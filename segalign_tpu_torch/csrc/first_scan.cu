// K1: the first x-drop window of both extension directions.
//
// Replaces segalign_tpu/ops/extend_pallas.py first_scan_pallas
// (_first_scan_kernel). Input is one (B, 2W) pair of byte rows per hit,
// gathered at loc - W: lanes [0, W) are the left extension, scanned right
// to left; lanes [W, 2W) are the right extension. The initial state is
// implicit (cum = maxv = 0, maxp = -1 right and 0 left, zero counts).
//
// Bound on the H100: bytes. The function reads the 2 x 2W bytes of a
// row's r2 and q2 once and writes 2 x 45 bytes of state; at the main path's
// shape (B = 2^17, W = 512) that is 268.4 MB of windows, 1.2 MB of anchors
// and 11.8 MB of state, 0.084 ms at 3.35 TB/s. Its arithmetic is about six
// integer operations a lane (a table lookup, an add, a max, a subtract and
// two compares), 0.8e9 in all, 0.012 ms at the 67e12 a second of the
// card's non-tensor units. A row whose window ends at a sequence end needs
// fewer bytes (only in-bounds lanes are read). Design (scan.cuh): one warp
// walks one (row, direction); its 32 threads load 16 contiguous bytes each,
// 512 contiguous bytes an array, which at W = 512 is the whole window in
// one step, and shuffle scans join the threads' partial sums and maxima.
// Blocks are one direction each, so a warp never diverges on the
// direction; eight warps a block.
//
// Second entry point, sa_first_scan_seq (K1s): the same function on the
// windows of the padded sequences, with no gathered rows between. It
// computes first_scan(gather_rows(ref_pad, pad + loc_r - W, 2W),
// gather_rows(query_pad, pad + loc_q - W, 2W), ...): the same clamp of the
// window's start, the same state. The gathers' two (B, 2W) byte arrays
// (256 MiB at B = 2^17, W = 512) never exist.
//
// Bound on the H100: the larger of its bytes and its operations. It must
// read the sequence bytes the valid rows' windows cover, once each however
// many windows share them, 9 bytes of anchors and flag a row, and write 90
// of state; a chunk's anchors cluster (on the query by construction, on
// the reference in its repeats), so at the main path's shape (B = 2^17, W
// = 512) that is some 16 MB, 0.005 ms. Its operations: six a lane up to a
// row's first drop (a lookup, an add, a max, a subtract, two compares)
// and two past it (the lookup and the add), at 67e12 a second; most rows
// drop within a few tens of lanes. chip_smoke.py counts both from its
// inputs, the drops from the plain walk.
//
// What held the earlier design back: a warp walked one row, 512 lanes a
// step with three passes and shuffle scans, so its time was the same at W
// = 256 as at W = 512 (a warp walks a whole chunk with half its threads
// masked) and every lane paid the full recurrence past the drop.
//
// Design: one thread walks one (row, direction), lane by lane, as the
// plain version defines the recurrence; a warp holds 32 rows of one
// direction, a block 128 rows both ways (walk_row says how a row's walk
// goes). Its 16-byte loads come straight from the sequences, unguarded
// where the whole warp's blocks lie inside them, and its q bytes are
// aligned to its r blocks in registers (align_block); a table
// lookup takes a byte permute and an add for its address (lookup), into a
// table kept in 32 copies, one a bank, so that no two lanes of a warp
// share a bank (with one copy, soft-masked bases, code 4, put the pairs
// of r = 4 and r = 0 in the same banks, and a quarter of the benchmark
// pair's bases are soft-masked). Once no
// row of the warp is alive, the rest of the window only adds scores; the
// match counts come out of the same walk (a snapshot at each new best).
//
// What holds it now (scripts/k1s_rows.py, PERF.md): its time grows with
// the lanes walked (W = 256 takes two thirds of W = 512) and not with its
// instruction count (cutting the sums' loop from 9 to 4.5 instructions a
// lane moved it by under 10%). Each warp-wide load reads 32 rows' windows
// at 32 unrelated addresses, and the loads and the lookups share the
// SM's L1 and shared-memory data path; copying each row's r blocks into
// shared memory with loads that cover each row's span together measured
// slower, and loading two blocks a step instead of one no faster.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

// One direction of one row, by one warp. The window's bytes, the anchors
// and the valid flag are loaded together, before the branch on the flag
// (a row that is not valid reads a window it does not use; such rows are
// few).
template <bool LEFT>
__device__ __forceinline__ void first_half(
    const uint8_t* __restrict__ r, const uint8_t* __restrict__ q,
    const int32_t* __restrict__ loc_r, const int32_t* __restrict__ loc_q,
    const bool* __restrict__ valid, const sa::Tables& tab,
    const int32_t* zero4, int row, int W, int32_t xdrop, int32_t ref_len,
    int32_t query_len, bool with_counts, const sa::State& out) {
  const int lane = threadIdx.x & 31;
  const sa::Offsets o0 = sa::first_chunk<LEFT>(r, q, W);
  const int64_t lr = loc_r[row], lq = loc_q[row];
  const int32_t init_maxp = LEFT ? 0 : -1;
  if (!valid[row]) {
    if (lane == 0) {
      out.done[row] = true;
      out.cum[row] = 0;
      out.maxv[row] = 0;
      out.maxp[row] = init_maxp;
    }
    if (lane < 4) {
      out.counts[row * 4 + lane] = 0;
      out.cdel[row * 4 + lane] = 0;
    }
    return;
  }
  // left: lane W - p holds the byte at extension offset p = 1 .. W
  const int64_t a = ref_len - lr, b = query_len - lq;
  const int64_t lim = LEFT ? (lr < lq ? lr : lq) + 1 : (a < b ? a : b);
  sa::scan_window<LEFT>(r, q, W, tab, xdrop, LEFT ? 1 : 0, lim, o0, 0, 0,
                        init_maxp, zero4, zero4, with_counts, out, row);
}

__global__ void __launch_bounds__(sa::WARPS_PER_BLOCK * 32)
    first_scan_kernel(const uint8_t* __restrict__ r2,
                      const uint8_t* __restrict__ q2,
                      const int32_t* __restrict__ loc_r,
                      const int32_t* __restrict__ loc_q,
                      const bool* __restrict__ valid,
                      const int32_t* __restrict__ sub_g, int B, int W,
                      int32_t xdrop, int32_t ref_len, int32_t query_len,
                      bool with_counts, sa::State right, sa::State left) {
  __shared__ sa::Tables tab;
  __shared__ int32_t zero4[4];
  if (threadIdx.x < 4) zero4[threadIdx.x] = 0;
  sa::load_tables(tab, sub_g);
  const int row = blockIdx.x * sa::WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= B) return;
  const size_t base = static_cast<size_t>(row) * 2 * W;
  if (blockIdx.y == 1) {
    first_half<true>(r2 + base, q2 + base, loc_r, loc_q, valid, tab, zero4,
                     row, W, xdrop, ref_len, query_len, with_counts, left);
  } else {
    first_half<false>(r2 + base + W, q2 + base + W, loc_r, loc_q, valid, tab,
                      zero4, row, W, xdrop, ref_len, query_len, with_counts,
                      right);
  }
}

// ---- K1s: first_scan_seq_kernel, a thread a (row, direction) ----------

constexpr int SEQ_ROWS = 128;  // rows a block: four warps right, four left
// blocks an SM must hold at once: caps the registers at 80 a thread
constexpr int SEQ_MIN_BLOCKS = 3;

// Four byte pairs as table entries r * 8 + q, byte j of r with byte j of
// q. Codes are below 8; a byte of 8 or more, which no padded sequence
// holds, still gives an entry inside the table.
__device__ __forceinline__ uint32_t entries_word(uint32_t r, uint32_t q) {
  return ((r << 3) + q) & 0x3f3f3f3fu;
}

// The table word of entry byte j of the four words o, by one byte permute
// and one add. The table keeps 32 copies of each entry, one a bank, so
// that no two lanes of a warp read one bank: entry i's copies fill bytes
// [256 i, 256 i + 128) (scores) and [256 i + 128, 256 i + 256) (match
// counts), and base is the calling lane's copy of entry 0 (the table plus
// 4 lane, plus 128 for the match counts).
__device__ __forceinline__ uint32_t lookup(const uint32_t (&o)[4], int j,
                                           uint32_t base) {
  const uint32_t addr =
      __byte_perm(o[j >> 2], 0, 0x4404 | ((j & 3) << 4)) + base;
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// The walk of one (row, direction) so far.
struct Walk {
  int32_t cum = 0;         // the running sum over every lane walked
  int32_t m = 0;           // the running max of cum, floored at 0
  int32_t best = sa::NEG;  // the largest cum before the drop (strict >)
  int32_t bestk = -1;      // its lane
  bool alive = true;       // no lane has dropped yet
  // matches (equal codes below 4) of the blocks walked, and of the lanes
  // up to bestk: bases 0 and 2 (lo), 1 and 3 (hi), 16-bit fields
  uint32_t lo = 0, hi = 0, snap_lo = 0, snap_hi = 0;
};

// One block of 16 lanes, k0 .. k0 + 15, in walk order, from its entries
// o; tab is the lane's copy of the table (lookup).
// FULL: the whole recurrence (cum, the running max, the drop test, the
// best and, with COUNTS, a snapshot of the match counts at each new
// best); otherwise only the sums. MASKED: lanes outside [0, kend) score 0
// and are not tested.
template <bool LEFT, bool COUNTS, bool FULL, bool MASKED>
__device__ __forceinline__ void walk_block(Walk& w, const uint32_t (&o)[4],
                                           uint32_t tab, int k0, int kend,
                                           int32_t xdrop) {
  uint32_t n = 0, nsnap = 0;  // this block's matches, 8-bit fields
  bool snapped = false;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int j = LEFT ? 15 - jj : jj;  // the byte of walk position jj
    int32_t s = static_cast<int32_t>(lookup(o, j, tab));
    uint32_t one = COUNTS ? lookup(o, j, tab + 128) : 0u;
    bool in = true;
    if (MASKED) {
      in = static_cast<unsigned>(k0 + jj) < static_cast<unsigned>(kend);
      s = in ? s : 0;
      one = in ? one : 0u;
    }
    const int32_t c = sa::wadd(w.cum, s);
    w.cum = c;
    if (COUNTS) n += one;
    if (FULL) {
      w.m = c > w.m ? c : w.m;
      w.alive = w.alive && !(in && sa::wsub(w.m, c) > xdrop);
      const bool up = w.alive && in && c > w.best;
      w.best = up ? c : w.best;
      w.bestk = up ? k0 + jj : w.bestk;
      if (COUNTS) {
        nsnap = up ? n : nsnap;
        snapped = snapped || up;
      }
    }
  }
  if (COUNTS) {
    if (FULL && snapped) {
      w.snap_lo = w.lo + (nsnap & 0x00ff00ffu);
      w.snap_hi = w.hi + ((nsnap >> 8) & 0x00ff00ffu);
    }
    w.lo += n & 0x00ff00ffu;
    w.hi += (n >> 8) & 0x00ff00ffu;
  }
}

// The start of the 2W-wide window of anchor loc, as gather_rows computes
// it: pad + loc - W in int32 (wrapping, as the torch expression does),
// clamped to [0, n - 2W].
__device__ __forceinline__ int64_t window_start(int32_t pad, int32_t loc,
                                                int W, int64_t n) {
  const int64_t s = static_cast<int32_t>(static_cast<uint32_t>(pad) +
                                         static_cast<uint32_t>(loc) -
                                         static_cast<uint32_t>(W));
  const int64_t hi = n - 2 * static_cast<int64_t>(W);
  return s < 0 ? 0 : (s > hi ? hi : s);
}

// The sequences' bytes of one (row, direction), a 16-byte block of r and
// its q bytes at a time: r block i, and q blocks i and i + 1 of the q
// stream, from which align_block cuts r block i's q bytes; the blocks run
// up (right) or down (left) by step. r and q are the offsets of the next r
// block and the next q block to load.
struct Blocks {
  const uint8_t* __restrict__ ref;
  const uint8_t* __restrict__ qry;
  int64_t n_ref, n_qry, r, q, step;
  bool w8, w4;
  int sh;
  bool left;
  uint4 qprev;  // the q block before q
  __device__ __forceinline__ void start() {
    qprev = sa::load_block(qry, n_qry, q);
    q += step;
  }
  // Whether the next `count` blocks lie inside both sequences.
  __device__ __forceinline__ bool inside(int count) const {
    const int64_t span = step * (count - 1);
    const auto in = [](int64_t a, int64_t b, int64_t n) {
      const int64_t lo = a < b ? a : b, hi = a < b ? b : a;
      return lo >= 0 && hi <= n - 16;
    };
    return in(r, r + span, n_ref) && in(q, q + span, n_qry);
  }
  // The table entries of the next block. GUARD: a block that crosses an
  // end of its sequence reads as 0 past it; otherwise every block lies
  // inside.
  template <bool GUARD>
  __device__ __forceinline__ void next(uint32_t (&o)[4]) {
    const uint4 rb = GUARD ? sa::load_block(ref, n_ref, r)
                           : __ldg(reinterpret_cast<const uint4*>(ref + r));
    const uint4 qn = GUARD ? sa::load_block(qry, n_qry, q)
                           : __ldg(reinterpret_cast<const uint4*>(qry + q));
    r += step;
    q += step;
    const uint4 qb = left ? sa::align_block(qn, qprev, w8, w4, sh)
                          : sa::align_block(qprev, qn, w8, w4, sh);
    qprev = qn;
    o[0] = entries_word(rb.x, qb.x);
    o[1] = entries_word(rb.y, qb.y);
    o[2] = entries_word(rb.z, qb.z);
    o[3] = entries_word(rb.w, qb.w);
  }
};

// One direction of one row, by one thread; the warp's 32 rows walk
// together. Lane k is extension offset p = k (right, storage byte s + W +
// k of the window at s) or k + 1 (left, byte s + W - 1 - k). The walk
// goes over the aligned 16-byte blocks of r that hold lanes [0, kend),
// the in-bounds ones: lane 0 sits at walk position mr of block 0 (the
// positions before it, and those past kend in the last block, are
// masked). Three phases, each the same over the warp: the full
// recurrence until no row of the warp has an alive lane left in its
// window (a vote a block); then only the sums over the blocks that every
// row with lanes holds whole; then the rest, masked. A row that is not
// valid, or whose window has no in-bounds lane (kend 0), walks with the
// warp on blocks it does not use and writes the fresh state: done, maxp
// -1 (right) or 0 (left), the rest 0.
template <bool LEFT, bool COUNTS>
__device__ __forceinline__ void walk_row(
    const uint8_t* __restrict__ ref, int64_t n_ref,
    const uint8_t* __restrict__ qry, int64_t n_qry,
    const int32_t* __restrict__ loc_r, const int32_t* __restrict__ loc_q,
    const bool* __restrict__ valid, uint32_t tab, int row, int B, int W,
    int32_t pad, int32_t xdrop, int32_t ref_len, int32_t query_len,
    const sa::State& out) {
  int32_t lr = 0, lq = 0;
  bool ok = false;
  if (row < B) {
    lr = loc_r[row];
    lq = loc_q[row];
    ok = valid[row];
  }
  const int64_t a = static_cast<int64_t>(ref_len) - lr;
  const int64_t b = static_cast<int64_t>(query_len) - lq;
  const int64_t lim = LEFT ? (lr < lq ? lr : lq) : (a < b ? a : b);
  const int kend =
      !ok || lim <= 0 ? 0 : (lim >= W ? W : static_cast<int>(lim));
  // storage bytes of lane 0
  const int64_t fr = window_start(pad, lr, W, n_ref) + (LEFT ? W - 1 : W);
  const int64_t fq = window_start(pad, lq, W, n_qry) + (LEFT ? W - 1 : W);
  const int mr = LEFT ? 15 - static_cast<int>(fr & 15)
                      : static_cast<int>(fr & 15);
  // the q bytes of r block i are [t + step i, + 16): q stream blocks i
  // and i + 1 hold them (left: the stream runs down from the block above)
  const int64_t t = LEFT ? fq - 15 + mr : fq - mr;
  const int d = static_cast<int>(t & 15);
  Blocks blk{ref, qry, n_ref, n_qry, fr & ~static_cast<int64_t>(15),
             (t & ~static_cast<int64_t>(15)) + (LEFT ? 16 : 0),
             LEFT ? -16 : 16, (d & 8) != 0, (d & 4) != 0, 8 * (d & 3), LEFT,
             make_uint4(0, 0, 0, 0)};
  const int nb = kend ? (mr + kend + 15) >> 4 : 0;
  // over the warp: the blocks to walk, and [i_lo, i_hi), the blocks that
  // hold only in-bounds lanes of every row with any
  const int nbw = __reduce_max_sync(sa::FULL, nb);
  const int i_lo = __any_sync(sa::FULL, kend > 0 && mr > 0) ? 1 : 0;
  const int i_hi = static_cast<int>(__reduce_min_sync(
      sa::FULL, kend ? static_cast<unsigned>((mr + kend) >> 4) : ~0u));

  Walk w;
  uint32_t o[4] = {0, 0, 0, 0};  // a row with no block reads entry 0
  if (nb) blk.start();
  int i = 0;
  while (i < nbw) {  // the full recurrence
    if (i < nb) blk.next<true>(o);
    const int k0 = 16 * i - mr;
    if (i >= i_lo && i < i_hi) {
      walk_block<LEFT, COUNTS, true, false>(w, o, tab, k0, kend,
                                                    xdrop);
    } else {
      walk_block<LEFT, COUNTS, true, true>(w, o, tab, k0, kend,
                                                   xdrop);
    }
    ++i;
    if (!__any_sync(sa::FULL, w.alive && k0 + 16 < kend)) break;
  }
  // sums over whole blocks; unguarded where the blocks of every row lie
  // inside both sequences (a row without lanes loads blocks it does not
  // use)
  if (__all_sync(sa::FULL, i >= i_hi || blk.inside(i_hi - i))) {
    for (; i < i_hi; ++i) {
      blk.next<false>(o);
      walk_block<LEFT, COUNTS, false, false>(w, o, tab, 0, kend,
                                                     xdrop);
    }
  } else {
    for (; i < i_hi; ++i) {
      blk.next<true>(o);
      walk_block<LEFT, COUNTS, false, false>(w, o, tab, 0, kend,
                                                     xdrop);
    }
  }
  for (; i < nbw; ++i) {  // sums, masked
    if (i < nb) blk.next<true>(o);
    walk_block<LEFT, COUNTS, false, true>(w, o, tab, 16 * i - mr,
                                                  kend, xdrop);
  }

  if (row >= B) return;
  const int32_t p0 = LEFT ? 1 : 0;
  const bool is_new = kend > 0 && w.best > 0;  // maxv > its start, 0
  out.done[row] = kend == 0 || !w.alive || kend < W;
  out.cum[row] = kend ? w.cum : 0;
  out.maxv[row] = is_new ? w.best : 0;
  out.maxp[row] = is_new ? p0 + w.bestk : p0 - 1;
  uint32_t in_lo = 0, in_hi = 0, all_lo = 0, all_hi = 0;
  if (COUNTS && kend) {
    in_lo = is_new ? w.snap_lo : 0u;
    in_hi = is_new ? w.snap_hi : 0u;
    all_lo = w.lo;
    all_hi = w.hi;
  }
  // field by field: the counts up to bestk never exceed the window's
  const uint32_t del_lo = all_lo - in_lo, del_hi = all_hi - in_hi;
  reinterpret_cast<int4*>(out.counts)[row] = make_int4(
      in_lo & 0xffff, in_hi & 0xffff, in_lo >> 16, in_hi >> 16);
  reinterpret_cast<int4*>(out.cdel)[row] = make_int4(
      del_lo & 0xffff, del_hi & 0xffff, del_lo >> 16, del_hi >> 16);
}


// Eight warps a block over 128 rows: even warps walk the right windows of
// 32 rows, odd warps the left windows of the same rows. Each block fills
// its tables in shared memory first (lookup says how they lie).
template <bool COUNTS>
__global__ void __launch_bounds__(256, SEQ_MIN_BLOCKS)
    first_scan_seq_kernel(const uint8_t* __restrict__ ref_pad, int64_t n_ref,
                          const uint8_t* __restrict__ query_pad,
                          int64_t n_query,
                          const int32_t* __restrict__ loc_r,
                          const int32_t* __restrict__ loc_q,
                          const bool* __restrict__ valid,
                          const int32_t* __restrict__ sub_g, int B, int W,
                          int32_t pad, int32_t xdrop, int32_t ref_len,
                          int32_t query_len, sa::State right,
                          sa::State left) {
  __shared__ __align__(1024) uint32_t rtab[64 * 64];
  for (int i = threadIdx.x; i < 64 * 64; i += blockDim.x) {
    const int e = i >> 6;
    rtab[i] = (i & 32) ? ((e % 9 == 0 && e < 32) ? 1u << (8 * (e / 9)) : 0u)
                       : static_cast<uint32_t>(sub_g[e]);
  }
  __syncthreads();
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(rtab)) +
      4 * (threadIdx.x & 31);
  const int warp = threadIdx.x >> 5;
  const int row =
      blockIdx.x * SEQ_ROWS + (warp >> 1) * 32 + (threadIdx.x & 31);
  if (warp & 1) {
    walk_row<true, COUNTS>(ref_pad, n_ref, query_pad, n_query, loc_r,
                                   loc_q, valid, base, row, B, W, pad,
                                   xdrop, ref_len, query_len, left);
  } else {
    walk_row<false, COUNTS>(ref_pad, n_ref, query_pad, n_query,
                                    loc_r, loc_q, valid, base, row, B, W,
                                    pad, xdrop, ref_len, query_len, right);
  }
}

sa::State state_of(void* done, void* cum, void* maxv, void* maxp,
                   void* counts, void* cdel) {
  return sa::State{static_cast<bool*>(done), static_cast<int32_t*>(cum),
                   static_cast<int32_t*>(maxv), static_cast<int32_t*>(maxp),
                   static_cast<int32_t*>(counts),
                   static_cast<int32_t*>(cdel)};
}

}  // namespace

extern "C" cudaError_t sa_first_scan(
    const void* r2, const void* q2, const void* loc_r, const void* loc_q,
    const void* valid, const void* sub, int B, int W, int xdrop, int ref_len,
    int query_len, int with_counts, void* r_done, void* r_cum, void* r_maxv,
    void* r_maxp, void* r_counts, void* r_cdel, void* l_done, void* l_cum,
    void* l_maxv, void* l_maxp, void* l_counts, void* l_cdel,
    void* stream) {
  const sa::State right =
      state_of(r_done, r_cum, r_maxv, r_maxp, r_counts, r_cdel);
  const sa::State left =
      state_of(l_done, l_cum, l_maxv, l_maxp, l_counts, l_cdel);
  if (B == 0) return cudaSuccess;
  const dim3 grid((B + sa::WARPS_PER_BLOCK - 1) / sa::WARPS_PER_BLOCK, 2);
  first_scan_kernel<<<grid, sa::WARPS_PER_BLOCK * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(r2), static_cast<const uint8_t*>(q2),
      static_cast<const int32_t*>(loc_r), static_cast<const int32_t*>(loc_q),
      static_cast<const bool*>(valid), static_cast<const int32_t*>(sub), B, W,
      xdrop, ref_len, query_len, with_counts != 0, right, left);
  return cudaGetLastError();
}

extern "C" cudaError_t sa_first_scan_seq(
    const void* ref_pad, int64_t n_ref, const void* query_pad,
    int64_t n_query, const void* loc_r, const void* loc_q, const void* valid,
    const void* sub, int B, int W, int pad, int xdrop, int ref_len,
    int query_len, int with_counts, void* r_done, void* r_cum, void* r_maxv,
    void* r_maxp, void* r_counts, void* r_cdel, void* l_done, void* l_cum,
    void* l_maxv, void* l_maxp, void* l_counts, void* l_cdel,
    void* stream) {
  const sa::State right =
      state_of(r_done, r_cum, r_maxv, r_maxp, r_counts, r_cdel);
  const sa::State left =
      state_of(l_done, l_cum, l_maxv, l_maxp, l_counts, l_cdel);
  if (B == 0) return cudaSuccess;
  const int grid = (B + SEQ_ROWS - 1) / SEQ_ROWS;
  auto kernel = with_counts ? first_scan_seq_kernel<true>
                            : first_scan_seq_kernel<false>;
  kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ref_pad), n_ref,
      static_cast<const uint8_t*>(query_pad), n_query,
      static_cast<const int32_t*>(loc_r), static_cast<const int32_t*>(loc_q),
      static_cast<const bool*>(valid), static_cast<const int32_t*>(sub), B, W,
      pad, xdrop, ref_len, query_len, right, left);
  return cudaGetLastError();
}
