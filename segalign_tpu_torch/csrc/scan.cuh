// One x-drop window of one extension direction for one row, walked by one
// warp. Shared by first_scan.cu (K1), window_scan.cu (K4) and
// window_scan_wide.cu (K5): it takes the place of the lane scans inside the
// TPU kernels those replace (segalign_tpu/ops/extend_pallas.py
// first_scan_pallas and window_scan_pallas, ops/extend_tiled.py
// window_scan_tall).
//
// The recurrence is the scan form of oracle/scan_spec.py, with the carried
// state of ops/extend3.py's window step, in int32 with wraparound:
//   cum_k = cum_{k-1} + sub[r_k * 8 + q_k]            (0 out of bounds)
//   m_k   = max(maxv0, cum_0 .. cum_k)                 (floored at maxv0)
//   d     = first lane with m_k - cum_k > xdrop       (W if none)
//   best  = max cum_k over lanes k < d, earliest lane on ties (strict >)
// The cumulative score and, with counts on, the match counts run over every
// in-bounds lane of the window, past the drop: the window's outputs are a
// function of the whole window, not of the lanes before the drop.
//
// Bound and design. The function reads each in-bounds byte of r and q once
// and writes 45 bytes of state a row, and does a handful of integer
// operations a byte, so on the H100 it is bound by bytes: 2 x W a row over
// 3.35 TB/s, which at the main path's shapes is 0.084 ms for K1 (2^17 rows,
// both directions, W = 512: 280.7 MB), 0.0105 ms for K4 (8192 alive rows
// of 16384, W = 2048: 35.1 MB) and 0.164 ms for K5 (2^17 rows, W = 2048:
// 549.2 MB); the .cu files say how each is counted. To get near
// that, a warp walks the row in chunks of 512 lanes: thread l loads the 16
// bytes at chunk * 512 + 16 * l of r and of q as one uint4 each, so the
// warp reads 512 contiguous bytes an array a step (from the top of the
// window down when a left window is stored ascending). The dependent chain
// of the recurrence is cut by three passes over the thread's 16 scores,
// which stay in registers, each joined across the warp by shuffles:
//   1. the thread's 16 scores are summed, and an inclusive warp scan of
//      the sums (wrapping adds, which are associative) gives every thread
//      the true cum before its first byte;
//   2. each thread walks its bytes from that cum and takes the max of the
//      true values; a warp prefix max, floored at the carried max, gives
//      the true running max before its first byte (a max over the values
//      themselves is associative whatever wrapped; the (sum, max) pair
//      operator max(m1, s1 + m2) is not once a sum wraps, so it is not
//      used);
//   3. each thread walks once more with the true cum and max, counts its
//      bytes before its first drop and keeps its best cum among them; a
//      ballot finds the first thread that dropped, the hardware's warp
//      max over the threads up to it gives best, and a second ballot the
//      earliest thread that holds it.
// A chunk that lies wholly in bounds (uniform over the warp) masks no
// score. Once the drop is known, later chunks only add their scores to
// cum. The match counts need the window's final max position, so they are
// a second walk, over a table that maps a byte pair to a packed one for
// its base: the first chunk's bytes are still in registers (all of W =
// 512), later chunks are read again (L1/L2 hits). One thread writes the
// row's scalars and threads 0-3 the four counts each.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sa {

constexpr int32_t NEG = -2147483647;  // -(2^31) + 1
constexpr int32_t INT32_LOWEST = -2147483647 - 1;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNK = 512;          // lanes a warp walks a step
constexpr int WARPS_PER_BLOCK = 8;  // one row (and direction) a warp

// The six arrays of the extension state of one direction.
struct State {
  bool* done;
  int32_t* cum;
  int32_t* maxv;
  int32_t* maxp;
  int32_t* counts;  // (B, 4)
  int32_t* cdel;    // (B, 4)
};

// The tables a block keeps in shared memory, indexed by r * 8 + q: the
// substitution score, and for the match counts 1 << (8 * b) where r == q
// == b < 4 (a match of base b), else 0.
struct Tables {
  int32_t score[64];
  uint32_t match[64];
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// Inclusive warp scan of wrapping sums.
__device__ __forceinline__ int32_t warp_scan_sum(int32_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int32_t t = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = wadd(v, t);
  }
  return v;
}

// Inclusive warp scan of maxima.
__device__ __forceinline__ int32_t warp_scan_max(int32_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int32_t t = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = t > v ? t : v;
  }
  return v;
}

// Wrapping sum over the warp (the hardware's warp reduction).
__device__ __forceinline__ int32_t warp_sum(int32_t v) {
  return static_cast<int32_t>(
      __reduce_add_sync(FULL, static_cast<uint32_t>(v)));
}

// A thread's 16 bytes of r and q as byte offsets into a 64-entry table of
// 4-byte words: four offsets (r * 8 + q) * 4 a word. Codes are below 8.
struct Offsets {
  uint32_t w[4];
  // the offset of the j-th byte in storage order
  __device__ __forceinline__ uint32_t at(int j) const {
    return (j & 3) == 3 ? w[j >> 2] >> 24
                        : (w[j >> 2] >> (8 * (j & 3))) & 0xffu;
  }
};

template <typename T>
__device__ __forceinline__ T table_at(const T* table, uint32_t offset) {
  return *reinterpret_cast<const T*>(
      reinterpret_cast<const unsigned char*>(table) + offset);
}

// The thread's 16-byte block `blk` of the window in scan order (zeros past
// the window) as table offsets.
template <bool LEFT>
__device__ __forceinline__ Offsets load_offsets(
    const uint4* __restrict__ r4, const uint4* __restrict__ q4, int blk,
    int nblk) {
  uint4 rv = make_uint4(0, 0, 0, 0), qv = rv;
  if (blk < nblk) {
    const int src = LEFT ? nblk - 1 - blk : blk;
    rv = __ldg(r4 + src);
    qv = __ldg(q4 + src);
  }
  Offsets o;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    o.w[w] = (((word_of(rv, w) & 0x07070707u) << 3) |
              (word_of(qv, w) & 0x07070707u))
             << 2;
  }
  return o;
}

// The thread's 16 scores in scan order and their wrapping sum. FULLY: all
// 16 lanes are in bounds; otherwise the first nv are.
template <bool LEFT, bool FULLY>
__device__ __forceinline__ int32_t scores_of(const Offsets& o,
                                             const int32_t* score, int nv,
                                             int32_t (&s)[16]) {
  int32_t t = 0;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int32_t v = table_at(score, o.at(LEFT ? 15 - jj : jj));
    s[jj] = (FULLY || jj < nv) ? v : 0;
    t = wadd(t, s[jj]);
  }
  return t;
}

// The calling thread's table offsets for the window's first chunk, which
// every scan reads whatever the anchors say: a caller loads it before it
// branches on the row's state, so that the window's first bytes travel
// together with the anchors and the state, not after them.
template <bool LEFT>
__device__ __forceinline__ Offsets first_chunk(const uint8_t* __restrict__ r,
                                               const uint8_t* __restrict__ q,
                                               int W) {
  return load_offsets<LEFT>(reinterpret_cast<const uint4*>(r),
                            reinterpret_cast<const uint4*>(q),
                            threadIdx.x & 31, W / 16);
}

// Scan one window and write the row's new state. Called by all 32 threads
// of a warp with the same arguments.
//   o0     : first_chunk<LEFT>(r, q, W) of the calling thread.
//   r, q   : the window's W bytes in ascending storage order, 16-byte
//            aligned, W a multiple of 16.
//   LEFT   : scan order is descending storage order (left extension).
//   p0     : extension offset of the first scanned lane; lane k has p0 + k.
//   lim    : lanes with extension offset < lim are in bounds. They are a
//            prefix of the scan order, since p rises along it.
//   tab    : the block's tables (shared memory).
//   cum0.. : the carried state of an alive row; counts0/cdel0 point at 4
//            ints each.
template <bool LEFT>
__device__ __forceinline__ void scan_window(const uint8_t* __restrict__ r,
                            const uint8_t* __restrict__ q, int W,
                            const Tables& tab, int32_t xdrop, int32_t p0,
                            int64_t lim, Offsets o0, int32_t cum0,
                            int32_t maxv0,
                            int32_t maxp0, const int32_t* counts0,
                            const int32_t* cdel0, bool with_counts,
                            const State& out, int row) {
  const int lane = threadIdx.x & 31;
  const uint4* r4 = reinterpret_cast<const uint4*>(r);
  const uint4* q4 = reinterpret_cast<const uint4*>(q);
  const int nblk = W / 16;
  const int64_t n_inb64 = lim - p0;
  const int n_inb =
      n_inb64 < 0 ? 0 : (n_inb64 > W ? W : static_cast<int>(n_inb64));
  // Lanes past the last in-bounds one score 0, so each repeats the cum and
  // the running max of the lane before it: it drops only if that lane
  // did, and it cannot beat that lane's cum. So no lane needs a mask in
  // the drop test or the search for the best, lane 0 is tested even when
  // nothing is in bounds (a carried state may already sit more than xdrop
  // below its max), and only the chunks below max(n_inb, 1) are read.
  const int kend = n_inb > 0 ? n_inb : 1;
  const int nchunks = (kend + CHUNK - 1) / CHUNK;

  int32_t c = cum0, m = maxv0, best = NEG;
  int bestk = -1, dk = W;
  int32_t tail = 0;  // this thread's scores of the chunks after the drop
  Offsets o = o0;
  for (int ci = 0;;) {
    const int k0 = ci * CHUNK + lane * 16;
    // pass 1: the 16 scores and their sum (no masks where the whole chunk
    // is in bounds, which is uniform over the warp)
    int32_t s[16];
    const int32_t t = n_inb >= (ci + 1) * CHUNK
                          ? scores_of<LEFT, true>(o, tab.score, 16, s)
                          : scores_of<LEFT, false>(o, tab.score, n_inb - k0,
                                                   s);
    if (dk != W) {  // warp-uniform: past the drop only the sum runs on
      tail = wadd(tail, t);
    } else {
      const int32_t incl = warp_scan_sum(t, lane);
      const int32_t c_lane = wadd(c, wsub(incl, t));
      // pass 2: the max of this thread's true values, then the running max
      // before its first byte
      int32_t v = c_lane, lmax = INT32_LOWEST;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        v = wadd(v, s[jj]);
        lmax = v > lmax ? v : lmax;
      }
      const int32_t imax = warp_scan_max(lmax, lane);
      int32_t mm = __shfl_up_sync(FULL, imax, 1);
      mm = (lane > 0 && mm > m) ? mm : m;
      // pass 3: the bytes before this thread's first drop (jd of them) and
      // the best cum among them, earliest on ties
      v = c_lane;
      int32_t lbest = NEG;
      int lbestj = 0, jd = 0;
      bool alive = true;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        v = wadd(v, s[jj]);
        mm = v > mm ? v : mm;
        alive = alive && !(wsub(mm, v) > xdrop);
        jd += alive;
        if (alive && v > lbest) {
          lbest = v;
          lbestj = jj;
        }
      }
      const unsigned dropped = __ballot_sync(FULL, jd < 16);
      if (dropped) {
        const int first = __ffs(dropped) - 1;
        dk = ci * CHUNK + first * 16 + __shfl_sync(FULL, jd, first);
        if (lane > first) lbest = NEG;
      }
      const int32_t cbest = __reduce_max_sync(FULL, lbest);
      if (cbest > best) {  // warp-uniform; the earliest thread that holds it
        const int holder = __ffs(__ballot_sync(FULL, lbest == cbest)) - 1;
        best = cbest;
        bestk = ci * CHUNK + holder * 16 + __shfl_sync(FULL, lbestj, holder);
      }
      c = wadd(c, __shfl_sync(FULL, incl, 31));
      const int32_t cmax = __shfl_sync(FULL, imax, 31);
      m = cmax > m ? cmax : m;
    }
    if (++ci >= nchunks) break;
    o = load_offsets<LEFT>(r4, q4, ci * 32 + lane, nblk);
  }
  c = wadd(c, warp_sum(tail));

  const int32_t Mv = best > maxv0 ? best : maxv0;
  const bool is_new = Mv > maxv0;
  const int32_t Mp = is_new ? p0 + bestk : maxp0;
  const bool finish = dk < W || n_inb64 < W;

  if (lane == 0) {
    out.done[row] = finish;
    out.cum[row] = c;
    out.maxv[row] = Mv;
    out.maxp[row] = Mp;
  }
  if (!with_counts) {
    if (lane < 4) {
      out.counts[row * 4 + lane] = counts0[lane];
      out.cdel[row * 4 + lane] = cdel0[lane];
    }
    return;
  }
  // Matches (equal codes < 4) inside the extent (p <= Mp) and in all, over
  // every in-bounds lane: four 8-bit fields a thread (at most 16 matches a
  // chunk and 8 chunks, W being at most 4096), widened to 16-bit fields
  // for the sums over the warp.
  const int64_t kin64 = static_cast<int64_t>(Mp) - p0;
  const int kin = kin64 < -1 ? -1 : (kin64 > W ? W : static_cast<int>(kin64));
  uint32_t a_in = 0, a_all = 0;
  const int ncount = (n_inb + CHUNK - 1) / CHUNK;
  for (int ci = 0; ci < ncount; ++ci) {
    const Offsets o = ci == 0 ? o0
                              : load_offsets<LEFT>(r4, q4, ci * 32 + lane,
                                                   nblk);
    const int k0 = ci * CHUNK + lane * 16;
    const int nv = n_inb - k0, nin = kin - k0;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const uint32_t one = table_at(tab.match, o.at(LEFT ? 15 - jj : jj));
      const uint32_t counted = jj < nv ? one : 0u;
      a_all += counted;
      a_in += jj <= nin ? counted : 0u;
    }
  }
  const uint32_t a_out = a_all - a_in;  // field by field: a_in <= a_all
  // fields 0 and 2, and fields 1 and 3, summed over the warp
  const uint32_t in02 = __reduce_add_sync(FULL, a_in & 0x00ff00ffu);
  const uint32_t in13 = __reduce_add_sync(FULL, (a_in >> 8) & 0x00ff00ffu);
  const uint32_t out02 = __reduce_add_sync(FULL, a_out & 0x00ff00ffu);
  const uint32_t out13 = __reduce_add_sync(FULL, (a_out >> 8) & 0x00ff00ffu);
  if (lane < 4) {
    const int shift = 16 * (lane >> 1);
    const int32_t n_in = ((lane & 1 ? in13 : in02) >> shift) & 0xffffu;
    const int32_t n_out = ((lane & 1 ? out13 : out02) >> shift) & 0xffffu;
    const bool new_max = Mp > maxp0;
    const int32_t c0 = counts0[lane], d0 = cdel0[lane];
    out.counts[row * 4 + lane] = wadd(new_max ? wadd(c0, d0) : c0, n_in);
    out.cdel[row * 4 + lane] = wadd(new_max ? 0 : d0, n_out);
  }
}

// Fill the block's tables from the 64-entry substitution table.
__device__ __forceinline__ void load_tables(Tables& tab,
                                            const int32_t* sub_g) {
  for (int i = threadIdx.x; i < 64; i += blockDim.x) {
    tab.score[i] = sub_g[i];
    tab.match[i] = (i % 9 == 0 && i < 32) ? 1u << (8 * (i / 9)) : 0u;
  }
  __syncthreads();
}

// One window of each row from its carried state (K4, K5), a warp a row.
// RAW: the window is in ascending storage order and a left one is walked
// from its last byte (K4); otherwise both directions are in extension order
// (K5). Either way the first lane walked is extension offset tile (right)
// or tile + 1 (left). A row done on entry passes through unchanged: its
// warp copies the 45 bytes of state and reads no window.
template <bool RAW>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32) carried_scan_kernel(
    const uint8_t* __restrict__ r, const uint8_t* __restrict__ q,
    const int32_t* __restrict__ loc_r, const int32_t* __restrict__ loc_q,
    const int32_t* __restrict__ cum, const int32_t* __restrict__ maxv,
    const int32_t* __restrict__ maxp, const bool* __restrict__ done,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ cdel,
    const int32_t* __restrict__ sub_g, int B, int W, int32_t xdrop,
    int32_t tile, int32_t ref_len, int32_t query_len, bool left,
    bool with_counts, State out) {
  __shared__ Tables tab;
  load_tables(tab, sub_g);
  const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;
  if (done[row]) {
    if (lane == 0) {
      out.done[row] = true;
      out.cum[row] = cum[row];
      out.maxv[row] = maxv[row];
      out.maxp[row] = maxp[row];
    }
    if (lane < 4) {
      out.counts[row * 4 + lane] = counts[row * 4 + lane];
      out.cdel[row * 4 + lane] = cdel[row * 4 + lane];
    }
    return;
  }
  const size_t base = static_cast<size_t>(row) * W;
  if (left) {
    const Offsets o0 = first_chunk<RAW>(r + base, q + base, W);
    const int64_t lr = loc_r[row], lq = loc_q[row];
    const int64_t lim = (lr < lq ? lr : lq) + 1;
    scan_window<RAW>(r + base, q + base, W, tab, xdrop, tile + 1, lim, o0,
                     cum[row], maxv[row], maxp[row], counts + row * 4,
                     cdel + row * 4, with_counts, out, row);
  } else {
    const Offsets o0 = first_chunk<false>(r + base, q + base, W);
    const int64_t lr = loc_r[row], lq = loc_q[row];
    const int64_t a = ref_len - lr, b = query_len - lq;
    scan_window<false>(r + base, q + base, W, tab, xdrop, tile,
                       a < b ? a : b, o0, cum[row], maxv[row], maxp[row],
                       counts + row * 4, cdel + row * 4, with_counts, out,
                       row);
  }
}

// The launcher body of K4 and K5: a warp a row, eight rows a block.
template <bool RAW>
cudaError_t launch_carried_scan(
    const void* r, const void* q, const void* loc_r, const void* loc_q,
    const void* cum, const void* maxv, const void* maxp, const void* done,
    const void* counts, const void* cdel, const void* sub, int B, int W,
    int xdrop, int tile, int ref_len, int query_len, int left,
    int with_counts, void* o_done, void* o_cum, void* o_maxv, void* o_maxp,
    void* o_counts, void* o_cdel, void* stream) {
  const State out{static_cast<bool*>(o_done), static_cast<int32_t*>(o_cum),
                  static_cast<int32_t*>(o_maxv),
                  static_cast<int32_t*>(o_maxp),
                  static_cast<int32_t*>(o_counts),
                  static_cast<int32_t*>(o_cdel)};
  if (B == 0) return cudaSuccess;
  const int blocks = (B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  carried_scan_kernel<RAW><<<blocks, WARPS_PER_BLOCK * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(r), static_cast<const uint8_t*>(q),
      static_cast<const int32_t*>(loc_r), static_cast<const int32_t*>(loc_q),
      static_cast<const int32_t*>(cum), static_cast<const int32_t*>(maxv),
      static_cast<const int32_t*>(maxp), static_cast<const bool*>(done),
      static_cast<const int32_t*>(counts), static_cast<const int32_t*>(cdel),
      static_cast<const int32_t*>(sub), B, W, xdrop, tile, ref_len, query_len,
      left != 0, with_counts != 0, out);
  return cudaGetLastError();
}

}  // namespace sa
