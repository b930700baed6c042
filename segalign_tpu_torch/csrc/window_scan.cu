// K4: a continuation x-drop window from the carried extension state.
//
// Replaces segalign_tpu/ops/extend_tiled.py window_scan_tall
// (_window_scan_tall_kernel). Input is the raw (B, W) byte windows in
// ascending storage order: the right extension at [loc + tile, loc + tile
// + W), the left one at [loc - tile - W, loc - tile), scanned in descending
// order with extension offset p = tile + W - f for storage lane f. Rows
// already done pass through unchanged.
//
// Bound on the H100: bytes. An alive row's 2 x W window bytes are read
// once (fewer at a sequence end), and every row's 45 bytes of state and 8
// of anchors are read and 45 written. At the main path's shape (16384
// rows, 8192 alive on entry, W = 2048) that is 33.6 MB of windows and
// 1.6 MB of state, 0.0105 ms at 3.35 TB/s; the arithmetic (about six
// integer operations a lane, 0.1e9) is 0.0015 ms at 67e12 a second. So
// small a launch is near its floor of a few microseconds, and what counts
// is to spread the alive rows over the whole card: a warp walks a row
// (scan.cuh, carried_scan_kernel), so 8192 alive rows are 262144 threads
// on all 132 SMs, each step of a warp reads 512 contiguous bytes an array,
// four steps a window, a done row's warp copies its state and exits, and a
// row stops reading past its last in-bounds lane. The TPU kernel's
// shortcuts (a bf16 matmul prefix sum, 16-bit packed count sums) are not
// carried over: sums here are exact int32.
//
// A second entry point below, sa_window_scan_seq (K4s), walks each alive
// row's windows one after another, read straight from the padded sequences.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

extern "C" cudaError_t sa_window_scan(
    const void* r, const void* q, const void* loc_r, const void* loc_q,
    const void* cum, const void* maxv, const void* maxp, const void* done,
    const void* counts, const void* cdel, const void* sub, int B, int W,
    int xdrop, int tile, int ref_len, int query_len, int left,
    int with_counts, void* o_done, void* o_cum, void* o_maxv, void* o_maxp,
    void* o_counts, void* o_cdel, void* stream) {
  return sa::launch_carried_scan<true>(
      r, q, loc_r, loc_q, cum, maxv, maxp, done, counts, cdel, sub, B, W,
      xdrop, tile, ref_len, query_len, left, with_counts, o_done, o_cum,
      o_maxv, o_maxp, o_counts, o_cdel, stream);
}

// ---- K4s: sa_window_scan_seq, every survivor walked to its end ----------
//
// Replaces the continuation of segalign_tpu/ops/extend_fused.py (_run_tail
// and _cont_loop, whose step _step_pallas is K2 + K4: gather_rows_pallas,
// extend_pallas.py:469, and window_scan_tall, extend_tiled.py:261) for both
// directions of one program at once. It computes what the host-stepped
// survivor loop computes (ops/extend_fused.py run_survivors, one gather per
// sequence and one K4 a step): every row that is not done on entry walks
// W-wide windows at tile = tile0, tile0 + W, tile0 + 2W, ..., to the right
// [loc + tile, loc + tile + W), to the left [loc - tile - W, loc - tile)
// from its top byte down, each window's start clamped as gather_rows
// clamps it (pad + loc + off in int32, then to [0, n - W]), until the
// window where it drops or reaches a sequence end. The state is updated in
// place: a row done on entry is read (its flag) and not written.
//
// Bound on the H100: the larger of its bytes and its operations. It must
// read each in-bounds sequence byte that the alive rows' windows cover,
// once, every row's done flag of both directions, and the alive rows'
// anchors and state, and write their state; its operations are six a lane
// up to a row's drop and two past it (chip_smoke.py counts both from the
// plain walk on its inputs). The survivors of a program are few (some 700
// right and 500 left of 2^17 rows at the benchmark's first cell) and the
// longest of them sets the launch's time, so the design is about spreading
// them over the card, not about bytes.
//
// Design: one warp walks one alive row, window after window, with
// scan_carry (scan.cuh: 512 contiguous bytes an array a step, shuffle
// scans, sums only past the drop), its state in registers until the row is
// done, and the next chunk's bytes asked for before the passes over this
// one (a warp walks its row alone, so nothing else hides the wait); the
// window's 16-byte spans are cut from aligned loads of the sequences
// (SeqLoad: a window starts at any byte, r and q at different offsets). A
// persistent grid, as many blocks as the SMs hold at once, finds the alive
// rows itself: a warp claims a group of 128 rows of one direction from the
// launch's counter (four done flags a thread), walks the first alive row
// of the group and puts the others on the launch's list; once every group
// is scanned, the warps take the listed rows one at a time. So a done row
// costs a flag read, and alive rows that sit together (the hits of one
// homology do) spread over the warps instead of queueing on one. The
// counters and the list are the launch's own (scratch; the launcher zeroes
// the four counters on the launch's stream, and the list is read only once
// it is whole): two programs may run at once on one card.
namespace {

constexpr int SEQ_WARPS = 4;       // warps a block
constexpr int GROUP = 128;         // rows a claim: four flags a thread
constexpr int SCRATCH_HEAD = 4;    // counters before the list

// The start of a window of W bytes at off from anchor loc, as gather_rows
// computes it: pad + loc + off in int32 (wrapping, as the torch expression
// does), clamped to [0, n - W].
__device__ __forceinline__ int64_t window_start(int32_t pad, int32_t loc,
                                                int32_t off, int W,
                                                int64_t n) {
  const int64_t s = sa::wadd(sa::wadd(pad, loc), off);
  const int64_t hi = n - W;
  return s < 0 ? 0 : (s > hi ? hi : s);
}

struct Seqs {
  const uint8_t* __restrict__ ref;
  const uint8_t* __restrict__ qry;
  int64_t n_ref, n_qry;
};

// Walk one alive row of one direction to its end and write its state. All
// 32 threads of the warp call it.
template <bool LEFT>
__device__ __forceinline__ void walk_row(
    const Seqs& sq, const int32_t* __restrict__ loc_r,
    const int32_t* __restrict__ loc_q, const sa::Tables& tab, int row,
    int32_t tile0, int W, int32_t pad, int32_t xdrop, int32_t ref_len,
    int32_t query_len, bool with_counts, const sa::State& st) {
  const int lane = threadIdx.x & 31;
  const int32_t lr = loc_r[row], lq = loc_q[row];
  sa::Carry c{st.cum[row], st.maxv[row], st.maxp[row], 0, 0};
  if (lane < 4) {
    c.count = st.counts[row * 4 + lane];
    c.cdel = st.cdel[row * 4 + lane];
  }
  const int64_t a = static_cast<int64_t>(ref_len) - lr;
  const int64_t b = static_cast<int64_t>(query_len) - lq;
  const int64_t lim = LEFT ? static_cast<int64_t>(lr < lq ? lr : lq) + 1
                           : (a < b ? a : b);
  for (int32_t tile = tile0;; tile = sa::wadd(tile, W)) {
    const int32_t off = LEFT ? sa::wsub(sa::wsub(0, tile), W) : tile;
    const int64_t sr = window_start(pad, lr, off, W, sq.n_ref);
    const int64_t sqs = window_start(pad, lq, off, W, sq.n_qry);
    const sa::SeqLoad<LEFT> load{sq.ref,
                                 sq.qry,
                                 sq.n_ref,
                                 sq.n_qry,
                                 sr & ~static_cast<int64_t>(15),
                                 sqs & ~static_cast<int64_t>(15),
                                 static_cast<int>(sr & 15),
                                 static_cast<int>(sqs & 15),
                                 W / 16};
    const sa::Offsets o0 = load(lane);
    if (sa::scan_carry<LEFT, true>(load, W, tab, xdrop,
                                   LEFT ? sa::wadd(tile, 1) : tile, lim, o0,
                                   c, with_counts)) {
      break;
    }
  }
  sa::store_state(st, row, c, true);
}

__global__ void __launch_bounds__(SEQ_WARPS * 32) window_scan_seq_kernel(
    Seqs sq, const int32_t* __restrict__ loc_r,
    const int32_t* __restrict__ loc_q, const int32_t* __restrict__ sub_g,
    int B, int32_t tile0, int W, int32_t pad, int32_t xdrop,
    int32_t ref_len, int32_t query_len, bool with_counts, sa::State right,
    sa::State left, int* scratch) {
  __shared__ sa::Tables tab;
  sa::load_tables(tab, sub_g);
  const int lane = threadIdx.x & 31;
  int* next = scratch;         // groups claimed
  int* scanned = scratch + 1;  // groups whose alive rows are taken or listed
  int* tail = scratch + 2;     // list entries written
  int* head = scratch + 3;     // list entries taken
  int* list = scratch + SCRATCH_HEAD;  // 2 row + left
  const int groups = 2 * ((B + GROUP - 1) / GROUP);
  const auto walk = [&](int item) {  // item: 2 row + left
    if (item & 1) {
      walk_row<true>(sq, loc_r, loc_q, tab, item >> 1, tile0, W, pad, xdrop,
                     ref_len, query_len, with_counts, left);
    } else {
      walk_row<false>(sq, loc_r, loc_q, tab, item >> 1, tile0, W, pad,
                      xdrop, ref_len, query_len, with_counts, right);
    }
  };
  for (;;) {  // the groups
    int g = 0;
    if (lane == 0) g = atomicAdd(next, 1);
    g = __shfl_sync(sa::FULL, g, 0);
    if (g >= groups) break;
    const int dir = g & 1;
    const bool* done = dir ? left.done : right.done;
    const int base = (g >> 1) * GROUP;
    unsigned alive[4];
    int n = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = base + 32 * j + lane;
      alive[j] = __ballot_sync(sa::FULL, row < B && !done[row]);
      n += __popc(alive[j]);
    }
    int mine = -1;
    if (n) {
      int j0 = 0;
      while (!alive[j0]) ++j0;
      mine = base + 32 * j0 + __ffs(alive[j0]) - 1;
      alive[j0] &= alive[j0] - 1;
      if (n > 1) {  // the others go on the list
        int slot = 0;
        if (lane == 0) slot = atomicAdd(tail, n - 1);
        slot = __shfl_sync(sa::FULL, slot, 0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if ((alive[j] >> lane) & 1u) {
            list[slot + __popc(alive[j] & ((1u << lane) - 1u))] =
                2 * (base + 32 * j + lane) + dir;
          }
          slot += __popc(alive[j]);
        }
        __threadfence();
      }
    }
    __syncwarp();
    if (lane == 0) atomicAdd(scanned, 1);
    if (mine >= 0) walk(2 * mine + dir);
  }
  // the listed rows, one at a time, once every group is scanned: each
  // group's entries are written and fenced before it counts as scanned,
  // so then the list is whole (the warps that scan do not wait on
  // anything, so this wait ends)
  int listed = 0;
  if (lane == 0) {
    while (atomicAdd(scanned, 0) < groups) __nanosleep(128);
    __threadfence();
    listed = atomicAdd(tail, 0);
  }
  listed = __shfl_sync(sa::FULL, listed, 0);
  for (;;) {
    int item = 0;
    if (lane == 0) {
      const int i = atomicAdd(head, 1);
      item = i < listed ? __ldcg(list + i) : -1;
    }
    item = __shfl_sync(sa::FULL, item, 0);
    if (item < 0) return;
    walk(item);
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

// scratch: 4 + 2 B int32 of the launch's own; its four counters are zeroed
// here on `stream`.
extern "C" cudaError_t sa_window_scan_seq(
    const void* ref_pad, int64_t n_ref, const void* query_pad,
    int64_t n_query, const void* loc_r, const void* loc_q, const void* sub,
    int B, int tile, int W, int pad, int xdrop, int ref_len, int query_len,
    int with_counts, void* r_done, void* r_cum, void* r_maxv, void* r_maxp,
    void* r_counts, void* r_cdel, void* l_done, void* l_cum, void* l_maxv,
    void* l_maxp, void* l_counts, void* l_cdel, void* scratch,
    void* stream) {
  if (B == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, SCRATCH_HEAD * sizeof(int), s);
  if (err != cudaSuccess) return err;
  // the blocks the card holds at once (the same on every card of a
  // machine)
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, window_scan_seq_kernel, SEQ_WARPS * 32, 0);
    }
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  // a warp for every row of both directions at most
  const int64_t want = (2 * static_cast<int64_t>(B) + SEQ_WARPS - 1) /
                       SEQ_WARPS;
  const int grid = static_cast<int>(want < resident ? want : resident);
  window_scan_seq_kernel<<<grid, SEQ_WARPS * 32, 0, s>>>(
      Seqs{static_cast<const uint8_t*>(ref_pad),
           static_cast<const uint8_t*>(query_pad), n_ref, n_query},
      static_cast<const int32_t*>(loc_r), static_cast<const int32_t*>(loc_q),
      static_cast<const int32_t*>(sub), B, tile, W, pad, xdrop, ref_len,
      query_len, with_counts != 0,
      state_of(r_done, r_cum, r_maxv, r_maxp, r_counts, r_cdel),
      state_of(l_done, l_cum, l_maxv, l_maxp, l_counts, l_cdel),
      static_cast<int*>(scratch));
  return cudaGetLastError();
}
