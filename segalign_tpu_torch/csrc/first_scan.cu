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
// Second entry point, sa_first_scan_seq: the same function on the windows
// of the padded sequences, with no gathered rows between. It computes
// first_scan(gather_rows(ref_pad, pad + loc_r - W, 2W),
// gather_rows(query_pad, pad + loc_q - W, 2W), ...): the same clamp of
// the window's start, the same state. The gathers' two (B, 2W) byte
// arrays (256 MiB at B = 2^17, W = 512) never exist, and neither do their
// writes and reads. Bound on the H100: the function must read the
// sequence bytes the valid rows' windows cover, once each however many
// windows share them, 9 bytes of anchors and flag a row, and write 90 of
// state; a chunk's anchors cluster (on the query by construction, on the
// reference in its repeats), so at the main path's shape that is some 16
// MB, and the bound is the scans' operations (0.8e9 at W = 512, 0.012 ms;
// chip_smoke.py counts both from its inputs). What the kernel must hide is
// latency: each row's window addresses come from its anchors, and its
// scan from its windows. Design: one warp a row, both directions.
// scan_window needs 16-byte aligned rows (scan.cuh), and a window starts
// anywhere, so the warp copies the row's 2W bytes of r and of q into
// 2W + 16 bytes of shared memory each: the aligned 16-byte blocks that
// cover the window, as uint4 loads (byte loads for a block past the
// sequence's end), all of a batch of six a thread issued before any is
// stored, then a shift of each copy by the window's offset within its
// first block, in place (each thread reads five words and funnel-shifts
// them into one block; the warp syncs between the reads and the writes).
// Then scan_window runs on the copies unchanged, reading shared memory:
// the left window is the copy's first W bytes, the right one the next W.
// A row that is not valid reads nothing. 2 x (2W + 16) bytes a warp,
// 16.6 KB a block at W = 512.
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

// The aligned 16-byte block at off (a multiple of 16) of seq, n bytes
// long: one uint4 load, or byte loads where it passes the end (0 past it).
__device__ __forceinline__ uint4 load_block(const uint8_t* __restrict__ seq,
                                            int64_t n, int64_t off) {
  if (off + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(seq + off));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (off + i < n) {
      w[i >> 2] |= static_cast<uint32_t>(seq[off + i]) << (8 * (i & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Shift a copy left by mis bytes, in place: block j of the result is bytes
// [16 j + mis, 16 j + mis + 16) of the copy, words 4 j + mis / 4 .. + 4
// funnel-shifted right by mis % 4 bytes. nblk blocks; the copy holds one
// more. By one warp, every read of a round before any write (a block's
// words are read by the thread of the block before it too).
__device__ __forceinline__ void shift_copy(uint8_t* buf, int mis, int nblk) {
  if (mis == 0) return;  // the same over the warp
  const int lane = threadIdx.x & 31;
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(buf);
  const int ws = mis >> 2, sh = 8 * (mis & 3);
  for (int base = 0; base < nblk; base += 32) {
    const int j = base + lane;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (j < nblk) {
      const uint32_t* w = w32 + 4 * j + ws;
      const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
      v = make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                     __funnelshift_r(w2, w3, sh),
                     __funnelshift_r(w3, w4, sh));
    }
    __syncwarp();
    if (j < nblk) reinterpret_cast<uint4*>(buf)[j] = v;
    __syncwarp();
  }
}

// Bytes [s_r, s_r + L) of r_seq into rbuf and [s_q, s_q + L) of q_seq into
// qbuf (L + 16 bytes of shared memory each, 16-byte aligned; L a multiple
// of 16; the sequences 16-byte aligned; each span inside its sequence), by
// one warp.
__device__ __forceinline__ void copy_windows(
    const uint8_t* __restrict__ r_seq, int64_t n_r, int64_t s_r,
    const uint8_t* __restrict__ q_seq, int64_t n_q, int64_t s_q, int L,
    uint8_t* rbuf, uint8_t* qbuf) {
  constexpr int kSlots = 3;  // blocks a thread loads an array a batch
  const int lane = threadIdx.x & 31;
  const int nblk = L / 16;
  const int64_t a_r = s_r & ~static_cast<int64_t>(15);
  const int64_t a_q = s_q & ~static_cast<int64_t>(15);
  uint4* r4 = reinterpret_cast<uint4*>(rbuf);
  uint4* q4 = reinterpret_cast<uint4*>(qbuf);
  // the nblk + 1 aligned blocks from a_r and from a_q
  for (int base = 0; base <= nblk; base += 32 * kSlots) {
    uint4 vr[kSlots], vq[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int k = base + 32 * i + lane;
      if (k <= nblk) {
        vr[i] = load_block(r_seq, n_r, a_r + 16 * static_cast<int64_t>(k));
        vq[i] = load_block(q_seq, n_q, a_q + 16 * static_cast<int64_t>(k));
      }
    }
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int k = base + 32 * i + lane;
      if (k <= nblk) {
        r4[k] = vr[i];
        q4[k] = vq[i];
      }
    }
  }
  __syncwarp();
  shift_copy(rbuf, static_cast<int>(s_r & 15), nblk);
  shift_copy(qbuf, static_cast<int>(s_q & 15), nblk);
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

// The fresh state of a row that is not valid: done, maxp -1 (right) or 0
// (left), the rest 0.
__device__ __forceinline__ void write_invalid(const sa::State& out, int row,
                                              int32_t init_maxp) {
  const int lane = threadIdx.x & 31;
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
}

__global__ void __launch_bounds__(sa::WARPS_PER_BLOCK * 32)
    first_scan_seq_kernel(const uint8_t* __restrict__ ref_pad, int64_t n_ref,
                          const uint8_t* __restrict__ query_pad,
                          int64_t n_query,
                          const int32_t* __restrict__ loc_r,
                          const int32_t* __restrict__ loc_q,
                          const bool* __restrict__ valid,
                          const int32_t* __restrict__ sub_g, int B, int W,
                          int32_t pad, int32_t xdrop, int32_t ref_len,
                          int32_t query_len, bool with_counts,
                          sa::State right, sa::State left) {
  __shared__ sa::Tables tab;
  __shared__ int32_t zero4[4];
  extern __shared__ __align__(16) uint8_t windows[];
  if (threadIdx.x < 4) zero4[threadIdx.x] = 0;
  sa::load_tables(tab, sub_g);
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * sa::WARPS_PER_BLOCK + warp;
  if (row >= B) return;
  if (!valid[row]) {
    write_invalid(right, row, -1);
    write_invalid(left, row, 0);
    return;
  }
  const int32_t lr = loc_r[row], lq = loc_q[row];
  uint8_t* rbuf = windows + static_cast<size_t>(warp) * 2 * (2 * W + 16);
  uint8_t* qbuf = rbuf + 2 * W + 16;
  copy_windows(ref_pad, n_ref, window_start(pad, lr, W, n_ref), query_pad,
               n_query, window_start(pad, lq, W, n_query), 2 * W, rbuf,
               qbuf);
  __syncwarp();
  // left: the copies' first W bytes, lane W - p holding extension offset p
  const sa::Offsets ol = sa::first_chunk<true, true>(rbuf, qbuf, W);
  sa::scan_window<true, true>(rbuf, qbuf, W, tab, xdrop, 1,
                              (lr < lq ? lr : lq) + static_cast<int64_t>(1),
                              ol, 0, 0, 0, zero4, zero4, with_counts, left,
                              row);
  // right: the next W bytes
  const sa::Offsets orr =
      sa::first_chunk<false, true>(rbuf + W, qbuf + W, W);
  const int64_t a = static_cast<int64_t>(ref_len) - lr;
  const int64_t b = static_cast<int64_t>(query_len) - lq;
  sa::scan_window<false, true>(rbuf + W, qbuf + W, W, tab, xdrop, 0,
                               a < b ? a : b, orr, 0, 0, -1, zero4, zero4,
                               with_counts, right, row);
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
  const size_t smem =
      static_cast<size_t>(sa::WARPS_PER_BLOCK) * 2 * (2 * W + 16);
  if (smem > 48 * 1024) {  // above the default, as dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        first_scan_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = (B + sa::WARPS_PER_BLOCK - 1) / sa::WARPS_PER_BLOCK;
  first_scan_seq_kernel<<<grid, sa::WARPS_PER_BLOCK * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ref_pad), n_ref,
      static_cast<const uint8_t*>(query_pad), n_query,
      static_cast<const int32_t*>(loc_r), static_cast<const int32_t*>(loc_q),
      static_cast<const bool*>(valid), static_cast<const int32_t*>(sub), B, W,
      pad, xdrop, ref_len, query_len, with_counts != 0, right, left);
  return cudaGetLastError();
}
