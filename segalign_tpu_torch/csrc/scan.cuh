// One x-drop window of one extension direction for one row, walked lane by
// lane by one thread. Shared by first_scan.cu (K1), window_scan.cu (K4) and
// window_scan_wide.cu (K5).
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
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sa {

constexpr int32_t NEG = -2147483647;  // -(2^31) + 1

// The six arrays of the extension state of one direction.
struct State {
  bool* done;
  int32_t* cum;
  int32_t* maxv;
  int32_t* maxp;
  int32_t* counts;  // (B, 4)
  int32_t* cdel;    // (B, 4)
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ uint32_t byte_of(const uint4& v, int j) {
  const uint32_t w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j & 3))) & 0xffu;
}

// Scan one window and write the row's new state.
//   r, q   : the window's W bytes in ascending storage order, 16-byte
//            aligned, W a multiple of 16.
//   LEFT   : scan order is descending storage order (left extension).
//   p0     : extension offset of the first scanned lane; lane k has p0 + k.
//   lim    : lanes with extension offset < lim are in bounds. They are a
//            prefix of the scan order, since p rises along it.
//   sub    : the 64-entry substitution table (shared memory).
//   cum0.. : the carried state of an alive row; counts0/cdel0 point at 4
//            ints each.
template <bool LEFT>
__device__ void scan_window(const uint8_t* __restrict__ r,
                            const uint8_t* __restrict__ q, int W,
                            const int32_t* __restrict__ sub, int32_t xdrop,
                            int32_t p0, int64_t lim, int32_t cum0,
                            int32_t maxv0, int32_t maxp0,
                            const int32_t* counts0, const int32_t* cdel0,
                            bool with_counts, const State& out, int row) {
  const uint4* r4 = reinterpret_cast<const uint4*>(r);
  const uint4* q4 = reinterpret_cast<const uint4*>(q);
  const int nch = W / 16;
  const int64_t n_inb64 = lim - p0;
  const int n_inb =
      n_inb64 < 0 ? 0 : (n_inb64 > W ? W : static_cast<int>(n_inb64));
  // Lanes past the last in-bounds one score 0: cum and the running max stay
  // put, so they can neither drop nor set a new best. Scanning stops after
  // the chunk holding lane max(n_inb, 1) - 1 (lane 0 is always checked: a
  // carried state may already sit more than xdrop below its max).
  const int kend = n_inb > 0 ? n_inb : 1;

  int32_t c = cum0, m = maxv0, best = NEG;
  int bestk = -1, dk = W;
  for (int ci = 0; ci * 16 < kend; ++ci) {
    const int src = LEFT ? nch - 1 - ci : ci;
    const uint4 rv = __ldg(r4 + src);
    const uint4 qv = __ldg(q4 + src);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = LEFT ? 15 - jj : jj;
      const int k = ci * 16 + jj;
      const uint32_t rb = byte_of(rv, j), qb = byte_of(qv, j);
      const int32_t s = k < n_inb ? sub[(rb * 8 + qb) & 63] : 0;
      c = wadd(c, s);
      if (dk == W) {
        m = c > m ? c : m;
        if (wsub(m, c) > xdrop) {
          dk = k;
        } else if (c > best) {
          best = c;
          bestk = k;
        }
      }
    }
  }

  const int32_t Mv = best > maxv0 ? best : maxv0;
  const bool is_new = Mv > maxv0;
  const int32_t Mp = is_new ? p0 + bestk : maxp0;
  const bool finish = dk < W || n_inb64 < W;

  out.done[row] = finish;
  out.cum[row] = c;
  out.maxv[row] = Mv;
  out.maxp[row] = Mp;
  if (!with_counts) {
    for (int b = 0; b < 4; ++b) {
      out.counts[row * 4 + b] = counts0[b];
      out.cdel[row * 4 + b] = cdel0[b];
    }
    return;
  }
  // Matches (equal codes < 4) inside the extent (p <= Mp) and outside it,
  // over every in-bounds lane, four 16-bit fields per accumulator (W is at
  // most 4096, so no field overflows).
  const int64_t kin = static_cast<int64_t>(Mp) - p0;
  uint64_t ain = 0, aout = 0;
  for (int ci = 0; ci * 16 < n_inb; ++ci) {
    const int src = LEFT ? nch - 1 - ci : ci;
    const uint4 rv = __ldg(r4 + src);
    const uint4 qv = __ldg(q4 + src);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = LEFT ? 15 - jj : jj;
      const int k = ci * 16 + jj;
      const uint32_t rb = byte_of(rv, j), qb = byte_of(qv, j);
      if (k < n_inb && rb == qb && rb < 4) {
        const uint64_t one = 1ull << (16 * rb);
        if (k <= kin) {
          ain += one;
        } else {
          aout += one;
        }
      }
    }
  }
  const bool new_max = Mp > maxp0;
  for (int b = 0; b < 4; ++b) {
    const int32_t cin = new_max ? wadd(counts0[b], cdel0[b]) : counts0[b];
    const int32_t cout = new_max ? 0 : cdel0[b];
    out.counts[row * 4 + b] =
        wadd(cin, static_cast<int32_t>((ain >> (16 * b)) & 0xffffu));
    out.cdel[row * 4 + b] =
        wadd(cout, static_cast<int32_t>((aout >> (16 * b)) & 0xffffu));
  }
}

// Copy the substitution table into shared memory (64 int32).
__device__ __forceinline__ void load_sub(int32_t* dst, const int32_t* src) {
  for (int i = threadIdx.x; i < 64; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

// One window of each row from its carried state (K4, K5). RAW: the window
// is in ascending storage order and a left one is walked from its last
// byte (K4); otherwise both directions are in extension order (K5). Either
// way the first lane walked is extension offset tile (right) or tile + 1
// (left). Rows done on entry pass through unchanged.
template <bool RAW>
__global__ void carried_scan_kernel(
    const uint8_t* __restrict__ r, const uint8_t* __restrict__ q,
    const int32_t* __restrict__ loc_r, const int32_t* __restrict__ loc_q,
    const int32_t* __restrict__ cum, const int32_t* __restrict__ maxv,
    const int32_t* __restrict__ maxp, const bool* __restrict__ done,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ cdel,
    const int32_t* __restrict__ sub_g, int B, int W, int32_t xdrop,
    int32_t tile, int32_t ref_len, int32_t query_len, bool left,
    bool with_counts, State out) {
  __shared__ int32_t sub[64];
  load_sub(sub, sub_g);
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  if (done[row]) {
    out.done[row] = true;
    out.cum[row] = cum[row];
    out.maxv[row] = maxv[row];
    out.maxp[row] = maxp[row];
    for (int b = 0; b < 4; ++b) {
      out.counts[row * 4 + b] = counts[row * 4 + b];
      out.cdel[row * 4 + b] = cdel[row * 4 + b];
    }
    return;
  }
  const int64_t lr = loc_r[row], lq = loc_q[row];
  const size_t base = static_cast<size_t>(row) * W;
  if (left) {
    const int64_t lim = (lr < lq ? lr : lq) + 1;
    scan_window<RAW>(r + base, q + base, W, sub, xdrop, tile + 1, lim,
                     cum[row], maxv[row], maxp[row], counts + row * 4,
                     cdel + row * 4, with_counts, out, row);
  } else {
    const int64_t a = ref_len - lr, b = query_len - lq;
    scan_window<false>(r + base, q + base, W, sub, xdrop, tile,
                       a < b ? a : b, cum[row], maxv[row], maxp[row],
                       counts + row * 4, cdel + row * 4, with_counts, out,
                       row);
  }
}

// The launcher body of K4 and K5: 128 rows per block.
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
  const int threads = 128;
  carried_scan_kernel<RAW><<<(B + threads - 1) / threads, threads, 0,
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
