// S3 and S4: the launch-cost probe's kernel, out = 2 * x in float32.
//
// Replaces the one-block `x * 2` Pallas kernels of scripts/probe_env.py
// (probe_pallas) and scripts/probe_extension.py (probe_overhead's ptiny).
// The probes time a launch, so the kernel is the least that does the work:
// one thread per element. Bound on the H100: by bytes 0.0003 ms at
// (256, 512) floats (1.0 MB read and written, at 3.35 TB/s) and less at
// (8, 128), so what a call costs is the launch itself, a few microseconds
// of host and device time, reached the way K1-K5 are, through the ctypes
// launcher.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void scale2_kernel(const float* __restrict__ x, int64_t n,
                              float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < n) out[i] = x[i] * 2.0f;
}

}  // namespace

extern "C" cudaError_t sa_scale2(const void* x, int64_t n, void* out,
                                 void* stream) {
  if (n == 0) return cudaSuccess;
  scale2_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<float*>(out));
  return cudaGetLastError();
}
