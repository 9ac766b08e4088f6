// kbisect probe #8 for NVIDIA Hopper (sm_90a): a per-component sum of
// squares over clusters, hand-written CUDA with a plain C interface
// (loaded with ctypes by sagecal_tpu_torch/kernels/build.py).
//
// Replaces the Pallas kernel of kbisect.py's variant_b (:49, pallas_call
// :63): grid over rows, 4D coherency block + middle-index slicing +
// reduce.
//
// What it computes, for coh (mp, 1, 8, rows) f32:
//   out[0, k, r] = sum_m coh[m, 0, k, r]^2                  -> (1, 8, rows)
// The Pallas kernel stores a (1, 8, T) block into an (F, 8, T) output, so
// it is defined for F = 1 only; the wrapper refuses any other F.
//
// Design.  One thread per (k, row), kThreads rows per block, grid y the
// component k; each thread loops over clusters in order (FFMA), reading
// coh coalesced along rows.  No atomics: a repeat is bit-identical.
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s f32): bytes.  At mp 104
// and 113,664 rows: 378.2 MB of coherencies read once and 3.6 MB written
// (0.114 ms) against 0.19 GFLOP.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // rows per block

__global__ void __launch_bounds__(kThreads)
kbisect_b_kernel(const float* __restrict__ coh, int mp, int rows,
                 float* __restrict__ out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int k = blockIdx.y;
  if (r >= rows) return;
  const float* p = coh + (size_t)k * rows + r;
  const size_t stride = (size_t)8 * rows;  // one cluster
  float s = 0.f;
#pragma unroll 8
  for (int m = 0; m < mp; ++m) {
    const float x = __ldg(p + (size_t)m * stride);
    s = fmaf(x, x, s);
  }
  out[(size_t)k * rows + r] = s;
}

}  // namespace

extern "C" {

// coh (mp, 1, 8, rows) f32 -> out (1, 8, rows) f32.  Returns
// cudaGetLastError().
int kbisect_b(const float* coh, int mp, int rows, float* out, void* stream) {
  if (mp < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((rows + kThreads - 1) / kThreads, 8);
  kbisect_b_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coh, mp, rows, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
