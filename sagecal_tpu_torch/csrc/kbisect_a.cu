// kbisect probe #9 for NVIDIA Hopper (sm_90a): an indexed selection of
// gain-table columns summed over clusters and over the grid's revisits,
// hand-written CUDA with a plain C interface (loaded with ctypes by
// sagecal_tpu_torch/kernels/build.py).
//
// Replaces the Pallas kernel of kbisect.py's variant_a (:77, pallas_call
// :101): int32 input + in-kernel iota one-hot + dot + output revisit
// accumulation across the grid.
//
// What it computes, for antp (1, R*T) int32 and tab (4*mp, npad) f32:
//   out[0, k, t] = sum_{r < R} sum_m tab[4m + k, antp[r*T + t]]  -> (1, 4, T)
// where a station index outside [0, npad) selects nothing (adds 0), as
// the one-hot column of such an index is all zero.
//
// Design.  The one-hot product existed for the TPU's matrix unit; here
// each index is a bounds-checked gather.  The TPU grid revisits one
// output block for r = 0, 1, ... in order; Hopper blocks run in no
// order, so the sum over r is a second pass: kernel 1 has one thread per
// (r, t) that sums its four components over clusters in order into a
// per-r partial (R, 4, T); kernel 2 has one thread per (k, t) that sums
// the partials over r = 0, 1, ... in order, the grid's order.  No
// atomics: a repeat is bit-identical.
//
// Bound on the H100 (67 TFLOP/s f32, 3.35 TB/s HBM): operations.  At
// mp 104, R 444, T 256: 4 * 104 * 113,664 = 47 MFLOP (0.7 us) over
// 0.67 MB.  Two launches and a few microseconds of gathers from a
// 213 KB table: launch latency dominates.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
kbisect_a_partial_kernel(const int* __restrict__ antp,
                         const float* __restrict__ tab, int mp, int npad,
                         int R, int T, float* __restrict__ partial) {
  const int i = blockIdx.x * kThreads + threadIdx.x;  // r*T + t
  if (i >= R * T) return;
  const int r = i / T, t = i - r * T;
  const int a = __ldg(antp + i);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  if (a >= 0 && a < npad) {
    const float* col = tab + a;
    for (int m = 0; m < mp; ++m) {
      const float* p = col + (size_t)4 * m * npad;
      s0 += __ldg(p);
      s1 += __ldg(p + npad);
      s2 += __ldg(p + 2 * (size_t)npad);
      s3 += __ldg(p + 3 * (size_t)npad);
    }
  }
  float* q = partial + (size_t)r * 4 * T + t;
  q[0] = s0;
  q[(size_t)T] = s1;
  q[2 * (size_t)T] = s2;
  q[3 * (size_t)T] = s3;
}

__global__ void __launch_bounds__(kThreads)
kbisect_a_sum_kernel(const float* __restrict__ partial, int R, int T,
                     float* __restrict__ out) {
  const int e = blockIdx.x * kThreads + threadIdx.x;  // k*T + t
  if (e >= 4 * T) return;
  const size_t stride = (size_t)4 * T;  // one r
  float s = __ldg(partial + e);
#pragma unroll 8
  for (int r = 1; r < R; ++r) s += __ldg(partial + (size_t)r * stride + e);
  out[e] = s;
}

}  // namespace

extern "C" {

// antp (R*T,) int32, tab (4*mp, npad) f32, partial (R, 4, T) f32 scratch
// -> out (4, T) f32.  Returns the first non-zero cudaGetLastError().
int kbisect_a(const int* antp, const float* tab, int mp, int npad, int R,
              int T, float* partial, float* out, void* stream) {
  if (mp < 1 || npad < 1 || R < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid1((R * T + kThreads - 1) / kThreads);
  kbisect_a_partial_kernel<<<grid1, kThreads, 0, st>>>(antp, tab, mp, npad, R,
                                                       T, partial);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid2((4 * T + kThreads - 1) / kThreads);
  kbisect_a_sum_kernel<<<grid2, kThreads, 0, st>>>(partial, R, T, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
