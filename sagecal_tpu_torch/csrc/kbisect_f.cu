// kbisect probe #10 for NVIDIA Hopper (sm_90a): a component-major
// indexed selection and a component-pair reduction, hand-written CUDA
// with a plain C interface (loaded with ctypes by
// sagecal_tpu_torch/kernels/build.py).
//
// Replaces the Pallas kernel of kbisect.py's variant_f (:158, pallas_call
// :176): reshape-free gains, component-major tables, one dot per
// component.
//
// What it computes, for antp (1, T) int32 and tab (4, mp, npad) f32, with
// a = antp[t]:
//   out[t] = sum_m tab[0,m,a] tab[1,m,a] + tab[2,m,a] tab[3,m,a]   -> (1, T)
// and out[t] = 0 when a is outside [0, npad): the one-hot column of such
// an index is all zero, so the Pallas kernel selects nothing.
//
// Design.  The one-hot products existed for the TPU's matrix unit; here
// one thread per t gathers its four components by index, with a bounds
// check, and sums over clusters in order.  No atomics: a repeat is
// bit-identical.
//
// Bound on the H100 (67 TFLOP/s f32, 3.35 TB/s HBM): operations.  At
// mp 104 and T 113,664: 4 * 104 * T = 47 MFLOP (0.7 us) over 1.1 MB.  A
// few microseconds of gathers from a 213 KB table: launch latency
// dominates.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
kbisect_f_kernel(const int* __restrict__ antp, const float* __restrict__ tab,
                 int mp, int npad, int T, float* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const int a = __ldg(antp + t);
  float s = 0.f;
  if (a >= 0 && a < npad) {
    const size_t plane = (size_t)mp * npad;  // one component
    const float* col = tab + a;
    for (int m = 0; m < mp; ++m) {
      const float* p = col + (size_t)m * npad;
      s += __ldg(p) * __ldg(p + plane) +
           __ldg(p + 2 * plane) * __ldg(p + 3 * plane);
    }
  }
  out[t] = s;
}

}  // namespace

extern "C" {

// antp (T,) int32, tab (4, mp, npad) f32 -> out (T,) f32.  Returns
// cudaGetLastError().
int kbisect_f(const int* antp, const float* tab, int mp, int npad, int T,
              float* out, void* stream) {
  if (mp < 1 || npad < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kThreads - 1) / kThreads);
  kbisect_f_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      antp, tab, mp, npad, T, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
