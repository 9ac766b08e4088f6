// kbisect probe #7 for NVIDIA Hopper (sm_90a): a dense product and a
// component-pair reduction, hand-written CUDA with a plain C interface
// (loaded with ctypes by sagecal_tpu_torch/kernels/build.py).
//
// Replaces the Pallas kernel of kbisect.py's variant_c (:23, pallas_call
// :37): no grid, one block, MXU dot + sublane reshape-slice + reduce.
//
// What it computes, for tab (4*mp, npad) f32 and oh (npad, T) f32:
//   g      = tab @ oh                                   (4*mp, T)
//   out[t] = sum_m g[4m,t] g[4m+1,t] + g[4m+2,t] g[4m+3,t]   -> (1, T)
// The product is the probe's own body: no cuBLAS, no tensor cores, no
// TF32 (Hopper's f32 wgmma is TF32).  Exact-f32 FFMA loops, so the
// reference is the interpret-mode output of the JAX probe.
//
// Design.  One thread per column t, kThreads columns per block.  The
// block's oh columns (npad x kThreads) are staged once in shared memory,
// so oh is read from device memory exactly once; tab is staged kRows
// rows (kRows / 4 clusters) at a time, because at mp 104 the whole tab
// is 213 KB, above what a block may hold beside the oh tile.  Each
// thread accumulates its column of the kRows rows of g in registers
// (FFMA over n in order, four n per step from one float4 broadcast load
// of each tab row), then folds the chunk's clusters into its running sum
// in cluster order.  Rows and n are zero-padded in shared memory to a
// multiple of 4, so padded clusters add exactly 0.  No atomics: a repeat
// is bit-identical.
//
// Bound on the H100 (67 TFLOP/s f32 non-tensor, 3.35 TB/s HBM):
// operations.  At mp 104, T 113,664: 2 * 416 * 128 * T = 12.1 GFLOP
// (0.181 ms) over 58.9 MB (0.018 ms).  The inner loop issues one shared
// load per 4 FFMA per row, so shared-memory issue, not the FFMA rate,
// is the first limit of this simple design.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // columns per block
constexpr int kRows = 32;      // tab rows staged per step (8 clusters)

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

size_t smem_bytes(int npad) {
  return sizeof(float) * (size_t)pad4(npad) * (kThreads + kRows);
}

__global__ void __launch_bounds__(kThreads)
kbisect_c_kernel(const float* __restrict__ tab, const float* __restrict__ oh,
                 int mp, int npad, int T, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int ld = pad4(npad);
  float* oh_s = reinterpret_cast<float*>(smem4);  // [n][column], ld rows
  float* tab_s = oh_s + (size_t)ld * kThreads;    // [row][n], kRows rows
  const int tid = threadIdx.x;
  const int t = blockIdx.x * kThreads + tid;
  const bool live = t < T;

  for (int n = 0; n < ld; ++n)
    oh_s[n * kThreads + tid] =
        (live && n < npad) ? __ldg(oh + (size_t)n * T + t) : 0.f;

  const int rows = 4 * mp;
  float s = 0.f;
  for (int r0 = 0; r0 < rows; r0 += kRows) {
    __syncthreads();  // the previous chunk is consumed; oh_s is written
    for (int i = tid; i < kRows * ld; i += kThreads) {
      const int j = i / ld, n = i - j * ld;
      tab_s[i] = (r0 + j < rows && n < npad)
                     ? __ldg(tab + (size_t)(r0 + j) * npad + n) : 0.f;
    }
    __syncthreads();

    float g[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) g[j] = 0.f;
    for (int n = 0; n < ld; n += 4) {
      const float o0 = oh_s[(n + 0) * kThreads + tid];
      const float o1 = oh_s[(n + 1) * kThreads + tid];
      const float o2 = oh_s[(n + 2) * kThreads + tid];
      const float o3 = oh_s[(n + 3) * kThreads + tid];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float4 w = *reinterpret_cast<const float4*>(tab_s + j * ld + n);
        g[j] = fmaf(w.x, o0, g[j]);
        g[j] = fmaf(w.y, o1, g[j]);
        g[j] = fmaf(w.z, o2, g[j]);
        g[j] = fmaf(w.w, o3, g[j]);
      }
    }
#pragma unroll
    for (int c = 0; c < kRows / 4; ++c)
      s += g[4 * c] * g[4 * c + 1] + g[4 * c + 2] * g[4 * c + 3];
  }
  if (live) out[t] = s;
}

}  // namespace

extern "C" {

// tab (4*mp, npad) f32, oh (npad, T) f32 -> out (T,) f32.  Returns the
// first non-zero CUDA error (cudaErrorInvalidValue for a shape the
// launch cannot take, e.g. an npad whose staging passes the shared-memory
// limit).
int kbisect_c(const float* tab, const float* oh, int mp, int npad, int T,
              float* out, void* stream) {
  if (mp < 1 || npad < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(npad);
  const int err = (int)cudaFuncSetAttribute(
      kbisect_c_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  const dim3 grid((T + kThreads - 1) / kThreads);
  kbisect_c_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tab, oh, mp, npad, T, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
