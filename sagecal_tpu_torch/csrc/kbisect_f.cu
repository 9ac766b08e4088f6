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
// Design.  out[t] depends on t only through its station a, so the table
// is reduced per station first and gathered second:
//   1. reduce: P[s] = sum_m tab0 tab1 + tab2 tab3 for every s < npad.  A
//      block takes kSlice consecutive stations: each thread loads the four
//      components of kPer (m, s) cells (coalesced, all in flight at once)
//      and stages their products tab0 tab1 + tab2 tab3 in shared memory;
//      then one thread a station adds them over m in order.  The product
//      and the order are those of the per-column loop of the first CUDA
//      port, so each column keeps that kernel's bits;
//   2. gather: out[t] = P[antp[t]], or 0 out of range: a coalesced read
//      of antp, a read of P (npad words, held on chip), a coalesced
//      write; launched as a programmatic dependent of the reduction
//      (dependent_launch.cuh), it reads antp while the reduction runs.
// P is a global table of npad words that the wrapper allocates, so no
// shared-memory size caps npad.  The one-launch form (stages 4) fuses the
// two: every block reduces the whole table into its own shared memory,
// straight from L2, then gathers its columns.  It saves a launch but
// reads the table once a block, so it is the default only where the
// columns take few blocks (kbisect's own shape: one block); it takes
// npad <= kOneLaunchMaxNpad.  No atomics, every sum in a fixed order: a
// repeat is bit-identical.
//
// Bound on the H100 (3.35 TB/s HBM): bytes.  The function's least work
// reads each input once and writes the output once: 1.12 MB at mp 104,
// npad 128, T 113,664, 0.34 us; its 53,248 table flops and 113,664
// gathered words take less.  A launch on the device costs more than that
// whole bound, so the time is launch latency plus the latency of the
// reduction's chain over m.

#include <cuda_runtime.h>

#include "dependent_launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 16;                          // stations a reduce block
constexpr int kChunk = 128;                         // clusters staged at once
constexpr int kPer = kChunk * kSlice / kThreads;  // (m, s) a thread: 8
// the one-launch form: P in at most 48 KB of shared memory, and the
// default where at most kOneLaunchMaxBlocks blocks, each of which reduces
// the whole table, share the gather and the table is small (at mp 8 one
// launch won, at mp 104 two did on the H100; PERF.md)
constexpr int kOneLaunchMaxNpad = 48 * 1024 / 4;
constexpr int kOneLaunchMaxBlocks = 16;
constexpr int kOneLaunchMaxWords = 16384;  // the table a block reduces: 64 KB

int col_blocks(int T) { return (T + kThreads - 1) / kThreads; }

__global__ void __launch_bounds__(kThreads)
kbisect_f_reduce_kernel(const float* __restrict__ tab, int mp, int npad,
                        float* __restrict__ P) {
  __shared__ float prod[kChunk * kSlice];  // [i][j], 8 KB
  launch_dependents();
  const size_t plane = (size_t)mp * npad;  // one component
  const int s0 = blockIdx.x * kSlice;
  const int j = threadIdx.x;  // the summing threads' station in the slice
  float acc = 0.f;
  for (int m0 = 0; m0 < mp; m0 += kChunk) {
    const int nm = min(kChunk, mp - m0);
    float v[kPer][4];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = q * kThreads + threadIdx.x;
      const int i = e / kSlice, s = s0 + e % kSlice;
      const bool in = i < nm && s < npad;
      const float* p = tab + (size_t)(m0 + i) * npad + s;
#pragma unroll
      for (int c = 0; c < 4; ++c) v[q][c] = in ? __ldg(p + c * plane) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      prod[q * kThreads + threadIdx.x] =
          v[q][0] * v[q][1] + v[q][2] * v[q][3];
    __syncthreads();
    if (j < kSlice) {
#pragma unroll 8
      for (int i = 0; i < nm; ++i) acc += prod[i * kSlice + j];
    }
    __syncthreads();
  }
  if (j < kSlice && s0 + j < npad) P[s0 + j] = acc;
}

// One thread a column, reading P from global memory (kOneLaunch false)
// or reducing it first into the block's shared memory (true).
template <bool kOneLaunch>
__global__ void __launch_bounds__(kThreads)
kbisect_f_gather_kernel(const int* __restrict__ antp,
                        const float* __restrict__ tab, int mp, int npad,
                        int T, const float* __restrict__ P,
                        float* __restrict__ out) {
  extern __shared__ float own[];  // one-launch form: P, npad words
  const int t = blockIdx.x * kThreads + threadIdx.x;
  // the column's station, loaded before the reduction (or the wait for
  // it) so that the two latencies overlap
  const int a = t < T ? __ldg(antp + t) : -1;
  if (kOneLaunch) {
    const size_t plane = (size_t)mp * npad;  // one component
    for (int s = threadIdx.x; s < npad; s += kThreads) {
      float acc = 0.f;
#pragma unroll 16
      for (int m = 0; m < mp; ++m) {
        const float* p = tab + (size_t)m * npad + s;
        acc += __ldg(p) * __ldg(p + plane) +
               __ldg(p + 2 * plane) * __ldg(p + 3 * plane);
      }
      own[s] = acc;
    }
    __syncthreads();
  } else {
    wait_for_prerequisites();  // P is the reduction's
  }
  const float* sums = kOneLaunch ? own : P;
  if (t < T) out[t] = (a >= 0 && a < npad) ? sums[a] : 0.f;
}

}  // namespace

extern "C" {

int kbisect_f_one_launch_max_npad() { return kOneLaunchMaxNpad; }

// The faster form for this shape, as measured on the H100 (PERF.md): one
// launch (4) where few blocks each reduce a small table, else two (3).
int kbisect_f_default_stages(int mp, int npad, int T) {
  return npad <= kOneLaunchMaxNpad && col_blocks(T) <= kOneLaunchMaxBlocks &&
                 4 * (long long)mp * npad <= kOneLaunchMaxWords
             ? 4
             : 3;
}

// antp (T,) int32, tab (4, mp, npad) f32, P (npad,) f32 scratch -> out
// (T,) f32.  stages: bit 1 the reduction into P, bit 2 the gather from P
// (3: both, two launches); 4 the one-launch form (P unused).  Returns
// the first non-zero cudaGetLastError().
int kbisect_f(const int* antp, const float* tab, int mp, int npad, int T,
              int stages, float* P, float* out, void* stream) {
  if (mp < 1 || npad < 1 || T < 1 || stages < 1 || stages > 4 ||
      (stages == 4 && npad > kOneLaunchMaxNpad))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stages == 4) {
    kbisect_f_gather_kernel<true><<<col_blocks(T), kThreads,
                                    npad * sizeof(float), st>>>(
        antp, tab, mp, npad, T, nullptr, out);
    return (int)cudaGetLastError();
  }
  if (stages & 1) {
    kbisect_f_reduce_kernel<<<(npad + kSlice - 1) / kSlice, kThreads, 0,
                              st>>>(tab, mp, npad, P);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (stages & 2) {
    const int err = (int)launch_dependent(
        kbisect_f_gather_kernel<false>, dim3(col_blocks(T)), dim3(kThreads),
        st, antp, tab, mp, npad, T, (const float*)P, out);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
