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
// Design.  The sum over m depends on an index only through its station,
// so the table is reduced per station first and gathered second:
//   1. reduce: S[s, k] = sum_m tab[4m + k, s] for every s < npad, stored
//      as one float4 a station.  A block takes kSlice consecutive
//      stations: its threads stage the slice's 4 mp table words in shared
//      memory (kPer coalesced loads a thread, all in flight at once), then
//      one thread a (station, k) sums over m in order;
//   2. gather: the TPU grid revisits one output block for r = 0, 1, ...;
//      here a block takes kCols columns and splits r into kChunks
//      contiguous chunks, one thread a (column, chunk): it adds the float4
//      S[antp[r*T + t]] of its chunk's r in order (a coalesced read of
//      antp, a 16-byte read of S held on chip).  The chunks' sums meet in
//      shared memory and are added in chunk order, so every sum runs in a
//      fixed order.  It is launched as a programmatic dependent of the
//      reduction (dependent_launch.cuh), so its launch latency hides
//      behind it.
// S is a global table of 4 npad words that the wrapper allocates, so no
// shared-memory size caps npad.  The one-launch form (stages 4) fuses the
// two: every block reduces the whole table into its own shared memory,
// straight from L2, before its gather.  It saves a launch but reads the
// table once a block, so it is the default only where the columns take
// few blocks (kbisect's T = 256: 16 blocks); it takes npad <=
// kOneLaunchMaxNpad.  No atomics: a repeat is bit-identical.
//
// Bound on the H100 (3.35 TB/s HBM): bytes.  The function's least work
// reads each input once and writes the output once: 0.67 MB at mp 104,
// npad 128, R 444, T 256, 0.20 us; its 53,248 table flops and 454,656
// gathered words take less.  A launch on the device costs more than that
// whole bound, so the time is launch latency plus the latency of the
// reduction's chain over m and of each chunk's gathers.

#include <cuda_runtime.h>

#include "dependent_launch.cuh"

namespace {

constexpr int kThreads = 256;                       // a reduce block
constexpr int kSlice = 16;                          // stations a reduce block
constexpr int kChunk = 128;                         // clusters staged at once
constexpr int kPer = 4 * kChunk * kSlice / kThreads;  // loads a thread: 32
constexpr int kCols = 16;                           // columns a gather block
constexpr int kChunks = 64;                         // r chunks a gather block
constexpr int kGather = kCols * kChunks;            // gather block: 1024
// the one-launch form: S in 32 KB of shared memory, and the default where
// at most kOneLaunchMaxBlocks blocks, each of which reduces the whole
// table, share the gather and the table is small (at mp 8 one launch won,
// at mp 104 two did on the H100; PERF.md)
constexpr int kOneLaunchMaxNpad = 2048;
constexpr int kOneLaunchMaxBlocks = 16;
constexpr int kOneLaunchMaxWords = 16384;  // the table a block reduces: 64 KB

int col_blocks(int T) { return (T + kCols - 1) / kCols; }

__global__ void __launch_bounds__(kThreads)
kbisect_a_reduce_kernel(const float* __restrict__ tab, int mp, int npad,
                        float* __restrict__ S) {
  __shared__ float stage[4 * kChunk * kSlice];  // [4i + k][j], 32 KB
  launch_dependents();
  const int s0 = blockIdx.x * kSlice;
  // the summing threads: one a (k, station j of the slice)
  const int k = threadIdx.x / kSlice, j = threadIdx.x % kSlice;
  float acc = 0.f;
  for (int m0 = 0; m0 < mp; m0 += kChunk) {
    const int nm = min(kChunk, mp - m0);
    float v[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = q * kThreads + threadIdx.x;
      const int row = e / kSlice, s = s0 + e % kSlice;  // row = 4i + k
      v[q] = (row < 4 * nm && s < npad)
                 ? __ldg(tab + ((size_t)4 * m0 + row) * npad + s)
                 : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) stage[q * kThreads + threadIdx.x] = v[q];
    __syncthreads();
    if (k < 4) {
      const float* st = stage + k * kSlice + j;
#pragma unroll 8
      for (int i = 0; i < nm; ++i) acc += st[4 * i * kSlice];
    }
    __syncthreads();
  }
  if (k < 4 && s0 + j < npad) S[(size_t)(s0 + j) * 4 + k] = acc;
}

// A block of kCols columns x kChunks r chunks, reading S from global
// memory (kOneLaunch false) or reducing it first into the block's shared
// memory (true).
template <bool kOneLaunch>
__global__ void __launch_bounds__(kGather)
kbisect_a_gather_kernel(const int* __restrict__ antp,
                        const float* __restrict__ tab, int mp, int npad,
                        int R, int T, const float4* __restrict__ S,
                        float* __restrict__ out) {
  __shared__ float part[kChunks][4][kCols];  // 16 KB
  extern __shared__ float4 own[];            // one-launch form: S
  if (kOneLaunch) {
    float* own_f = reinterpret_cast<float*>(own);
    for (int x = threadIdx.x; x < 4 * npad; x += kGather) {
      const int k = x / npad, s = x % npad;
      float acc = 0.f;
#pragma unroll 16
      for (int m = 0; m < mp; ++m)
        acc += __ldg(tab + (size_t)(4 * m + k) * npad + s);
      own_f[s * 4 + k] = acc;
    }
    __syncthreads();
  } else {
    wait_for_prerequisites();  // S is the reduction's
  }
  const float4* sums = kOneLaunch ? own : S;
  const int c = threadIdx.x % kCols, chunk = threadIdx.x / kCols;
  const int t = blockIdx.x * kCols + c;
  const int len = (R + kChunks - 1) / kChunks;
  const int r0 = chunk * len, r1 = min(R, r0 + len);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (t < T) {
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const int a = __ldg(antp + (size_t)r * T + t);
      if (a >= 0 && a < npad) {
        const float4 v = sums[a];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
  }
  part[chunk][0][c] = acc.x;
  part[chunk][1][c] = acc.y;
  part[chunk][2][c] = acc.z;
  part[chunk][3][c] = acc.w;
  __syncthreads();
  if (threadIdx.x < 4 * kCols) {
    const int k = threadIdx.x / kCols, col = threadIdx.x % kCols;
    const int tc = blockIdx.x * kCols + col;
    float s = part[0][k][col];
    for (int q = 1; q < kChunks; ++q) s += part[q][k][col];
    if (tc < T) out[(size_t)k * T + tc] = s;
  }
}

}  // namespace

extern "C" {

int kbisect_a_one_launch_max_npad() { return kOneLaunchMaxNpad; }

// The faster form for this shape, as measured on the H100 (PERF.md): one
// launch (4) where few blocks each reduce a small table, else two (3).
int kbisect_a_default_stages(int mp, int npad, int T) {
  return npad <= kOneLaunchMaxNpad && col_blocks(T) <= kOneLaunchMaxBlocks &&
                 4 * (long long)mp * npad <= kOneLaunchMaxWords
             ? 4
             : 3;
}

// antp (R*T,) int32, tab (4*mp, npad) f32, S (npad, 4) f32 scratch ->
// out (4, T) f32.  stages: bit 1 the reduction into S, bit 2 the gather
// from S (3: both, two launches); 4 the one-launch form (S unused).
// Returns the first non-zero cudaGetLastError().
int kbisect_a(const int* antp, const float* tab, int mp, int npad, int R,
              int T, int stages, float* S, float* out, void* stream) {
  if (mp < 1 || npad < 1 || R < 1 || T < 1 || stages < 1 || stages > 4 ||
      (stages == 4 && npad > kOneLaunchMaxNpad))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stages == 4) {
    kbisect_a_gather_kernel<true>
        <<<col_blocks(T), kGather, npad * sizeof(float4), st>>>(
            antp, tab, mp, npad, R, T, nullptr, out);
    return (int)cudaGetLastError();
  }
  if (stages & 1) {
    kbisect_a_reduce_kernel<<<(npad + kSlice - 1) / kSlice, kThreads, 0,
                              st>>>(tab, mp, npad, S);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (stages & 2) {
    const int err = (int)launch_dependent(
        kbisect_a_gather_kernel<false>, dim3(col_blocks(T)), dim3(kGather),
        st, antp, tab, mp, npad, R, T, reinterpret_cast<const float4*>(S),
        out);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
