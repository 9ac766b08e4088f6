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
// Bound on the H100 (67 TFLOP/s f32 non-tensor, 3.35 TB/s HBM):
// operations.  At mp 104, T 113,664, npad 128: 2 * 416 * 128 * T =
// 12.1 GFLOP (0.181 ms) over 58.9 MB (0.018 ms).  The kernel must keep
// the FFMA pipes busy, as an SGEMM does, while g never leaves the chip.
//
// Design: a register-blocked SGEMM whose epilogue is the pair reduction.
// - Block (x, y) computes the 128 x 128 tile of g of row tile x (32
//   clusters) and column tile y, with 256 threads, each holding an 8 x 8
//   register tile: rows 4r..4r+3 and 64+4r..64+4r+3 (two whole clusters),
//   columns 4c..4c+3 and 64+4c..64+4c+3 (so a quarter-warp's float4 loads
//   hit distinct banks or broadcast).  Per n it issues 4 float4 shared
//   loads for 64 FFMA (16 per load; one thread per column issues one per
//   4).
// - n streams in slices of 16, double-buffered: oh's slice by cp.async,
//   tab's through registers (loaded during the previous slice's FFMA and
//   stored transposed, [n][row], after it).  One __syncthreads a slice.
// - Epilogue: each thread folds its two clusters' pair products into 8
//   column partials; the 16 row groups' partials are added through shared
//   memory in row-group order, giving one partial per (row tile, column).
//   A second kernel adds the row tiles in order.  No atomics: a repeat is
//   bit-identical.  Grid x (row tiles) runs fastest, so the blocks that
//   share a column tile of oh run together and read it from L2.
// - Rows past 4*mp and n past npad are zero-filled, so a padded cluster
//   adds exactly 0; a warp whose rows are all padding skips its FFMA.
// - 32 KB of shared memory and at most 128 registers a thread: two blocks
//   (16 warps) per SM.  No limit on npad.
// 16-byte copies need npad and T to be multiples of 4 (and aligned
// pointers); other shapes take 4-byte copies, same arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 16;  // row groups (and column groups) of threads
constexpr int kTile = 128;   // rows of a block's tile of g
constexpr int kCols = 8;     // columns a thread holds (a multiple of 4)
constexpr int kTileC = kGroups * kCols;  // columns of a block's tile
constexpr int kSlice = 16;   // n per pipeline stage
constexpr int kMinBlocks = 2;  // blocks per SM the registers must allow
// 4-n pieces of tab's slice per thread (kSlice >= 8)
constexpr int kTabPieces = kTile * kSlice / 4 / kThreads;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool live) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool live) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// oh's slice [n0, n0 + kSlice) x [col0, col0 + kTileC) into dst [n][col],
// zero past npad and T.
template <bool kVec>
__device__ __forceinline__ void issue_oh(float* dst, const float* oh, int n0,
                                         int col0, int npad, int T) {
  if (kVec) {
    for (int i = threadIdx.x; i < kSlice * kTileC / 4; i += kThreads) {
      const int n = i / (kTileC / 4), c = 4 * (i % (kTileC / 4));
      const bool live = n0 + n < npad && col0 + c < T;  // T % 4 == 0
      cp_async16(dst + n * kTileC + c,
                 live ? oh + (size_t)(n0 + n) * T + col0 + c : oh, live);
    }
  } else {
    for (int i = threadIdx.x; i < kSlice * kTileC; i += kThreads) {
      const int n = i / kTileC, c = i % kTileC;
      const bool live = n0 + n < npad && col0 + c < T;
      cp_async4(dst + i, live ? oh + (size_t)(n0 + n) * T + col0 + c : oh,
                live);
    }
  }
}

// tab's slice rows [r0, r0 + kTile) x [n0, n0 + kSlice): this thread's
// 4-n pieces (row i % kTile, n 4 (i / kTile)) into registers, zero past
// `rows` and npad.
template <bool kVec>
__device__ __forceinline__ void load_tab(float4 a[kTabPieces],
                                         const float* tab, int r0, int n0,
                                         int rows, int npad) {
#pragma unroll
  for (int u = 0; u < kTabPieces; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = r0 + i % kTile, n = n0 + 4 * (i / kTile);
    const float* p = tab + (size_t)r * npad + n;
    if (kVec) {  // npad % 4 == 0: the 4 n all in or all out
      a[u] = r < rows && n < npad ? __ldg(reinterpret_cast<const float4*>(p))
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const bool in = r < rows;
      a[u].x = in && n < npad ? __ldg(p) : 0.f;
      a[u].y = in && n + 1 < npad ? __ldg(p + 1) : 0.f;
      a[u].z = in && n + 2 < npad ? __ldg(p + 2) : 0.f;
      a[u].w = in && n + 3 < npad ? __ldg(p + 3) : 0.f;
    }
  }
}

// The registers of load_tab, transposed into dst [n][row].
__device__ __forceinline__ void store_tab(float* dst,
                                          const float4 a[kTabPieces]) {
#pragma unroll
  for (int u = 0; u < kTabPieces; ++u) {
    const int i = threadIdx.x + u * kThreads;
    float* d = dst + 4 * (i / kTile) * kTile + i % kTile;
    d[0] = a[u].x;
    d[kTile] = a[u].y;
    d[2 * kTile] = a[u].z;
    d[3 * kTile] = a[u].w;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
kbisect_c_kernel(const float* __restrict__ tab, const float* __restrict__ oh,
                 int mp, int npad, int T, float* __restrict__ partial) {
  __shared__ float4 smem4[2 * kSlice * (kTile + kTileC) / 4];
  float* a_s = reinterpret_cast<float*>(smem4);  // 2 x [n][row]
  float* b_s = a_s + 2 * kSlice * kTile;          // 2 x [n][col]
  const int tid = threadIdx.x;
  const int rows = 4 * mp;
  const int r0 = blockIdx.x * kTile, col0 = blockIdx.y * kTileC;
  const int nslices = (npad + kSlice - 1) / kSlice;
  const int cg = tid % kGroups, rg = tid / kGroups;
  // every row of this warp (row groups 2w, 2w + 1) is padding
  const bool idle = r0 + 8 * (tid / 32) >= rows;

  float4 a[kTabPieces];
  load_tab<kVec>(a, tab, r0, 0, rows, npad);
  store_tab(a_s, a);
  issue_oh<kVec>(b_s, oh, 0, col0, npad, T);
  cp_async_commit();

  float g[8][kCols];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) g[i][c] = 0.f;

  for (int s = 0; s < nslices; ++s) {
    cp_async_wait_all();
    // slice s is visible to all; everyone is done with slice s - 1, whose
    // buffers the next slice overwrites
    __syncthreads();
    const int nb = (s + 1) & 1;
    if (s + 1 < nslices) {
      issue_oh<kVec>(b_s + nb * kSlice * kTileC, oh, (s + 1) * kSlice, col0,
                     npad, T);
      load_tab<kVec>(a, tab, r0, (s + 1) * kSlice, rows, npad);
    }
    cp_async_commit();
    if (!idle) {
      const float* as = a_s + (s & 1) * kSlice * kTile + 4 * rg;
      const float* bs = b_s + (s & 1) * kSlice * kTileC + 4 * cg;
#pragma unroll
      for (int n = 0; n < kSlice; ++n) {
        const float4 alo = *reinterpret_cast<const float4*>(as + n * kTile);
        const float4 ahi =
            *reinterpret_cast<const float4*>(as + n * kTile + 64);
        const float av[8] = {alo.x, alo.y, alo.z, alo.w,
                             ahi.x, ahi.y, ahi.z, ahi.w};
        float bv[kCols];
#pragma unroll
        for (int u = 0; u < kCols / 4; ++u) {
          const float4 b4 = *reinterpret_cast<const float4*>(
              bs + n * kTileC + 64 * u);
          bv[4 * u] = b4.x;
          bv[4 * u + 1] = b4.y;
          bv[4 * u + 2] = b4.z;
          bv[4 * u + 3] = b4.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            g[i][c] = fmaf(av[i], bv[c], g[i][c]);
      }
    }
    if (s + 1 < nslices) store_tab(a_s + nb * kSlice * kTile, a);
  }

  // pair products of the thread's two clusters, then the 16 row groups'
  // partials added in row-group order
  cp_async_wait_all();
  __syncthreads();
  float* red = a_s;  // [rg][kTileC]
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    red[rg * kTileC + 64 * (c / 4) + 4 * cg + c % 4] =
        (g[0][c] * g[1][c] + g[2][c] * g[3][c]) +
        (g[4][c] * g[5][c] + g[6][c] * g[7][c]);
  __syncthreads();
  for (int c = tid; c < kTileC; c += kThreads) {
    if (col0 + c >= T) break;
    float acc = 0.f;
    for (int r = 0; r < kGroups; ++r) acc += red[r * kTileC + c];
    partial[(size_t)blockIdx.x * T + col0 + c] = acc;
  }
}

// out[t] = sum over row tiles, in order, of partial[tile][t].
__global__ void __launch_bounds__(kThreads)
kbisect_c_sum_kernel(const float* __restrict__ partial, int ntiles, int T,
                     float* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  float acc = 0.f;
  for (int k = 0; k < ntiles; ++k) acc += partial[(size_t)k * T + t];
  out[t] = acc;
}

int row_tiles(int mp) { return (4 * mp + kTile - 1) / kTile; }

template <bool kVec>
int launch(const float* tab, const float* oh, int mp, int npad, int T,
           float* partial, float* out, cudaStream_t stream) {
  const dim3 grid(row_tiles(mp), (T + kTileC - 1) / kTileC);
  kbisect_c_kernel<kVec><<<grid, kThreads, 0, stream>>>(tab, oh, mp, npad, T,
                                                        partial);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  kbisect_c_sum_kernel<<<(T + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(partial, row_tiles(mp), T, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Row tiles of the product for mp clusters: the first axis of partial.
int kbisect_c_row_tiles(int mp) { return row_tiles(mp); }

// tab (4*mp, npad) f32, oh (npad, T) f32 -> out (T,) f32, with scratch
// partial (kbisect_c_row_tiles(mp), T) f32.  Returns the first non-zero
// CUDA error (cudaErrorInvalidValue for an empty shape or a grid the
// launch cannot take).
int kbisect_c(const float* tab, const float* oh, int mp, int npad, int T,
              float* partial, float* out, void* stream) {
  if (mp < 1 || npad < 1 || T < 1 || row_tiles(mp) > 65535 ||
      (T + kTileC - 1) / kTileC > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = npad % 4 == 0 && T % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(tab) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(oh) % 16) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(tab, oh, mp, npad, T, partial, out, st)
             : launch<false>(tab, oh, mp, npad, T, partial, out, st);
}

}  // extern "C"
