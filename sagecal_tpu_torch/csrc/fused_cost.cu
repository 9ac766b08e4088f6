// Fused RIME predict and calibration objective for NVIDIA Hopper
// (sm_90a): forward and backward of the joint-LBFGS cost, solo and batched
// over B lanes, and of the full-model predict, hand-written CUDA with a
// plain C interface (loaded with ctypes by
// sagecal_tpu_torch/kernels/build.py).
//
// Replaces the Pallas kernels of sagecal_tpu/ops/rime_kernel.py:
//   #1 predict forward  _fused_predict_fwd_impl (:265; bodies _fwd_kernel
//            :220, _fwd_kernel_hybrid :228, _fwd_store :209)
//   #2 predict backward _fused_predict_bwd_impl (:407; bodies _bwd_kernel
//            :385, _bwd_kernel_hybrid :395, _g_from_ref :294)
//   #3 forward  _fused_cost_fwd_impl (:842; bodies _obj_fwd_kernel :768,
//            _obj_fwd_kernel_hybrid :779, _obj_partial :738)
//   #4 backward _fused_cost_bwd_impl (:877; bodies _obj_bwd_kernel :815,
//            _obj_bwd_kernel_hybrid :828, _g_from_residual :791,
//            _bwd_accumulate :305, _bwd_store :359)
//   #5 batched forward  _fused_cost_batch_fwd_impl (:1250; body
//            _obj_fwd_kernel_batch :1202)
//   #6 batched backward _fused_cost_batch_bwd_impl (:1273; body
//            _obj_bwd_kernel_batch :1237)
// Each is bound by the bytes it moves (below).

// What they compute, per row r and channel f of one tile:
//   V(f,r) = sum_m Jp_m C_m(f,r) Jq_m^H          (gains of row r's stations)
//   d      = (vis(f,r) - V(f,r)) * mask(f,r)       (4 complex components)
//   cost   = sum |d|^2   (Gaussian)  or  sum log1p(|d|^2 / nu)  (robust)
// and the backward gives d(cost)/d(tab_re, tab_im) for the component-major
// gain tables tab[k][m*nc + c][station] (k = row-major 2x2 component).
// The upstream scalar cotangent is applied by the caller.  The predict
// pair computes V itself, written out as (F, 8, rowsp) f32 planes, and
// the backward of sum(g * V) for an upstream model cotangent g of that
// shape (the caller's cotangent is g: no scalar is applied).
//
// Layouts (the JAX package's packed layouts, padding optional):
//   tab_re/tab_im (4, mp*nc, npad) f32; coh (mp, F, 8, rowsp) f32 or bf16,
//   component axis [re XX, re XY, re YX, re YY, im XX, ..., im YY];
//   ant_p/ant_q (rowsp,) int32; cmap (mp, rowsp) int32 (nc > 1 only);
//   vis (F, 8, rowsp) f32; mask (F, rowsp) f32; nu (1,) f32 on the device.
// Batched (B lanes, nc = 1): tables (4, B*mp, npad), lane b's clusters on
//   rows [b*mp, (b+1)*mp); coh (B*mp, F, 8, rowsp); vis (B, F, 8, rowsp);
//   mask (B, F, rowsp); nu (B,) on the device (one per lane, never a
//   host float); ant_p/ant_q shared by every lane.  The grid's last
//   index is the lane; each kernel body first moves its pointers to its
//   lane (64-bit offsets: B*mp*F*8*rowsp passes 2^31 at serve shapes);
//   the solo kernels are the same bodies compiled without the lane
//   offsets.  A lane whose mask is all zero gives a cost of exactly 0 and
//   a cotangent of exactly 0.
//
// Design.  One thread per row, 256 rows per block (a row tile).  Each
// thread reads its row's station indices (and chunk index when nc > 1)
// and loads Jp, Jq straight from the tables by index: exact f32, no
// one-hot selection matmul (the TPU kernel's _sel_dot existed only for the
// MXU) and no TF32 anywhere.  Coherency planes are read coalesced along
// rows and bf16 is upcast at the load.  Ragged edges (rows past rowsp)
// are masked here; no tile, cluster or station padding is required.
//
// Forwards (#1, #3, #5): each block writes one partial sum (fixed-order
// tree reduction in shared memory; the caller sums the (B, n_blocks)
// partials per lane), or #1 its rows' model.
//
// Backwards (#4 solo, #6 batched, #2 predict), deterministic with no
// floating-point atomics (shared-memory ones included):
// 1. cotangent (#4, #6): re-forms V and writes the model cotangent
//    g = -2 mask d (Gaussian) or -2 mask d / (nu + |d|^2) (robust),
//    (lanes, F, 8, rowsp) f32: one stack pass, #3's arithmetic with
//    clusters outer and both channels per pass; each warp stages its own
//    rows' coherencies four clusters ahead (cp.async into a ring,
//    __syncwarp).  #2 has no such kernel: its g is the caller's upstream
//    model cotangent, read in the same layout.
// 2. gradient: blocks of (8 row tiles of 256 rows, 3 clusters;
//    kTilesPerBlock, kClustersPerBlock, and the lane on the grid's z axis
//    for #6) run in parallel, two per SM.  A block stages its clusters'
//    gains once in shared memory.  Within a row tile there is no block
//    barrier: each warp stages its own 32 rows' coherencies one step
//    ahead (cp.async into a ring, __syncwarp), and each thread forms its
//    row's dJp and dJq for every cluster of the group and stores them at
//    its items' positions in the station plan (built once per tile, or
//    once per bucket for #6's lanes, which share their stations, by
//    ops/rime_kernel.py::BwdPlan: each row tile's (role, row) items
//    stably sorted by (chunk, station)).  Then, between two barriers, one
//    lane per ((cluster, key), component) adds the key's contiguous items
//    in sorted order into the group's sums in shared memory, tile after
//    tile.  One partial table per (lane, 8 tiles, cluster group).  Where
//    one cluster's gains and sums (64 nc npad bytes) do not fit, a block
//    takes one cluster and a slice of its (chunk, station) keys and reads
//    the gains from the tables; each slice re-reads the stack
//    (grad_shape).
// 3. sum: each lane's partial tables in block order.
// Two calls on the same inputs give bit-identical tables.  Scratch: g
// (not for #2) and lanes x ceil(ntiles / 8) x 8 x mp*nc x npad floats.
//
// Bound on the H100 (80 GB HBM3 at 3.35 TB/s, 67 TFLOP/s f32 non-tensor):
// bytes.  At the north-star tile (62 stations, 100 clusters, 60 x 2)
// the coherency stack is 100 x 2 x 8 x 113,460 x 4 B = 726 MB in f32,
// ~0.22 ms a pass, against ~2.7 GFLOP (forward) = 0.04 ms; a serve
// bucket of 8 such tiles with 8 clusters each moves ~531 MB, ~0.16 ms.
// The forwards read the stack once; the predict forward adds the model,
// 7.3 MB (bound ~0.219 ms at the north-star tile).  The bounds of the
// objective backwards #4/#6 count the stack once too
// (kernels/parity.py::fused_cost_work), but their design reads it twice,
// once per kernel 1 and 2, because a row's cotangent needs every cluster
// and the cluster axis does not fit on chip between the two (the TPU's
// VMEM held it): their floor is two passes, half the one-pass bound.  The
// predict backward #2 reads the stack once, in kernel 2, and its bound
// (~0.219 ms) counts the stack, the upstream g and the tables.  Measured
// on the H100 (PERF.md), a pass runs near 2.5 TB/s with nothing else in
// it, and the gradient kernel's products and station sums add to it.
// Holding a row tile's stack on chip or in L2 between the two phases is
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // rows per block (a row tile)

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

struct Tile {
  const float* tab_re;
  const float* tab_im;
  const int* ant_p;
  const int* ant_q;
  const int* cmap;
  const float* vis;
  const float* mask;
  int mp, nc, npad, F, rowsp;
  int lanes;     // B
  size_t plane;  // floats per table component plane: lanes * mp * nc * npad
};

// Move the tile's per-lane pointers (tables, visibilities, mask) to lane
// b and return lane b's coherencies; indices and the chunk map are shared.
template <typename CT>
__device__ __forceinline__ const CT* to_lane(Tile& t, const CT* coh, int b) {
  const size_t lane_rows = (size_t)b * t.mp * t.nc;
  t.tab_re += lane_rows * t.npad;
  t.tab_im += lane_rows * t.npad;
  t.vis += (size_t)b * t.F * 8 * t.rowsp;
  t.mask += (size_t)b * t.F * t.rowsp;
  return coh + (size_t)b * t.mp * t.F * 8 * t.rowsp;
}

// Gains of (cluster-chunk row `mrow`, station `st`): 4 components re/im.
__device__ __forceinline__ void load_gain(const Tile& t, int mrow, int st,
                                          float re[4], float im[4]) {
  const size_t off = (size_t)mrow * t.npad + st;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    re[k] = ld(t.tab_re + k * t.plane + off);
    im[k] = ld(t.tab_im + k * t.plane + off);
  }
}

__device__ __forceinline__ int chunk_row(const Tile& t, int m, int r) {
  return m * t.nc + (t.nc > 1 ? t.cmap[(size_t)m * t.rowsp + r] : 0);
}

// A = C Jq^H:  A_aj = sum_b C_ab conj(Jq_jb), 2x2 index ab = 2a+b.
__device__ __forceinline__ void cjqh(const float cr[4], const float ci[4],
                                     const float qr[4], const float qi[4],
                                     float ar[4], float ai[4]) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float re = 0.f, im = 0.f;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float c_r = cr[2 * a + b], c_i = ci[2 * a + b];
        const float q_r = qr[2 * j + b], q_i = qi[2 * j + b];
        re += c_r * q_r + c_i * q_i;
        im += c_i * q_r - c_r * q_i;
      }
      ar[2 * a + j] = re;
      ai[2 * a + j] = im;
    }
  }
}

// V += Jp A:  V_ij += sum_a Jp_ia A_aj.
__device__ __forceinline__ void add_jp_a(const float pr[4], const float pi[4],
                                         const float ar[4], const float ai[4],
                                         float vr[4], float vi[4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float re = 0.f, im = 0.f;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float p_r = pr[2 * i + a], p_i = pi[2 * i + a];
        const float a_r = ar[2 * a + j], a_i = ai[2 * a + j];
        re += p_r * a_r - p_i * a_i;
        im += p_r * a_i + p_i * a_r;
      }
      vr[2 * i + j] += re;
      vi[2 * i + j] += im;
    }
  }
}

template <typename CT>
__device__ __forceinline__ void load_coh(const CT* coh, const Tile& t, int m,
                                         int f, int r, float cr[4],
                                         float ci[4]) {
  const CT* base = coh + ((size_t)m * t.F + f) * 8 * t.rowsp + r;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cr[k] = ld(base + (size_t)k * t.rowsp);
    ci[k] = ld(base + (size_t)(4 + k) * t.rowsp);
  }
}

// Model V(f, r) = sum_m Jp C_m Jq^H for one row and channel.
template <typename CT>
__device__ void model_row(const CT* coh, const Tile& t, int f, int r, int ap,
                          int aq, float vr[4], float vi[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) vr[k] = vi[k] = 0.f;
  for (int m = 0; m < t.mp; ++m) {
    const int mrow = chunk_row(t, m, r);
    float pr[4], pi[4], qr[4], qi[4], cr[4], ci[4], ar[4], ai[4];
    load_gain(t, mrow, ap, pr, pi);
    load_gain(t, mrow, aq, qr, qi);
    load_coh(coh, t, m, f, r, cr, ci);
    cjqh(cr, ci, qr, qi, ar, ai);
    add_jp_a(pr, pi, ar, ai, vr, vi);
  }
}

template <typename CT, bool kBatched>
__global__ void __launch_bounds__(kThreads)
fused_cost_fwd_kernel(Tile t, const CT* __restrict__ coh,
                      const float* __restrict__ nu_ptr, int robust,
                      float* __restrict__ partial) {
  __shared__ float red[kThreads];
  // the solo kernels (kBatched false) compile without the lane offsets
  const int b = kBatched ? (int)blockIdx.y : 0;
  if (kBatched) coh = to_lane(t, coh, b);
  const int r = blockIdx.x * kThreads + threadIdx.x;
  float part = 0.f;
  if (r < t.rowsp) {
    const int ap = t.ant_p[r], aq = t.ant_q[r];
    const float nu = robust ? nu_ptr[b] : 1.f;
    for (int f = 0; f < t.F; ++f) {
      float vr[4], vi[4];
      model_row(coh, t, f, r, ap, aq, vr, vi);
      const float msk = t.mask[(size_t)f * t.rowsp + r];
      const float* vis = t.vis + (size_t)f * 8 * t.rowsp + r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float dr = (vis[(size_t)k * t.rowsp] - vr[k]) * msk;
        const float di = (vis[(size_t)(4 + k) * t.rowsp] - vi[k]) * msk;
        const float e2 = dr * dr + di * di;
        part += robust ? log1pf(e2 / nu) : e2;
      }
    }
  }
  red[threadIdx.x] = part;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0)
    partial[kBatched ? (size_t)b * gridDim.x + blockIdx.x : blockIdx.x] =
        red[0];
}

// ---- the backwards: cotangent (#4, #6), gradient (#4, #6, #2), sum
//
// The cotangent g of a row needs every cluster; the gradient of cluster m
// needs only g and C_m.  So one kernel forms g (one stack pass, #3's
// body) and writes it out; a second runs (row super-tile, cluster group)
// blocks in parallel over g and the stack (a second pass); a third sums
// the super-tiles' partial tables in order.  #6 runs the same bodies with
// the lane on the grid (kBatched), and #2 the last two on the caller's g.

// The station plan of every (chunk map, row tile), built on the device by
// ops/rime_kernel.py::BwdPlan once per tile (one for all of #6's lanes,
// which share their stations and have nc = 1): the tile's 2 * kThreads
// (role, row) items, item i = role * kThreads + (row - tile start),
// stably sorted by key c * npad + station (c the row's chunk under that
// map, station ant_p or ant_q by role; rows past rowsp last).
//   pos (nplans, ntiles, 2 * kThreads): sorted position of each item;
//   seg (nplans, ntiles, nc * npad + 1): first position of each key
//       (seg[nc * npad] = the tile's valid items);
//   of_cluster (mp,): cluster m's plan (read when nc > 1).
struct GradPlan {
  const int* pos;
  const int* seg;
  const int* of_cluster;
  int ntiles;
};

constexpr int kItems = 2 * kThreads;  // (role, row) items of a row tile
constexpr int kRegPlanes = 16;        // coherency planes staged: 2 channels
constexpr int kStages = 2;            // gradient ring slots: steps ahead + 1
// A gradient block's row tiles (one partial table per kTilesPerBlock
// tiles) and the most clusters it takes (fewer while its shared memory
// passes kGradSmemTarget).  At the north-star tile on the H100 (PERF.md)
// 8 tiles ran faster than 4, and 3 clusters faster than 2 or 4.
constexpr int kTilesPerBlock = 8;
constexpr int kClustersPerBlock = 3;
// cotangent ring slots: 80 KB at F = 2, two blocks an SM (deeper rings
// that leave one block an SM ran slower on the H100)
constexpr int kCotStages = 5;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Dynamic shared memory of the gradient kernel for gc clusters and kz of
// the K = nc * npad keys (chunk, station): the coherency ring (kStages x
// kRegPlanes planes x kThreads rows of CT), the group's gains (8 floats a
// key, staged only when kz = K), its sums over the block's kz keys, the
// tile's sorted contributions of each cluster (8 floats an item), and the
// kz + 1 segment starts of each cluster's plan (one plan when nc = 1).
__host__ __device__ inline size_t grad_smem_bytes(int gc, int nc, int K,
                                                  int kz, int csize) {
  const size_t plans = nc > 1 ? gc : 1;
  const size_t gains = kz == K ? (size_t)gc * K * 8 : 0;
  return (size_t)kStages * kRegPlanes * kThreads * csize +
         sizeof(float) * (gains + (size_t)gc * kz * 8 +
                          (size_t)gc * kItems * 8) +
         sizeof(int) * plans * ((size_t)kz + 1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage kRegPlanes coherency planes of cluster m from channel f0 on for
// this warp's 32 rows of row tile `tile` into ring slot dst
// ([plane][kThreads]).  vec:
// 16-byte cp.async copies shared by the warp's lanes (rowsp a multiple of
// 16 bytes' worth of CT, aligned stack; copies wholly in or past rowsp);
// else each lane loads its own row.  Planes past F * 8 are not staged.
template <typename CT>
__device__ __forceinline__ void stage_coh(CT* dst, const CT* coh,
                                          const Tile& t, int m, int f0,
                                          int tile, int vec) {
  const int lane = threadIdx.x & 31, w0 = threadIdx.x & ~31;
  const int planes = min(kRegPlanes, (t.F - f0) * 8);
  const int r0 = tile * kThreads + w0;
  const CT* src = coh + ((size_t)m * t.F + f0) * 8 * t.rowsp + r0;
  if (vec) {
    constexpr int per = 16 / sizeof(CT);  // rows per copy
    constexpr int units = 32 / per;       // copies per plane
    for (int u = lane; u < planes * units; u += 32) {
      const int pl = u / units, c = (u % units) * per;
      const bool live = r0 + c < t.rowsp;
      cp_async16(dst + pl * kThreads + w0 + c,
                 live ? src + (size_t)pl * t.rowsp + c : coh, live);
    }
  } else if (r0 + lane < t.rowsp) {
    for (int pl = 0; pl < planes; ++pl)
      dst[pl * kThreads + w0 + lane] = src[(size_t)pl * t.rowsp + lane];
  }
}

// Cotangent kernel: g(f, r) = -2 mask d  (Gaussian) or -2 mask d / (nu +
// |d|^2)  (robust) of every row and channel, stored as the planes of (F, 8,
// rowsp) f32 (lane y's, batched).  One stack pass: clusters outer, two
// channels at a time, the row's gains loaded once per cluster; each warp
// stages its own rows' coherencies kCotStages - 1 clusters ahead (cp.async
// into a ring in shared memory, __syncwarp before reading them).
template <typename CT, bool kBatched>
__global__ void __launch_bounds__(kThreads)
fused_cost_cot_kernel(Tile t, const CT* __restrict__ coh,
                      const float* __restrict__ nu_ptr, int robust, int vec,
                      float* __restrict__ g) {
  extern __shared__ float4 smem4[];
  CT* ring = reinterpret_cast<CT*>(smem4);  // kCotStages x [plane][kThreads]
  constexpr int kSlot = kRegPlanes * kThreads;
  const int b = kBatched ? (int)blockIdx.y : 0;
  if (kBatched) {
    coh = to_lane(t, coh, b);
    g += (size_t)b * t.F * 8 * t.rowsp;
  }
  const int tid = threadIdx.x;
  const int r = blockIdx.x * kThreads + tid;
  const bool valid = r < t.rowsp;  // every lane stages and syncs its warp
  const int ap = valid ? t.ant_p[r] : 0, aq = valid ? t.ant_q[r] : 0;
  const float nu = robust ? nu_ptr[b] : 1.f;
  for (int f0 = 0; f0 < t.F; f0 += 2) {
    const int nf = min(2, t.F - f0);
    float vr[2][4] = {}, vi[2][4] = {};
#pragma unroll
    for (int m = 0; m < kCotStages - 1; ++m) {
      if (m < t.mp)
        stage_coh(ring + m * kSlot, coh, t, m, f0, blockIdx.x, vec);
      cp_async_commit();
    }
    for (int m = 0; m < t.mp; ++m) {
      const int nx = m + kCotStages - 1;
      if (nx < t.mp)  // into the slot cluster m - 1 used
        stage_coh(ring + (nx % kCotStages) * kSlot, coh, t, nx, f0,
                  blockIdx.x, vec);
      cp_async_commit();
      cp_async_wait<kCotStages - 1>();  // this warp's copies of cluster m
      __syncwarp();
      const CT* cur = ring + (m % kCotStages) * kSlot + tid;
      if (valid) {
        const int mrow = chunk_row(t, m, r);
        float pr[4], pi[4], qr[4], qi[4];
        load_gain(t, mrow, ap, pr, pi);
        load_gain(t, mrow, aq, qr, qi);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h >= nf) break;
          float cr[4], ci[4], ar[4], ai[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            cr[k] = to_f(cur[(h * 8 + k) * kThreads]);
            ci[k] = to_f(cur[(h * 8 + 4 + k) * kThreads]);
          }
          cjqh(cr, ci, qr, qi, ar, ai);
          add_jp_a(pr, pi, ar, ai, vr[h], vi[h]);
        }
      }
      __syncwarp();  // the warp is done with slot m before it is refilled
    }
    cp_async_wait<0>();
    if (!valid) continue;
    for (int h = 0; h < nf; ++h) {
      const int f = f0 + h;
      const float msk = t.mask[(size_t)f * t.rowsp + r];
      const float* vis = t.vis + (size_t)f * 8 * t.rowsp + r;
      float* o = g + (size_t)f * 8 * t.rowsp + r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float dr = (vis[(size_t)k * t.rowsp] - vr[h][k]) * msk;
        const float di = (vis[(size_t)(4 + k) * t.rowsp] - vi[h][k]) * msk;
        const float w = robust ? 2.f / (nu + dr * dr + di * di) : 2.f;
        o[(size_t)k * t.rowsp] = -w * msk * dr;
        o[(size_t)(4 + k) * t.rowsp] = -w * msk * di;
      }
    }
  }
}

// One channel of a row's gain cotangents: A = C Jq^H, then
// dJp_ia += sum_j g_ij conj(A_aj); dA_aj = sum_i conj(Jp_ia) g_ij;
// dJq_jb += sum_a conj(dA_aj) C_ab.
__device__ __forceinline__ void grad_channel(
    const float cr[4], const float ci[4], const float gr[4],
    const float gi[4], const float pr[4], const float pi[4],
    const float qr[4], const float qi[4], float djp_r[4], float djp_i[4],
    float djq_r[4], float djq_i[4]) {
  float ar[4], ai[4];
  cjqh(cr, ci, qr, qi, ar, ai);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float re = 0.f, im = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float g_r = gr[2 * i + j], g_i = gi[2 * i + j];
        const float a_r = ar[2 * a + j], a_i = ai[2 * a + j];
        re += g_r * a_r + g_i * a_i;
        im += g_i * a_r - g_r * a_i;
      }
      djp_r[2 * i + a] += re;
      djp_i[2 * i + a] += im;
    }
  }
  float dar[4], dai[4];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float re = 0.f, im = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p_r = pr[2 * i + a], p_i = pi[2 * i + a];
        const float g_r = gr[2 * i + j], g_i = gi[2 * i + j];
        re += p_r * g_r + p_i * g_i;
        im += p_r * g_i - p_i * g_r;
      }
      dar[2 * a + j] = re;
      dai[2 * a + j] = im;
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float re = 0.f, im = 0.f;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float d_r = dar[2 * a + j], d_i = dai[2 * a + j];
        const float c_r = cr[2 * a + b], c_i = ci[2 * a + b];
        re += d_r * c_r + d_i * c_i;
        im += d_r * c_i - d_i * c_r;
      }
      djq_r[2 * j + b] += re;
      djq_i[2 * j + b] += im;
    }
  }
}

// Gradient kernel (#4, #6 and #2; for #2 g is the caller's).  Block (x, y,
// z) covers row tiles [x * kTilesPerBlock, (x + 1) * kTilesPerBlock), the gc
// clusters of group y / nz and the kz keys (chunk, station) of slice y % nz.
// Per tile, each thread runs through the group's clusters with no block
// barrier: it forms its row's dJp and dJq (summed over channels) from g, its
// row's coherencies and the group's gains, and stores them at its two items'
// sorted positions in that cluster's contributions.  Each warp stages its
// own 32 rows' coherencies kStages - 1 steps ahead (cp.async into a ring;
// __syncwarp, not __syncthreads, before reading them).  Then, between two
// barriers, lane (q = lane / 8, j = lane % 8) of warp w takes (cluster, key)
// 4 w + q (then + 32, ...) of the slice and adds component j of the key's
// contiguous items, in sorted order, into the group's sums, tile after tile.
// The block writes its slice of its group's rows of partial table x (of lane
// z, batched).  When the group's tables fit (nz = 1, kz = K) the gains are
// staged in shared memory; otherwise (gc = 1, K split into nz slices) each
// thread loads its row's gains from the tables, every slice re-reads the
// tile's stack, and the sums are the same, in the same order.
template <typename CT, bool kBatched>
__global__ void __launch_bounds__(kThreads, 2)
fused_cost_grad_kernel(Tile t, const CT* __restrict__ coh,
                       const float* __restrict__ g, GradPlan plan, int gc,
                       int kz, int vec, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  const int lane_b = kBatched ? (int)blockIdx.z : 0;
  if (kBatched) {
    coh = to_lane(t, coh, lane_b);
    g += (size_t)lane_b * t.F * 8 * t.rowsp;
  }
  const int tid = threadIdx.x;
  const int nc = t.nc, npad = t.npad, K = nc * npad;
  const bool staged = kz == K;  // the group's gains in shared memory
  const int nz = (K + kz - 1) / kz;
  const int m0 = (blockIdx.y / nz) * gc, k0 = (blockIdx.y % nz) * kz;
  const int ng = min(gc, t.mp - m0), nk = min(kz, K - k0);
  const int tile0 = blockIdx.x * kTilesPerBlock;
  const int nt = min(kTilesPerBlock, plan.ntiles - tile0);
  CT* ring = reinterpret_cast<CT*>(smem4);  // kStages x [plane][kThreads]
  constexpr int kSlot = kRegPlanes * kThreads;
  float* gains = reinterpret_cast<float*>(ring + kStages * kSlot);
  float* acc = gains + (staged ? (size_t)gc * K * 8 : 0);  // [mloc][kk][8]
  float* contrib = acc + (size_t)gc * kz * 8;  // [mloc][position][8]
  int* seg = reinterpret_cast<int*>(contrib + (size_t)gc * kItems * 8);

  if (staged) {
    const size_t ntab = (size_t)ng * K * 8;
    for (size_t e = tid; e < ntab; e += kThreads) {
      const int k = (int)(e % 8);
      const size_t rs = e / 8;  // (mloc nc + c) npad + st
      const size_t src =
          (size_t)(k & 3) * t.plane + (size_t)m0 * nc * npad + rs;
      gains[e] = k < 4 ? ld(t.tab_re + src) : ld(t.tab_im + src);
    }
  }
  const size_t nacc = (size_t)ng * kz * 8;
  for (size_t e = tid; e < nacc; e += kThreads) acc[e] = 0.f;
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int kq = lane >> 3, j = lane & 7;
  const int nsteps = nt * ng;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nsteps)
      stage_coh(ring + i * kSlot, coh, t, m0 + i % ng, 0, tile0 + i / ng,
                vec);
    cp_async_commit();
  }
  for (int ti = 0; ti < nt; ++ti) {
    const int tile = tile0 + ti;
    const int r = tile * kThreads + tid;
    const bool valid = r < t.rowsp;
    for (int ml = 0; ml < (nc > 1 ? ng : 1); ++ml) {
      const size_t pt = (size_t)(nc > 1 ? plan.of_cluster[m0 + ml] : 0) *
                            plan.ntiles + tile;
      for (int kk = tid; kk <= nk; kk += kThreads)
        seg[ml * (kz + 1) + kk] = plan.seg[pt * (K + 1) + k0 + kk];
    }
    int ap = 0, aq = 0, pp = 0, pq = 0;
    float gk[kRegPlanes];  // g of this row, channels 0 and 1
    if (valid) {
      ap = t.ant_p[r];
      aq = t.ant_q[r];
      pp = plan.pos[(size_t)tile * kItems + tid];
      pq = plan.pos[(size_t)tile * kItems + kThreads + tid];
#pragma unroll
      for (int pl = 0; pl < kRegPlanes; ++pl)
        gk[pl] = pl < t.F * 8 ? __ldg(g + (size_t)pl * t.rowsp + r) : 0.f;
    }
    for (int mloc = 0; mloc < ng; ++mloc) {
      const int i = ti * ng + mloc, nx = i + kStages - 1;
      if (nx < nsteps)  // into the slot step i - 1 used
        stage_coh(ring + (nx % kStages) * kSlot, coh, t, m0 + nx % ng, 0,
                  tile0 + nx / ng, vec);
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // this warp's copies of step i
      __syncwarp();
      const CT* cur = ring + (i % kStages) * kSlot + tid;
      if (valid) {
        const int m = m0 + mloc;
        if (nc > 1) {
          const size_t pt = (size_t)plan.of_cluster[m] * plan.ntiles + tile;
          pp = plan.pos[pt * kItems + tid];
          pq = plan.pos[pt * kItems + kThreads + tid];
        }
        const int c = nc > 1 ? t.cmap[(size_t)m * t.rowsp + r] : 0;
        float pr[4], pi[4], qr[4], qi[4];
        if (staged) {
          const float* gm = gains + (size_t)(mloc * nc + c) * npad * 8;
          const float4 p0 = *reinterpret_cast<const float4*>(gm + ap * 8);
          const float4 p1 =
              *reinterpret_cast<const float4*>(gm + ap * 8 + 4);
          const float4 q0 = *reinterpret_cast<const float4*>(gm + aq * 8);
          const float4 q1 =
              *reinterpret_cast<const float4*>(gm + aq * 8 + 4);
          pr[0] = p0.x, pr[1] = p0.y, pr[2] = p0.z, pr[3] = p0.w;
          pi[0] = p1.x, pi[1] = p1.y, pi[2] = p1.z, pi[3] = p1.w;
          qr[0] = q0.x, qr[1] = q0.y, qr[2] = q0.z, qr[3] = q0.w;
          qi[0] = q1.x, qi[1] = q1.y, qi[2] = q1.z, qi[3] = q1.w;
        } else {
          load_gain(t, m * nc + c, ap, pr, pi);
          load_gain(t, m * nc + c, aq, qr, qi);
        }
        float djp_r[4] = {0.f, 0.f, 0.f, 0.f}, djp_i[4] = {0.f, 0.f, 0.f, 0.f};
        float djq_r[4] = {0.f, 0.f, 0.f, 0.f}, djq_i[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int f = 0; f < kRegPlanes / 8; ++f) {
          if (f >= t.F) break;
          float cr[4], ci[4], gr[4], gi[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            cr[k] = to_f(cur[(f * 8 + k) * kThreads]);
            ci[k] = to_f(cur[(f * 8 + 4 + k) * kThreads]);
            gr[k] = gk[f * 8 + k];
            gi[k] = gk[f * 8 + 4 + k];
          }
          grad_channel(cr, ci, gr, gi, pr, pi, qr, qi, djp_r, djp_i, djq_r,
                       djq_i);
        }
        for (int f = kRegPlanes / 8; f < t.F; ++f) {  // channels past 2
          float cr[4], ci[4], gr[4], gi[4];
          const CT* cp = coh + ((size_t)m * t.F + f) * 8 * t.rowsp + r;
          const float* gp = g + (size_t)f * 8 * t.rowsp + r;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            cr[k] = ld(cp + (size_t)k * t.rowsp);
            ci[k] = ld(cp + (size_t)(4 + k) * t.rowsp);
            gr[k] = __ldg(gp + (size_t)k * t.rowsp);
            gi[k] = __ldg(gp + (size_t)(4 + k) * t.rowsp);
          }
          grad_channel(cr, ci, gr, gi, pr, pi, qr, qi, djp_r, djp_i, djq_r,
                       djq_i);
        }
        float* cw = contrib + (size_t)mloc * kItems * 8;
        float4* cp = reinterpret_cast<float4*>(cw + (size_t)pp * 8);
        cp[0] = make_float4(djp_r[0], djp_r[1], djp_r[2], djp_r[3]);
        cp[1] = make_float4(djp_i[0], djp_i[1], djp_i[2], djp_i[3]);
        float4* cq = reinterpret_cast<float4*>(cw + (size_t)pq * 8);
        cq[0] = make_float4(djq_r[0], djq_r[1], djq_r[2], djq_r[3]);
        cq[1] = make_float4(djq_i[0], djq_i[1], djq_i[2], djq_i[3]);
      }
      __syncwarp();  // the warp is done with slot i before it is refilled
    }
    __syncthreads();  // the tile's contributions and segment starts
    for (int idx = 4 * warp + kq; idx < ng * nk; idx += kThreads / 8) {
      const int ml = idx / nk, kk = idx - ml * nk;
      const int* sg = seg + (nc > 1 ? ml : 0) * (kz + 1);
      const float* cb = contrib + (size_t)ml * kItems * 8 + j;
      const int s1 = sg[kk + 1];
      float v = 0.f;
#pragma unroll 8
      for (int p = sg[kk]; p < s1; ++p) v += cb[p * 8];  // loads in flight
      acc[((size_t)ml * kz + kk) * 8 + j] += v;
    }
    __syncthreads();  // before the next tile's contributions
  }

  cp_async_wait<0>();
  // the slice of the group's sums to this block's partial table,
  // coalesced along the keys
  const size_t tabsz = (size_t)t.mp * nc * npad;  // one component plane
  float* part =
      partial + ((size_t)lane_b * gridDim.x + blockIdx.x) * 8 * tabsz;
  const size_t nout = (size_t)ng * nk * 8;
  for (size_t e = tid; e < nout; e += kThreads) {
    const size_t kk = e % nk;  // key - k0
    const size_t q = e / nk;   // j ng + mloc
    const int jj = (int)(q / ng), ml = (int)(q % ng);
    part[jj * tabsz + (size_t)(m0 + ml) * K + k0 + kk] =
        acc[((size_t)ml * kz + kk) * 8 + jj];
  }
}

// Kernel #1, the fused predict forward: the model V(f, r) of every row
// and channel, stored as the 8 planes of (F, 8, rowsp), coalesced along
// rows.  Reads the coherency stack once.
template <typename CT>
__global__ void __launch_bounds__(kThreads)
fused_predict_fwd_kernel(Tile t, const CT* __restrict__ coh,
                         float* __restrict__ out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= t.rowsp) return;
  const int ap = t.ant_p[r], aq = t.ant_q[r];
  for (int f = 0; f < t.F; ++f) {
    float vr[4], vi[4];
    model_row(coh, t, f, r, ap, aq, vr, vi);
    float* o = out + (size_t)f * 8 * t.rowsp + r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[(size_t)k * t.rowsp] = vr[k];
      o[(size_t)(4 + k) * t.rowsp] = vi[k];
    }
  }
}

// Per lane b (grid y): sum over blocks k (in order) of partial[b][k][e],
// e = (j, row, station) of the lane's (8, mrows, npad) table, written to
// out (8, lanes * mrows, npad) at component j, row b * mrows + row.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partial, int nblocks,
                    size_t tabsz, float* __restrict__ out) {
  const size_t n = 8 * tabsz;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const size_t b = blockIdx.y;
  const float* p = partial + b * nblocks * n + e;
  float acc = 0.f;
  for (int k = 0; k < nblocks; ++k) acc += p[(size_t)k * n];
  out[((e / tabsz) * gridDim.y + b) * tabsz + e % tabsz] = acc;
}

Tile make_tile(const float* tab_re, const float* tab_im, const int* ant_p,
               const int* ant_q, const int* cmap, const float* vis,
               const float* mask, int mp, int nc, int npad, int F,
               int rowsp, int lanes) {
  Tile t;
  t.tab_re = tab_re;
  t.tab_im = tab_im;
  t.ant_p = ant_p;
  t.ant_q = ant_q;
  t.cmap = cmap;
  t.vis = vis;
  t.mask = mask;
  t.mp = mp;
  t.nc = nc;
  t.npad = npad;
  t.F = F;
  t.rowsp = rowsp;
  t.lanes = lanes;
  t.plane = (size_t)lanes * mp * nc * npad;
  return t;
}

template <bool kBatched>
int launch_fwd(const Tile& t, const void* coh, int coh_bf16, const float* nu,
               int robust, float* partial, void* stream) {
  if (t.lanes < 1 || t.lanes > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((t.rowsp + kThreads - 1) / kThreads, t.lanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (coh_bf16)
    fused_cost_fwd_kernel<__nv_bfloat16, kBatched><<<grid, kThreads, 0, st>>>(
        t, static_cast<const __nv_bfloat16*>(coh), nu, robust, partial);
  else
    fused_cost_fwd_kernel<float, kBatched><<<grid, kThreads, 0, st>>>(
        t, static_cast<const float*>(coh), nu, robust, partial);
  return (int)cudaGetLastError();
}

// out = the lanes' partial tables (nblocks per lane) summed in order
int launch_sum_partials(const Tile& t, const float* partial, int nblocks,
                        float* out, cudaStream_t st) {
  const size_t tabsz = (size_t)t.mp * t.nc * t.npad;
  const dim3 grid((unsigned)((8 * tabsz + kThreads - 1) / kThreads), t.lanes);
  sum_partials_kernel<<<grid, kThreads, 0, st>>>(partial, nblocks, tabsz,
                                                 out);
  return (int)cudaGetLastError();
}

int launch_predict_fwd(const Tile& t, const void* coh, int coh_bf16,
                       float* out, void* stream) {
  const dim3 grid((t.rowsp + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (coh_bf16)
    fused_predict_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        t, static_cast<const __nv_bfloat16*>(coh), out);
  else
    fused_predict_fwd_kernel<float><<<grid, kThreads, 0, st>>>(
        t, static_cast<const float*>(coh), out);
  return (int)cudaGetLastError();
}

// The backwards' launches.  kGradSmemTarget: two gradient blocks an SM
// (228 KB less 1 KB a block).
constexpr size_t kGradSmemTarget = 113 * 1024;
constexpr size_t kSmemMax = 232448;

// The gradient kernel's clusters per block (gc) and keys per block (kz):
// up to kClustersPerBlock clusters with their gains and sums staged (kz =
// K = nc * npad) while that fits; else one cluster and K split into the
// fewest even slices whose sums fit in kGradSmemTarget, gains read from
// the tables.
void grad_shape(const Tile& t, int csize, int* gc, int* kz) {
  const int K = t.nc * t.npad;
  int c = kClustersPerBlock < t.mp ? kClustersPerBlock : t.mp;
  while (c > 1 && grad_smem_bytes(c, t.nc, K, K, csize) > kGradSmemTarget)
    --c;
  *gc = c;
  *kz = K;
  if (grad_smem_bytes(c, t.nc, K, K, csize) <= kSmemMax) return;
  *gc = 1;
  const size_t fixed = grad_smem_bytes(1, t.nc, K, 0, csize);
  const int fit = (int)((kGradSmemTarget - fixed) / (8 * sizeof(float) +
                                                     sizeof(int)));
  const int nz = (K + fit - 1) / fit;
  *kz = (K + nz - 1) / nz;
}

// A kernel's dynamic shared memory: up to smem bytes, from the largest
// carveout, so that as many blocks as fit share an SM.
template <typename Kernel>
int smem_attributes(Kernel kernel, size_t smem) {
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

int grad_tables(int rowsp) {
  const int ntiles = (rowsp + kThreads - 1) / kThreads;
  return (ntiles + kTilesPerBlock - 1) / kTilesPerBlock;
}

// Whether the stack takes the 16-byte cp.async copies (stage_coh's vec):
// rowsp a multiple of 16 bytes' worth of CT and an aligned stack.  Every
// cluster and lane then starts aligned too.
template <typename CT>
int coh_vec(const CT* coh, int rowsp) {
  return rowsp % (16 / (int)sizeof(CT)) == 0 &&
         reinterpret_cast<uintptr_t>(coh) % 16 == 0;
}

// The gradient kernel (stages & 2: the lanes' partial tables from g and
// the stack) and the sum (stages & 4: out), shared by #4, #6 and #2.
template <typename CT, bool kBatched>
int launch_grad_sum(const Tile& t, const CT* coh, const float* g,
                    const GradPlan& plan, int stages, float* partial,
                    float* out, cudaStream_t st) {
  const int ntables = grad_tables(t.rowsp);
  if (stages & 2) {
    int gc, kz;
    grad_shape(t, sizeof(CT), &gc, &kz);
    const int K = t.nc * t.npad, nz = (K + kz - 1) / kz;
    const size_t smem = grad_smem_bytes(gc, t.nc, K, kz, sizeof(CT));
    int err = smem_attributes(fused_cost_grad_kernel<CT, kBatched>, smem);
    if (err) return err;
    const dim3 grid(ntables, (t.mp + gc - 1) / gc * nz, t.lanes);
    fused_cost_grad_kernel<CT, kBatched><<<grid, kThreads, smem, st>>>(
        t, coh, g, plan, gc, kz, coh_vec(coh, t.rowsp), partial);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (stages & 4) return launch_sum_partials(t, partial, ntables, out, st);
  return 0;
}

// Kernels #4 (solo) and #6 (kBatched, t.lanes lanes): the cotangent
// kernel (stages & 1) writes g, then the gradient and the sum.
template <typename CT, bool kBatched>
int launch_cost_bwd(const Tile& t, const CT* coh, const float* nu,
                    int robust, const GradPlan& plan, int stages, float* g,
                    float* partial, float* out, cudaStream_t st) {
  if (t.lanes < 1 || t.lanes > 65535) return (int)cudaErrorInvalidValue;
  if (stages & 1) {
    const size_t smem =
        (size_t)kCotStages * kRegPlanes * kThreads * sizeof(CT);
    int err = smem_attributes(fused_cost_cot_kernel<CT, kBatched>, smem);
    if (err) return err;
    const dim3 grid((t.rowsp + kThreads - 1) / kThreads, t.lanes);
    fused_cost_cot_kernel<CT, kBatched><<<grid, kThreads, smem, st>>>(
        t, coh, nu, robust, coh_vec(coh, t.rowsp), g);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_grad_sum<CT, kBatched>(t, coh, g, plan, stages, partial, out,
                                       st);
}

template <bool kBatched>
int cost_bwd(const Tile& t, const void* coh, int coh_bf16, const float* nu,
             int robust, const GradPlan& plan, int stages, float* g,
             float* partial, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return coh_bf16
             ? launch_cost_bwd<__nv_bfloat16, kBatched>(
                   t, static_cast<const __nv_bfloat16*>(coh), nu, robust,
                   plan, stages, g, partial, out, st)
             : launch_cost_bwd<float, kBatched>(
                   t, static_cast<const float*>(coh), nu, robust, plan,
                   stages, g, partial, out, st);
}

GradPlan make_plan(const int* pos, const int* seg, const int* of_cluster,
                   int rowsp) {
  return GradPlan{pos, seg, of_cluster, (rowsp + kThreads - 1) / kThreads};
}

}  // namespace

extern "C" {

// Number of blocks (= forward partial sums).
int fused_cost_num_blocks(int rowsp) {
  return (rowsp + kThreads - 1) / kThreads;
}

// Forward (kernel #3): partial (num_blocks,) f32.  Returns
// cudaGetLastError().
int fused_cost_fwd(const float* tab_re, const float* tab_im, const void* coh,
                   int coh_bf16, const int* ant_p, const int* ant_q,
                   const int* cmap, const float* vis, const float* mask,
                   const float* nu, int mp, int nc, int npad, int F,
                   int rowsp, int robust, float* partial, void* stream) {
  const Tile t = make_tile(tab_re, tab_im, ant_p, ant_q, cmap, vis, mask, mp,
                           nc, npad, F, rowsp, 1);
  return launch_fwd<false>(t, coh, coh_bf16, nu, robust, partial, stream);
}

// Backward (kernel #4): the cotangent kernel (stages & 1) writes g
// (F, 8, rowsp); the gradient kernel (stages & 2) writes partial
// (fused_cost_bwd_num_tables(rowsp), 8, mp*nc, npad); the sum (stages &
// 4) writes out (8, mp*nc, npad) = [d tab_re (4 planes); d tab_im (4
// planes)].  plan_*: the station plan of these rows (GradPlan above;
// plan_of read when nc > 1).  Returns the first non-zero CUDA error.
int fused_cost_bwd(const float* tab_re, const float* tab_im, const void* coh,
                   int coh_bf16, const int* ant_p, const int* ant_q,
                   const int* cmap, const float* vis, const float* mask,
                   const float* nu, int mp, int nc, int npad, int F,
                   int rowsp, int robust, const int* plan_pos,
                   const int* plan_seg, const int* plan_of, int stages,
                   float* g, float* partial, float* out, void* stream) {
  const Tile t = make_tile(tab_re, tab_im, ant_p, ant_q, cmap, vis, mask, mp,
                           nc, npad, F, rowsp, 1);
  return cost_bwd<false>(t, coh, coh_bf16, nu, robust,
                         make_plan(plan_pos, plan_seg, plan_of, rowsp),
                         stages, g, partial, out, stream);
}

// Number of partial tables of a backward, per lane (one per
// kTilesPerBlock row tiles).
int fused_cost_bwd_num_tables(int rowsp) { return grad_tables(rowsp); }

// Batched forward over B lanes (kernel #5, nc = 1): partial
// (B, num_blocks) f32.
int fused_cost_batch_fwd(const float* tab_re, const float* tab_im,
                         const void* coh, int coh_bf16, const int* ant_p,
                         const int* ant_q, const float* vis,
                         const float* mask, const float* nu, int lanes,
                         int mp, int npad, int F, int rowsp, int robust,
                         float* partial, void* stream) {
  const Tile t = make_tile(tab_re, tab_im, ant_p, ant_q, nullptr, vis, mask,
                           mp, 1, npad, F, rowsp, lanes);
  return launch_fwd<true>(t, coh, coh_bf16, nu, robust, partial, stream);
}

// Batched backward (kernel #6, nc = 1): as fused_cost_bwd per lane, with
// g (B, F, 8, rowsp), partial (B, fused_cost_bwd_num_tables(rowsp), 8,
// mp, npad) and out (8, B*mp, npad), each lane's d cost_b / d tables on
// its own rows.  One station plan (plan_pos, plan_seg) for every lane:
// the lanes share ant_p/ant_q.  cudaErrorInvalidValue for lanes outside
// 1..65535.
int fused_cost_batch_bwd(const float* tab_re, const float* tab_im,
                         const void* coh, int coh_bf16, const int* ant_p,
                         const int* ant_q, const float* vis,
                         const float* mask, const float* nu, int lanes,
                         int mp, int npad, int F, int rowsp, int robust,
                         const int* plan_pos, const int* plan_seg,
                         int stages, float* g, float* partial, float* out,
                         void* stream) {
  const Tile t = make_tile(tab_re, tab_im, ant_p, ant_q, nullptr, vis, mask,
                           mp, 1, npad, F, rowsp, lanes);
  return cost_bwd<true>(t, coh, coh_bf16, nu, robust,
                        make_plan(plan_pos, plan_seg, nullptr, rowsp),
                        stages, g, partial, out, stream);
}

// Predict forward (kernel #1): out (F, 8, rowsp) f32, the model of every
// row and channel.  Returns cudaGetLastError().
int fused_predict_fwd(const float* tab_re, const float* tab_im,
                      const void* coh, int coh_bf16, const int* ant_p,
                      const int* ant_q, const int* cmap, int mp, int nc,
                      int npad, int F, int rowsp, float* out, void* stream) {
  const Tile t = make_tile(tab_re, tab_im, ant_p, ant_q, cmap, nullptr,
                           nullptr, mp, nc, npad, F, rowsp, 1);
  return launch_predict_fwd(t, coh, coh_bf16, out, stream);
}

// Predict backward (kernel #2): the gradient kernel (stages & 2) on the
// upstream model cotangent g (F, 8, rowsp) f32 writes partial
// (fused_cost_bwd_num_tables(rowsp), 8, mp*nc, npad); the sum (stages &
// 4) writes out (8, mp*nc, npad) = [d tab_re (4 planes); d tab_im (4
// planes)].  plan_* as for fused_cost_bwd.  Returns the first non-zero
// CUDA error.
int fused_predict_bwd(const float* tab_re, const float* tab_im,
                      const void* coh, int coh_bf16, const int* ant_p,
                      const int* ant_q, const int* cmap, const float* g,
                      int mp, int nc, int npad, int F, int rowsp,
                      const int* plan_pos, const int* plan_seg,
                      const int* plan_of, int stages, float* partial,
                      float* out, void* stream) {
  const Tile t = make_tile(tab_re, tab_im, ant_p, ant_q, cmap, nullptr,
                           nullptr, mp, nc, npad, F, rowsp, 1);
  const GradPlan plan = make_plan(plan_pos, plan_seg, plan_of, rowsp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return coh_bf16 ? launch_grad_sum<__nv_bfloat16, false>(
                        t, static_cast<const __nv_bfloat16*>(coh), g, plan,
                        stages, partial, out, st)
                  : launch_grad_sum<float, false>(
                        t, static_cast<const float*>(coh), g, plan, stages,
                        partial, out, st);
}

}  // extern "C"
