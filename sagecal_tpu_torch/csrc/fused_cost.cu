// Fused calibration objective for NVIDIA Hopper (sm_90a): forward and
// backward of the joint-LBFGS cost, hand-written CUDA with a plain C
// interface (loaded with ctypes by sagecal_tpu_torch/kernels/build.py).
//
// Replaces the Pallas kernels of sagecal_tpu/ops/rime_kernel.py:
//   forward  _fused_cost_fwd_impl (:842; bodies _obj_fwd_kernel :768,
//            _obj_fwd_kernel_hybrid :779, _obj_partial :738)
//   backward _fused_cost_bwd_impl (:877; bodies _obj_bwd_kernel :815,
//            _obj_bwd_kernel_hybrid :828, _g_from_residual :791,
//            _bwd_accumulate :305, _bwd_store :359)
//
// What they compute, per row r and channel f of one tile:
//   V(f,r) = sum_m Jp_m C_m(f,r) Jq_m^H          (gains of row r's stations)
//   d      = (vis(f,r) - V(f,r)) * mask(f,r)       (4 complex components)
//   cost   = sum |d|^2   (Gaussian)  or  sum log1p(|d|^2 / nu)  (robust)
// and the backward gives d(cost)/d(tab_re, tab_im) for the component-major
// gain tables tab[k][m*nc + c][station] (k = row-major 2x2 component).
// The upstream scalar cotangent is applied by the caller.
//
// Layouts (the JAX package's packed layouts, padding optional):
//   tab_re/tab_im (4, mp*nc, npad) f32; coh (mp, F, 8, rowsp) f32 or bf16,
//   component axis [re XX, re XY, re YX, re YY, im XX, ..., im YY];
//   ant_p/ant_q (rowsp,) int32; cmap (mp, rowsp) int32 (nc > 1 only);
//   vis (F, 8, rowsp) f32; mask (F, rowsp) f32; nu (1,) f32 on the device.
//
// Design.  One thread per row, 256 rows per block.  Each thread reads its
// row's station indices (and chunk index when nc > 1) and loads Jp, Jq
// straight from the tables by index: exact f32, no one-hot selection
// matmul (the TPU kernel's _sel_dot existed only for the MXU) and no
// TF32 anywhere.  Coherency planes are read coalesced along rows and
// bf16 is upcast at the load.  Ragged edges (rows past rowsp) are masked
// here; no tile, cluster or station padding is required.
//
// Forward: each block writes one partial sum (fixed-order tree reduction
// in shared memory); the caller sums the (n_blocks,) partials.
//
// Backward, deterministic with no floating-point atomics: phase 1
// re-forms V and the model cotangent g = -2 mask d (Gaussian) or
// -2 mask d / (nu + |d|^2) (robust) per row into shared memory; phase 2
// loops over clusters again, forms each row's dJp and dJq (summed over
// channels), and combines the block's rows per (chunk, station) in a
// fixed order — rows are sorted by station once per block (a stable
// counting sort of the 2*256 (row, role) keys) — into a per-block
// partial table.  A second kernel sums the partial tables over blocks in
// block order.  Two calls on the same inputs give bit-identical tables.
//
// Bound on the H100 (80 GB HBM3 at 3.35 TB/s, 67 TFLOP/s f32 non-tensor):
// bytes.  At the north-star tile (62 stations, 100 clusters, 60 x 2)
// the coherency stack is 100 x 2 x 8 x 113,460 x 4 B = 726 MB in f32,
// ~0.22 ms a pass, against ~2.7 GFLOP (forward) = 0.04 ms.  The forward
// reads the stack once.  Known cost of this simple design: the backward
// reads it twice (phase 1 and phase 2), because the cluster axis does
// not fit in a row's registers the way it fitted in the TPU's VMEM; the
// gain tables are gathered per (row, cluster) from L1/L2.  Shared-memory
// staging, splitting the cluster axis and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // rows per block, both kernels

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
};

// Gains of (cluster-chunk row `mrow`, station `st`): 4 components re/im.
__device__ __forceinline__ void load_gain(const Tile& t, int mrow, int st,
                                          float re[4], float im[4]) {
  const size_t plane = (size_t)t.mp * t.nc * t.npad;
  const size_t off = (size_t)mrow * t.npad + st;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    re[k] = ld(t.tab_re + k * plane + off);
    im[k] = ld(t.tab_im + k * plane + off);
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

template <typename CT>
__global__ void __launch_bounds__(kThreads)
fused_cost_fwd_kernel(Tile t, const CT* __restrict__ coh,
                      const float* __restrict__ nu_ptr, int robust,
                      float* __restrict__ partial) {
  __shared__ float red[kThreads];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  float part = 0.f;
  if (r < t.rowsp) {
    const int ap = t.ant_p[r], aq = t.ant_q[r];
    const float nu = robust ? *nu_ptr : 1.f;
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
  if (threadIdx.x == 0) partial[blockIdx.x] = red[0];
}

// Dynamic shared-memory layout of the backward kernel (floats then ints).
struct BwdSmem {
  float* g;        // (F*8, T) model cotangent of the block's rows
  float* contrib;  // (2, 8, T) this cluster's dJp (role 0) / dJq (role 1)
  int* keys;       // (2T,) station of each (role, row) item; npad = none
  int* order;      // (2T,) items sorted by station (stable)
  int* seg;        // (npad + 2,) segment starts per station
  int* cm;         // (T,) chunk index of each row for the current cluster
};

__host__ __device__ inline size_t bwd_smem_bytes(int F, int npad) {
  return sizeof(float) * ((size_t)F * 8 * kThreads + 2 * 8 * kThreads) +
         sizeof(int) * (4 * kThreads + (size_t)(npad + 2) + kThreads);
}

template <typename CT>
__global__ void __launch_bounds__(kThreads)
fused_cost_bwd_kernel(Tile t, const CT* __restrict__ coh,
                      const float* __restrict__ nu_ptr, int robust,
                      float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int T = kThreads;
  BwdSmem s;
  s.g = smem;
  s.contrib = s.g + (size_t)t.F * 8 * T;
  s.keys = reinterpret_cast<int*>(s.contrib + 2 * 8 * T);
  s.order = s.keys + 2 * T;
  s.seg = s.order + 2 * T;
  s.cm = s.seg + (t.npad + 2);

  const int tid = threadIdx.x;
  const int r = blockIdx.x * T + tid;
  const bool valid = r < t.rowsp;
  const int ap = valid ? t.ant_p[r] : 0;
  const int aq = valid ? t.ant_q[r] : 0;

  // ---- phase 1: model cotangent g of this row, every channel
  const float nu = robust ? *nu_ptr : 1.f;
  for (int f = 0; f < t.F; ++f) {
    float gr[4] = {0.f, 0.f, 0.f, 0.f}, gi[4] = {0.f, 0.f, 0.f, 0.f};
    if (valid) {
      float vr[4], vi[4];
      model_row(coh, t, f, r, ap, aq, vr, vi);
      const float msk = t.mask[(size_t)f * t.rowsp + r];
      const float* vis = t.vis + (size_t)f * 8 * t.rowsp + r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float dr = (vis[(size_t)k * t.rowsp] - vr[k]) * msk;
        const float di = (vis[(size_t)(4 + k) * t.rowsp] - vi[k]) * msk;
        const float w = robust ? 2.f / (nu + dr * dr + di * di) : 2.f;
        gr[k] = -w * msk * dr;
        gi[k] = -w * msk * di;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s.g[(f * 8 + k) * T + tid] = gr[k];
      s.g[(f * 8 + 4 + k) * T + tid] = gi[k];
    }
  }

  // ---- stable counting sort of the block's (role, row) items by station
  for (int i = tid; i < 2 * T; i += T) {
    const int role = i / T, tt = i % T, rr = blockIdx.x * T + tt;
    s.keys[i] = rr < t.rowsp ? (role == 0 ? t.ant_p[rr] : t.ant_q[rr])
                             : t.npad;
  }
  __syncthreads();
  for (int st = tid; st <= t.npad; st += T) {
    int cnt = 0;
    for (int i = 0; i < 2 * T; ++i) cnt += s.keys[i] == st;
    s.seg[st + 1] = cnt;  // counts, prefix-summed below
  }
  __syncthreads();
  if (tid == 0) {
    s.seg[0] = 0;
    for (int st = 0; st <= t.npad; ++st) s.seg[st + 1] += s.seg[st];
  }
  __syncthreads();
  for (int i = tid; i < 2 * T; i += T) {
    const int key = s.keys[i];
    int rank = 0;
    for (int j = 0; j < i; ++j) rank += s.keys[j] == key;
    s.order[s.seg[key] + rank] = i;
  }
  __syncthreads();

  // ---- phase 2: per cluster, per-row dJp / dJq, combined per station
  const size_t mrows = (size_t)t.mp * t.nc;
  const size_t tabsz = mrows * t.npad;  // one component plane
  float* part_b = partial + (size_t)blockIdx.x * 8 * tabsz;
  for (int m = 0; m < t.mp; ++m) {
    float djp_r[4] = {0.f, 0.f, 0.f, 0.f}, djp_i[4] = {0.f, 0.f, 0.f, 0.f};
    float djq_r[4] = {0.f, 0.f, 0.f, 0.f}, djq_i[4] = {0.f, 0.f, 0.f, 0.f};
    int c = 0;
    if (valid) {
      const int mrow = chunk_row(t, m, r);
      c = mrow - m * t.nc;
      float pr[4], pi[4], qr[4], qi[4];
      load_gain(t, mrow, ap, pr, pi);
      load_gain(t, mrow, aq, qr, qi);
      for (int f = 0; f < t.F; ++f) {
        float cr[4], ci[4], ar[4], ai[4], gr[4], gi[4];
        load_coh(coh, t, m, f, r, cr, ci);
        cjqh(cr, ci, qr, qi, ar, ai);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          gr[k] = s.g[(f * 8 + k) * T + tid];
          gi[k] = s.g[(f * 8 + 4 + k) * T + tid];
        }
        // dJp_ia += sum_j g_ij conj(A_aj)
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
        // dA_aj = sum_i conj(Jp_ia) g_ij ; dJq_jb += sum_a conj(dA_aj) C_ab
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
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s.contrib[(0 * 8 + k) * T + tid] = djp_r[k];
      s.contrib[(0 * 8 + 4 + k) * T + tid] = djp_i[k];
      s.contrib[(1 * 8 + k) * T + tid] = djq_r[k];
      s.contrib[(1 * 8 + 4 + k) * T + tid] = djq_i[k];
    }
    s.cm[tid] = c;
    __syncthreads();
    // one task per (component j, chunk c, station st): sum the station's
    // items in sorted (= row, then role) order; write every table entry
    const int ntask = 8 * t.nc * t.npad;
    for (int task = tid; task < ntask; task += T) {
      const int st = task % t.npad;
      const int cc = (task / t.npad) % t.nc;
      const int j = task / (t.npad * t.nc);
      float acc = 0.f;
      for (int pos = s.seg[st]; pos < s.seg[st + 1]; ++pos) {
        const int item = s.order[pos];
        const int tt = item % T;
        if (t.nc == 1 || s.cm[tt] == cc)
          acc += s.contrib[((item / T) * 8 + j) * T + tt];
      }
      part_b[(size_t)j * tabsz + ((size_t)m * t.nc + cc) * t.npad + st] = acc;
    }
    __syncthreads();
  }
}

// out[e] = sum over blocks b (in order) of partial[b][e].
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partial, int nblocks,
                    size_t n, float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int b = 0; b < nblocks; ++b) acc += partial[(size_t)b * n + e];
  out[e] = acc;
}

Tile make_tile(const float* tab_re, const float* tab_im, const int* ant_p,
               const int* ant_q, const int* cmap, const float* vis,
               const float* mask, int mp, int nc, int npad, int F,
               int rowsp) {
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
  return t;
}

}  // namespace

extern "C" {

// Number of blocks (= forward partial sums, = backward partial tables).
int fused_cost_num_blocks(int rowsp) {
  return (rowsp + kThreads - 1) / kThreads;
}

// Forward: partial (num_blocks,) f32.  Returns cudaGetLastError().
int fused_cost_fwd(const float* tab_re, const float* tab_im, const void* coh,
                   int coh_bf16, const int* ant_p, const int* ant_q,
                   const int* cmap, const float* vis, const float* mask,
                   const float* nu, int mp, int nc, int npad, int F,
                   int rowsp, int robust, float* partial, void* stream) {
  const Tile t = make_tile(tab_re, tab_im, ant_p, ant_q, cmap, vis, mask, mp,
                           nc, npad, F, rowsp);
  const dim3 grid(fused_cost_num_blocks(rowsp));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (coh_bf16)
    fused_cost_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        t, static_cast<const __nv_bfloat16*>(coh), nu, robust, partial);
  else
    fused_cost_fwd_kernel<float><<<grid, kThreads, 0, st>>>(
        t, static_cast<const float*>(coh), nu, robust, partial);
  return (int)cudaGetLastError();
}

// Backward: partial (num_blocks, 8, mp*nc, npad) scratch, out
// (8, mp*nc, npad) = [d tab_re (4 planes); d tab_im (4 planes)].
// Returns the first non-zero cudaGetLastError().
int fused_cost_bwd(const float* tab_re, const float* tab_im, const void* coh,
                   int coh_bf16, const int* ant_p, const int* ant_q,
                   const int* cmap, const float* vis, const float* mask,
                   const float* nu, int mp, int nc, int npad, int F,
                   int rowsp, int robust, float* partial, float* out,
                   void* stream) {
  const Tile t = make_tile(tab_re, tab_im, ant_p, ant_q, cmap, vis, mask, mp,
                           nc, npad, F, rowsp);
  const int nblocks = fused_cost_num_blocks(rowsp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem_bytes(F, npad);
  int err;
  if (coh_bf16) {
    err = (int)cudaFuncSetAttribute(
        fused_cost_bwd_kernel<__nv_bfloat16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    fused_cost_bwd_kernel<__nv_bfloat16><<<nblocks, kThreads, smem, st>>>(
        t, static_cast<const __nv_bfloat16*>(coh), nu, robust, partial);
  } else {
    err = (int)cudaFuncSetAttribute(
        fused_cost_bwd_kernel<float>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    fused_cost_bwd_kernel<float><<<nblocks, kThreads, smem, st>>>(
        t, static_cast<const float*>(coh), nu, robust, partial);
  }
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t n = (size_t)8 * mp * nc * npad;
  const unsigned sum_blocks = (unsigned)((n + kThreads - 1) / kThreads);
  sum_partials_kernel<<<sum_blocks, kThreads, 0, st>>>(partial, nblocks, n,
                                                       out);
  return (int)cudaGetLastError();
}

}  // extern "C"
