"""Fused calibration objective: CUDA kernel pair, plain version, packing.

Counterpart of the fused-objective part of ``sagecal_tpu/ops/rime_kernel.py``
(``fused_cost_packed`` / ``fused_cost_packed_hybrid`` and their Pallas
kernels ``_fused_cost_fwd_impl`` :842 and ``_fused_cost_bwd_impl`` :877).

The objective, for one tile in the packed-real layout::

    V(f, r) = sum_m Jp_m C_m(f, r) Jq_m^H,   d = (vis - V) * mask
    cost    = sum |d|^2                 (Gaussian, nu None)
            = sum log1p(|d|^2 / nu)     (Student's-t, nu given)

differentiable with respect to the gain tables only (the coherencies,
visibilities and mask are constants of the solve).

- :func:`fused_cost_packed` / :func:`fused_cost_packed_hybrid` are the
  wrappers.  On CUDA tensors they launch the hand-written kernels of
  ``csrc/fused_cost.cu`` through :class:`_FusedCost` (forward kernel;
  the backward kernel gives d cost / d tables, scaled here by the
  upstream scalar) — or raise.  On CPU tensors, and only then, they use
  the plain version.
- :func:`fused_cost_packed_plain` is the plain PyTorch version of the
  same function (gains gathered with ``index_select``, differentiated by
  autograd); the CPU tests and ``chip_smoke.py`` hold the kernels
  against it.
- :func:`fused_cost_fwd_cuda` / :func:`fused_cost_bwd_cuda` launch the
  kernels; each counts its launches in a ``launches`` attribute.

Layouts are the JAX package's, with the TPU paddings made parameters
(default: none): tables ``(4, mp*nc, npad)`` component-major f32,
coherencies ``(mp, F, 8, rowsp)`` f32 or bf16 (re XX..YY then im XX..YY),
``ant_p``/``ant_q`` ``(1, rowsp)`` int32, ``cmap`` ``(mp, rowsp)``
int32, ``vis_ri`` ``(F, 8, rowsp)`` f32, ``mask_p`` ``(F, rowsp)`` f32.
The kernels mask their own ragged edges, so the TPU's 128-station cap,
cluster padding to 8, row tiles and row chunking are gone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tfn

# ------------------------------------------------------------- packing


def pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def pack_gain_tables(jones, mp: int, npad=None):
    """(M, N, 2, 2) — or (M, nc, N, 2, 2) hybrid — complex Jones ->
    component-major (tab_re, tab_im), each (4, mp*nc, npad) f32: plane k
    holds component k (row-major [J00, J01, J10, J11]) for every
    (cluster, chunk) row ``m*nc + c``.  ``npad`` defaults to N (no
    station padding).  Differentiable."""
    if jones.ndim == 5:
        M, nc, N = jones.shape[0], jones.shape[1], jones.shape[2]
    else:
        M, nc, N = jones.shape[0], 1, jones.shape[1]
    npad = N if npad is None else npad
    flat = jones.reshape(M * nc, N, 4)  # row-major J00, J01, J10, J11
    tab = flat.permute(2, 0, 1)  # (4, M*nc, N)
    pads = (0, npad - N, 0, nc * (mp - M))
    return (tfn.pad(tab.real, pads).float().contiguous(),
            tfn.pad(tab.imag, pads).float().contiguous())


def pack_predict_inputs(vis, mask, coh, ant_p, ant_q, chunk_map=None,
                        row_pad: int = 1, cluster_pad: int = 1):
    """Pack complex (F, 4, rows) visibilities, (M, F, 4, rows)
    coherencies, the (F, rows) mask and station indices into the kernel
    layout: rows padded to a multiple of ``row_pad``, clusters to a
    multiple of ``cluster_pad`` (both 1 = no padding), re/im stacked on
    the component axis, station indices (1, rowsp) int32.  Padded rows
    and clusters carry zero coherency and zero mask.  Returns
    (vis_ri, mask_p, coh_ri, antp, antq, cmap_or_None)."""
    M, rows = coh.shape[0], coh.shape[-1]
    mp = pad_to(M, cluster_pad)
    pad_r = pad_to(rows, row_pad) - rows
    coh_ri = torch.cat([coh.real, coh.imag], dim=-2).float()
    coh_ri = tfn.pad(coh_ri, (0, pad_r, 0, 0, 0, 0, 0, mp - M))
    vis_ri = tfn.pad(torch.cat([vis.real, vis.imag], dim=-2).float(),
                     (0, pad_r))
    mask_p = tfn.pad(mask.float(), (0, pad_r))
    antp = tfn.pad(ant_p.to(torch.int32)[None, :], (0, pad_r))
    antq = tfn.pad(ant_q.to(torch.int32)[None, :], (0, pad_r))
    cmap = None
    if chunk_map is not None:
        cmap = tfn.pad(chunk_map.to(torch.int32), (0, pad_r, 0, mp - M))
    return (vis_ri.contiguous(), mask_p.contiguous(), coh_ri.contiguous(),
            antp.contiguous(), antq.contiguous(),
            None if cmap is None else cmap.contiguous())


def unpack_gain_grads(dre, dim, M: int, N: int):
    """Inverse of :func:`pack_gain_tables` for cotangents (nc = 1):
    (4, mp, npad) pair -> (M, N, 2, 2) re / im pair."""
    dre = dre[:, :M, :N].permute(1, 2, 0).reshape(M, N, 2, 2)
    dim = dim[:, :M, :N].permute(1, 2, 0).reshape(M, N, 2, 2)
    return dre, dim


# --------------------------------------------------------- plain version


def _nu_cell(nu, device) -> torch.Tensor:
    """nu as a (1,) f32 tensor on ``device`` (a tensor stays on the
    device: no host sync).  Gaussian (None) gives 1.0, never read."""
    if nu is None:
        return torch.ones((1,), dtype=torch.float32, device=device)
    return torch.as_tensor(nu, device=device).to(torch.float32).reshape(1)


def fused_cost_packed_plain(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri,
                            mask_p, nu=None, cmap=None, nc: int = 1):
    """The plain PyTorch version of the fused objective (module doc):
    same inputs as the kernels (``cmap``/``nc`` for hybrid chunks), gains
    gathered with ``index_select``, differentiable by autograd."""
    mp, F, _, rowsp = coh_ri.shape
    npad = tab_re.shape[2]
    ap = ant_p.reshape(-1).long()
    aq = ant_q.reshape(-1).long()
    mrow = torch.arange(mp, device=ap.device)[:, None] * nc
    if cmap is not None and nc > 1:
        mrow = mrow + cmap.long()
    tab = torch.complex(tab_re, tab_im).reshape(4, -1)  # (4, mrows*npad)

    def gains(ant):
        idx = (mrow * npad + ant[None, :]).reshape(-1)
        g = tab.index_select(1, idx).reshape(4, mp, 1, rowsp)
        return g[0], g[1], g[2], g[3]  # (mp, 1, rowsp) each

    pa, pb, pc, pd = gains(ap)
    qa, qb, qc, qd = (x.conj() for x in gains(aq))
    c = coh_ri.float()
    C = torch.complex(c[:, :, :4], c[:, :, 4:])  # (mp, F, 4, rowsp)
    c00, c01, c10, c11 = C[:, :, 0], C[:, :, 1], C[:, :, 2], C[:, :, 3]
    a00 = c00 * qa + c01 * qb
    a01 = c00 * qc + c01 * qd
    a10 = c10 * qa + c11 * qb
    a11 = c10 * qc + c11 * qd
    V = torch.stack([
        (pa * a00 + pb * a10).sum(0), (pa * a01 + pb * a11).sum(0),
        (pc * a00 + pd * a10).sum(0), (pc * a01 + pd * a11).sum(0),
    ], dim=1)  # (F, 4, rowsp)
    vis = torch.complex(vis_ri[:, :4], vis_ri[:, 4:])
    d = (vis - V) * mask_p[:, None, :]
    e2 = d.real ** 2 + d.imag ** 2
    if nu is None:
        return e2.sum()
    return torch.log1p(e2 / _nu_cell(nu, e2.device)).sum()


# -------------------------------------------------------------- kernels


def _check_cuda_inputs(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                       nu_arr, cmap, nc):
    dev = tab_re.device
    if dev.type != "cuda":
        raise ValueError(f"fused cost kernels need CUDA tensors, got {dev}")
    mp, F, eight, rowsp = coh_ri.shape
    mrows, npad = mp * nc, tab_re.shape[2]
    want = {
        "tab_re": (tab_re, (4, mrows, npad), (torch.float32,)),
        "tab_im": (tab_im, (4, mrows, npad), (torch.float32,)),
        "coh_ri": (coh_ri, (mp, F, 8, rowsp), (torch.float32, torch.bfloat16)),
        "ant_p": (ant_p, (1, rowsp), (torch.int32,)),
        "ant_q": (ant_q, (1, rowsp), (torch.int32,)),
        "vis_ri": (vis_ri, (F, 8, rowsp), (torch.float32,)),
        "mask_p": (mask_p, (F, rowsp), (torch.float32,)),
        "nu": (nu_arr, (1,), (torch.float32,)),
    }
    if nc > 1:
        want["cmap"] = (cmap, (mp, rowsp), (torch.int32,))
    for name, (x, shape, dtypes) in want.items():
        if x is None:
            raise ValueError(f"fused cost kernels: {name} is required")
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, tables on {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} shape {tuple(x.shape)}, want {shape}")
        if x.dtype not in dtypes:
            raise ValueError(f"{name} dtype {x.dtype}, want one of {dtypes}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_args(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                 nu_arr, cmap, nc, robust):
    mp, F, _, rowsp = coh_ri.shape
    return [
        tab_re.data_ptr(), tab_im.data_ptr(), coh_ri.data_ptr(),
        int(coh_ri.dtype == torch.bfloat16), ant_p.data_ptr(),
        ant_q.data_ptr(), cmap.data_ptr() if nc > 1 else None,
        vis_ri.data_ptr(), mask_p.data_ptr(), nu_arr.data_ptr(),
        mp, nc, tab_re.shape[2], F, rowsp, int(robust),
    ]


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def fused_cost_fwd_cuda(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                        nu_arr, robust: bool, cmap=None, nc: int = 1):
    """Launch the forward kernel: (n_blocks,) f32 partial costs (their
    sum is the cost).  Replaces ``_fused_cost_fwd_impl``."""
    from sagecal_tpu_torch.kernels.build import load

    _check_cuda_inputs(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                       nu_arr, cmap, nc)
    lib = load("fused_cost")
    nb = lib.fused_cost_num_blocks(coh_ri.shape[3])
    partial = torch.empty((nb,), dtype=torch.float32, device=tab_re.device)
    args = _launch_args(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                        nu_arr, cmap, nc, robust)
    stream = torch.cuda.current_stream(tab_re.device).cuda_stream
    _raise_on(lib.fused_cost_fwd(*args, partial.data_ptr(), stream),
              "fused_cost_fwd")
    fused_cost_fwd_cuda.launches += 1
    return partial


def fused_cost_bwd_cuda(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                        nu_arr, robust: bool, cmap=None, nc: int = 1):
    """Launch the backward kernels: (d tab_re, d tab_im), each
    (4, mp*nc, npad), bit-identical on repeat.  Replaces
    ``_fused_cost_bwd_impl``."""
    from sagecal_tpu_torch.kernels.build import load

    _check_cuda_inputs(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                       nu_arr, cmap, nc)
    lib = load("fused_cost")
    nb = lib.fused_cost_num_blocks(coh_ri.shape[3])
    dev = tab_re.device
    n = 8 * tab_re.shape[1] * tab_re.shape[2]
    partial = torch.empty((nb * n,), dtype=torch.float32, device=dev)
    out = torch.empty((8,) + tuple(tab_re.shape[1:]), dtype=torch.float32,
                      device=dev)
    args = _launch_args(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                        nu_arr, cmap, nc, robust)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib.fused_cost_bwd(*args, partial.data_ptr(), out.data_ptr(),
                                 stream), "fused_cost_bwd")
    fused_cost_bwd_cuda.launches += 1
    return out[:4], out[4:]


fused_cost_fwd_cuda.launches = 0
fused_cost_bwd_cuda.launches = 0


class _FusedCost(torch.autograd.Function):
    """The fused objective on CUDA: forward and backward kernels."""

    @staticmethod
    def forward(ctx, tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                nu_arr, cmap, nc, robust):
        ctx.save_for_backward(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri,
                              mask_p, nu_arr, cmap)
        ctx.nc, ctx.robust = nc, robust
        return fused_cost_fwd_cuda(tab_re, tab_im, coh_ri, ant_p, ant_q,
                                   vis_ri, mask_p, nu_arr, robust, cmap,
                                   nc).sum()

    @staticmethod
    def backward(ctx, gbar):
        saved = ctx.saved_tensors
        dre, dim = fused_cost_bwd_cuda(*saved[:8], ctx.robust, saved[8],
                                       ctx.nc)
        # the kernel gives d cost / d tables; the upstream scalar is
        # applied here (one scalar-times-table op)
        return (gbar * dre, gbar * dim) + (None,) * 9


def _fused_cost(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p, nu,
                cmap, nc):
    if not tab_re.is_cuda:
        return fused_cost_packed_plain(tab_re, tab_im, coh_ri, ant_p, ant_q,
                                       vis_ri, mask_p, nu, cmap, nc)
    nu_arr = _nu_cell(nu, tab_re.device)
    return _FusedCost.apply(
        tab_re.contiguous(), tab_im.contiguous(), coh_ri, ant_p, ant_q,
        vis_ri, mask_p, nu_arr, cmap, nc, nu is not None)


def fused_cost_packed(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                      nu=None):
    """Scalar calibration objective (module doc), ``nu`` None for the
    Gaussian cost or a float / device scalar for the Student's-t cost.
    Differentiable with respect to ``tab_re``/``tab_im`` only."""
    return _fused_cost(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                       nu, None, 1)


def fused_cost_packed_hybrid(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri,
                             mask_p, cmap, nc, nu=None):
    """Hybrid-chunk (nc > 1) objective: tables carry one row per
    (cluster, chunk); ``cmap`` (mp, rowsp) selects each row's chunk."""
    return _fused_cost(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                       nu, cmap, nc)
