"""Fused RIME predict and calibration objective: CUDA kernels, plain
versions, packing.

Counterpart of ``sagecal_tpu/ops/rime_kernel.py``: the fused objective
(``fused_cost_packed`` / ``fused_cost_packed_hybrid`` and their Pallas
kernels ``_fused_cost_fwd_impl`` :842 and ``_fused_cost_bwd_impl`` :877),
the fused predict (``fused_predict_packed`` / ``_hybrid``, kernels
``_fused_predict_fwd_impl`` :265 and ``_fused_predict_bwd_impl`` :407;
its own section below) and the batched objective (last section).

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
  kernels; each counts its launches in a ``launches`` attribute.  Every
  launcher is observable without changing a launch: under
  ``SAGECAL_CHECKIFY`` it refuses out-of-range indices before launching
  (``obs/contracts.py``), with telemetry on it records its launch's work
  from shapes (``obs/perf.py::note_launch``), and while a device profile
  runs it launches inside a ``sagecal::#<row>`` annotation
  (``obs/devprof.py``); otherwise each is one flag check.  Every
  backward (#4, the predict's #2, the batched #6) takes the tile's
  :class:`BwdPlan`, the (role, row) -> station order of each row tile,
  which a caller builds once and passes to the wrappers (``plan=``); a
  plan refuses index tensors it was not built from.
- The fused predict V itself, as (F, 8, rowsp) planes, with its plain
  version (:func:`fused_predict_packed_plain`, sharing the RIME products
  of :func:`_model_plain` with the objective's) and launchers
  :func:`fused_predict_fwd_cuda` / :func:`fused_predict_bwd_cuda`; its
  backward takes the upstream model cotangent.
- The batched objective of B lanes (a serve bucket), its plain version,
  launchers and packing, counterparts of ``fused_cost_packed_batch`` and
  kernels ``_fused_cost_batch_fwd_impl`` :1250 /
  ``_fused_cost_batch_bwd_impl`` :1273, form the last section.

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

from sagecal_tpu_torch.kernels.work import (
    fused_cost_batch_shape_work, fused_cost_shape_work,
    fused_predict_shape_work,
)
from sagecal_tpu_torch.obs.contracts import check_indices, checkify_enabled
from sagecal_tpu_torch.obs.devprof import launch_annotation
from sagecal_tpu_torch.obs.perf import note_launch
from sagecal_tpu_torch.obs.registry import telemetry_enabled
from sagecal_tpu_torch.obs.trace import host_read

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


def _model_plain(tab_re, tab_im, coh_ri, ant_p, ant_q, cmap=None,
                 nc: int = 1):
    """The model V = sum_m Jp C_m Jq^H of the packed inputs, complex
    (F, 4, rowsp): the RIME products of both plain versions, gains
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

    return _model_from_gains(gains(ap), gains(aq), coh_ri)


def _model_from_gains(gp, gq, coh_ri):
    """sum_m Jp C_m Jq^H from each row's gathered gains: ``gp``/``gq``
    the four row-major components, each complex (mp, 1, rowsp); complex
    (F, 4, rowsp)."""
    pa, pb, pc, pd = gp
    qa, qb, qc, qd = (x.conj() for x in gq)
    c = coh_ri.float()
    C = torch.complex(c[:, :, :4], c[:, :, 4:])  # (mp, F, 4, rowsp)
    c00, c01, c10, c11 = C[:, :, 0], C[:, :, 1], C[:, :, 2], C[:, :, 3]
    a00 = c00 * qa + c01 * qb
    a01 = c00 * qc + c01 * qd
    a10 = c10 * qa + c11 * qb
    a11 = c10 * qc + c11 * qd
    return torch.stack([
        (pa * a00 + pb * a10).sum(0), (pa * a01 + pb * a11).sum(0),
        (pc * a00 + pd * a10).sum(0), (pc * a01 + pd * a11).sum(0),
    ], dim=1)  # (F, 4, rowsp)


def fused_predict_packed_plain(tab_re, tab_im, coh_ri, ant_p, ant_q,
                               cmap=None, nc: int = 1):
    """The plain PyTorch version of the fused predict: the model of the
    packed inputs as (F, 8, rowsp) f32 planes [re XX..YY, im XX..YY]
    (``cmap``/``nc`` for hybrid chunks), differentiable by autograd."""
    V = _model_plain(tab_re, tab_im, coh_ri, ant_p, ant_q, cmap, nc)
    return torch.cat([V.real, V.imag], dim=1)


def fused_cost_packed_plain(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri,
                            mask_p, nu=None, cmap=None, nc: int = 1):
    """The plain PyTorch version of the fused objective (module doc):
    same inputs as the kernels (``cmap``/``nc`` for hybrid chunks), the
    model of :func:`_model_plain`, differentiable by autograd."""
    V = _model_plain(tab_re, tab_im, coh_ri, ant_p, ant_q, cmap, nc)
    return _cost_of_model(V, vis_ri, mask_p, nu)


def _cost_of_model(V, vis_ri, mask_p, nu=None):
    """The objective of a model V (F, 4, rowsp) complex (module doc)."""
    vis = torch.complex(vis_ri[:, :4], vis_ri[:, 4:])
    d = (vis - V) * mask_p[:, None, :]
    e2 = d.real ** 2 + d.imag ** 2
    if nu is None:
        return e2.sum()
    return torch.log1p(e2 / _nu_cell(nu, e2.device)).sum()


# -------------------------------------------------------------- kernels


def _check_tensors(dev, want: dict):
    """Raise ValueError unless every ``name: (tensor, shape, dtypes)`` of
    ``want`` is a contiguous tensor on ``dev`` (CUDA) of that shape and
    one of those dtypes.  Shared by every CUDA launcher of the port."""
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernels need CUDA tensors, got {dev}")
    for name, (x, shape, dtypes) in want.items():
        if x is None:
            raise ValueError(f"CUDA kernels: {name} is required")
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, the first input on {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} shape {tuple(x.shape)}, want {shape}")
        if x.dtype not in dtypes:
            raise ValueError(f"{name} dtype {x.dtype}, want one of {dtypes}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _model_inputs(tab_re, tab_im, coh_ri, ant_p, ant_q, cmap, nc) -> dict:
    """The model's inputs in :func:`_check_tensors`' form, shared by the
    predict and objective kernels."""
    mp, F, eight, rowsp = coh_ri.shape
    mrows, npad = mp * nc, tab_re.shape[2]
    want = {
        "tab_re": (tab_re, (4, mrows, npad), (torch.float32,)),
        "tab_im": (tab_im, (4, mrows, npad), (torch.float32,)),
        "coh_ri": (coh_ri, (mp, F, 8, rowsp), (torch.float32, torch.bfloat16)),
        "ant_p": (ant_p, (1, rowsp), (torch.int32,)),
        "ant_q": (ant_q, (1, rowsp), (torch.int32,)),
    }
    if nc > 1:
        want["cmap"] = (cmap, (mp, rowsp), (torch.int32,))
    return want


def _check_cuda_inputs(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                       nu_arr, cmap, nc):
    F, rowsp = coh_ri.shape[1], coh_ri.shape[3]
    want = _model_inputs(tab_re, tab_im, coh_ri, ant_p, ant_q, cmap, nc)
    want.update({
        "vis_ri": (vis_ri, (F, 8, rowsp), (torch.float32,)),
        "mask_p": (mask_p, (F, rowsp), (torch.float32,)),
        "nu": (nu_arr, (1,), (torch.float32,)),
    })
    _check_tensors(tab_re.device, want)


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


def _check_index_contract(what, tab_re, ant_p, ant_q, cmap, nc):
    """``SAGECAL_CHECKIFY``: the indices within the kernels' gather
    bounds, before anything runs (``obs/contracts.py``)."""
    if checkify_enabled():
        check_indices(what, tab_re.shape[2], ant_p, ant_q, cmap, nc)


def _note_model_launch(name, tab_re, coh_ri, nc, direction, shape_work):
    """Telemetry: this launch's work, from shapes (``kernels/work.py``)."""
    if telemetry_enabled():
        mp, F, _, rowsp = coh_ri.shape
        sig = (mp, nc, tab_re.shape[2], F, rowsp, coh_ri.element_size())
        nbytes, flops = shape_work(*sig)[direction]
        note_launch(name, (nbytes, flops, 0), sig)


def fused_cost_fwd_cuda(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                        nu_arr, robust: bool, cmap=None, nc: int = 1):
    """Launch the forward kernel: (n_blocks,) f32 partial costs (their
    sum is the cost).  Replaces ``_fused_cost_fwd_impl``."""
    from sagecal_tpu_torch.kernels.build import load

    _check_cuda_inputs(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                       nu_arr, cmap, nc)
    _check_index_contract("fused_cost_fwd", tab_re, ant_p, ant_q, cmap, nc)
    lib = load("fused_cost")
    nb = lib.fused_cost_num_blocks(coh_ri.shape[3])
    partial = torch.empty((nb,), dtype=torch.float32, device=tab_re.device)
    args = _launch_args(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                        nu_arr, cmap, nc, robust)
    stream = torch.cuda.current_stream(tab_re.device).cuda_stream
    with launch_annotation(3, "fused_cost_fwd"):
        _raise_on(lib.fused_cost_fwd(*args, partial.data_ptr(), stream),
                  "fused_cost_fwd")
    fused_cost_fwd_cuda.launches += 1
    _note_model_launch("fused_cost_fwd", tab_re, coh_ri, nc, "fwd",
                       fused_cost_shape_work)
    return partial


# ------------------------------------------- kernel #4's station plan

BWD_TILE = 256  # rows of a row tile: kThreads of csrc/fused_cost.cu


def _distinct_rows(x):
    """(rows, index): the distinct rows of ``x`` (m, n) int64 and each
    row's index among them.  Rows are grouped by a seeded weighted sum (a
    1-D ``torch.unique``), then checked equal element by element;
    ``torch.unique(dim=0)``, which orders whole rows by comparison, runs
    only if two different rows share a sum."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randint(1, 1 << 20, (x.shape[1],), generator=gen).to(x.device)
    _, index = torch.unique((x * w).sum(1), return_inverse=True)
    with host_read("rime_kernel.distinct_count"):
        count = int(index.max()) + 1
    first = torch.full((count,), x.shape[0], dtype=torch.long,
                       device=x.device)
    first.scatter_reduce_(0, index, torch.arange(x.shape[0], device=x.device),
                          "amin")
    rows = x[first]
    with host_read("rime_kernel.distinct_equal"):
        same = torch.equal(rows[index], x)
    if same:
        return rows, index
    return torch.unique(x, dim=0, return_inverse=True)


def _same_tensor(built, x) -> bool:
    """Whether ``x`` is the tensor ``built`` records (``_source``): the
    same memory, shape, strides and dtype, unmodified since (its version
    counter, shared with its views, has not moved).  The plan holds the
    tensor, so its memory cannot pass to another.  No device sync."""
    if built is None or x is None:
        return built is None and x is None
    t, version = built
    same = x is t or (x.data_ptr() == t.data_ptr() and x.dtype == t.dtype
                      and x.shape == t.shape and x.stride() == t.stride()
                      and x.device == t.device)
    return same and x._version == version


def _source(x):
    return None if x is None else (x, x._version)


class BwdPlan:
    """The station plan of the backward's gradient kernel for one tile
    (kernels #4 and #2), or for every lane of a bucket (#6: the lanes
    share their stations).

    Each row tile of ``BWD_TILE`` rows has ``2 * BWD_TILE`` (role, row)
    items, item ``i = role * BWD_TILE + (row - tile start)``, role 0 the
    row's ``ant_p``, role 1 its ``ant_q``.  Per distinct chunk map (one
    when ``nc`` is 1) the items are stably sorted by key ``c * npad +
    station``, c the row's chunk; rows past ``rowsp`` (the last tile's
    ragged end) take key ``nc * npad`` and sort last.

    - ``pos`` (nplans, ntiles, 2 * BWD_TILE) int32: each item's sorted
      position;
    - ``seg`` (nplans, ntiles, nc * npad + 1) int32: the first position
      of each key; ``seg[..., nc * npad]`` is the tile's valid items;
    - ``of_cluster`` (mp,) int32: cluster m's plan (nc > 1; else (1,)).

    It depends on the station indices and the chunk map only, never on
    the gains, so a solve builds it once per tile
    (``_make_fused_joint_cost``, once per bucket in
    ``_make_fused_joint_cost_batch``) and every backward launch reuses
    it.  It records the index tensors it was built from, and
    :meth:`check` refuses a launch that passes others.  Built on their
    device with stable torch ops; station indices must lie in ``[0,
    npad)`` and chunks in ``[0, nc)`` (ValueError otherwise)."""

    def __init__(self, ant_p, ant_q, cmap, nc: int, npad: int):
        ap, aq = ant_p.reshape(-1).long(), ant_q.reshape(-1).long()
        dev, rowsp = ap.device, ap.numel()
        with host_read("rime_kernel.station_check"):
            bad = bool(((ap < 0) | (ap >= npad) | (aq < 0)
                        | (aq >= npad)).any())
        if bad:
            raise ValueError(f"station index outside [0, {npad})")
        if nc > 1:
            maps, of_cluster = _distinct_rows(cmap.long())
            with host_read("rime_kernel.chunk_check"):
                bad = bool(((maps < 0) | (maps >= nc)).any())
            if bad:
                raise ValueError(f"chunk index outside [0, {nc})")
        else:
            maps = torch.zeros((1, rowsp), dtype=torch.long, device=dev)
            of_cluster = torch.zeros((1,), dtype=torch.long, device=dev)
        nkeys = nc * npad
        ntiles = -(-rowsp // BWD_TILE)
        pad = ntiles * BWD_TILE - rowsp

        def keys(ant):
            k = tfn.pad(maps * npad + ant[None, :], (0, pad), value=nkeys)
            return k.reshape(-1, ntiles, BWD_TILE)

        sorted_keys, order = torch.sort(torch.cat([keys(ap), keys(aq)], -1),
                                        dim=-1, stable=True)
        pos = torch.empty_like(order)
        pos.scatter_(-1, order, torch.arange(2 * BWD_TILE, device=dev)
                     .expand_as(order))
        starts = torch.arange(nkeys + 1, device=dev).expand(
            *sorted_keys.shape[:2], nkeys + 1).contiguous()
        seg = torch.searchsorted(sorted_keys.contiguous(), starts)
        self.pos = pos.to(torch.int32).contiguous()
        self.seg = seg.to(torch.int32).contiguous()
        self.of_cluster = of_cluster.to(torch.int32).contiguous()
        self.nc, self.npad = nc, npad
        self.rowsp, self.ntiles = rowsp, ntiles
        self._built_from = {"ant_p": _source(ant_p), "ant_q": _source(ant_q),
                            "cmap": _source(cmap if nc > 1 else None)}

    def check(self, ant_p, ant_q, cmap, npad: int, nc: int, mp: int):
        """Raise ValueError unless this plan is for these shapes, on the
        indices' device, and was built from these very index tensors
        (``cmap`` read when nc > 1), unmodified since."""
        want = (ant_p.shape[-1], npad, nc)
        if (self.rowsp, self.npad, self.nc) != want:
            have = (self.rowsp, self.npad, self.nc)
            raise ValueError(f"plan for (rowsp, npad, nc) = {have}, "
                             f"want {want}")
        if nc > 1 and self.of_cluster.numel() != mp:
            raise ValueError(f"plan for {self.of_cluster.numel()} clusters, "
                             f"want {mp}")
        if self.pos.device != ant_p.device:
            raise ValueError(f"plan on {self.pos.device}, inputs on "
                             f"{ant_p.device}")
        given = {"ant_p": ant_p, "ant_q": ant_q,
                 "cmap": cmap if nc > 1 else None}
        for name, x in given.items():
            if not _same_tensor(self._built_from[name], x):
                raise ValueError(f"plan built from another {name} (or one "
                                 f"modified since): build one for these "
                                 f"indices")


def _scratch(bufs, shapes: dict, dev) -> dict:
    """``bufs`` (a dict, or None for new) with an f32 buffer of each
    ``name: shape`` of ``shapes`` that it lacks."""
    bufs = {} if bufs is None else bufs
    for name, shape in shapes.items():
        if name not in bufs:
            bufs[name] = torch.empty(shape, dtype=torch.float32, device=dev)
    return bufs


def _check_stages(stages: int, full: int, scratch):
    """Raise ValueError unless ``stages`` launches the whole backward or
    the caller passes the ``scratch`` buffers a partial launch fills: a
    partial launch leaves the returned tables unwritten."""
    if stages & ~full or not stages:
        raise ValueError(f"stages {stages} is not a subset of {full}")
    if stages != full and scratch is None:
        raise ValueError(f"stages {stages} launches part of the backward "
                         f"and leaves its tables unwritten: pass the "
                         f"scratch dict it fills (only stages={full} "
                         f"returns the gradient)")


def fused_cost_bwd_cuda(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                        nu_arr, robust: bool, cmap=None, nc: int = 1,
                        plan=None, stages: int = 7, scratch=None):
    """Launch kernel #4: (d tab_re, d tab_im), each (4, mp*nc, npad),
    bit-identical on repeat.  Replaces ``_fused_cost_bwd_impl``.

    Three launches: the cotangent kernel (g, (F, 8, rowsp)), the gradient
    kernel (one partial table per 8 row tiles) and their ordered sum.
    ``plan``: the tile's :class:`BwdPlan` (built here when None).
    ``stages`` (bit 1 cotangent, 2 gradient, 4 sum) and ``scratch`` (a
    dict of the buffers "g", "partial", "out", filled on first use and
    reused) let a timing run launch one kernel at a time; only
    ``stages=7`` gives the tables, and any other value needs
    ``scratch`` (ValueError otherwise)."""
    from sagecal_tpu_torch.kernels.build import load

    _check_stages(stages, 7, scratch)
    _check_cuda_inputs(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                       nu_arr, cmap, nc)
    _check_index_contract("fused_cost_bwd", tab_re, ant_p, ant_q, cmap, nc)
    mp, F, _, rowsp = coh_ri.shape
    dev, npad = tab_re.device, tab_re.shape[2]
    if plan is None:
        plan = BwdPlan(ant_p, ant_q, cmap, nc, npad)
    plan.check(ant_p, ant_q, cmap, npad, nc, mp)
    lib = load("fused_cost")
    ntables = lib.fused_cost_bwd_num_tables(rowsp)
    bufs = _scratch(scratch, {
        "g": (F, 8, rowsp), "partial": (ntables * 8 * tab_re.shape[1] * npad,),
        "out": (8,) + tuple(tab_re.shape[1:])}, dev)
    args = _launch_args(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                        nu_arr, cmap, nc, robust)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with launch_annotation(4, "fused_cost_bwd"):
        _raise_on(lib.fused_cost_bwd(
            *args, plan.pos.data_ptr(), plan.seg.data_ptr(),
            plan.of_cluster.data_ptr(), stages, bufs["g"].data_ptr(),
            bufs["partial"].data_ptr(), bufs["out"].data_ptr(), stream),
            "fused_cost_bwd")
    fused_cost_bwd_cuda.launches += 1
    _note_model_launch("fused_cost_bwd", tab_re, coh_ri, nc, "bwd",
                       fused_cost_shape_work)
    return bufs["out"][:4], bufs["out"][4:]


fused_cost_fwd_cuda.launches = 0
fused_cost_bwd_cuda.launches = 0


# The fused objectives give gain-table gradients only.  Autograd asking
# their backward for any other input's (coherencies, visibilities, mask,
# nu) raises: a None there would be a silent zero on the card, where the
# CPU's plain version gives the true gradient.
_DATA_GRADIENT_REFUSED = (
    "the fused objective gives gain-table gradients only (no coherency, "
    "visibility, mask or nu gradient); differentiate "
    "solvers.sage.predict_full_model for sky-model gradients")


class _FusedCost(torch.autograd.Function):
    """The fused objective on CUDA: forward and backward kernels."""

    @staticmethod
    def forward(ctx, tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                nu_arr, cmap, nc, robust, plan):
        ctx.save_for_backward(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri,
                              mask_p, nu_arr, cmap)
        ctx.nc, ctx.robust, ctx.plan = nc, robust, plan
        return fused_cost_fwd_cuda(tab_re, tab_im, coh_ri, ant_p, ant_q,
                                   vis_ri, mask_p, nu_arr, robust, cmap,
                                   nc).sum()

    @staticmethod
    def backward(ctx, gbar):
        if any(ctx.needs_input_grad[2:]):
            raise FusedSkyGradientError(_DATA_GRADIENT_REFUSED)
        saved = ctx.saved_tensors
        dre, dim = fused_cost_bwd_cuda(*saved[:8], ctx.robust, saved[8],
                                       ctx.nc, ctx.plan)
        # the kernel gives d cost / d tables; the upstream scalar is
        # applied here (one scalar-times-table op)
        return (gbar * dre, gbar * dim) + (None,) * 10


def _fused_cost(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p, nu,
                cmap, nc, plan=None):
    _check_index_contract("fused_cost_packed", tab_re, ant_p, ant_q, cmap, nc)
    if plan is not None:  # on either device: a CPU run refuses it as a launch
        plan.check(ant_p, ant_q, cmap, tab_re.shape[2], nc, coh_ri.shape[0])
    if not tab_re.is_cuda:
        return fused_cost_packed_plain(tab_re, tab_im, coh_ri, ant_p, ant_q,
                                       vis_ri, mask_p, nu, cmap, nc)
    nu_arr = _nu_cell(nu, tab_re.device)
    return _FusedCost.apply(
        tab_re.contiguous(), tab_im.contiguous(), coh_ri, ant_p, ant_q,
        vis_ri, mask_p, nu_arr, cmap, nc, nu is not None, plan)


def fused_cost_packed(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                      nu=None, *, plan=None):
    """Scalar calibration objective (module doc), ``nu`` None for the
    Gaussian cost or a float / device scalar for the Student's-t cost.
    Differentiable with respect to ``tab_re``/``tab_im`` only.  ``plan``:
    the tile's :class:`BwdPlan`, built once by a caller that runs many
    backwards (else each backward on the card builds its own)."""
    return _fused_cost(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                       nu, None, 1, plan)


def fused_cost_packed_hybrid(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri,
                             mask_p, cmap, nc, nu=None, *, plan=None):
    """Hybrid-chunk (nc > 1) objective: tables carry one row per
    (cluster, chunk); ``cmap`` (mp, rowsp) selects each row's chunk.
    ``plan`` as for :func:`fused_cost_packed`."""
    return _fused_cost(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                       nu, cmap, nc, plan)


# ------------------------------------------------------- fused predict
#
# Counterpart of ``fused_predict_packed`` / ``fused_predict_packed_hybrid``
# (sagecal_tpu/ops/rime_kernel.py:496-555) and their kernels
# ``_fused_predict_fwd_impl`` :265 (#1) and ``_fused_predict_bwd_impl``
# :407 (#2): the model V = sum_m Jp C_m Jq^H of the packed inputs, as
# (F, 8, rowsp) f32 planes, differentiable with respect to the gain
# tables.  The residual step (``ops/residual.py``) forms its model here.
# The JAX package's chunked forms (``fused_predict_packed_chunked`` and
# ``_hybrid_chunked``) exist only because of the TPU's Mosaic grid limit
# and are not ported; the CUDA grid takes every row in one launch.

# The fused backward gives gain-table cotangents only: no coherency
# (sky-parameter) cotangent.  Requesting one raises
# FusedSkyGradientError; it is never a silent zero (the JAX package's
# ``sky_constant`` contract, :441-493).  Sky refinement differentiates
# ``solvers.sage.predict_full_model`` instead.
FUSED_COHERENCY_COTANGENT = False


class FusedSkyGradientError(NotImplementedError):
    """A caller asked for coherency (sky-parameter) gradients through the
    fused predict, whose backward gives gain cotangents only."""


def fused_predict_fwd_cuda(tab_re, tab_im, coh_ri, ant_p, ant_q, cmap=None,
                           nc: int = 1):
    """Launch kernel #1: the model (F, 8, rowsp) f32.  Replaces
    ``_fused_predict_fwd_impl``."""
    from sagecal_tpu_torch.kernels.build import load

    _check_tensors(tab_re.device, _model_inputs(tab_re, tab_im, coh_ri,
                                                ant_p, ant_q, cmap, nc))
    _check_index_contract("fused_predict_fwd", tab_re, ant_p, ant_q, cmap, nc)
    lib = load("fused_cost")
    mp, F, _, rowsp = coh_ri.shape
    out = torch.empty((F, 8, rowsp), dtype=torch.float32,
                      device=tab_re.device)
    stream = torch.cuda.current_stream(tab_re.device).cuda_stream
    with launch_annotation(1, "fused_predict_fwd"):
        _raise_on(lib.fused_predict_fwd(
            tab_re.data_ptr(), tab_im.data_ptr(), coh_ri.data_ptr(),
            int(coh_ri.dtype == torch.bfloat16), ant_p.data_ptr(),
            ant_q.data_ptr(), cmap.data_ptr() if nc > 1 else None, mp, nc,
            tab_re.shape[2], F, rowsp, out.data_ptr(), stream),
            "fused_predict_fwd")
    fused_predict_fwd_cuda.launches += 1
    _note_model_launch("fused_predict_fwd", tab_re, coh_ri, nc, "fwd",
                       fused_predict_shape_work)
    return out


def fused_predict_bwd_cuda(tab_re, tab_im, coh_ri, ant_p, ant_q, g_ri,
                           cmap=None, nc: int = 1, plan=None, stages: int = 6,
                           scratch=None):
    """Launch kernel #2 on the model cotangent ``g_ri`` (F, 8, rowsp):
    (d tab_re, d tab_im), each (4, mp*nc, npad), bit-identical on repeat.
    Replaces ``_fused_predict_bwd_impl``.

    Two launches, #4's gradient kernel on ``g_ri`` (one partial table per
    8 row tiles) and their ordered sum.  ``plan``: the tile's
    :class:`BwdPlan` (built here when None).  ``stages`` (bit 2
    gradient, 4 sum) and ``scratch`` (buffers "partial", "out") as for
    :func:`fused_cost_bwd_cuda`; only ``stages=6`` gives the tables, and
    any other value needs ``scratch``."""
    from sagecal_tpu_torch.kernels.build import load

    _check_stages(stages, 6, scratch)
    mp, F, _, rowsp = coh_ri.shape
    want = _model_inputs(tab_re, tab_im, coh_ri, ant_p, ant_q, cmap, nc)
    want["g_ri"] = (g_ri, (F, 8, rowsp), (torch.float32,))
    _check_tensors(tab_re.device, want)
    _check_index_contract("fused_predict_bwd", tab_re, ant_p, ant_q, cmap, nc)
    dev, npad = tab_re.device, tab_re.shape[2]
    if plan is None:
        plan = BwdPlan(ant_p, ant_q, cmap, nc, npad)
    plan.check(ant_p, ant_q, cmap, npad, nc, mp)
    lib = load("fused_cost")
    ntables = lib.fused_cost_bwd_num_tables(rowsp)
    bufs = _scratch(scratch, {
        "partial": (ntables * 8 * tab_re.shape[1] * npad,),
        "out": (8,) + tuple(tab_re.shape[1:])}, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with launch_annotation(2, "fused_predict_bwd"):
        _raise_on(lib.fused_predict_bwd(
            tab_re.data_ptr(), tab_im.data_ptr(), coh_ri.data_ptr(),
            int(coh_ri.dtype == torch.bfloat16), ant_p.data_ptr(),
            ant_q.data_ptr(), cmap.data_ptr() if nc > 1 else None,
            g_ri.data_ptr(), mp, nc, npad, F, rowsp, plan.pos.data_ptr(),
            plan.seg.data_ptr(), plan.of_cluster.data_ptr(), stages,
            bufs["partial"].data_ptr(), bufs["out"].data_ptr(), stream),
            "fused_predict_bwd")
    fused_predict_bwd_cuda.launches += 1
    _note_model_launch("fused_predict_bwd", tab_re, coh_ri, nc, "bwd",
                       fused_predict_shape_work)
    return bufs["out"][:4], bufs["out"][4:]


fused_predict_fwd_cuda.launches = 0
fused_predict_bwd_cuda.launches = 0


class _FusedPredict(torch.autograd.Function):
    """The fused predict: kernels #1/#2 on CUDA tensors, the plain version
    (and its autograd VJP) on CPU tensors.  The backward raises
    :class:`FusedSkyGradientError` when a coherency gradient is asked.
    ``plan``: the tile's :class:`BwdPlan` for #2 (None: built per
    backward)."""

    @staticmethod
    def forward(ctx, tab_re, tab_im, coh_ri, ant_p, ant_q, cmap, nc, plan):
        ctx.save_for_backward(tab_re, tab_im, coh_ri, ant_p, ant_q, cmap)
        ctx.nc, ctx.plan = nc, plan
        if tab_re.is_cuda:
            return fused_predict_fwd_cuda(tab_re, tab_im, coh_ri, ant_p,
                                          ant_q, cmap, nc)
        return fused_predict_packed_plain(tab_re, tab_im, coh_ri, ant_p,
                                          ant_q, cmap, nc)

    @staticmethod
    def backward(ctx, g_ri):
        if ctx.needs_input_grad[2]:
            raise FusedSkyGradientError(
                "the fused predict has no coherency cotangent (its backward "
                "gives gain-table cotangents only); differentiate "
                "solvers.sage.predict_full_model for sky-model gradients")
        tab_re, tab_im, coh_ri, ant_p, ant_q, cmap = ctx.saved_tensors
        if tab_re.is_cuda:
            dre, dim = fused_predict_bwd_cuda(tab_re, tab_im, coh_ri, ant_p,
                                              ant_q, g_ri.contiguous(), cmap,
                                              ctx.nc, ctx.plan)
        else:
            with torch.enable_grad():
                a = tab_re.detach().requires_grad_(True)
                b = tab_im.detach().requires_grad_(True)
                model = fused_predict_packed_plain(a, b, coh_ri, ant_p, ant_q,
                                                   cmap, ctx.nc)
                dre, dim = torch.autograd.grad(model, (a, b), g_ri)
        return (dre, dim) + (None,) * 6


def _fused_predict(tab_re, tab_im, coh_ri, ant_p, ant_q, cmap, nc, plan):
    _check_index_contract("fused_predict_packed", tab_re, ant_p, ant_q, cmap,
                          nc)
    if plan is not None:  # on either device, as _fused_cost
        plan.check(ant_p, ant_q, cmap, tab_re.shape[2], nc, coh_ri.shape[0])
    return _FusedPredict.apply(tab_re.contiguous(), tab_im.contiguous(),
                               coh_ri, ant_p, ant_q, cmap, nc, plan)


def fused_predict_packed(tab_re, tab_im, coh_ri, ant_p, ant_q, *, plan=None):
    """Full-model RIME predict, packed layout (module doc): the model
    (F, 8, rowsp) f32.  Differentiable with respect to ``tab_re`` /
    ``tab_im`` only.  CUDA tensors launch kernels #1/#2 (or raise); CPU
    tensors, and only those, take the plain version.  ``plan``: the
    tile's :class:`BwdPlan`, built once by a caller that runs many
    backwards (else each backward on the card builds its own)."""
    return _fused_predict(tab_re, tab_im, coh_ri, ant_p, ant_q, None, 1, plan)


def fused_predict_packed_hybrid(tab_re, tab_im, coh_ri, ant_p, ant_q, cmap,
                                nc, *, plan=None):
    """Hybrid-chunk (nc > 1) predict: tables carry one row per (cluster,
    chunk); ``cmap`` (mp, rowsp) int32 selects each row's chunk.
    ``plan`` as for :func:`fused_predict_packed`."""
    return _fused_predict(tab_re, tab_im, coh_ri, ant_p, ant_q, cmap, nc,
                          plan)


# ---------------------------------------------------- batched objective
#
# Counterpart of the batched part of sagecal_tpu/ops/rime_kernel.py
# (``fused_cost_packed_batch`` :1342, kernels ``_fused_cost_batch_fwd_impl``
# :1250 and ``_fused_cost_batch_bwd_impl`` :1273): the objective of B
# independent same-shape lanes (a serve bucket) in one launch, giving the
# (B,) per-lane costs.  Lane-major layouts, nc = 1 only: tables
# (4, B*mp, npad) with lane b on rows [b*mp, (b+1)*mp); coherencies
# (B*mp, F, 8, rowsp) f32 or bf16; ``vis_ri`` (B, F, 8, rowsp); ``mask_p``
# (B, F, rowsp); ``ant_p``/``ant_q`` (1, rowsp) shared by every lane; nu
# per lane as a (B,) f32 device tensor.  A lane whose mask is zero (the
# ``valid`` guard of :func:`pack_cost_inputs_batch`) costs exactly 0 and
# gets an exactly-zero cotangent.


def pack_gain_tables_batch(jones_b, mp=None, npad=None):
    """(B, M, N, 2, 2) complex Jones -> lane-major component-major tables
    (tab_re, tab_im), each (4, B*mp, npad) f32: lane b's clusters occupy
    rows [b*mp, (b+1)*mp) of every component plane.  ``mp``/``npad``
    default to M and N (no padding).  Differentiable."""
    B, M, N = jones_b.shape[0], jones_b.shape[1], jones_b.shape[2]
    mp = M if mp is None else mp
    npad = N if npad is None else npad
    tab = jones_b.reshape(B, M, N, 4).permute(3, 0, 1, 2)  # (4, B, M, N)
    pads = (0, npad - N, 0, mp - M)
    return tuple(tfn.pad(part, pads).reshape(4, B * mp, npad).float()
                 .contiguous() for part in (tab.real, tab.imag))


def pack_cost_inputs_batch(vis_b, mask_b, coh_b, ant_p, ant_q,
                           row_pad: int = 1, cluster_pad: int = 1,
                           valid=None):
    """Pack a batch of same-shape lanes into the batched kernels' layout:
    complex ``vis_b`` (B, F, 4, rows) -> ``vis_ri`` (B, F, 8, rowsp);
    ``mask_b`` (B, F, rows) -> ``mask_p`` (B, F, rowsp); complex ``coh_b``
    (B, M, F, 4, rows) -> ``coh_ri`` (B*mp, F, 8, rowsp) lane-major;
    shared ``ant_p``/``ant_q`` (rows,) -> (1, rowsp) int32.  Rows are
    padded to a multiple of ``row_pad`` and clusters to ``cluster_pad``
    (both 1 = none; the JAX package's 128 and 8 give its layout, whose
    ``chunked_rowsp`` equals ``pad_to(rows, 128)`` up to 32,768 rows).
    ``valid`` (B,) zeroes whole lanes' masks: the ragged-lane guard.
    Returns (vis_ri, mask_p, coh_ri, antp, antq)."""
    lanes = [pack_predict_inputs(vis_b[b], mask_b[b], coh_b[b], ant_p, ant_q,
                                 None, row_pad, cluster_pad)
             for b in range(coh_b.shape[0])]
    mask_p = torch.stack([lane[1] for lane in lanes])
    if valid is not None:
        keep = torch.as_tensor(valid, device=mask_p.device)
        mask_p = mask_p * keep.to(torch.float32)[:, None, None]
    return (torch.stack([lane[0] for lane in lanes]), mask_p.contiguous(),
            torch.cat([lane[2] for lane in lanes]), lanes[0][3], lanes[0][4])


def unpack_gain_grads_batch(dre, dim, B: int, M: int, N: int):
    """Inverse of :func:`pack_gain_tables_batch` for cotangents:
    (4, B*mp, npad) pair -> (B, M, N, 2, 2) re / im pair."""
    mp, npad = dre.shape[1] // B, dre.shape[2]
    return tuple(d.reshape(4, B, mp, npad)[:, :, :M, :N].permute(1, 2, 3, 0)
                 .reshape(B, M, N, 2, 2) for d in (dre, dim))


def _nu_lanes(nu, B: int, device) -> torch.Tensor:
    """Per-lane nu as a (B,) f32 tensor on ``device`` (the counterpart of
    ``_nu_rows``, :1330).  None (Gaussian) gives ones, never read; a
    scalar is broadcast; a (B,) tensor stays on the device (no host
    read)."""
    if nu is None:
        return torch.ones((B,), dtype=torch.float32, device=device)
    nu = torch.as_tensor(nu, device=device).to(torch.float32)
    return nu.reshape(-1).expand(B).contiguous()


def fused_cost_packed_batch_plain(tab_re, tab_im, coh_ri, ant_p, ant_q,
                                  vis_ri, mask_p, nu=None):
    """The plain PyTorch version of the batched objective: lane b's cost
    is :func:`fused_cost_packed_plain` on lane b's tables, coherencies,
    visibilities, mask and nu (``index_select`` gathers, autograd).
    Returns the (B,) per-lane costs."""
    B = vis_ri.shape[0]
    mp = tab_re.shape[1] // B
    nus = None if nu is None else _nu_lanes(nu, B, tab_re.device)
    return torch.stack([
        fused_cost_packed_plain(
            tab_re[:, b * mp:(b + 1) * mp], tab_im[:, b * mp:(b + 1) * mp],
            coh_ri[b * mp:(b + 1) * mp], ant_p, ant_q, vis_ri[b], mask_p[b],
            None if nus is None else nus[b])
        for b in range(B)])


def _check_cuda_inputs_batch(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri,
                             mask_p, nu_lanes):
    B, F, _, rowsp = vis_ri.shape
    mrows, npad = tab_re.shape[1], tab_re.shape[2]
    if not 1 <= B <= 65535 or mrows % B:
        raise ValueError(f"batched fused cost: B={B} lanes (1..65535) must "
                         f"divide the {mrows} table rows")
    coh_dtypes = (torch.float32, torch.bfloat16)
    _check_tensors(tab_re.device, {
        "tab_re": (tab_re, (4, mrows, npad), (torch.float32,)),
        "tab_im": (tab_im, (4, mrows, npad), (torch.float32,)),
        "coh_ri": (coh_ri, (mrows, F, 8, rowsp), coh_dtypes),
        "ant_p": (ant_p, (1, rowsp), (torch.int32,)),
        "ant_q": (ant_q, (1, rowsp), (torch.int32,)),
        "vis_ri": (vis_ri, (B, F, 8, rowsp), (torch.float32,)),
        "mask_p": (mask_p, (B, F, rowsp), (torch.float32,)),
        "nu": (nu_lanes, (B,), (torch.float32,)),
    })


def _launch_args_batch(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                       nu_lanes, robust):
    B, F, _, rowsp = vis_ri.shape
    return [
        tab_re.data_ptr(), tab_im.data_ptr(), coh_ri.data_ptr(),
        int(coh_ri.dtype == torch.bfloat16), ant_p.data_ptr(),
        ant_q.data_ptr(), vis_ri.data_ptr(), mask_p.data_ptr(),
        nu_lanes.data_ptr(), B, tab_re.shape[1] // B, tab_re.shape[2], F,
        rowsp, int(robust),
    ]


def _note_batch_launch(name, tab_re, coh_ri, vis_ri, direction):
    """Telemetry: a batched launch's work, from shapes."""
    if telemetry_enabled():
        B, F, _, rowsp = vis_ri.shape
        sig = (B, tab_re.shape[1] // B, tab_re.shape[2], F, rowsp,
               coh_ri.element_size())
        nbytes, flops = fused_cost_batch_shape_work(*sig)[direction]
        note_launch(name, (nbytes, flops, 0), sig)


def fused_cost_batch_fwd_cuda(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri,
                              mask_p, nu_lanes, robust: bool):
    """Launch the batched forward kernel: (B, n_blocks) f32 partial
    costs (each lane's row sum is its cost).  Replaces
    ``_fused_cost_batch_fwd_impl``."""
    from sagecal_tpu_torch.kernels.build import load

    _check_cuda_inputs_batch(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri,
                             mask_p, nu_lanes)
    _check_index_contract("fused_cost_batch_fwd", tab_re, ant_p, ant_q, None,
                          1)
    lib = load("fused_cost")
    B = vis_ri.shape[0]
    nb = lib.fused_cost_num_blocks(vis_ri.shape[3])
    partial = torch.empty((B, nb), dtype=torch.float32, device=tab_re.device)
    args = _launch_args_batch(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri,
                              mask_p, nu_lanes, robust)
    stream = torch.cuda.current_stream(tab_re.device).cuda_stream
    with launch_annotation(5, "fused_cost_batch_fwd"):
        _raise_on(lib.fused_cost_batch_fwd(*args, partial.data_ptr(), stream),
                  "fused_cost_batch_fwd")
    fused_cost_batch_fwd_cuda.launches += 1
    _note_batch_launch("fused_cost_batch_fwd", tab_re, coh_ri, vis_ri, "fwd")
    return partial


def fused_cost_batch_bwd_cuda(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri,
                              mask_p, nu_lanes, robust: bool, plan=None,
                              stages: int = 7, scratch=None):
    """Launch the batched backward kernels (#6): (d tab_re, d tab_im),
    each (4, B*mp, npad), lane b's d cost_b / d tables on its own rows;
    bit-identical on repeat.  Replaces ``_fused_cost_batch_bwd_impl``.

    #4's three kernels with the lane on the grid: the cotangent kernel
    (g, (B, F, 8, rowsp)), the gradient kernel (per lane one partial
    table per 8 row tiles) and their ordered sum.  ``plan``: one
    :class:`BwdPlan` of the shared ``ant_p``/``ant_q`` for every lane
    (built here when None).  ``stages`` and ``scratch`` as for
    :func:`fused_cost_bwd_cuda`."""
    from sagecal_tpu_torch.kernels.build import load

    _check_stages(stages, 7, scratch)
    _check_cuda_inputs_batch(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri,
                             mask_p, nu_lanes)
    _check_index_contract("fused_cost_batch_bwd", tab_re, ant_p, ant_q, None,
                          1)
    B, F, _, rowsp = vis_ri.shape
    dev, npad = tab_re.device, tab_re.shape[2]
    if plan is None:
        plan = BwdPlan(ant_p, ant_q, None, 1, npad)
    plan.check(ant_p, ant_q, None, npad, 1, tab_re.shape[1] // B)
    lib = load("fused_cost")
    ntables = lib.fused_cost_bwd_num_tables(rowsp)
    bufs = _scratch(scratch, {
        "g": (B, F, 8, rowsp),
        "partial": (ntables * 8 * tab_re.shape[1] * npad,),  # per lane
        "out": (8,) + tuple(tab_re.shape[1:])}, dev)
    args = _launch_args_batch(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri,
                              mask_p, nu_lanes, robust)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with launch_annotation(6, "fused_cost_batch_bwd"):
        _raise_on(lib.fused_cost_batch_bwd(
            *args, plan.pos.data_ptr(), plan.seg.data_ptr(), stages,
            bufs["g"].data_ptr(), bufs["partial"].data_ptr(),
            bufs["out"].data_ptr(), stream), "fused_cost_batch_bwd")
    fused_cost_batch_bwd_cuda.launches += 1
    _note_batch_launch("fused_cost_batch_bwd", tab_re, coh_ri, vis_ri, "bwd")
    return bufs["out"][:4], bufs["out"][4:]


fused_cost_batch_fwd_cuda.launches = 0
fused_cost_batch_bwd_cuda.launches = 0


class _FusedCostBatch(torch.autograd.Function):
    """The batched objective on CUDA: forward and backward kernels."""

    @staticmethod
    def forward(ctx, tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri, mask_p,
                nu_lanes, robust, plan):
        ctx.save_for_backward(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri,
                              mask_p, nu_lanes)
        ctx.robust, ctx.plan = robust, plan
        return fused_cost_batch_fwd_cuda(tab_re, tab_im, coh_ri, ant_p, ant_q,
                                         vis_ri, mask_p, nu_lanes,
                                         robust).sum(1)

    @staticmethod
    def backward(ctx, gbar):
        if any(ctx.needs_input_grad[2:]):
            raise FusedSkyGradientError(_DATA_GRADIENT_REFUSED)
        saved = ctx.saved_tensors
        dre, dim = fused_cost_batch_bwd_cuda(*saved, ctx.robust, ctx.plan)
        # the kernel gives d cost_b / d tables; the per-lane upstream
        # cotangent (B,) scales each lane's row block here (:1318-1324)
        B = saved[5].shape[0]
        scale = gbar.repeat_interleave(dre.shape[1] // B)[None, :, None]
        return (scale * dre, scale * dim) + (None,) * 8


def fused_cost_packed_batch(tab_re, tab_im, coh_ri, ant_p, ant_q, vis_ri,
                            mask_p, nu=None, *, plan=None):
    """Per-lane calibration objectives (B,) for a batch of lanes (section
    comment above), ``nu`` None for the Gaussian cost or a float / (B,)
    tensor for the Student's-t cost.  Differentiable with respect to
    ``tab_re``/``tab_im`` only.  CUDA tensors launch the batched kernels
    (or raise); CPU tensors, and only those, take the plain version.
    ``plan``: one :class:`BwdPlan` of the shared ``ant_p``/``ant_q``,
    built once per bucket by a caller that runs many backwards (else
    each backward on the card builds its own)."""
    _check_index_contract("fused_cost_packed_batch", tab_re, ant_p, ant_q,
                          None, 1)
    if plan is not None:  # on either device, as _fused_cost
        plan.check(ant_p, ant_q, None, tab_re.shape[2], 1,
                   tab_re.shape[1] // vis_ri.shape[0])
    if not tab_re.is_cuda:
        return fused_cost_packed_batch_plain(tab_re, tab_im, coh_ri, ant_p,
                                             ant_q, vis_ri, mask_p, nu)
    nu_lanes = _nu_lanes(nu, vis_ri.shape[0], tab_re.device)
    return _FusedCostBatch.apply(
        tab_re.contiguous(), tab_im.contiguous(), coh_ri, ant_p, ant_q,
        vis_ri, mask_p, nu_lanes, nu is not None, plan)
