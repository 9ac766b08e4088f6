"""Hold the fused kernels against their plain PyTorch versions.

Shared by the ``cuda``-marked tests and ``chip_smoke.py``: one seeded
random problem in the kernels' packed layout (solo, and batched over B
lanes), and one comparison each for the objective (cost relative error,
gradient error relative to the gradient's norm: elementwise f32
gradient checks fail on summation order alone), the predict (model
error relative to its max abs, gradient as for the objective, under a
seeded upstream cotangent) and the batched objective, with whether two
backward launches give bit-identical tables.  Each comparison builds its
problem's backward station plan once (:func:`plan_of`) and passes it to
every backward, as a solve does.  Each kernel pair has its work count
(bytes and operations) for its bound.

The visibilities are drawn independently of the model, so the residual
is of the model's size: the comparison then measures the kernels'
arithmetic, not the cancellation of a near-perfect fit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sagecal_tpu_torch.core.types import params_to_jones
from sagecal_tpu_torch.ops.rime_kernel import (
    BwdPlan, FusedSkyGradientError, _nu_cell, _nu_lanes,
    fused_cost_batch_bwd_cuda,
    fused_cost_bwd_cuda, fused_cost_packed, fused_cost_packed_batch,
    fused_cost_packed_batch_plain, fused_cost_packed_hybrid,
    fused_cost_packed_plain, fused_predict_bwd_cuda, fused_predict_fwd_cuda,
    fused_predict_packed,
    fused_predict_packed_hybrid, fused_predict_packed_plain, pack_gain_tables,
    pack_predict_inputs,
)


@dataclasses.dataclass
class CostProblem:
    tab_re: torch.Tensor
    tab_im: torch.Tensor
    coh_ri: torch.Tensor
    ant_p: torch.Tensor
    ant_q: torch.Tensor
    vis_ri: torch.Tensor
    mask_p: torch.Tensor
    cmap: Optional[torch.Tensor]
    nc: int

    @property
    def inputs(self):
        return (self.coh_ri, self.ant_p, self.ant_q, self.vis_ri, self.mask_p)


def random_cost_problem(M: int, N: int, F: int, rows: int, nc: int = 1,
                        coh_dtype=torch.float32, seed: int = 0,
                        drop: float = 0.1, device="cuda") -> CostProblem:
    """Seeded problem in the kernel layout (no padding): gains near the
    identity, complex-normal coherencies and visibilities, ~``drop`` of
    the mask flagged.  ``rows`` follow the tile's baseline order when
    rows is a multiple of N(N-1)/2, else random station pairs."""
    rng = np.random.default_rng(seed)
    shape = (M, nc, N, 2, 2) if nc > 1 else (M, N, 2, 2)
    jones = np.eye(2) + 0.3 * (rng.standard_normal(shape)
                               + 1j * rng.standard_normal(shape))
    coh = rng.standard_normal((M, F, 8, rows)).astype(np.float32)
    vis = rng.standard_normal((F, 8, rows)).astype(np.float32)
    mask = (rng.random((F, rows)) > drop).astype(np.float32)
    p, q = np.triu_indices(N, 1)
    if rows % p.size == 0:
        ant_p, ant_q = np.tile(p, rows // p.size), np.tile(q, rows // p.size)
    else:
        ant_p = rng.integers(0, N - 1, rows)
        ant_q = ant_p + rng.integers(1, N - ant_p)
    cmap = None
    if nc > 1:
        cmap = np.repeat(np.arange(nc), -(-rows // nc))[:rows]
        cmap = torch.as_tensor(np.broadcast_to(cmap, (M, rows)).copy(),
                               dtype=torch.int32).to(device)
    tre, tim = pack_gain_tables(torch.as_tensor(jones, dtype=torch.complex128), M)
    as_t = lambda x, dt: torch.as_tensor(x, dtype=dt).to(device).contiguous()
    return CostProblem(
        tab_re=tre.to(device), tab_im=tim.to(device),
        coh_ri=as_t(coh, torch.float32).to(coh_dtype),
        ant_p=as_t(ant_p[None, :], torch.int32),
        ant_q=as_t(ant_q[None, :], torch.int32),
        vis_ri=as_t(vis, torch.float32), mask_p=as_t(mask, torch.float32),
        cmap=cmap, nc=nc,
    )


def tile_cost_problem(data, cdata, p) -> CostProblem:
    """A tile's own objective inputs at the solution ``p`` (M, nc, 8N),
    packed as ``sagefit``'s fused joint cost packs them
    (``solvers/sage.py::_make_fused_joint_cost``): the kernels can then
    be held against their plain version at the shapes a solve gives
    them."""
    M, nc, n8 = p.shape
    vis_ri, mask_p, coh_ri, antp, antq, cmap = pack_predict_inputs(
        data.vis, data.mask, cdata.coh, data.ant_p, data.ant_q,
        cdata.chunk_map if nc > 1 else None)
    jones = params_to_jones(p.detach().float())
    tre, tim = pack_gain_tables(jones if nc > 1 else jones[:, 0], M)
    return CostProblem(tab_re=tre, tab_im=tim, coh_ri=coh_ri, ant_p=antp,
                       ant_q=antq, vis_ri=vis_ri, mask_p=mask_p, cmap=cmap,
                       nc=nc)


def plan_of(prob) -> BwdPlan:
    """The backward station plan of a problem's indices (a batch's lanes
    share theirs)."""
    cmap, nc = getattr(prob, "cmap", None), getattr(prob, "nc", 1)
    return BwdPlan(prob.ant_p, prob.ant_q, cmap, nc, prob.tab_re.shape[2])


def value_and_grad(prob: CostProblem, nu=None, plain: bool = False,
                   plan=None):
    """(cost, d cost / d tab_re, d cost / d tab_im) through the wrapper
    (kernels on CUDA tensors; ``plan`` its station plan, None to build
    one) or through the plain version."""
    a = prob.tab_re.detach().clone().requires_grad_(True)
    b = prob.tab_im.detach().clone().requires_grad_(True)
    if plain:
        cost = fused_cost_packed_plain(a, b, *prob.inputs, nu, prob.cmap,
                                       prob.nc)
    elif prob.nc > 1:
        cost = fused_cost_packed_hybrid(a, b, *prob.inputs, prob.cmap,
                                        prob.nc, nu, plan=plan)
    else:
        cost = fused_cost_packed(a, b, *prob.inputs, nu, plan=plan)
    ga, gb = torch.autograd.grad(cost, (a, b))
    return cost.detach(), ga, gb


def compare_with_plain(prob: CostProblem, nu=None, plan=None) -> dict:
    """Kernels vs plain version on the same inputs (``plan``: the
    problem's station plan, None to build one here): {"cost_rel",
    "cost_abs_err", "grad_rel", "grad_max_abs_err", "bitwise_repeat"}."""
    plan = plan_of(prob) if plan is None else plan
    ck, gka, gkb = value_and_grad(prob, nu, plan=plan)
    cp, gpa, gpb = value_and_grad(prob, nu, plain=True)
    gk = torch.cat([gka.reshape(-1), gkb.reshape(-1)]).double()
    gp = torch.cat([gpa.reshape(-1), gpb.reshape(-1)]).double()
    args = (prob.tab_re, prob.tab_im, *prob.inputs,
            _nu_cell(nu, prob.tab_re.device), nu is not None, prob.cmap,
            prob.nc)
    r1 = fused_cost_bwd_cuda(*args, plan=plan)
    r2 = fused_cost_bwd_cuda(*args, plan=plan)
    return {
        "cost_rel": abs(float(ck) - float(cp)) / abs(float(cp)),
        "cost_abs_err": abs(float(ck) - float(cp)),
        "grad_rel": float(torch.linalg.norm(gk - gp) / torch.linalg.norm(gp)),
        "grad_max_abs_err": float((gk - gp).abs().max()),
        "bitwise_repeat": bool(torch.equal(r1[0], r2[0])
                               and torch.equal(r1[1], r2[1])),
    }


# published peaks of one H100 SXM (NVIDIA data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# words an SM's load path serves from L1 or shared memory a clock (32
# banks of 4 bytes), over 132 SMs at the clock that gives the f32 peak
# (128 FMA lanes an SM, 2 flops each): an eighth of the f32 rate, 8.4e12
# words (33.5 TB) a second
GATHER_WORDS_PER_S = F32_FLOPS_PER_S * 32 / 256


def roofline(nbytes: int, flops: int, gathers: int = 0) -> dict:
    """The least time the card could take for this work: bytes over the
    memory rate, or operations, whichever is larger.  The operations'
    time is the larger of the flops over the f32 peak and ``gathers``
    (words a kernel picks by index from a table that sits on chip) over
    the rate the SMs serve them."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_FLOPS_PER_S, gathers / GATHER_WORDS_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "gathers": gathers}


# real f32 operations per (cluster, channel, row): the model's two 2x2
# complex products (8 complex multiply-adds each, 8 flops apiece), and in
# the backward the model again plus C Jq^H, dJp, dA and dJq
_MODEL_FLOPS = 128
_BWD_FLOPS = _MODEL_FLOPS + 4 * 64
_RESIDUAL_FLOPS = 40  # per (channel, row): masked residual and its cost


def fused_cost_work(prob: CostProblem) -> dict:
    """Bytes each kernel must move (every input read once, every output
    written once) and the operations it does, for this problem:
    {"fwd": (bytes, flops), "bwd": (bytes, flops)}."""
    mp, F, _, rowsp = prob.coh_ri.shape
    nbytes = lambda t: 0 if t is None else t.numel() * t.element_size()
    inputs = sum(nbytes(t) for t in (prob.tab_re, prob.tab_im, *prob.inputs,
                                     prob.cmap)) + 4  # + nu
    tables = 2 * nbytes(prob.tab_re)
    cells, rows = mp * F * rowsp, F * rowsp
    return {
        "fwd": (inputs + 4, _MODEL_FLOPS * cells + _RESIDUAL_FLOPS * rows),
        "bwd": (inputs + tables,
                _BWD_FLOPS * cells + 2 * _RESIDUAL_FLOPS * rows),
    }


# ---------------------------------------------------------- fused predict
#
# The predict kernels #1/#2 take the model inputs of a CostProblem (its
# visibilities and mask are not read) and, backward, an upstream model
# cotangent g (F, 8, rowsp).


def model_cotangent(prob: CostProblem, seed: int = 0) -> torch.Tensor:
    """A seeded standard-normal upstream cotangent of the model,
    (F, 8, rowsp) f32 on the problem's device."""
    mp, F, _, rowsp = prob.coh_ri.shape
    g = np.random.default_rng(seed).standard_normal((F, 8, rowsp))
    return torch.as_tensor(g, dtype=torch.float32).to(prob.tab_re.device)


def predict_and_grad(prob: CostProblem, g, plain: bool = False, plan=None):
    """(model (F, 8, rowsp), d <g, model> / d tab_re, ... / d tab_im)
    through the wrapper (kernels on CUDA tensors; ``plan`` as for
    :func:`value_and_grad`) or the plain version."""
    a = prob.tab_re.detach().clone().requires_grad_(True)
    b = prob.tab_im.detach().clone().requires_grad_(True)
    args = (prob.coh_ri, prob.ant_p, prob.ant_q)
    if plain:
        model = fused_predict_packed_plain(a, b, *args, prob.cmap, prob.nc)
    elif prob.nc > 1:
        model = fused_predict_packed_hybrid(a, b, *args, prob.cmap, prob.nc,
                                            plan=plan)
    else:
        model = fused_predict_packed(a, b, *args, plan=plan)
    ga, gb = torch.autograd.grad(model, (a, b), g)
    return model.detach(), ga, gb


def sky_gradient_raises(prob: CostProblem, g) -> bool:
    """Whether asking the fused predict for a coherency gradient raises
    FusedSkyGradientError (never a silent zero)."""
    coh = prob.coh_ri.detach().clone().requires_grad_(True)
    model = fused_predict_packed_hybrid(prob.tab_re, prob.tab_im, coh,
                                        prob.ant_p, prob.ant_q, prob.cmap,
                                        prob.nc)
    try:
        torch.autograd.grad(model, coh, g)
    except FusedSkyGradientError:
        return True
    return False


def compare_predict_with_plain(prob: CostProblem, seed: int = 0,
                               plan=None) -> dict:
    """Kernels #1/#2 vs the plain predict on the same inputs and a seeded
    upstream cotangent (``plan`` as for :func:`compare_with_plain`):
    {"model_rel" (max abs error over the model's max abs),
    "model_max_abs_err", "grad_rel" (error norm over the cotangent's
    norm), "grad_max_abs_err", "bitwise_repeat", "sky_error_raised"}."""
    g = model_cotangent(prob, seed)
    plan = plan_of(prob) if plan is None else plan
    mk, gka, gkb = predict_and_grad(prob, g, plan=plan)
    mpl, gpa, gpb = predict_and_grad(prob, g, plain=True)
    gk = torch.cat([gka.reshape(-1), gkb.reshape(-1)]).double()
    gp = torch.cat([gpa.reshape(-1), gpb.reshape(-1)]).double()
    merr = float((mk.double() - mpl.double()).abs().max())
    args = (prob.tab_re, prob.tab_im, prob.coh_ri, prob.ant_p, prob.ant_q, g,
            prob.cmap, prob.nc)
    r1 = fused_predict_bwd_cuda(*args, plan=plan)
    r2 = fused_predict_bwd_cuda(*args, plan=plan)
    return {
        "model_rel": merr / float(mpl.abs().max()),
        "model_max_abs_err": merr,
        "grad_rel": float(torch.linalg.norm(gk - gp) / torch.linalg.norm(gp)),
        "grad_max_abs_err": float((gk - gp).abs().max()),
        "bitwise_repeat": bool(torch.equal(r1[0], r2[0])
                               and torch.equal(r1[1], r2[1])),
        "sky_error_raised": sky_gradient_raises(prob, g),
    }


def compare_predict_on_tile(data, cdata, p) -> dict:
    """Kernel #1 vs the plain predict on the packed inputs that the
    residual step of a float32 tile with solutions ``p`` gives it
    (``ops/residual.py::packed_predict_inputs``): {"model_rel" (max abs
    error over the model's max abs), "model_max_abs_err",
    "bitwise_repeat"}.  Its two launches add to #1's count: read the
    path's count before calling it."""
    from sagecal_tpu_torch.ops.residual import packed_predict_inputs

    tre, tim, coh_ri, antp, antq, cmap, nc = packed_predict_inputs(
        p, cdata, data)
    k1 = fused_predict_fwd_cuda(tre, tim, coh_ri, antp, antq, cmap, nc)
    k2 = fused_predict_fwd_cuda(tre, tim, coh_ri, antp, antq, cmap, nc)
    pl = fused_predict_packed_plain(tre, tim, coh_ri, antp, antq, cmap, nc)
    err = float((k1.double() - pl.double()).abs().max())
    return {"model_rel": err / float(pl.abs().max()),
            "model_max_abs_err": err, "bitwise_repeat": torch.equal(k1, k2)}


def fused_predict_work(prob: CostProblem) -> dict:
    """Bytes kernels #1/#2 must move (every input read once, every output
    written once) and the operations they do, for this problem:
    {"fwd": (bytes, flops), "bwd": (bytes, flops)}.  The forward writes
    the model; the backward reads the model cotangent and writes the two
    tables."""
    mp, F, _, rowsp = prob.coh_ri.shape
    nbytes = lambda t: 0 if t is None else t.numel() * t.element_size()
    inputs = sum(nbytes(t) for t in (prob.tab_re, prob.tab_im, prob.coh_ri,
                                     prob.ant_p, prob.ant_q, prob.cmap))
    model = 4 * F * 8 * rowsp
    cells = mp * F * rowsp
    return {
        "fwd": (inputs + model, _MODEL_FLOPS * cells),
        "bwd": (inputs + model + 2 * nbytes(prob.tab_re),
                (_BWD_FLOPS - _MODEL_FLOPS) * cells),
    }


# ------------------------------------------------------ batched objective


@dataclasses.dataclass
class BatchCostProblem:
    tab_re: torch.Tensor  # (4, B*M, N)
    tab_im: torch.Tensor
    coh_ri: torch.Tensor  # (B*M, F, 8, rows)
    ant_p: torch.Tensor  # (1, rows) shared by every lane
    ant_q: torch.Tensor
    vis_ri: torch.Tensor  # (B, F, 8, rows)
    mask_p: torch.Tensor  # (B, F, rows); padded lanes all zero
    valid: np.ndarray  # (B,) bool

    @property
    def inputs(self):
        return (self.coh_ri, self.ant_p, self.ant_q, self.vis_ri, self.mask_p)


def random_cost_problem_batch(B: int, M: int, N: int, F: int, rows: int,
                              coh_dtype=torch.float32, seed: int = 0,
                              nvalid: Optional[int] = None, drop: float = 0.1,
                              device="cuda") -> BatchCostProblem:
    """Seeded batch in the batched kernels' layout (no padding): B lanes
    sharing lane 0's baseline geometry, each with its own gains,
    coherencies, visibilities and mask.  ``nvalid`` < B zeroes the masks of the last
    B - nvalid lanes (the ragged-lane guard)."""
    lanes = [random_cost_problem(M, N, F, rows, seed=seed + b, drop=drop,
                                 device="cpu") for b in range(B)]
    valid = np.arange(B) < (B if nvalid is None else nvalid)
    mask = torch.stack([p.mask_p for p in lanes])
    mask = mask * torch.as_tensor(valid, dtype=torch.float32)[:, None, None]
    to = lambda x: x.to(device).contiguous()
    return BatchCostProblem(
        tab_re=to(torch.cat([p.tab_re for p in lanes], dim=1)),
        tab_im=to(torch.cat([p.tab_im for p in lanes], dim=1)),
        coh_ri=to(torch.cat([p.coh_ri for p in lanes]).to(coh_dtype)),
        ant_p=to(lanes[0].ant_p), ant_q=to(lanes[0].ant_q),
        vis_ri=to(torch.stack([p.vis_ri for p in lanes])), mask_p=to(mask),
        valid=valid,
    )


def lane_weights(B: int, seed: int = 0) -> torch.Tensor:
    """Seeded per-lane upstream cotangents in [0.5, 1.5)."""
    return torch.as_tensor(np.random.default_rng(seed).uniform(0.5, 1.5, B),
                           dtype=torch.float32)


def value_and_grad_batch(prob: BatchCostProblem, nu=None, weights=None,
                         plain: bool = False, plan=None):
    """((B,) costs, d sum(w * costs) / d tab_re, ... / d tab_im) through
    the wrapper (kernels on CUDA tensors; ``plan`` as for
    :func:`value_and_grad`) or the plain version."""
    a = prob.tab_re.detach().clone().requires_grad_(True)
    b = prob.tab_im.detach().clone().requires_grad_(True)
    if plain:
        costs = fused_cost_packed_batch_plain(a, b, *prob.inputs, nu)
    else:
        costs = fused_cost_packed_batch(a, b, *prob.inputs, nu, plan=plan)
    w = torch.ones_like(costs) if weights is None else weights.to(costs)
    ga, gb = torch.autograd.grad(costs, (a, b), w)
    return costs.detach(), ga, gb


def compare_batch_with_plain(prob: BatchCostProblem, nu=None,
                             plan=None) -> dict:
    """Batched kernels vs plain version on the same inputs, with seeded
    per-lane cotangents (``plan`` as for :func:`compare_with_plain`):
    {"cost_rel" (worst lane), "cost_abs_err", "grad_rel",
    "grad_max_abs_err", "bitwise_repeat", "pad_lanes_zero"} (the last:
    every padded lane's cost and table rows exactly 0)."""
    B = prob.vis_ri.shape[0]
    w = lane_weights(B)
    plan = plan_of(prob) if plan is None else plan
    ck, gka, gkb = value_and_grad_batch(prob, nu, w, plan=plan)
    cp, gpa, gpb = value_and_grad_batch(prob, nu, w, plain=True)
    real = torch.as_tensor(prob.valid)
    ckd, cpd = ck.double().cpu(), cp.double().cpu()
    gk = torch.cat([gka.reshape(-1), gkb.reshape(-1)]).double()
    gp = torch.cat([gpa.reshape(-1), gpb.reshape(-1)]).double()
    args = (prob.tab_re, prob.tab_im, *prob.inputs,
            _nu_lanes(nu, B, prob.tab_re.device), nu is not None)
    r1 = fused_cost_batch_bwd_cuda(*args, plan=plan)
    r2 = fused_cost_batch_bwd_cuda(*args, plan=plan)
    mp = prob.tab_re.shape[1] // B
    pad_zero = True
    for lane in np.flatnonzero(~prob.valid):
        rows = slice(lane * mp, (lane + 1) * mp)
        pad_zero &= bool(ck[lane] == 0 and (gka[:, rows] == 0).all()
                         and (gkb[:, rows] == 0).all())
    return {
        "cost_rel": float(((ckd - cpd).abs() / cpd.abs())[real].max()),
        "cost_abs_err": float((ckd - cpd).abs().max()),
        "grad_rel": float(torch.linalg.norm(gk - gp) / torch.linalg.norm(gp)),
        "grad_max_abs_err": float((gk - gp).abs().max()),
        "bitwise_repeat": bool(torch.equal(r1[0], r2[0])
                               and torch.equal(r1[1], r2[1])),
        "pad_lanes_zero": pad_zero,
    }


def fused_cost_batch_work(prob: BatchCostProblem) -> dict:
    """Bytes and operations of the batched kernels for this batch, as
    :func:`fused_cost_work`: {"fwd": (bytes, flops), "bwd": ...}.  The
    per-lane nu is B floats; the forward writes B costs."""
    mrows, F, _, rowsp = prob.coh_ri.shape
    B = prob.vis_ri.shape[0]
    nbytes = lambda t: t.numel() * t.element_size()
    inputs = sum(nbytes(t) for t in (prob.tab_re, prob.tab_im,
                                     *prob.inputs)) + 4 * B
    tables = 2 * nbytes(prob.tab_re)
    cells, rows = mrows * F * rowsp, B * F * rowsp
    return {
        "fwd": (inputs + 4 * B, _MODEL_FLOPS * cells + _RESIDUAL_FLOPS * rows),
        "bwd": (inputs + tables,
                _BWD_FLOPS * cells + 2 * _RESIDUAL_FLOPS * rows),
    }


# ------------------------------------------------- kbisect probes (#7-#10)
#
# The probes of ``tools/kbisect.py``.  ``inputs`` is the probe's input
# tuple in its order (c: tab, oh; b: coh; a: antp, tab; f: antp, tab);
# probe a's row block is the tool's ``T``, read at call time.

# The JAX package's values of ``kbisect.py``'s six variants on its own
# inputs, recorded on the CPU (Pallas interpret mode, exact f32); a CPU
# test pins them to JAX's live output.  The port's variants draw the
# same bytes, so ``chip_smoke.py`` holds the card to these without
# importing JAX.
KBISECT_JAX_VALUES = {
    "c": -9362.337890625,
    "b": 32622.32421875,
    "a": 163.71005249023438,
    "f": 20.169593811035156,
    "d": 126.0821533203125,
    "e": 1091.026123046875,
}

PROBES = ("c", "b", "a", "f")


def random_probe_inputs(name: str, gen: torch.Generator, mp: int, T: int,
                        R: int = 1, npad: int = 128, stations: int = 62):
    """Seeded inputs of probe ``name`` on the generator's device:
    standard-normal f32 tables (and oh / coherencies), station indices
    in [0, stations) int32.  ``T`` is the columns of c and f and the row
    block of a; b has R T rows and a R T indices."""
    dev = gen.device
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    ant = lambda n: torch.randint(0, stations, (1, n), generator=gen,
                                  device=dev, dtype=torch.int32)
    return {
        "c": lambda: (randn(4 * mp, npad), randn(npad, T)),
        "b": lambda: (randn(mp, 1, 8, R * T),),
        "a": lambda: (ant(R * T), randn(4 * mp, npad)),
        "f": lambda: (ant(T), randn(4, mp, npad)),
    }[name]()


def mix_out_of_range(name: str, inputs):
    """Probe a or f inputs with station indices -1, npad and 200 mixed
    in -> (inputs, zero): ``zero`` (the output's last axis) marks the
    columns every index of which is out of range, whose output must be
    exactly 0.  Every 7th column is wholly out of range; a, whose
    columns take R indices, also gets every 5th revisit of every
    column out of range."""
    antp, tab = inputs
    npad = tab.shape[-1]
    bad = torch.tensor([-1, npad, 200], dtype=torch.int32, device=antp.device)
    ncols = antp.shape[1] if name == "f" else _kbisect().T
    a = antp.clone().reshape(-1, ncols)  # (revisits, columns)
    zero = torch.zeros(ncols, dtype=torch.bool, device=antp.device)
    zero[::7] = True
    a[:, zero] = bad[torch.arange(int(zero.sum()), device=a.device) % 3]
    if name == "a":
        a[::5] = bad[torch.arange(ncols, device=a.device) % 3]
    return (a.reshape(1, -1).contiguous(), tab), zero


def _kbisect():
    from sagecal_tpu_torch.tools import kbisect

    return kbisect


def compare_probe_with_plain(name: str, inputs, zero=None) -> dict:
    """Probe ``name``'s kernel (through its wrapper) against its plain
    version on the same inputs: {"rel" (max abs error over the plain
    output's max abs), "max_abs_err", "bitwise_repeat", "zeros_exact"
    (the ``zero`` columns exactly 0 in both; True without ``zero``)}."""
    kb = _kbisect()
    fn, plain = getattr(kb, f"probe_{name}"), getattr(kb, f"probe_{name}_plain")
    k1 = fn(*inputs)
    k2 = fn(*inputs)
    p = plain(*inputs)
    err = float((k1.double() - p.double()).abs().max())
    zeros = True
    if zero is not None:
        zeros = bool((k1[..., zero] == 0).all() and (p[..., zero] == 0).all())
    return {"rel": err / float(p.abs().max()), "max_abs_err": err,
            "bitwise_repeat": bool(torch.equal(k1, k2)), "zeros_exact": zeros}


def probe_library_call(name: str, inputs):
    """One PyTorch call computing probe ``name``'s whole function on
    these inputs, as a thunk (its output may drop the leading axis of
    1), or None where there is none: c and b are one ``torch.einsum``
    each; a and f select with a bounds mask first, so no single call
    computes them.  Call under ``full_f32`` (no TF32)."""
    if name == "c":
        tab, oh = inputs
        t = tab.view(tab.shape[0] // 4, 2, 2, tab.shape[1])
        # g[4m + 2p] g[4m + 2p + 1] summed over m and p = 0, 1
        return lambda: torch.einsum("mpn,nt,mpk,kt->t", t[:, :, 0], oh,
                                    t[:, :, 1], oh)
    if name == "b":
        (coh,) = inputs
        return lambda: torch.einsum("mfkr,mfkr->fkr", coh, coh)
    return None


def kbisect_work(name: str, inputs) -> tuple:
    """(bytes, flops, gathers): the least work probe ``name``'s function
    needs on these inputs.  Every input read once, the output written
    once; c and b the flops of their sums.  a and f depend on a column
    only through its station ``s = antp[t]``, so their least work
    reduces the table per station first (a: ``S[k, s] = sum_m tab[4m +
    k, s]``, f: ``P[s] = sum_m tab0 tab1 + tab2 tab3``; one flop per
    table word either way) and then gathers 4 words (a, which also adds
    its R revisits of a column) or 1 (f) per in-range index.  Out of
    range indices select nothing."""
    nbytes = sum(x.numel() * x.element_size() for x in inputs)
    if name == "c":
        tab, oh = inputs
        rows, cols = tab.shape[0], oh.shape[1]
        flops = 2 * rows * oh.shape[0] * cols + rows * cols
        return nbytes + 4 * cols, flops, 0
    if name == "b":
        mp, _, _, rows = inputs[0].shape
        return nbytes + 4 * 8 * rows, 2 * mp * 8 * rows, 0
    antp, tab = inputs
    npad = tab.shape[-1]
    valid = int(((antp >= 0) & (antp < npad)).sum())
    if name == "a":
        return (nbytes + 4 * 4 * _kbisect().T, tab.numel() + 4 * valid,
                4 * valid)
    return nbytes + 4 * antp.shape[1], tab.numel(), valid
