"""Hold the fused-objective kernels against their plain PyTorch version.

Shared by the ``cuda``-marked tests and ``chip_smoke.py``: one seeded
random problem in the kernels' packed layout, and one comparison —
cost relative error, gradient error relative to the gradient's norm
(elementwise f32 gradient checks fail on summation order alone), and
whether two backward launches give bit-identical tables.

The visibilities are drawn independently of the model, so the residual
is of the model's size: the comparison then measures the kernels'
arithmetic, not the cancellation of a near-perfect fit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sagecal_tpu_torch.ops.rime_kernel import (
    _nu_cell, fused_cost_bwd_cuda, fused_cost_packed,
    fused_cost_packed_hybrid, fused_cost_packed_plain, pack_gain_tables,
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


def value_and_grad(prob: CostProblem, nu=None, plain: bool = False):
    """(cost, d cost / d tab_re, d cost / d tab_im) through the wrapper
    (kernels on CUDA tensors) or through the plain version."""
    a = prob.tab_re.detach().clone().requires_grad_(True)
    b = prob.tab_im.detach().clone().requires_grad_(True)
    if plain:
        cost = fused_cost_packed_plain(a, b, *prob.inputs, nu, prob.cmap,
                                       prob.nc)
    elif prob.nc > 1:
        cost = fused_cost_packed_hybrid(a, b, *prob.inputs, prob.cmap,
                                        prob.nc, nu)
    else:
        cost = fused_cost_packed(a, b, *prob.inputs, nu)
    ga, gb = torch.autograd.grad(cost, (a, b))
    return cost.detach(), ga, gb


def compare_with_plain(prob: CostProblem, nu=None) -> dict:
    """Kernels vs plain version on the same inputs: {"cost_rel",
    "cost_abs_err", "grad_rel", "grad_max_abs_err", "bitwise_repeat"}."""
    ck, gka, gkb = value_and_grad(prob, nu)
    cp, gpa, gpb = value_and_grad(prob, nu, plain=True)
    gk = torch.cat([gka.reshape(-1), gkb.reshape(-1)]).double()
    gp = torch.cat([gpa.reshape(-1), gpb.reshape(-1)]).double()
    args = (prob.tab_re, prob.tab_im, *prob.inputs,
            _nu_cell(nu, prob.tab_re.device), nu is not None, prob.cmap,
            prob.nc)
    r1 = fused_cost_bwd_cuda(*args)
    r2 = fused_cost_bwd_cuda(*args)
    return {
        "cost_rel": abs(float(ck) - float(cp)) / abs(float(cp)),
        "cost_abs_err": abs(float(ck) - float(cp)),
        "grad_rel": float(torch.linalg.norm(gk - gp) / torch.linalg.norm(gp)),
        "grad_max_abs_err": float((gk - gp).abs().max()),
        "bitwise_repeat": bool(torch.equal(r1[0], r2[0])
                               and torch.equal(r1[1], r2[1])),
    }


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
