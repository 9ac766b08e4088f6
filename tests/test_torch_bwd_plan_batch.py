"""The backwards' station plan for the predict backward #2 and for B lanes
of the batched objective #6 sharing one plan, on the CPU, and the plan's
refusal of index tensors it was not built from.

The per-item contributions of ``plan_gradient`` (``test_torch_bwd_plan``)
summed segment by segment through the plan must give, for an upstream
model cotangent, the predict's gain cotangents (``fused_predict_packed_plain``'s
autograd at f64, and the JAX package's ``_fused_predict_bwd_impl`` in
interpret mode), and, lane by lane with one plan of the shared stations,
the batched objective's gradient (``fused_cost_packed_batch_plain`` at
f64, and the JAX batched kernel in interpret mode).  A lane whose mask is
all zero gets an exactly-zero gradient.

Tolerances as ``test_torch_bwd_plan.py``: the f64 segment sums agree with
autograd's f64 gradient to 1e-12 of its norm (summation order only);
against the JAX kernels, which compute in f32, 1e-5 of the norm.
"""

import numpy as np
import pytest
import torch

from test_torch_bwd_plan import _indices, _problem, plan_gradient
from torch_port_common import norm_rel


def _plain_predict_grad(p, g):
    from sagecal_tpu_torch.ops.rime_kernel import fused_predict_packed_plain

    a = p["tab_re"].clone().requires_grad_(True)
    b = p["tab_im"].clone().requires_grad_(True)
    model = fused_predict_packed_plain(a, b, p["coh_ri"], p["ant_p"],
                                       p["ant_q"], p["cmap"], p["nc"])
    return [x.numpy() for x in torch.autograd.grad(model, (a, b), g)]


@pytest.mark.parametrize("nc,npad,rows", [(1, 7, 600), (3, 200, 700)],
                         ids=["nc1-npad7-rows600", "nc3-npad200-rows700"])
def test_plan_segment_sums_give_the_plain_predict_gradient_f64(nc, npad,
                                                               rows):
    from sagecal_tpu_torch.ops.rime_kernel import BwdPlan

    rng = np.random.default_rng(rows + nc)
    p = _problem(rng, 3, 7, npad, 3, rows, nc, torch.float64)
    g = torch.as_tensor(rng.standard_normal((3, 8, rows)))
    plan = BwdPlan(p["ant_p"], p["ant_q"], p["cmap"], nc, npad)
    got = plan_gradient(p, plan, g=g)
    assert norm_rel(np.stack(got), np.stack(_plain_predict_grad(p, g))) \
        <= 1e-12


@pytest.mark.parametrize("nc", [1, 2], ids=["nc1", "nc2"])
def test_plan_segment_sums_match_jax_predict_kernel(nc):
    """On the JAX package's padded layout (rows to 128, clusters to 8,
    stations to NPAD), the plan's sums under the upstream cotangent give
    the Pallas predict backward's gain cotangents."""
    from test_torch_predict_kernel import _jax_predict_vjp, _port_inputs
    from test_torch_predict_kernel import _problem as jax_problem

    from sagecal_tpu_torch.ops.rime_kernel import BwdPlan

    jp = jax_problem(seed=nc + 20, nc=nc)
    _, gja, gjb = _jax_predict_vjp(jp, False)
    tre, tim, coh, antp, antq, cmap = _port_inputs(jp, False)
    p = dict(tab_re=tre, tab_im=tim, coh_ri=coh, ant_p=antp, ant_q=antq,
             cmap=cmap, nc=nc)
    plan = BwdPlan(antp, antq, cmap, nc, jp["npad"])
    got = plan_gradient(p, plan, g=torch.from_numpy(jp["g"]))
    assert norm_rel(np.stack(got), np.stack([gja, gjb])) <= 1e-5


def _lane(p, b, mp, nu):
    """Lane b of a batch in the batched layout, as one solo problem."""
    rows = slice(b * mp, (b + 1) * mp)
    return dict(tab_re=p["tab_re"][:, rows], tab_im=p["tab_im"][:, rows],
                coh_ri=p["coh_ri"][rows], ant_p=p["ant_p"],
                ant_q=p["ant_q"], vis_ri=p["vis_ri"][b],
                mask_p=p["mask_p"][b], cmap=None, nc=1,
                nu=None if nu is None else nu[b])


def batch_plan_gradient(p, plan, B, nu, weights):
    """The batched objective's d sum(w * costs) / d (tab_re, tab_im) from
    one shared plan: each lane's segment sums (:func:`plan_gradient`),
    scaled by its weight outside the sums, as ``_FusedCostBatch`` does,
    on the lane's own table rows."""
    mp = p["tab_re"].shape[1] // B
    parts = []
    for b in range(B):
        lane = _lane(p, b, mp, nu)
        parts.append([w * weights[b] for w in plan_gradient(lane, plan,
                                                            lane["nu"])])
    return [np.concatenate([part[k] for part in parts], axis=1)
            for k in range(2)]


def _batch(rng, B, M, N, F, rows, zero_lane):
    """B lanes in the batched layout sharing lane 0's stations (float64),
    the mask of lane ``zero_lane`` all zero."""
    lanes = [_problem(rng, M, N, N, F, rows, 1, torch.float64)
             for _ in range(B)]
    mask = torch.stack([lane["mask_p"] for lane in lanes])
    mask[zero_lane] = 0.0
    return dict(
        tab_re=torch.cat([lane["tab_re"] for lane in lanes], 1),
        tab_im=torch.cat([lane["tab_im"] for lane in lanes], 1),
        coh_ri=torch.cat([lane["coh_ri"] for lane in lanes]),
        ant_p=lanes[0]["ant_p"], ant_q=lanes[0]["ant_q"],
        vis_ri=torch.stack([lane["vis_ri"] for lane in lanes]),
        mask_p=mask)


@pytest.mark.parametrize("nu", [None, "per-lane"],
                         ids=["gauss", "robust-per-lane"])
def test_shared_plan_gives_the_batched_plain_gradient_f64(nu):
    from sagecal_tpu_torch.ops.rime_kernel import (
        BwdPlan, fused_cost_packed_batch_plain,
    )

    B, M, N = 4, 3, 7
    rng = np.random.default_rng(17)
    p = _batch(rng, B, M, N, 2, 600, zero_lane=2)
    nus = None if nu is None else torch.linspace(2.0, 12.0, B).double()
    w = rng.uniform(0.5, 1.5, B)
    plan = BwdPlan(p["ant_p"], p["ant_q"], None, 1, N)
    got = batch_plan_gradient(p, plan, B, nus, w)
    a = p["tab_re"].clone().requires_grad_(True)
    b = p["tab_im"].clone().requires_grad_(True)
    costs = fused_cost_packed_batch_plain(a, b, p["coh_ri"], p["ant_p"],
                                          p["ant_q"], p["vis_ri"],
                                          p["mask_p"], nus)
    want = [x.numpy() for x in torch.autograd.grad(costs, (a, b),
                                                   torch.as_tensor(w))]
    assert norm_rel(np.stack(got), np.stack(want)) <= 1e-12
    assert float(costs[2].detach()) == 0.0
    for table in got:  # the all-zero-mask lane: exactly zero
        assert not table[:, 2 * M:3 * M].any()


@pytest.mark.parametrize("nu_case", ["gauss", "robust-per-lane"])
def test_shared_plan_matches_jax_batched_kernel(nu_case):
    """The JAX package's batched problem (B = 3 lanes on its padded
    layout): one plan of the shared stations, lane by lane, gives the
    Pallas batched backward's gradient of the weighted total."""
    from test_torch_rime_kernel_batch import B, NU_CASES, _jax_batch, _weights

    from sagecal_tpu_torch.ops.rime_kernel import BwdPlan

    _, gja, gjb, port_in, mp, _ = _jax_batch(nu_case)
    tre, tim, coh_ri, antp, antq, vis_ri, mask_p = port_in
    p = dict(tab_re=tre, tab_im=tim, coh_ri=coh_ri, ant_p=antp, ant_q=antq,
             vis_ri=vis_ri, mask_p=mask_p)
    nu = NU_CASES[nu_case]
    nus = None if nu is None else torch.as_tensor(nu)
    plan = BwdPlan(antp, antq, None, 1, tre.shape[2])
    got = batch_plan_gradient(p, plan, B, nus, _weights())
    assert norm_rel(np.stack(got), np.stack([gja, gjb])) <= 1e-5


# ------------------------------------------ the plan refuses other indices


def _tile(seed=5, M=3, N=8, F=2, rows=300, nc=1):
    rng = np.random.default_rng(seed)
    return _problem(rng, M, N, N, F, rows, nc, torch.float32)


def _other(p, case):
    """(ant_p, ant_q, cmap) of the same shapes that the plan of ``p`` was
    not built from."""
    ap, aq, cmap = p["ant_p"], p["ant_q"], p["cmap"]
    if case == "equal-copy":
        return ap.clone(), aq, cmap
    if case == "other-stations":
        rng = np.random.default_rng(99)
        a, q = _indices(rng, 8, ap.shape[1])
        t = lambda x: torch.as_tensor(x, dtype=torch.int32)[None, :]
        return t(a), t(q), cmap
    if case == "modified-in-place":
        ap[0, :2] = ap[0, :2].flip(0)
        return ap, aq, cmap
    return ap, aq, cmap.clone()  # "other-chunk-map"


REFUSALS = ["equal-copy", "other-stations", "modified-in-place",
            "other-chunk-map"]


@pytest.mark.parametrize("case", REFUSALS)
def test_plan_refuses_index_tensors_it_was_not_built_from(case):
    """A plan of the same shapes built for other station indices (or
    another chunk map, or indices changed since) is refused, by ``check``
    and by every wrapper that takes a plan, before any backward."""
    from sagecal_tpu_torch.ops.rime_kernel import (
        BwdPlan, fused_cost_packed_hybrid, fused_predict_packed_hybrid,
    )

    p = _tile(nc=2)
    plan = BwdPlan(p["ant_p"], p["ant_q"], p["cmap"], 2, 8)
    plan.check(p["ant_p"], p["ant_q"], p["cmap"], 8, 2, 3)  # its own
    ap, aq, cmap = _other(p, case)
    with pytest.raises(ValueError, match="plan built from another"):
        plan.check(ap, aq, cmap, 8, 2, 3)
    with pytest.raises(ValueError, match="plan built from another"):
        fused_cost_packed_hybrid(p["tab_re"], p["tab_im"], p["coh_ri"], ap,
                                 aq, p["vis_ri"], p["mask_p"], cmap, 2,
                                 plan=plan)
    with pytest.raises(ValueError, match="plan built from another"):
        fused_predict_packed_hybrid(p["tab_re"], p["tab_im"], p["coh_ri"],
                                    ap, aq, cmap, 2, plan=plan)


def test_plan_of_lane_zero_serves_the_stacked_bucket_and_no_other():
    """``pack_cost_inputs_batch`` gives the bucket lane 0's packed
    indices; a plan built from them (as ``_make_fused_joint_cost_batch``
    builds it) is accepted for the stacked bucket, with the plain
    version's costs, and refused for lane 1's equal indices."""
    from sagecal_tpu_torch.ops.rime_kernel import (
        BwdPlan, fused_cost_packed_batch, pack_cost_inputs_batch,
        pack_gain_tables_batch, pack_predict_inputs,
    )

    B, M, N, F, rows = 3, 2, 6, 2, 150
    rng = np.random.default_rng(8)
    cplx = lambda *s: torch.as_tensor(rng.standard_normal(s)
                                      + 1j * rng.standard_normal(s))
    ant_p, ant_q = (torch.as_tensor(x) for x in _indices(rng, N, rows))
    vis, coh = cplx(B, F, 4, rows), cplx(B, M, F, 4, rows)
    mask = torch.ones((B, F, rows))
    vis_ri, mask_p, coh_ri, antp, antq = pack_cost_inputs_batch(
        vis, mask, coh, ant_p, ant_q, valid=[True, True, False])
    tre, tim = pack_gain_tables_batch(torch.eye(2) + 0.3 * cplx(B, M, N, 2, 2))
    plan = BwdPlan(antp, antq, None, 1, N)
    args = (tre, tim, coh_ri, antp, antq, vis_ri, mask_p, 5.0)
    assert torch.equal(fused_cost_packed_batch(*args, plan=plan),
                       fused_cost_packed_batch(*args))
    lane1 = pack_predict_inputs(vis[1], mask[1], coh[1], ant_p, ant_q)
    assert torch.equal(lane1[3], antp)  # equal values, another tensor
    with pytest.raises(ValueError, match="plan built from another"):
        fused_cost_packed_batch(tre, tim, coh_ri, lane1[3], lane1[4], vis_ri,
                                mask_p, 5.0, plan=plan)


# ------------------------------------- partial launches need the caller's buffers


BACKWARDS = {"cost": 7, "predict": 6, "cost_batch": 7}  # wrapper: its stages


@pytest.mark.parametrize("name,stages,match", [
    (name, st, m) for name, full in BACKWARDS.items()
    for st, m in ((full & 2, "pass the scratch"), (full | 8, "not a subset"),
                  (0, "not a subset"))])
def test_backward_wrappers_refuse_partial_stages_without_scratch(name, stages,
                                                                 match):
    """A launch of part of a backward (split timing) leaves the returned
    tables unwritten, so the wrappers refuse one whose caller passes no
    scratch buffers, and stage bits the backward does not have, before
    anything else; the whole backward passes that check (here, on CPU
    tensors, the launcher then refuses the device)."""
    from sagecal_tpu_torch.ops import rime_kernel as rk

    p = _tile()
    nu = rk._nu_cell(5.0, "cpu")
    launch = {
        "cost": lambda **kw: rk.fused_cost_bwd_cuda(
            p["tab_re"], p["tab_im"], p["coh_ri"], p["ant_p"], p["ant_q"],
            p["vis_ri"], p["mask_p"], nu, True, **kw),
        "predict": lambda **kw: rk.fused_predict_bwd_cuda(
            p["tab_re"], p["tab_im"], p["coh_ri"], p["ant_p"], p["ant_q"],
            torch.zeros((2, 8, p["ant_p"].shape[1])), **kw),
        "cost_batch": lambda **kw: rk.fused_cost_batch_bwd_cuda(
            p["tab_re"], p["tab_im"], p["coh_ri"], p["ant_p"], p["ant_q"],
            p["vis_ri"][None], p["mask_p"][None], nu, True, **kw),
    }[name]
    with pytest.raises(ValueError, match=match):
        launch(stages=stages)
    with pytest.raises(ValueError, match="CUDA"):
        launch(stages=BACKWARDS[name])
    with pytest.raises(ValueError, match="CUDA"):
        launch(stages=BACKWARDS[name] & 2, scratch={})
