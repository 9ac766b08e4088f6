"""The fused CUDA kernels (objective solo and batched, predict) and the
kbisect probes vs their plain PyTorch versions, the port's kbisect tool
against the JAX package's values, and the bit-reproducible solve, on
the card.

Marked ``cuda``: each test needs an NVIDIA GPU and skips without one
(decided in the fixture, never at import).  This file imports torch
only, so it runs on a machine without JAX; from the repo root::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances: cost relative error <= 1e-5 and gradient error <= 1e-5 of
the gradient's norm — both versions compute in f32 and differ only in
summation order (cluster sum per row, block tree, then block sum in the
kernels; torch's reductions in the plain version).  The backward must be
bit-identical on repeat: it uses no floating-point atomics.  A batched
lane whose mask is zero (a ragged bucket's pad) must give exactly zero
cost and cotangent.  The predict: model error <= 1e-5 of its max abs.
The backwards #4, #6 and #2 share one gradient kernel; each is held at
its edge shapes (``EDGE_4``, ``EDGE_6``, ``EDGE_2``; #6's and #2's
gradients within 1e-6 of their norm, as their f32 sums differ from the
plain version's in order only, bf16 coherencies being upcast exactly on
both sides), and a plan built once, a plan built per launch and the
kernels launched one at a time must give the same bits.
The LM assembly, the RTR gradient and Hessian-vector product, a whole
default-mode solve and a mode-5 (robust RTR) solve must be bit-identical
on repeat: they sum in a fixed order too.  The kbisect probes: max abs
error <= 1e-5 of the plain output's max abs, bit-identical on repeat,
exactly 0 where every station index is out of range.  The calibration
service at f32 ``--fused``: each route launches its kernels and none of
the other's, a failing kernel fails the run (no fallback), and each
dispatch's lanes are bit-identical to a direct batched solve.  The
consensus ADMM over bands on the card within 1e-8 relative of the CPU
at f64 on every ConsensusConfig route and in robust RTR-ADMM (mode 5,
before its trust region reaches the rounding floor), bit-identical on
repeat; the ``-f`` and ``-N`` apps at f32 launch #1 once per band per
tile (or minibatch),
repeat bit-identically, stay within 5e-3 of the CPU, and fail when #1
fails.  The spatially regularized consensus ADMM with the diffuse
constraint, and the federated minibatch round and average, on the card
within 1e-8 relative of the CPU at f64 and bit-identical on repeat; the
diffuse re-predict within 1e-10 of the CPU at f64 and 5e-3 at f32; #1
against its plain version (1e-5 of the model's max abs, bit-identical on
repeat) on a float32 tile whose diffuse cluster was predicted again.
The rows-sharded joint fit, the hierarchical sky predict, the widefield
app and the refinement gradient on the card within 1e-8 relative of the
CPU at f64 (the predict 1e-10 of its max abs), the sharded fit and the
predict bit-identical on repeat.  The fullbatch app stopped after its
first checkpoint and resumed gives an uninterrupted run's bits; a kernel
store built twice builds nothing the second time; a fleet worker on the
card gives the CPU's dispositions, its solutions within 5e-3.
"""

import os

import pytest
import torch

pytestmark = pytest.mark.cuda

NORTH_STAR = dict(M=100, N=62, F=2, rows=1891 * 60)  # 113,460 rows
SMALL = dict(M=3, N=7, F=2, rows=333)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU (README: port section)")
    return torch.device("cuda")


def _check(shape, nc, coh_dtype, nu, device):
    from sagecal_tpu_torch.kernels.parity import (
        compare_with_plain, random_cost_problem,
    )

    prob = random_cost_problem(**shape, nc=nc, coh_dtype=coh_dtype, seed=1,
                               device=device)
    out = compare_with_plain(prob, nu)
    assert out["cost_rel"] <= 1e-5, out
    assert out["grad_rel"] <= 1e-5, out
    assert out["bitwise_repeat"], out


@pytest.mark.parametrize("coh_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("nc", [1, 3], ids=["nc1", "nc3"])
@pytest.mark.parametrize("nu", [None, 5.0], ids=["gaussian", "robust"])
def test_kernels_match_plain_small(cuda, nu, nc, coh_dtype):
    _check(SMALL, nc, coh_dtype, nu, cuda)


@pytest.mark.parametrize("coh_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("nc", [1, 2], ids=["nc1", "nc2"])
@pytest.mark.parametrize("nu", [None, 5.0], ids=["gaussian", "robust"])
def test_kernels_match_plain_north_star(cuda, nu, nc, coh_dtype):
    _check(NORTH_STAR, nc, coh_dtype, nu, cuda)


# kernel #4's edge shapes: rows past 2048 (more than one block of 8 row
# tiles of 256, so several partial tables are summed) with a ragged end,
# or fewer; clusters not a multiple of the 3 a block takes; npad 200;
# nc 3; bf16 with rows that do and do not take 16-byte copies; robust and
# Gaussian; and npad * nc past 2695, where one cluster's gains and sums
# no longer fit in a block's shared memory and the (chunk, station) keys
# are split over blocks (npad 2400 still fits, one cluster a block)
EDGE_4 = [  # (M, N, F, rows, nc, coh dtype, nu)
    (11, 30, 2, 1500, 1, torch.float32, None),
    (11, 30, 2, 2333, 1, torch.bfloat16, 5.0),
    (5, 200, 2, 2333, 1, torch.float32, 5.0),
    (7, 20, 3, 2333, 3, torch.float32, 5.0),
    (7, 20, 2, 2336, 3, torch.bfloat16, None),
    (4, 2400, 2, 2333, 1, torch.float32, None),
    (4, 1000, 2, 2333, 3, torch.float32, 5.0),
    (3, 3000, 2, 2336, 1, torch.bfloat16, None),
]


@pytest.mark.parametrize(
    "M,N,F,rows,nc,coh_dtype,nu", EDGE_4,
    ids=[f"M{c[0]}-npad{c[1]}-F{c[2]}-rows{c[3]}-nc{c[4]}-"
         f"{str(c[5]).split('.')[-1]}-{'robust' if c[6] else 'gauss'}"
         for c in EDGE_4])
def test_cost_bwd_edge_shapes_match_plain(cuda, M, N, F, rows, nc,
                                          coh_dtype, nu):
    _check(dict(M=M, N=N, F=F, rows=rows), nc, coh_dtype, nu, cuda)


def test_cost_bwd_plan_given_or_built_and_stages_agree_bitwise(cuda):
    """A plan built once gives the same bits as one built per launch, and
    the three kernels launched one at a time (cotangent, gradient, sum)
    give the whole launch's tables."""
    from sagecal_tpu_torch.kernels.parity import random_cost_problem
    from sagecal_tpu_torch.ops.rime_kernel import (
        BwdPlan, _nu_cell, fused_cost_bwd_cuda,
    )

    prob = random_cost_problem(7, 20, 2, 1111, nc=3, seed=3, device=cuda)
    args = (prob.tab_re, prob.tab_im, *prob.inputs, _nu_cell(5.0, cuda), True,
            prob.cmap, prob.nc)
    whole = fused_cost_bwd_cuda(*args)
    plan = BwdPlan(prob.ant_p, prob.ant_q, prob.cmap, prob.nc,
                   prob.tab_re.shape[2])
    planned = fused_cost_bwd_cuda(*args, plan=plan)
    scratch = {}
    for stages in (1, 2, 4):
        staged = fused_cost_bwd_cuda(*args, plan=plan, stages=stages,
                                     scratch=scratch)
    for got in (planned, staged):
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])


# kernel #2's edge shapes, as EDGE_4 (it runs #4's gradient and sum
# kernels on the caller's cotangent): rows past 2048 with a ragged end;
# clusters not a multiple of 3; npad 200 and F 3; bf16 with rows that do
# (2336) and do not (2333) take 16-byte copies; nc 3; and npad 3000, where
# the (chunk, station) keys are split over blocks
EDGE_2 = [  # (M, N, F, rows, nc, coh dtype)
    (11, 30, 2, 2333, 1, torch.float32),
    (5, 200, 3, 2333, 1, torch.float32),
    (11, 30, 2, 2333, 1, torch.bfloat16),
    (7, 20, 2, 2336, 1, torch.bfloat16),
    (7, 20, 3, 2333, 3, torch.float32),
    (7, 20, 2, 2336, 3, torch.bfloat16),
    (3, 3000, 2, 2336, 1, torch.float32),
]


@pytest.mark.parametrize(
    "M,N,F,rows,nc,coh_dtype", EDGE_2,
    ids=[f"M{c[0]}-npad{c[1]}-F{c[2]}-rows{c[3]}-nc{c[4]}-"
         f"{str(c[5]).split('.')[-1]}" for c in EDGE_2])
def test_predict_bwd_edge_shapes_match_plain(cuda, M, N, F, rows, nc,
                                             coh_dtype):
    from sagecal_tpu_torch.kernels.parity import (
        compare_predict_with_plain, random_cost_problem,
    )

    prob = random_cost_problem(M, N, F, rows, nc=nc, coh_dtype=coh_dtype,
                               seed=6, device=cuda)
    out = compare_predict_with_plain(prob, seed=2)
    assert out["model_rel"] <= 1e-5, out
    assert out["grad_rel"] <= 1e-6, out  # summation order only
    assert out["bitwise_repeat"], out


def test_predict_bwd_plan_given_or_built_and_stages_agree_bitwise(cuda):
    """#2 on a plan built once gives the same bits as on one built per
    launch, and its two kernels launched one at a time (gradient, sum)
    give the whole launch's tables; the plan of other indices of the same
    shape is refused."""
    from sagecal_tpu_torch.kernels.parity import (
        model_cotangent, plan_of, random_cost_problem,
    )
    from sagecal_tpu_torch.ops.rime_kernel import fused_predict_bwd_cuda

    prob = random_cost_problem(7, 20, 2, 1111, nc=3, seed=3, device=cuda)
    args = (prob.tab_re, prob.tab_im, prob.coh_ri, prob.ant_p, prob.ant_q,
            model_cotangent(prob, 4), prob.cmap, prob.nc)
    whole = fused_predict_bwd_cuda(*args)
    plan = plan_of(prob)
    planned = fused_predict_bwd_cuda(*args, plan=plan)
    scratch = {}
    for stages in (2, 4):
        staged = fused_predict_bwd_cuda(*args, plan=plan, stages=stages,
                                        scratch=scratch)
    for got in (planned, staged):
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
    other = args[:3] + (prob.ant_p.clone(),) + args[4:]
    with pytest.raises(ValueError, match="plan built from another"):
        fused_predict_bwd_cuda(*other, plan=plan)


def test_launch_counters_count_kernel_launches(cuda):
    from sagecal_tpu_torch.kernels.parity import (
        random_cost_problem, value_and_grad,
    )
    from sagecal_tpu_torch.ops.rime_kernel import (
        fused_cost_bwd_cuda, fused_cost_fwd_cuda,
    )

    prob = random_cost_problem(**SMALL, device=cuda)
    f0, b0 = fused_cost_fwd_cuda.launches, fused_cost_bwd_cuda.launches
    value_and_grad(prob, 5.0)
    assert fused_cost_fwd_cuda.launches == f0 + 1
    assert fused_cost_bwd_cuda.launches == b0 + 1
    # the plain version launches neither kernel
    value_and_grad(prob, 5.0, plain=True)
    assert fused_cost_fwd_cuda.launches == f0 + 1
    assert fused_cost_bwd_cuda.launches == b0 + 1


def test_wrapper_rejects_bad_inputs_on_cuda(cuda):
    from sagecal_tpu_torch.kernels.parity import random_cost_problem
    from sagecal_tpu_torch.ops.rime_kernel import fused_cost_packed

    prob = random_cost_problem(**SMALL, device=cuda)
    with pytest.raises(ValueError):
        fused_cost_packed(prob.tab_re, prob.tab_im, prob.coh_ri.double(),
                          prob.ant_p, prob.ant_q, prob.vis_ri, prob.mask_p)
    with pytest.raises(ValueError):
        fused_cost_packed(prob.tab_re, prob.tab_im, prob.coh_ri,
                          prob.ant_p.cpu(), prob.ant_q, prob.vis_ri,
                          prob.mask_p)


# ------------------------------------------- batched objective (#5, #6)

BATCH_MID = dict(B=5, M=8, N=30, F=2, rows=435 * 20)  # 8,700 rows a lane


@pytest.mark.parametrize("nvalid", [None, 3], ids=["full", "ragged"])
@pytest.mark.parametrize("coh_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("nu", [None, 5.0, "per-lane"],
                         ids=["gaussian", "robust", "robust-per-lane"])
def test_batched_kernels_match_plain(cuda, nu, coh_dtype, nvalid):
    from sagecal_tpu_torch.kernels.parity import (
        compare_batch_with_plain, random_cost_problem_batch,
    )

    prob = random_cost_problem_batch(**BATCH_MID, coh_dtype=coh_dtype,
                                     seed=2, nvalid=nvalid, device=cuda)
    if nu == "per-lane":
        nu = torch.linspace(2.0, 12.0, BATCH_MID["B"], device=cuda)
    out = compare_batch_with_plain(prob, nu)
    assert out["cost_rel"] <= 1e-5, out
    assert out["grad_rel"] <= 1e-5, out
    assert out["bitwise_repeat"], out
    assert out["pad_lanes_zero"], out


# kernel #6's edge shapes: B = 1 and B = 16 with an all-zero lane; rows
# past 2048 with a ragged end; clusters not a multiple of 3; npad 200 and
# F 3; bf16 with (2336 rows) and without (2333) 16-byte copies; robust
# (per-lane nu) and Gaussian
EDGE_6 = [  # (B, M, N, F, rows, coh dtype, nu, valid lanes)
    (1, 8, 62, 2, 2333, torch.float32, "per-lane", None),
    (16, 8, 30, 2, 2333, torch.float32, "per-lane", 15),
    (4, 11, 30, 2, 2336, torch.bfloat16, None, 3),
    (3, 5, 200, 3, 2333, torch.float32, 5.0, None),
    (3, 7, 20, 2, 2333, torch.bfloat16, "per-lane", 2),
]


@pytest.mark.parametrize(
    "B,M,N,F,rows,coh_dtype,nu,nvalid", EDGE_6,
    ids=[f"B{c[0]}-M{c[1]}-npad{c[2]}-F{c[3]}-rows{c[4]}-"
         f"{str(c[5]).split('.')[-1]}-{c[6] or 'gauss'}-valid{c[7] or c[0]}"
         for c in EDGE_6])
def test_batched_bwd_edge_shapes_match_plain(cuda, B, M, N, F, rows,
                                             coh_dtype, nu, nvalid):
    from sagecal_tpu_torch.kernels.parity import (
        compare_batch_with_plain, random_cost_problem_batch,
    )

    prob = random_cost_problem_batch(B, M, N, F, rows, coh_dtype=coh_dtype,
                                     seed=5, nvalid=nvalid, device=cuda)
    if nu == "per-lane":
        nu = torch.linspace(2.0, 12.0, B, device=cuda)
    out = compare_batch_with_plain(prob, nu)
    assert out["cost_rel"] <= 1e-5, out
    assert out["grad_rel"] <= 1e-6, out  # summation order only
    assert out["bitwise_repeat"], out
    assert out["pad_lanes_zero"], out


def test_batched_bwd_plan_given_or_built_and_stages_agree_bitwise(cuda):
    """#6 on one plan for the lanes, built once, gives the same bits as
    on one built per launch, and its three kernels launched one at a time
    (cotangent, gradient, sum) give the whole launch's tables."""
    from sagecal_tpu_torch.kernels.parity import (
        plan_of, random_cost_problem_batch,
    )
    from sagecal_tpu_torch.ops.rime_kernel import (
        _nu_lanes, fused_cost_batch_bwd_cuda,
    )

    prob = random_cost_problem_batch(3, 7, 20, 2, 1111, seed=3, nvalid=2,
                                     device=cuda)
    args = (prob.tab_re, prob.tab_im, *prob.inputs,
            _nu_lanes(torch.tensor([2.0, 5.0, 9.0]), 3, cuda), True)
    whole = fused_cost_batch_bwd_cuda(*args)
    plan = plan_of(prob)
    planned = fused_cost_batch_bwd_cuda(*args, plan=plan)
    scratch = {}
    for stages in (1, 2, 4):
        staged = fused_cost_batch_bwd_cuda(*args, plan=plan, stages=stages,
                                           scratch=scratch)
    for got in (planned, staged):
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])


def test_batched_kernels_count_launches_and_solo_ones_do_not(cuda):
    from sagecal_tpu_torch.kernels.parity import (
        random_cost_problem_batch, value_and_grad_batch,
    )
    from sagecal_tpu_torch.ops import rime_kernel as rk

    prob = random_cost_problem_batch(3, 3, 7, 2, 333, device=cuda)
    counts = lambda: (rk.fused_cost_batch_fwd_cuda.launches,
                      rk.fused_cost_batch_bwd_cuda.launches,
                      rk.fused_cost_fwd_cuda.launches,
                      rk.fused_cost_bwd_cuda.launches)
    before = counts()
    value_and_grad_batch(prob, 5.0)
    assert counts() == (before[0] + 1, before[1] + 1) + before[2:]
    value_and_grad_batch(prob, 5.0, plain=True)
    assert counts() == (before[0] + 1, before[1] + 1) + before[2:]


def test_batched_wrapper_rejects_bad_inputs_on_cuda(cuda):
    from sagecal_tpu_torch.kernels.parity import random_cost_problem_batch
    from sagecal_tpu_torch.ops.rime_kernel import (
        fused_cost_batch_fwd_cuda, fused_cost_packed_batch,
    )

    prob = random_cost_problem_batch(3, 3, 7, 2, 333, device=cuda)
    coh, antp, antq, vis, mask = prob.inputs
    bad = [
        (coh.double(), antp, antq, vis, mask),  # dtype
        (coh, antp.long(), antq, vis, mask),  # index dtype
        (coh[:6], antp, antq, vis, mask),  # cluster rows vs tables
        (coh, antp, antq, vis[:2], mask),  # lanes vs tables
        (coh, antp.cpu(), antq, vis, mask),  # device
    ]
    for inputs in bad:
        with pytest.raises(ValueError):
            fused_cost_packed_batch(prob.tab_re, prob.tab_im, *inputs, 5.0)
    with pytest.raises(ValueError):  # nu must be one f32 per lane
        fused_cost_batch_fwd_cuda(prob.tab_re, prob.tab_im, *prob.inputs,
                                  torch.ones(2, device=cuda), True)


# ----------------------------------------------- fused predict (#1, #2)


@pytest.mark.parametrize("coh_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("nc", [1, 3], ids=["nc1", "nc3"])
def test_predict_kernels_match_plain_small(cuda, nc, coh_dtype):
    """Model within 1e-5 of its max abs, gain cotangent within 1e-5 of its
    norm under a random upstream cotangent, #2 bit-identical on repeat,
    and a coherency gradient refused."""
    from sagecal_tpu_torch.kernels.parity import (
        compare_predict_with_plain, random_cost_problem,
    )

    prob = random_cost_problem(**SMALL, nc=nc, coh_dtype=coh_dtype, seed=4,
                               device=cuda)
    out = compare_predict_with_plain(prob, seed=1)
    assert out["model_rel"] <= 1e-5, out
    assert out["grad_rel"] <= 1e-5, out
    assert out["bitwise_repeat"], out
    assert out["sky_error_raised"], out


def _small_tile(device, nstations=20, tilesz=12, nclusters=4):
    """A seeded f32 tile on the card: point clusters, gains identity +
    0.2 complex-normal, noise 1e-3, solves from the identity."""
    import numpy as np

    from sagecal_tpu_torch.core.types import jones_to_params
    from sagecal_tpu_torch.io.simulate import (
        corrupt_and_observe, make_visdata, random_jones,
    )
    from sagecal_tpu_torch.ops.rime import point_source_batch
    from sagecal_tpu_torch.solvers.sage import build_cluster_data

    rng = np.random.default_rng(3)
    data = make_visdata(nstations=nstations, tilesz=tilesz, nchan=2,
                        device=device)
    clusters = [point_source_batch(rng.uniform(-0.02, 0.02, 2),
                                   rng.uniform(-0.02, 0.02, 2),
                                   rng.uniform(1.0, 5.0, 2), device=device)
                for _ in range(nclusters)]
    truth = random_jones(nclusters, nstations, seed=5, amp=0.2, device=device)
    data = corrupt_and_observe(data, clusters, jones=truth, noise_sigma=1e-3)
    cdata = build_cluster_data(data, clusters, [1] * nclusters)
    p0 = jones_to_params(random_jones(nclusters, nstations, seed=9, amp=0.0,
                                      device=device))[:, None, :]
    return data, cdata, p0


def test_assemble_normal_eq_bit_identical_on_repeat(cuda):
    """The LM assembly sums in a fixed order: no float atomics."""
    from sagecal_tpu_torch.solvers.lm import NormalEqPlan, _assemble_normal_eq

    data, cdata, p0 = _small_tile(cuda, nstations=40, tilesz=30)
    p = p0[0] + 0.05 * torch.randn(p0[0].shape, device=cuda,
                                   generator=torch.Generator(device=cuda).manual_seed(0))
    plan = NormalEqPlan(data.ant_p, data.ant_q, cdata.chunk_map[0], 1,
                        p.shape[-1] // 8)
    args = (p, cdata.coh[0], data.vis, data.mask, data.ant_p, data.ant_q,
            cdata.chunk_map[0], plan, None)
    first = _assemble_normal_eq(*args)
    for _ in range(3):
        again = _assemble_normal_eq(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "torch-op"])
def test_short_sagefit_bit_identical_on_repeat(cuda, fused):
    """Two default-mode solves of one tile give the same bits (mode 3:
    OS-LM, robust LM and the joint LBFGS)."""
    from sagecal_tpu_torch.solvers.sage import SageConfig, sagefit

    data, cdata, p0 = _small_tile(cuda)
    cfg = SageConfig(solver_mode=3, max_emiter=2, max_iter=4, max_lbfgs=6,
                     use_fused_predict=fused)
    a = sagefit(data, cdata, p0, cfg, device=cuda)
    b = sagefit(data, cdata, p0, cfg, device=cuda)
    assert torch.equal(a.p, b.p)
    assert torch.equal(a.res_1, b.res_1)
    assert float(a.res_1) < float(a.res_0)


def test_calculate_residuals_launches_predict_kernel_once(cuda):
    from sagecal_tpu_torch.ops.residual import calculate_residuals
    from sagecal_tpu_torch.ops.rime_kernel import fused_predict_fwd_cuda
    from sagecal_tpu_torch.solvers.sage import predict_full_model

    data, cdata, p0 = _small_tile(cuda)
    before = fused_predict_fwd_cuda.launches
    res = calculate_residuals(data, cdata, p0)
    assert fused_predict_fwd_cuda.launches == before + 1
    want = data.vis - predict_full_model(p0, cdata, data)
    assert float((res - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ------------------------------------------- kbisect probes (#7-#10)
#
# Expected values come from the plain versions and from
# ``KBISECT_JAX_VALUES`` (the JAX package's values, recorded on the CPU):
# this file imports neither JAX nor the root ``kbisect.py``.

KBISECT_SHAPES = {"kbisect": dict(mp=8, T=256, R=2),
                  "mp16-r3": dict(mp=16, T=256, R=3)}


def _probe_inputs(name, shape, device, seed=0):
    from sagecal_tpu_torch.kernels.parity import random_probe_inputs

    gen = torch.Generator(device=device).manual_seed(seed)
    return random_probe_inputs(name, gen, **KBISECT_SHAPES[shape])


@pytest.mark.parametrize("shape", list(KBISECT_SHAPES))
@pytest.mark.parametrize("name", ["c", "b", "a", "f"])
def test_kbisect_probe_matches_plain(cuda, name, shape):
    """Within 1e-5 of the plain output's max abs, bit-identical on
    repeat."""
    from sagecal_tpu_torch.kernels.parity import compare_probe_with_plain

    inputs = _probe_inputs(name, shape, cuda)
    out = compare_probe_with_plain(name, inputs)
    assert out["rel"] <= 1e-5, out
    assert out["bitwise_repeat"], out


@pytest.mark.parametrize("mp,T,npad", [(13, 1000, 100), (3, 130, 7),
                                         (20, 517, 64)],
                         ids=["mp13-T1000-npad100", "mp3-T130-npad7",
                              "mp20-T517-npad64"])
def test_kbisect_probe_c_off_tile_shapes_match_plain(cuda, mp, T, npad):
    """#7 where no extent is a multiple of its tiles (128 columns, 64
    rows) or of its 16-byte copies."""
    from sagecal_tpu_torch.kernels.parity import (
        compare_probe_with_plain, random_probe_inputs,
    )

    gen = torch.Generator(device=cuda).manual_seed(2)
    out = compare_probe_with_plain(
        "c", random_probe_inputs("c", gen, mp=mp, T=T, npad=npad))
    assert out["rel"] <= 1e-5, out
    assert out["bitwise_repeat"], out


@pytest.mark.parametrize("name", ["a", "f"])
def test_kbisect_out_of_range_indices_give_exact_zeros(cuda, name):
    from sagecal_tpu_torch.kernels.parity import (
        compare_probe_with_plain, mix_out_of_range,
    )

    inputs = _probe_inputs(name, "mp16-r3", cuda, seed=1)
    inputs, zero = mix_out_of_range(name, inputs)
    out = compare_probe_with_plain(name, inputs, zero)
    assert out["zeros_exact"] and out["rel"] <= 1e-5, out


def test_kbisect_probe_b_refuses_more_than_one_channel(cuda):
    from sagecal_tpu_torch.tools.kbisect import probe_b

    with pytest.raises(ValueError):
        probe_b(torch.zeros((8, 2, 8, 512), device=cuda))


@pytest.mark.parametrize("name", ["c", "b", "a", "f"])
def test_kbisect_probe_counts_its_launches(cuda, name):
    from sagecal_tpu_torch.tools import kbisect as kb

    inputs = _probe_inputs(name, "kbisect", cuda)
    launcher = getattr(kb, f"probe_{name}_cuda")
    before = launcher.launches
    getattr(kb, f"probe_{name}")(*inputs)
    assert launcher.launches == before + 1
    getattr(kb, f"probe_{name}_plain")(*inputs)
    assert launcher.launches == before + 1


@pytest.mark.parametrize("name", ["c", "b", "a", "f"])
def test_kbisect_wrappers_reject_mixes_and_dtypes(cuda, name):
    from sagecal_tpu_torch.tools import kbisect as kb

    inputs = _probe_inputs(name, "kbisect", cuda)
    fn = getattr(kb, f"probe_{name}")
    bad = [tuple(x.double() if x.is_floating_point() else x.long()
                 for x in inputs)]  # wrong dtypes
    if len(inputs) > 1:  # CPU/CUDA mixes, either way round
        bad += [(inputs[0].cpu(),) + inputs[1:],
                inputs[:-1] + (inputs[-1].cpu(),)]
    for args in bad:
        with pytest.raises(ValueError):
            fn(*args)


# #9 and #10 reduce the table per station, then gather:
# npad around and far above a reduce block's 16-station slice, column
# counts off the gather blocks (f: 256 columns, a: 16), and the table
# through shared memory only in the one-launch form (stages 4).

GATHER_NPAD = [7, 100, 128, 3000]


def _gather_inputs(name, device, mp, npad, T=1000, R=3, seed=3,
                   stations=None):
    """Seeded inputs of probe a or f with every station of the table
    drawn (``stations`` defaults to npad)."""
    from sagecal_tpu_torch.kernels.parity import random_probe_inputs

    gen = torch.Generator(device=device).manual_seed(seed)
    return random_probe_inputs(name, gen, mp=mp, T=T, R=R, npad=npad,
                               stations=stations or npad)


@pytest.mark.parametrize("npad", GATHER_NPAD)
@pytest.mark.parametrize("name", ["a", "f"])
def test_kbisect_gather_probes_match_plain_at_npad(cuda, name, npad,
                                                   monkeypatch):
    """Within 1e-5 of the plain output's max abs and bit-identical on
    repeat, at a column count that is not a multiple of the gather block
    (f: T 1000 of 256-column blocks; a: T 100 of 16-column blocks)."""
    from sagecal_tpu_torch.kernels.parity import compare_probe_with_plain
    from sagecal_tpu_torch.tools import kbisect as kb

    monkeypatch.setattr(kb, "T", 100)
    inputs = _gather_inputs(name, cuda, 13, npad, T=kb.T if name == "a"
                            else 1000)
    out = compare_probe_with_plain(name, inputs)
    assert out["rel"] <= 1e-5 and out["bitwise_repeat"], out


@pytest.mark.parametrize("name", ["a", "f"])
def test_kbisect_gather_probes_take_npad_above_shared_memory(cuda, name):
    """npad 20,000 (S or P beyond a block's shared memory): the default
    two launches keep the sums in global memory and match the plain
    version; the one-launch form, which holds them in shared memory,
    refuses with ValueError."""
    from sagecal_tpu_torch.kernels.parity import compare_probe_with_plain
    from sagecal_tpu_torch.tools import kbisect as kb

    inputs = _gather_inputs(name, cuda, 5, 20000, T=512 if name == "f"
                            else kb.T, R=2)
    out = compare_probe_with_plain(name, inputs)
    assert out["rel"] <= 1e-5 and out["bitwise_repeat"], out
    with pytest.raises(ValueError, match="one-launch"):
        getattr(kb, f"probe_{name}_cuda")(*inputs, stages=4)


@pytest.mark.parametrize("name,T", [("a", 256), ("f", 256), ("f", 113664)],
                         ids=["a-T256", "f-T256", "f-T113664"])
def test_kbisect_gather_probe_forms_agree(cuda, name, T):
    """The two-launch form's reduction and gather launched one at a time
    on one scratch give its bits; the one-launch form matches the plain
    version within 1e-5 of its max abs, bit-identical on repeat; the
    default launch gives the bits of the form the kernel names as its
    default for the shape; stage values other than 1-4, and a half launch
    without scratch, raise ValueError.  mp 104; a at the north-star width
    (R 444 x the tool's T 256), f at kbisect's T and the north-star
    width's."""
    from sagecal_tpu_torch.kernels.build import load
    from sagecal_tpu_torch.tools import kbisect as kb

    inputs = _gather_inputs(name, cuda, 104, 128, T=T, R=444, stations=62)
    launch = getattr(kb, f"probe_{name}_cuda")
    two = launch(*inputs, stages=3).clone()
    scratch = {}
    launch(*inputs, stages=1, scratch=scratch)
    launch(*inputs, stages=2, scratch=scratch)
    assert torch.equal(scratch["out"], two)
    one = launch(*inputs, stages=4).clone()
    assert torch.equal(launch(*inputs, stages=4), one)
    plain = getattr(kb, f"probe_{name}_plain")(*inputs)
    for out in (one, two):
        err = float((out.double() - plain.double()).abs().max())
        assert err <= 1e-5 * float(plain.abs().max())
    default = getattr(load(f"kbisect_{name}"),
                      f"kbisect_{name}_default_stages")(104, 128, T)
    assert torch.equal(launch(*inputs), {3: two, 4: one}[default])
    for bad in ({"stages": 0}, {"stages": 5}, {"stages": 1},
                {"stages": 2}):
        with pytest.raises(ValueError):
            launch(*inputs, **bad)


def test_kbisect_probe_f_columns_of_one_station_agree_bitwise(cuda):
    """#10 reduces per station: every column of one station gets the same
    bits, whatever its place in the launch."""
    from sagecal_tpu_torch.tools import kbisect as kb

    antp, tab = _gather_inputs("f", cuda, 104, 128, T=113664, stations=62)
    out = kb.probe_f(antp, tab)[0]
    a = antp[0].long()
    for s in range(62):
        col = out[a == s]
        assert col.numel() > 0 and bool((col == col[0]).all()), s


@pytest.mark.parametrize("R", [1, 444])
def test_kbisect_probe_a_at_revisits(cuda, R):
    """#9 at one revisit (one r chunk of 64 used) and at the north-star
    width's 444 (each chunk 7 revisits): within 1e-5 of the plain
    output's max abs, bit-identical on repeat; with out-of-range indices
    mixed in (R 444; at R 1 ``mix_out_of_range`` empties every column),
    exact zeros where every index of a column is out of range."""
    from sagecal_tpu_torch.kernels.parity import (
        compare_probe_with_plain, mix_out_of_range,
    )

    inputs = _gather_inputs("a", cuda, 104, 128, T=256, R=R, stations=62)
    out = compare_probe_with_plain("a", inputs)
    assert out["rel"] <= 1e-5 and out["bitwise_repeat"], out
    if R == 1:
        return
    mixed, zero = mix_out_of_range("a", inputs)
    out = compare_probe_with_plain("a", mixed, zero)
    assert out["rel"] <= 1e-5 and out["zeros_exact"], out


def test_kbisect_tool_matches_jax_values_on_the_card(cuda):
    """Every variant of the tool runs on the card, each probe and the
    predict kernels launch as the variant says, and every value is
    within 1e-5 of the JAX package's."""
    from sagecal_tpu_torch.kernels.parity import KBISECT_JAX_VALUES
    from sagecal_tpu_torch.ops import rime_kernel as rk
    from sagecal_tpu_torch.tools import kbisect as kb

    counters = [kb.probe_c_cuda, kb.probe_b_cuda, kb.probe_a_cuda,
                kb.probe_f_cuda, rk.fused_predict_fwd_cuda,
                rk.fused_predict_bwd_cuda]
    before = [c.launches for c in counters]
    out = kb.run(["c", "b", "a", "d", "e", "f"])
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [1, 1, 1, 1, 2, 1]
    for name, v in out.items():
        want = KBISECT_JAX_VALUES[name]
        assert abs(v["val"] - want) <= 1e-5 * abs(want), (name, v)


def test_mode5_tile_bit_identical_and_launches_objective(cuda):
    """A mode-5 tile (robust RTR EM, then the fused robust LBFGS) run
    twice gives the same bits, and the objective kernels #3/#4 launch."""
    from sagecal_tpu_torch.ops.rime_kernel import (
        fused_cost_bwd_cuda, fused_cost_fwd_cuda,
    )
    from sagecal_tpu_torch.solvers.sage import SageConfig, sagefit

    data, cdata, p0 = _small_tile(cuda)
    cfg = SageConfig(solver_mode=5, max_emiter=2, max_iter=3, max_lbfgs=6,
                     use_fused_predict=True)
    fused_cost_fwd_cuda.launches = 0
    fused_cost_bwd_cuda.launches = 0
    a = sagefit(data, cdata, p0, cfg, device=cuda)
    assert fused_cost_fwd_cuda.launches > 0
    assert fused_cost_bwd_cuda.launches > 0
    b = sagefit(data, cdata, p0, cfg, device=cuda)
    assert torch.equal(a.p, b.p) and torch.equal(a.res_1, b.res_1)
    assert float(a.res_1) < float(a.res_0)


def test_rtr_hessian_vector_product_bit_identical_on_repeat(cuda):
    """The RTR gradient and Hessian-vector product sum per station in a
    fixed order: no float atomics, the same bits on every call."""
    from sagecal_tpu_torch.core.types import params_to_jones
    from sagecal_tpu_torch.solvers.lm import NormalEqPlan
    from sagecal_tpu_torch.solvers.rtr import _Fns

    data, cdata, p0 = _small_tile(cuda, nstations=40, tilesz=30)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = params_to_jones(p0[0] + 0.05 * torch.randn(
        p0[0].shape, device=cuda, generator=gen))
    eta = params_to_jones(torch.randn(p0[0].shape, device=cuda,
                                      generator=gen))
    plan = NormalEqPlan(data.ant_p, data.ant_q, cdata.chunk_map[0], 1,
                   p0.shape[-1] // 8)
    first = None
    for _ in range(4):
        fns = _Fns(data.vis, cdata.coh[0], data.mask, plan)
        out = (fns.grad(x), fns.hess(x, eta), fns.cost(x))
        if first is None:
            first = out
        assert all(torch.equal(a, b) for a, b in zip(first, out))


@pytest.mark.parametrize("mode", [3, 5])
def test_telemetry_and_quality_leave_the_solve_unchanged(cuda, mode):
    """A fused solve with ``collect_telemetry`` and ``collect_quality``
    on gives the bits of the same solve with both off, launches the
    objective kernels as often and reads back to the host no more often
    (the RTR solver's count, and every stream or device synchronization
    a CPU-only profiler sees)."""
    from sagecal_tpu_torch.ops.rime_kernel import (
        fused_cost_bwd_cuda, fused_cost_fwd_cuda,
    )
    from sagecal_tpu_torch.solvers import rtr
    from sagecal_tpu_torch.solvers.sage import SageConfig, sagefit

    data, cdata, p0 = _small_tile(cuda)
    cfg = SageConfig(solver_mode=mode, max_emiter=2, max_iter=3, max_lbfgs=6,
                     use_fused_predict=True)
    from torch.profiler import ProfilerActivity, profile

    runs = []
    for on in (False, True):
        fused_cost_fwd_cuda.launches = 0
        fused_cost_bwd_cuda.launches = 0
        rtr.host_read.count = 0
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = sagefit(data, cdata, p0, cfg.replace(
                collect_telemetry=on, collect_quality=on), device=cuda)
        syncs = sum(e.count for e in prof.key_averages()
                    if "Synchronize" in e.key)
        runs.append((out, fused_cost_fwd_cuda.launches,
                     fused_cost_bwd_cuda.launches, rtr.host_read.count,
                     syncs))
    (off, *n_off), (on, *n_on) = runs
    assert torch.equal(off.p, on.p) and torch.equal(off.res_1, on.res_1)
    assert n_off == n_on and n_on[0] > 0 and n_on[1] > 0
    assert off.telemetry is None and on.telemetry["lbfgs"] is not None
    assert torch.isfinite(on.quality["final"].chi2_station).all()


# tests/test_apps.py's two-cluster sky (phase centre ra 0, dec 51 deg)
FB_SKY = """P1 0 0 0.0 51 0 0.0 2.0 0 0 0 0 0 0 0 0 0 0 150e6
P2 0 2 0.0 50 30 0.0 1.0 0 0 0 0 0 0 0 0 0 0 150e6
"""
FB_CLUSTER = "1 1 P1\n2 1 P2\n"


def _fullbatch(tmp_path, tag, device, with_beam=False, **cfg_kw):
    """tests/test_torch_fullbatch.py's two-tile run (7 stations, 2
    channels, 4 timeslots, tilesz 2) at f32 --fused on an in-memory
    dataset made on the CPU (``with_beam``: with its synthetic ``/beam``
    group; ``cfg_kw``: more RunConfig fields, e.g. ``beam_mode``) ->
    (results, solutions text, residual column, per-kernel launches)."""
    import math

    import numpy as np

    from sagecal_tpu_torch.apps.config import RunConfig
    from sagecal_tpu_torch.apps.fullbatch import run_fullbatch
    from sagecal_tpu_torch.io import memh5
    from sagecal_tpu_torch.io.dataset import simulate_dataset
    from sagecal_tpu_torch.io.simulate import random_jones
    from sagecal_tpu_torch.io.skymodel import load_sky
    from sagecal_tpu_torch.ops import rime_kernel as rk

    sky = tmp_path / "t.sky.txt"
    sky.write_text(FB_SKY)
    (tmp_path / "t.sky.txt.cluster").write_text(FB_CLUSTER)
    dec0 = math.radians(51.0)
    clusters, _, _ = load_sky(str(sky), str(sky) + ".cluster", 0.0, dec0,
                              dtype=torch.float64, device="cpu")
    path = str(tmp_path / f"{tag}.h5")
    simulate_dataset(path, nstations=7, ntime=4, nchan=2, clusters=clusters,
                     jones=random_jones(2, 7, seed=3, amp=0.15,
                                        dtype=np.complex128, device="cpu"),
                     noise_sigma=1e-4, seed=0, dec0=dec0,
                     with_beam=with_beam, open_file=memh5.MemFile,
                     device="cpu")
    memh5.MemFile(path, "r+").attrs["dec0"] = dec0
    cfg = RunConfig(dataset=path, sky_model=str(sky),
                    cluster_file=str(sky) + ".cluster",
                    out_solutions=str(tmp_path / f"{tag}.sol"), tilesz=2,
                    max_emiter=2, max_iter=4, max_lbfgs=6, lbfgs_m=5,
                    solver_mode=1, use_f64=False, use_fused_predict=True,
                    **cfg_kw)
    kernels = (rk.fused_cost_fwd_cuda, rk.fused_cost_bwd_cuda,
               rk.fused_predict_fwd_cuda)
    for k in kernels:
        k.launches = 0
    results = run_fullbatch(cfg, log=lambda *a: None, device=device,
                            open_file=memh5.MemFile)
    launches = [k.launches for k in kernels]
    sol = (tmp_path / f"{tag}.sol").read_text()
    resid = np.asarray(memh5.MemFile(path, "r")["corrected"])
    memh5.remove(path)
    return results, sol, resid, launches


def test_fullbatch_on_the_card_matches_the_cpu_and_repeats(cuda, tmp_path):
    """The small fullbatch run at f32 --fused on CUDA: within the 5e-3 bar
    of the port's CPU run (res relative, solutions absolute, residual
    column of its max abs), bit-identical on repeat; #3/#4 launched and
    #1 once per tile's residual step."""
    import numpy as np

    from sagecal_tpu_torch.io.solutions import read_solutions

    cpu = _fullbatch(tmp_path, "cpu", "cpu")
    a = _fullbatch(tmp_path, "a", cuda)
    b = _fullbatch(tmp_path, "b", cuda)
    assert a[0] == b[0] and a[1] == b[1] and np.array_equal(a[2], b[2])
    assert a[3][0] > 0 and a[3][1] > 0 and a[3][2] == 2
    assert cpu[3] == [0, 0, 0]
    for (g0, g1), (w0, w1) in zip(a[0], cpu[0]):
        assert abs(g1 - w1) <= 5e-3 * w1 and g1 < g0
    (tmp_path / "x.sol").write_text(a[1])
    (tmp_path / "y.sol").write_text(cpu[1])
    ga, wa = (read_solutions(str(tmp_path / n))[1] for n in ("x.sol", "y.sol"))
    assert ga.shape == (2, 2, 7, 2, 2) and np.abs(ga - wa).max() <= 5e-3
    assert np.abs(a[2] - cpu[2]).max() <= 5e-3 * np.abs(cpu[2]).max()


def _service_requests(tmp_path, device):
    """The port's synthetic workload on an in-memory dataset (one tenant,
    7 stations, 2 tiles of 2 timeslots) as tenant0's 4 requests, and
    tenant1's 2 requests of the same tiles with cluster 1 at 2 hybrid
    chunks: at batch 2, two "fused_batch" buckets and one "fused"."""
    import json
    import os

    from sagecal_tpu_torch.io import memh5
    from sagecal_tpu_torch.serve.request import load_requests
    from sagecal_tpu_torch.serve.synthetic import make_synthetic_workload

    work = str(tmp_path / "w")
    manifest = make_synthetic_workload(work, 4, n_tenants=1,
                                       shapes=((7, 4, 2),),
                                       open_file=memh5.MemFile, device=device)
    doc = json.load(open(manifest))
    hybrid = os.path.join(work, "sky.txt.hybrid")
    with open(hybrid, "w") as f:
        f.write("1 2 P1\n2 1 P2\n")
    doc["requests"] += [dict(doc["requests"][i], request_id=f"hyb{i}",
                             tenant="tenant1", cluster_file=hybrid)
                        for i in range(2)]
    with open(manifest, "w") as f:
        json.dump(doc, f)
    return load_requests(manifest)


def _serve_on(tmp_path, reqs, device, tag):
    from sagecal_tpu_torch.apps.config import ServeConfig
    from sagecal_tpu_torch.io import memh5
    from sagecal_tpu_torch.serve.service import CalibrationService

    cfg = ServeConfig(out_dir=str(tmp_path / tag), batch=2, use_f64=False,
                      use_fused_predict=True)
    svc = CalibrationService(cfg, log=lambda *a: None, device=device,
                             open_file=memh5.MemFile)
    return svc, svc.run(reqs)


def _counts():
    from sagecal_tpu_torch.ops import rime_kernel as rk

    return [getattr(rk, f"fused_cost{k}_cuda").launches
            for k in ("_fwd", "_bwd", "_batch_fwd", "_batch_bwd")]


def _zero_counts():
    from sagecal_tpu_torch.ops import rime_kernel as rk

    for k in ("_fwd", "_bwd", "_batch_fwd", "_batch_bwd"):
        getattr(rk, f"fused_cost{k}_cuda").launches = 0


def test_service_routes_launch_their_kernels(cuda, tmp_path):
    """The service at f32 --fused on the card: tenant0's buckets on
    "fused_batch" launch #5/#6 and not #3/#4; tenant1's hybrid bucket on
    "fused" launches #3/#4 and not #5/#6; every residual falls."""
    reqs = _service_requests(tmp_path, cuda)
    for tenant, route, on, off in (("tenant0", "fused_batch", (2, 3), (0, 1)),
                                   ("tenant1", "fused", (0, 1), (2, 3))):
        _zero_counts()
        svc, summary = _serve_on(tmp_path, [r for r in reqs
                                            if r.tenant == tenant],
                                 cuda, tenant)
        n = _counts()
        assert all(n[i] > 0 for i in on) and all(n[i] == 0 for i in off), n
        for r in summary["results"]:
            assert r["kernel_path"] == route
            assert r["verdict"] != "diverged" and r["res_1"] < r["res_0"]


@pytest.mark.parametrize("kernel", ["fused_cost_batch_fwd", "fused_cost_fwd"])
def test_service_raises_when_a_kernel_fails(cuda, tmp_path, monkeypatch,
                                            kernel):
    """A kernel that fails on the card fails the service: no fallback to
    the plain version or the torch-op cost."""
    from sagecal_tpu_torch.ops import rime_kernel as rk

    reqs = _service_requests(tmp_path, cuda)
    tenant = "tenant0" if "batch" in kernel else "tenant1"

    def broken(*a, **k):
        raise RuntimeError(f"{kernel} made to fail")

    monkeypatch.setattr(rk, f"{kernel}_cuda", broken)
    with pytest.raises(RuntimeError, match="made to fail"):
        _serve_on(tmp_path, [r for r in reqs if r.tenant == tenant], cuda,
                  "broken")


def test_service_lanes_equal_a_direct_batch_solve(cuda, tmp_path,
                                                  monkeypatch):
    """Each dispatch's lanes are bit-identical to ``sagefit_packed_batch``
    called directly on the same stacked inputs with lane generators
    derived from the request ids."""
    import zlib

    import torch

    from sagecal_tpu_torch.serve.cache import ExecutableCache
    from sagecal_tpu_torch.solvers.batched import (
        derive_lane_generators, sagefit_packed_batch,
    )

    calls = []
    lookup = ExecutableCache.get_with_status

    def recording(cache, bucket, fp, **kw):
        fn, hit = lookup(cache, bucket, fp, **kw)

        def run(*args, **k):
            out = fn(*args, **k)
            calls.append((args, kw["batched_fused"], out))
            return out
        return run, hit

    monkeypatch.setattr(ExecutableCache, "get_with_status", recording)
    reqs = _service_requests(tmp_path, cuda)
    _, summary = _serve_on(tmp_path, reqs, cuda, "lanes")
    assert sorted(fused for _, fused, _ in calls) == [False, True, True]
    ids = [r["request_id"] for r in summary["results"]]
    for args, fused, out in calls:
        batch_ids, ids = ids[:2], ids[2:]
        gens = derive_lane_generators(
            0, [zlib.crc32(i.encode()) for i in batch_ids])
        direct = sagefit_packed_batch(*args[:8], gens, args[9],
                                      batched_fused=fused, device=cuda)
        assert torch.equal(direct.p, out.p)
        assert torch.equal(direct.res_1, out.res_1)


# --------------------------------------------- beams and diagnostics
#
# The beam-aware coherencies (``ops/beam.py``) feed #3/#4 and #1
# unchanged; their 2x2s are complex and off-diagonal, which an
# unpolarized unbeamed point sky never gives the kernels.


def _beam_tile(device, dtype=torch.float32, nstations=12, tilesz=8,
               nclusters=3):
    """A seeded tile with STAT_TILE beam coherencies (-B 2: array factor
    times the HBA element) on ``device``: 16 dipoles a tile, then 48 tile
    centroids (24 on the last station)."""
    import numpy as np

    from sagecal_tpu_torch.io.simulate import make_visdata
    from sagecal_tpu_torch.ops.beam import (
        BeamPointing, ElementCoeffs, StationGeometry,
    )
    from sagecal_tpu_torch.ops.rime import point_source_batch
    from sagecal_tpu_torch.solvers.sage import build_cluster_data_withbeam

    rng = np.random.default_rng(7)
    N, K = nstations, 64
    scale = np.where(np.arange(K) < 16, 2.5, 20.0)
    mask = np.ones((N, K))
    mask[-1, 40:] = 0.0
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64).to(device)  # noqa: E731
    geom = StationGeometry(
        longitude=f64(rng.uniform(0.11, 0.13, N)),
        latitude=f64(rng.uniform(0.91, 0.93, N)),
        x=f64(rng.uniform(-1, 1, (N, K)) * scale),
        y=f64(rng.uniform(-1, 1, (N, K)) * scale), z=f64(np.zeros((N, K))),
        elem_mask=f64(mask), bf_type=2)
    data = make_visdata(nstations=N, tilesz=tilesz, nchan=2, dec0=0.9,
                        dtype=np.float32 if dtype == torch.float32
                        else np.float64, device=device)
    clusters = [point_source_batch(rng.uniform(-0.05, 0.05, 2),
                                   rng.uniform(-0.05, 0.05, 2),
                                   rng.uniform(1.0, 5.0, 2), dtype=dtype,
                                   device=device) for _ in range(nclusters)]
    jd = 2460000.5 + np.arange(tilesz) * 10.0 / 86400.0
    cdata = build_cluster_data_withbeam(
        data, clusters, [1] * nclusters, geom,
        BeamPointing(0.0, 0.9, 0.0, 0.9, 150e6),
        ElementCoeffs.from_table("hba", 150e6, device=device), 3, jd, 0.0,
        0.9)
    return data, cdata


def test_objective_kernels_match_plain_on_beam_coherencies(cuda):
    """#3/#4 against their plain version on -B 2 coherencies, at identity
    and random gains, Gaussian and robust."""
    from sagecal_tpu_torch.core.types import jones_to_params
    from sagecal_tpu_torch.io.simulate import random_jones
    from sagecal_tpu_torch.kernels.parity import (
        compare_with_plain, tile_cost_problem,
    )

    data, cdata = _beam_tile(cuda)
    xy = cdata.coh[:, :, 1]
    assert float(xy.abs().max()) > 1e-3 * float(cdata.coh.abs().max())
    for amp in (0.0, 0.2):
        p = jones_to_params(random_jones(3, 12, seed=2, amp=amp,
                                         device=cuda))[:, None, :]
        prob = tile_cost_problem(data, cdata, p)
        for nu in (None, 5.0):
            out = compare_with_plain(prob, nu)
            assert out["cost_rel"] <= 1e-5, out
            assert out["grad_rel"] <= 1e-5, out
            assert out["bitwise_repeat"], out


def test_beam_coherencies_on_the_card_match_the_cpu(cuda):
    """The beam and the beam-aware predict at float64 on the card: within
    1e-10 of the CPU's largest magnitude (the same operations; the
    device's sin/cos/exp round differently in the last bits)."""
    cpu = _beam_tile("cpu", torch.float64)[1].coh
    card = _beam_tile(cuda, torch.float64)[1].coh.cpu()
    assert float((card - cpu).abs().max()) <= 1e-10 * float(cpu.abs().max())


def test_influence_on_the_card_matches_the_cpu(cuda):
    """``influence_function`` on the card (complex64, SVD least squares on
    cuSOLVER) against the CPU's: per correlation the eigenvalues as
    multisets within 1e-4 of the largest |lambda|."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    from sagecal_tpu_torch.core.types import jones_to_params
    from sagecal_tpu_torch.io.simulate import random_jones
    from sagecal_tpu_torch.ops.diagnostics import influence_function

    out = {}
    for dev in ("cpu", cuda):
        data, cdata = _beam_tile(dev)
        p = jones_to_params(random_jones(3, 12, seed=4, amp=0.1,
                                         device=dev))[:, None, :]
        out[str(dev)] = influence_function(data, cdata, p)
    got, want = out[str(cuda)], out["cpu"]
    assert np.isfinite(got).all() and got.shape == want.shape
    nbase = 12 * 11 // 2
    for c in range(4):
        g, w = got[0, c, :nbase], want[0, c, :nbase]
        cost = np.abs(g[:, None] - w[None, :])
        r, k = linear_sum_assignment(cost)
        assert cost[r, k].max() <= 1e-4 * np.abs(w).max()


def test_fullbatch_beam_on_the_card_matches_the_cpu_and_repeats(cuda,
                                                               tmp_path):
    """The small fullbatch run with -B 2 at f32 --fused on CUDA: within
    the 5e-3 bar of the CPU run, bit-identical on repeat, #3/#4 launched
    and #1 once per tile."""
    import numpy as np

    kw = dict(with_beam=True, beam_mode=2, element_coeffs="hba")
    cpu = _fullbatch(tmp_path, "bcpu", "cpu", **kw)
    a = _fullbatch(tmp_path, "ba", cuda, **kw)
    b = _fullbatch(tmp_path, "bb", cuda, **kw)
    assert a[0] == b[0] and a[1] == b[1] and np.array_equal(a[2], b[2])
    assert a[3][0] > 0 and a[3][1] > 0 and a[3][2] == 2
    for (g0, g1), (w0, w1) in zip(a[0], cpu[0]):
        assert abs(g1 - w1) <= 5e-3 * w1 and g1 < g0
    assert np.abs(a[2] - cpu[2]).max() <= 5e-3 * np.abs(cpu[2]).max()


# ------------------------------- consensus ADMM and the multi-band apps


def _mesh_problem(Nf, near=False, seed=11):
    """tests/test_torch_mesh.py's bands made by the port on the CPU (8
    stations, 2 point-source clusters, tilesz 2, gains linear in
    frequency over 120-180 MHz, f64): the stacked (data, cdata, p0, rho,
    B).  ``near``: p0 within 0.02 of the true gains (the regime where
    the robust RTR x-step is well conditioned), else the identity."""
    import numpy as np

    from sagecal_tpu_torch.core.types import identity_jones, jones_to_params
    from sagecal_tpu_torch.io.simulate import corrupt_and_observe, make_visdata
    from sagecal_tpu_torch.ops.rime import point_source_batch
    from sagecal_tpu_torch.parallel.consensus import setup_polynomials
    from sagecal_tpu_torch.parallel.mesh import stack_for_mesh
    from sagecal_tpu_torch.solvers.sage import build_cluster_data

    M, N = 2, 8
    freqs = np.linspace(120e6, 180e6, Nf)
    rng = np.random.default_rng(seed)
    c = lambda s: rng.standard_normal(s) + 1j * rng.standard_normal(s)  # noqa: E731
    Z0 = np.eye(2)[None, None] + 0.25 * c((M, N, 2, 2))
    Z1 = 0.15 * c((M, N, 2, 2))
    datas, cdatas, p0s = [], [], []
    for f in range(Nf):
        J = torch.as_tensor(Z0 + (freqs[f] - 150e6) / 150e6 * Z1)
        d = make_visdata(nstations=N, tilesz=2, nchan=1, freq0=150e6, seed=f,
                         dtype=np.float64, device="cpu")
        cl = [point_source_batch([0.0], [0.0], [2.0], dtype=torch.float64,
                                 device="cpu"),
              point_source_batch([0.02], [-0.01], [1.0], dtype=torch.float64,
                                 device="cpu")]
        d = corrupt_and_observe(d, cl, jones=J, noise_sigma=1e-4, seed=f)
        d = d.replace(freqs=torch.tensor([freqs[f]], dtype=torch.float64))
        datas.append(d)
        cdatas.append(build_cluster_data(d, cl, [1, 1]))
        p = (jones_to_params(J) if near else jones_to_params(
            identity_jones(N, torch.complex128, device="cpu")).expand(M, -1))
        if near:
            p = p + 0.02 * torch.from_numpy(rng.standard_normal(p.shape))
        p0s.append(p[:, None, :].clone())
    rho = torch.tensor([[20.0, 12.0]], dtype=torch.float64).repeat(Nf, 1)
    return (stack_for_mesh(datas), stack_for_mesh(cdatas), torch.stack(p0s),
            rho, setup_polynomials(freqs, 150e6, 2, 0))


MESH_ROUTES = {
    "8on8_bb": (8, 8, {}, dict(bb_rho=True, collect_trace=True)),
    "16on8": (16, 8, {}, dict(collect_trace=True)),
    "reduced_scatter": (8, 8, dict(zstep="reduced"), {}),
    "reduced_gather_bb": (8, 8, dict(zstep="reduced"),
                          dict(bb_rho=True, collect_trace=True)),
    "groups2_bb": (8, 4, dict(cluster_groups=2),
                   dict(bb_rho=True, collect_trace=True)),
    "groups2_reduced": (8, 4, dict(cluster_groups=2, zstep="reduced"), {}),
    "stale1_disc05": (16, 8, dict(staleness=1, staleness_discount=0.5),
                      dict(collect_trace=True)),
    "mode5_robust_rtr": (4, 4, {}, dict(solver_mode=5, bb_rho=True,
                                        collect_trace=True, itmax=-5)),
    "mode5_robust_rtr_1round": (4, 4, {}, dict(solver_mode=5, nadmm=1,
                                               collect_trace=True,
                                               itmax=-4)),
}


@pytest.mark.parametrize("route", list(MESH_ROUTES))
def test_admm_mesh_on_the_card_matches_the_cpu(cuda, route):
    """Every ConsensusConfig route on the card within 1e-8 relative of
    the CPU at f64: the virtual shards add in a fixed order on either
    device.  Robust RTR-ADMM (mode 5) runs at itmax -5 (five rounds of
    5 trust-region steps a cluster solve) and -4 (one round of 1
    steepest-descent and 6 trust-region steps), before its trust region
    reaches the rounding floor: there the CPU's own p moves by ~1e-13
    when the data move by 1e-13 (tests/rtr_admm_sensitivity.py)."""
    from sagecal_tpu_torch.interop import admm_result_to_numpy
    from sagecal_tpu_torch.parallel.consensus import ConsensusConfig
    from sagecal_tpu_torch.parallel.mesh import make_admm_mesh_fn
    from sagecal_tpu_torch.solvers.lm import LMConfig

    import numpy as np

    Nf, nsh, ccfg, kw = MESH_ROUTES[route]
    kw = {"nadmm": 5, "itmax": 4, **kw}
    itmax = kw.pop("itmax")
    args = _mesh_problem(Nf, near="mode5" in route)
    runs = [admm_result_to_numpy(make_admm_mesh_fn(
        nsh, max_emiter=1, plain_emiter=1,
        lm_config=LMConfig(itmax=itmax),
        consensus_cfg=ConsensusConfig(**ccfg), device=dev, **kw)(*args))
        for dev in ("cpu", cuda, cuda)]
    cpu, gpu, again = runs
    assert set(cpu) == set(gpu)
    assert all(np.array_equal(gpu[k], again[k]) for k in gpu)
    for k, want in cpu.items():
        scale = max(float(np.abs(want).max()), 1e-300)
        assert float(np.abs(gpu[k] - want).max()) <= 1e-8 * scale, k
    assert np.isfinite(cpu["p"]).all()


def _band_files(tmp_path, Nf, ntime=2, nchan=1, tag="b"):
    """Nf in-memory band datasets (7 stations, the two-cluster sky, gains
    linear in frequency over 130-170 MHz; tests/test_distributed.py's
    bands made by the port on the CPU) -> (glob, sky path)."""
    import math

    import numpy as np

    from sagecal_tpu_torch.io import memh5
    from sagecal_tpu_torch.io.dataset import simulate_dataset
    from sagecal_tpu_torch.io.skymodel import load_sky

    sky = tmp_path / "t.sky.txt"
    sky.write_text(FB_SKY)
    (tmp_path / "t.sky.txt.cluster").write_text(FB_CLUSTER)
    dec0 = math.radians(51.0)
    clusters, _, _ = load_sky(str(sky), str(sky) + ".cluster", 0.0, dec0,
                              dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5)
    c = lambda s: rng.standard_normal(s) + 1j * rng.standard_normal(s)  # noqa: E731
    Z0 = np.eye(2)[None, None] + 0.2 * c((2, 7, 2, 2))
    Z1 = 0.1 * c((2, 7, 2, 2))
    freqs = np.linspace(130e6, 170e6, Nf)
    for f in range(Nf):
        path = str(tmp_path / f"{tag}{f}.h5")
        simulate_dataset(path, nstations=7, ntime=ntime, nchan=nchan,
                         freq0=freqs[f], clusters=clusters,
                         jones=torch.as_tensor(Z0 + (freqs[f] - 150e6)
                                               / 150e6 * Z1),
                         noise_sigma=1e-4, seed=5 + f, dec0=dec0,
                         open_file=memh5.MemFile, device="cpu")
        h = memh5.MemFile(path, "r+")
        h.attrs["ra0"] = 0.0
        h.attrs["dec0"] = dec0
    return str(tmp_path / f"{tag}*.h5"), sky


def _distributed(tmp_path, device, tag, Nf=4):
    """4 bands, 2 tiles, f32, on ``device`` -> (traces, Z file text, band
    solution texts, residual columns, #1 launches)."""
    import numpy as np

    from sagecal_tpu_torch.apps.config import RunConfig
    from sagecal_tpu_torch.apps.distributed import run_distributed
    from sagecal_tpu_torch.io import memh5
    from sagecal_tpu_torch.ops import rime_kernel as rk

    pattern, sky = _band_files(tmp_path, Nf, ntime=4, tag=tag)
    sol = str(tmp_path / f"{tag}.z")
    cfg = RunConfig(dataset=pattern, sky_model=str(sky),
                    cluster_file=str(sky) + ".cluster", out_solutions=sol,
                    tilesz=2, max_emiter=1, max_iter=4, npoly=2,
                    admm_iters=3, admm_rho=10.0, solver_mode=1,
                    use_f64=False)
    rk.fused_predict_fwd_cuda.launches = 0
    traces = run_distributed(cfg, log=lambda *a: None, device=device,
                             open_file=memh5.MemFile)
    launches = rk.fused_predict_fwd_cuda.launches
    paths = memh5.MemFile.glob(pattern)
    cols = [np.asarray(memh5.MemFile(p, "r")["corrected"]) for p in paths]
    for p in paths:
        memh5.remove(p)
    texts = [open(sol).read()] + [open(f"{sol}.band{i}").read()
                                  for i in range(Nf)]
    return traces, texts, cols, launches


def test_distributed_on_the_card_launches_1_per_band_and_repeats(cuda,
                                                                 tmp_path):
    """The -f app at f32 on the card: kernel #1 once per band per tile
    (the residual step), a repeat bit-identical, within the 5e-3 bar of
    the CPU run."""
    import numpy as np

    cpu = _distributed(tmp_path, "cpu", "c")
    a = _distributed(tmp_path, cuda, "a")
    b = _distributed(tmp_path, cuda, "b")
    assert a[3] == 4 * 2 and cpu[3] == 0
    assert a[1] == b[1]
    assert all(np.array_equal(x, y) for x, y in zip(a[2], b[2]))
    for (ad, ap), (bd, bp) in zip(a[0], b[0]):
        assert np.array_equal(ad, bd) and np.array_equal(ap, bp)
    for g, w in zip(a[2], cpu[2]):
        assert np.abs(g - w).max() <= 5e-3 * np.abs(w).max()


def test_distributed_fails_when_kernel_1_fails(cuda, tmp_path, monkeypatch):
    """No fallback: a failing #1 fails the run."""
    from sagecal_tpu_torch.ops import rime_kernel as rk

    def broken(*a, **k):
        raise RuntimeError("fused_predict_fwd made to fail")

    monkeypatch.setattr(rk, "fused_predict_fwd_cuda", broken)
    with pytest.raises(RuntimeError, match="made to fail"):
        _distributed(tmp_path, cuda, "x")


def _minibatch(tmp_path, device, tag):
    """-N 1 -M 2 -w 4 -A 2 at f32 on a 4-channel in-memory dataset ->
    (results, solutions text, residual column, #1 launches)."""
    import numpy as np

    from sagecal_tpu_torch.apps.config import RunConfig
    from sagecal_tpu_torch.apps.minibatch import run_minibatch
    from sagecal_tpu_torch.io import memh5
    from sagecal_tpu_torch.ops import rime_kernel as rk

    pattern, sky = _band_files(tmp_path, 1, ntime=4, nchan=4, tag=tag)
    path = memh5.MemFile.glob(pattern)[0]
    cfg = RunConfig(dataset=path, sky_model=str(sky),
                    cluster_file=str(sky) + ".cluster",
                    out_solutions=str(tmp_path / f"{tag}.sol"), epochs=1,
                    minibatches=2, bands=4, admm_iters=2, npoly=2,
                    poly_type=0, admm_rho=2.0, max_lbfgs=6, lbfgs_m=5,
                    solver_mode=2, use_f64=False)
    rk.fused_predict_fwd_cuda.launches = 0
    res = run_minibatch(cfg, log=lambda *a: None, device=device,
                        open_file=memh5.MemFile)
    launches = rk.fused_predict_fwd_cuda.launches
    col = np.asarray(memh5.MemFile(path, "r")["corrected"])
    memh5.remove(path)
    return res, (tmp_path / f"{tag}.sol").read_text(), col, launches


def test_minibatch_on_the_card_launches_1_per_band_and_repeats(cuda,
                                                               tmp_path):
    """The -N app in consensus at f32 on the card: #1 once per band per
    minibatch, a repeat bit-identical, every band's residual below its
    data, within the 5e-3 bar of the CPU run."""
    import numpy as np

    cpu = _minibatch(tmp_path, "cpu", "c")
    a = _minibatch(tmp_path, cuda, "a")
    b = _minibatch(tmp_path, cuda, "b")
    assert a[3] == 4 * 2 and cpu[3] == 0
    assert a[0] == b[0] and a[1] == b[1] and np.array_equal(a[2], b[2])
    for (g0, g1), (w0, w1) in zip(a[0], cpu[0]):
        assert g1 < g0 and abs(g1 - w1) <= 5e-3 * w1
    assert np.abs(a[2] - cpu[2]).max() <= 5e-3 * np.abs(cpu[2]).max()


# ------------------- spatial regularization, diffuse sky, federated mode


def _spatial_config(device, B, diffuse=True):
    """A shapelet basis over _mesh_problem's two cluster positions and,
    with ``diffuse``, the diffuse constraint's initial model."""
    from sagecal_tpu_torch.parallel.mesh import SpatialConfig
    from sagecal_tpu_torch.parallel.spatial import (
        basis_blocks, find_initial_spatial, phikk_matrix,
        spatial_basis_modes,
    )

    modes, _ = spatial_basis_modes([0.0, 0.02], [0.0, -0.01], 2, 0.05)
    Phi = basis_blocks(modes, torch.complex128, device)
    Zd = (torch.from_numpy(find_initial_spatial(B, modes, 8)).to(device)
          if diffuse else None)
    return SpatialConfig(Phi=Phi, Phikk=phikk_matrix(Phi, 1e-6),
                         alpha=torch.tensor([6.0, 9.0], dtype=torch.float64,
                                            device=device),
                         mu=1e-4, cadence=1, fista_maxiter=25, Z_diff0=Zd,
                         gamma=0.3, lam_diff=1e-3)


@pytest.mark.parametrize("zstep", ["grouped", "reduced"])
def test_spatial_mesh_on_the_card_matches_the_cpu(cuda, zstep):
    """The consensus ADMM with spatial regularization and the diffuse
    constraint, 4 bands on 2 shards: within 1e-8 of the CPU at f64 in
    every field (Zspat, spat_res and Zspat_diff included), bit-identical
    on repeat."""
    import numpy as np

    from sagecal_tpu_torch.interop import admm_result_to_numpy
    from sagecal_tpu_torch.parallel.consensus import ConsensusConfig
    from sagecal_tpu_torch.parallel.mesh import make_admm_mesh_fn
    from sagecal_tpu_torch.solvers.lm import LMConfig

    args = _mesh_problem(4)
    B = args[4].numpy()
    runs = [admm_result_to_numpy(make_admm_mesh_fn(
        2, nadmm=4, max_emiter=1, plain_emiter=1, lm_config=LMConfig(itmax=4),
        spatial=_spatial_config(dev, B), device=dev,
        consensus_cfg=ConsensusConfig(zstep=zstep))(*args))
        for dev in ("cpu", cuda, cuda)]
    cpu, gpu, again = runs
    assert set(cpu) == set(gpu)
    assert all(np.array_equal(gpu[k], again[k]) for k in gpu)
    for k, want in cpu.items():
        scale = max(float(np.abs(want).max()), 1e-300)
        assert float(np.abs(gpu[k] - want).max()) <= 1e-8 * scale, k
    assert np.count_nonzero(cpu["spat_res"]) == 3


def _diffuse_tile(device, dtype, n0=4, seed=3):
    """A 2-channel tile of 8 stations with a point cluster and an
    all-shapelet cluster (``data/simsky.py::shapelet_source_batch``),
    and a seeded spatial model (2N, 2G), G = 4."""
    import numpy as np

    from sagecal_tpu_torch.data.simsky import shapelet_source_batch
    from sagecal_tpu_torch.io.simulate import make_visdata
    from sagecal_tpu_torch.ops.rime import point_source_batch
    from sagecal_tpu_torch.solvers.sage import build_cluster_data

    rng = np.random.default_rng(seed)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    d = make_visdata(nstations=8, tilesz=3, nchan=2, dtype=dtype,
                     device=device)
    src, tab = shapelet_source_batch(0.003, -0.002, 2.0,
                                     rng.standard_normal((n0, n0)), beta=0.01,
                                     dtype=tdt, device=device)
    pt = point_source_batch([0.01], [0.0], [1.0], dtype=tdt, device=device)
    cdata = build_cluster_data(d, [pt, src], [1, 1], shapelets=tab)
    Z = 0.2 * (rng.standard_normal((16, 8)) + 1j * rng.standard_normal((16, 8)))
    for s in range(8):
        Z[2 * s:2 * s + 2, 0:2] += np.eye(2)
    cdt = torch.complex128 if tdt == torch.float64 else torch.complex64
    return d, cdata, src, tab, torch.from_numpy(Z).to(device, cdt)


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_diffuse_repredict_on_the_card_matches_the_cpu(cuda, f64):
    import numpy as np

    from sagecal_tpu_torch.ops.diffuse import recalculate_diffuse_coherencies

    dt = np.float64 if f64 else np.float32
    got = []
    for dev in ("cpu", cuda, cuda):
        d, c, src, tab, Z = _diffuse_tile(dev, dt)
        got.append(recalculate_diffuse_coherencies(
            d, c, 1, src, tab, Z, 2, 5e-3).coh.cpu().numpy())
    cpu, gpu, again = got
    assert np.array_equal(gpu, again)
    tol = 1e-10 if f64 else 5e-3
    assert np.abs(gpu - cpu).max() <= tol * np.abs(cpu).max()


def test_kernel_1_matches_plain_on_repredicted_coherencies(cuda):
    """#1 on a float32 tile whose shapelet cluster was predicted again
    under a spatial model (the distributed app's second tile)."""
    import numpy as np

    from sagecal_tpu_torch.core.types import jones_to_params
    from sagecal_tpu_torch.io.simulate import random_jones
    from sagecal_tpu_torch.kernels.parity import compare_predict_on_tile
    from sagecal_tpu_torch.ops.diffuse import recalculate_diffuse_coherencies

    d, c, src, tab, Z = _diffuse_tile(cuda, np.float32)
    c2 = recalculate_diffuse_coherencies(d, c, 1, src, tab, Z, 2, 5e-3)
    assert not torch.equal(c2.coh[1], c.coh[1])
    p = jones_to_params(random_jones(2, 8, seed=4, amp=0.2,
                                     dtype=np.complex64, device=cuda))[:, None]
    out = compare_predict_on_tile(d, c2, p)
    assert out["model_rel"] <= 1e-5 and out["bitwise_repeat"], out


def test_federated_round_and_average_on_the_card_match_the_cpu(cuda):
    """Two federated minibatch rounds, the average and a third round on
    _mesh_problem's 4 bands: within 1e-8 of the CPU at f64, bit-identical
    on repeat."""
    import numpy as np

    from sagecal_tpu_torch.interop import federated_state_to_numpy
    from sagecal_tpu_torch.parallel.federated import (
        init_federated_state, make_fed_avg_fn, make_federated_minibatch_fn,
    )

    data, cdata, p0, rho, B = _mesh_problem(4)

    def run(dev):
        st = init_federated_state(4, 2, 1, 64, 2, 5, torch.float64,
                                  device=dev)
        step = make_federated_minibatch_fn(4, itmax=4, lbfgs_m=5, alpha=5.0,
                                           device=dev)
        avg = make_fed_avg_fn(4, alpha=5.0, device=dev)
        out = []
        for r in range(3):
            st, dres, cost = step(data, cdata, st, rho, B)
            out += [dres.cpu().numpy(), cost.cpu().numpy()]
            if r == 1:
                st = avg(st)
        return out, federated_state_to_numpy(st)

    cpu, gpu, again = (run(dev) for dev in ("cpu", cuda, cuda))
    for x, y in zip(gpu[0] + list(gpu[1].values()),
                    again[0] + list(again[1].values())):
        assert np.array_equal(x, y)
    for x, y in zip(gpu[0] + list(gpu[1].values()),
                    cpu[0] + list(cpu[1].values())):
        scale = max(float(np.abs(y).max()), 1e-300)
        assert float(np.abs(x - y).max()) <= 1e-8 * scale


def _sharded_tile(device):
    from sagecal_tpu_torch.core.types import identity_jones, jones_to_params
    from sagecal_tpu_torch.data.simsky import make_sky
    from sagecal_tpu_torch.solvers import pad_rows_to
    from sagecal_tpu_torch.solvers.sage import build_cluster_data

    import numpy as np

    sky = make_sky(nstations=7, tilesz=4, nchan=1, nclusters=2, seed=6,
                   dtype=np.float64, device=device)
    cdata = build_cluster_data(sky.data, sky.clusters, [1, 1], fdelta=0.0)
    p0 = jones_to_params(identity_jones(7, torch.complex128, device=device)
                         ).expand(2, 1, 56).clone()
    data, cdata = pad_rows_to(sky.data, cdata, 8)
    return data, cdata, p0


def test_sharded_fit_on_the_card_matches_the_cpu_and_repeats(cuda):
    from sagecal_tpu_torch.solvers import sharded_joint_fit

    outs = {}
    for dev in ("cpu", "cuda"):
        data, cdata, p0 = _sharded_tile(dev)
        outs[dev] = [sharded_joint_fit(data, cdata, p0, k, itmax=20,
                                       robust_nu=5.0, device=dev)
                     for k in (1, 4, 4)]
    for k in range(3):
        pc, cc, _ = outs["cpu"][k]
        pg, cg, _ = outs["cuda"][k]
        assert abs(float(cg) - float(cc)) <= 1e-9 * abs(float(cc))
        assert float((pg.cpu() - pc).abs().max()) <= 1e-7 * float(
            pc.abs().max())
    assert torch.equal(outs["cuda"][1][0], outs["cuda"][2][0])


def test_hier_predict_on_the_card_matches_the_cpu_and_repeats(cuda):
    import numpy as np

    from sagecal_tpu_torch.data.simsky import make_sky
    from sagecal_tpu_torch.sky import predict_coherencies_hier

    cohs = {}
    for dev in ("cpu", "cuda"):
        sky = make_sky(nstations=12, tilesz=2, nchan=2, nclusters=8,
                       freq0=30e6, wide_field=True, nsources=600,
                       extent_m=60.0, dtype=np.float64, device=dev)
        from sagecal_tpu_torch.apps.widefield import _merge_sources

        src = _merge_sources(sky.clusters)
        d = sky.data
        cohs[dev] = [predict_coherencies_hier(d.u, d.v, d.w, d.freqs, src,
                                              order=8, theta=1.5)
                     for _ in range(2)]
    ref = cohs["cpu"][0]
    err = float((cohs["cuda"][0].cpu() - ref).abs().max())
    assert err <= 1e-10 * float(ref.abs().max())
    assert torch.equal(cohs["cuda"][0], cohs["cuda"][1])


def test_widefield_app_on_the_card_matches_the_cpu(cuda, tmp_path):
    import json

    from sagecal_tpu_torch.apps.widefield import main

    argv = ["-n", "8", "--ntiles", "2", "-S", "400", "--nblobs", "6", "-k",
            "3", "-j", "1", "-e", "1", "-g", "2", "-l", "4"]
    got = {}
    for dev in ("cpu", "cuda"):
        out = tmp_path / dev
        assert main(argv + ["--out-dir", str(out)], device=dev) == 0
        got[dev] = json.load(open(out / "widefield.json"))
    for a, b in zip(got["cuda"]["tiles"], got["cpu"]["tiles"]):
        for k in ("res_0", "res_1"):
            assert abs(a[k] - b[k]) <= 1e-8 * abs(b[k])
        assert abs(a["rel_err"] - b["rel_err"]) <= 1e-10


def test_refine_gradient_on_the_card_matches_the_cpu(cuda):
    import numpy as np

    from sagecal_tpu_torch.data.simsky import make_sky, perturb_flux
    from sagecal_tpu_torch.refine import (
        RefineProblem, SkySpec, make_outer_value_and_grad,
    )

    got = {}
    for dev in ("cpu", "cuda"):
        sky = make_sky(nstations=5, tilesz=2, seed=3, dtype=np.float64,
                       device=dev)
        prob = RefineProblem(data=sky.data, clusters=perturb_flux(sky),
                             tables=sky.shapelet_tables,
                             spec=SkySpec(flux=[(0, 0)]))
        _, vg, _ = make_outer_value_and_grad(prob, iters=6,
                                             adjoint_matvec="jtj")
        th = prob.spec.theta0(prob.clusters, prob.tables)
        got[dev] = vg(th, prob.identity_gains())
    hc, gc = got["cpu"]
    hg, gg = got["cuda"]
    assert abs(float(hg) - float(hc)) <= 1e-8 * abs(float(hc))
    assert abs(float(gg[0]) - float(gc[0])) <= 1e-7 * abs(float(gc[0]))


# ---------------------------------------------------------------------------
# elastic resume, the kernel store and the fleet worker on the card


def _memfile_dataset(path, device, ntime=6):
    """A MemFile vis.h5 of the 2-cluster test sky at 7 stations (the card's
    machine has no h5py)."""
    import math

    from sagecal_tpu_torch.io.dataset import simulate_dataset
    from sagecal_tpu_torch.io.memh5 import MemFile
    from sagecal_tpu_torch.io.skymodel import load_sky

    d = os.path.dirname(path)
    sky = os.path.join(d, "t.sky.txt")
    with open(sky, "w") as f:
        f.write("P1 0 0 0.0 51 0 0.0 2.0 0 0 0 0 0 0 0 0 0 0 150e6\n"
                "P2 0 2 0.0 50 30 0.0 1.0 0 0 0 0 0 0 0 0 0 0 150e6\n")
    with open(sky + ".cluster", "w") as f:
        f.write("1 1 P1\n2 1 P2\n")
    clusters, _, _ = load_sky(sky, sky + ".cluster", 0.0, math.radians(51.0),
                              dtype=torch.float64, device=device)
    simulate_dataset(path, nstations=7, ntime=ntime, nchan=2,
                     clusters=clusters, noise_sigma=1e-4, seed=0,
                     dec0=math.radians(51.0), open_file=MemFile,
                     device=device)
    f = MemFile(path, "r+")
    f.attrs["ra0"] = 0.0
    f.attrs["dec0"] = math.radians(51.0)
    return sky


def test_fullbatch_kill_and_resume_on_the_card_is_bit_identical(
        cuda, tmp_path, monkeypatch):
    """f32 --fused (#3/#4 and #1): stopped after its first checkpoint,
    then resumed, the solutions file and the residual column equal an
    uninterrupted run's bit for bit."""
    import numpy as np

    from sagecal_tpu_torch.apps.cli import main
    from sagecal_tpu_torch.elastic.checkpoint import CheckpointManager
    from sagecal_tpu_torch.io.memh5 import MemFile, remove

    runs = {}
    for name in ("a", "b"):
        d = tmp_path / name
        d.mkdir()
        sky = _memfile_dataset(str(d / "x.h5"), cuda)
        runs[name] = ["-d", str(d / "x.h5"), "-s", sky, "-p",
                      str(d / "sol.txt"), "-t", "2", "-e", "1", "-g", "2",
                      "-l", "4", "--f32", "--fused"]
    assert main(runs["a"] + ["--checkpoint-every", "1"],
                open_file=MemFile) == 0
    update = CheckpointManager.update

    class Stop(Exception):
        pass

    def stop(self, *a, **k):
        if update(self, *a, **k) is not None:
            raise Stop

    with monkeypatch.context() as m:
        m.setattr(CheckpointManager, "update", stop)
        with pytest.raises(Stop):
            main(runs["b"] + ["--checkpoint-every", "1"], open_file=MemFile)
    assert main(runs["b"] + ["--resume"], open_file=MemFile) == 0
    sol = [open(tmp_path / n / "sol.txt").read() for n in "ab"]
    col = [np.asarray(MemFile(str(tmp_path / n / "x.h5"), "r")["corrected"])
           for n in "ab"]
    assert sol[0] == sol[1]
    assert np.array_equal(col[0], col[1])
    for n in "ab":
        remove(str(tmp_path / n / "x.h5"))


def test_kernel_store_second_load_builds_nothing(cuda, tmp_path, monkeypatch):
    from sagecal_tpu_torch.kernels import build
    from sagecal_tpu_torch.serve.aot_store import AOTArtifactStore

    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_store", None)
    counts = []
    for _ in range(2):
        store = AOTArtifactStore(str(tmp_path / "store"))
        build.attach_store(store)
        before = build.builds
        paths = build.build_all(["kbisect_b", "kbisect_c"])
        counts.append((build.builds - before, store.builds, store.hits))
        build._loaded.clear()
        assert build.load("kbisect_b").kbisect_b is not None
    build.attach_store(None)
    assert counts == [(2, 2, 0), (0, 0, 2)]
    assert all(p.startswith(str(tmp_path / "store")) for p in paths.values())
    assert store.versions["capability"] == "%d.%d" % (
        torch.cuda.get_device_capability())


def test_fleet_worker_on_the_card_gives_the_cpu_dispositions(cuda, tmp_path):
    """One in-process worker over a 4-request MemFile manifest, tenant1's
    SLO burning (policy degrade), at f32 --fused on the card and on the
    CPU: the same disposition per request, the solutions within 5e-3."""
    import json
    import time

    import numpy as np

    from sagecal_tpu_torch.apps.config import FleetConfig
    from sagecal_tpu_torch.fleet.coordinator import seed_queue
    from sagecal_tpu_torch.fleet.queue import LeaseQueue
    from sagecal_tpu_torch.fleet.worker import FleetWorker
    from sagecal_tpu_torch.io import solutions as solio
    from sagecal_tpu_torch.io.memh5 import MemFile
    from sagecal_tpu_torch.obs.slo import load_slo_specs
    from sagecal_tpu_torch.serve.request import load_requests
    from sagecal_tpu_torch.serve.synthetic import make_synthetic_workload

    path = make_synthetic_workload(str(tmp_path / "w"), 4, n_tenants=2,
                                   open_file=MemFile, device=cuda)
    doc = json.load(open(path))
    # tenant0's deadline is out of reach of any solve's latency (a kernel
    # build included): only tenant1's blown history trips admission
    doc["slos"] = [{"tenant": t, "deadline_s": d, "availability": 0.9,
                    "windows_s": [60.0, 300.0], "shed_burn": 2.0}
                   for t, d in (("tenant0", 3600.0), ("tenant1", 1.0))]
    json.dump(doc, open(path, "w"))
    got = {}
    for dev in ("cpu", "cuda"):
        out = str(tmp_path / dev)
        os.makedirs(out)
        for i in range(10):  # tenant1 far past its deadline
            json.dump({"request_id": f"old{i}", "tenant": "tenant1",
                       "verdict": "ok", "latency_s": 9.0,
                       "completed_at": time.time()},
                      open(os.path.join(out, f"old{i}.result.json"), "w"))
        cfg = FleetConfig(requests=path, out_dir=out, batch=2, max_emiter=1,
                          max_iter=2, max_lbfgs=4, use_f64=False,
                          use_fused_predict=True, max_idle_s=1.0,
                          poll_s=0.05, timeline=False)
        q = LeaseQueue(os.path.join(out, "queue"), worker="coord")
        seed_queue(q, load_requests(path), load_slo_specs(path),
                   log=lambda *a: None, open_file=MemFile)
        FleetWorker(cfg, log=lambda *a: None, device=dev,
                    open_file=MemFile).run()
        got[dev] = {}
        for n in sorted(os.listdir(out)):
            if n.endswith(".result.json") and n.startswith("req"):
                r = json.load(open(os.path.join(out, n)))
                got[dev][r["request_id"]] = (
                    "degrade" if r.get("degraded") else r["verdict"],
                    solio.read_solutions(r["solutions"])[1])
    assert sorted(got["cuda"]) == sorted(got["cpu"]) == [
        f"req{i:03d}" for i in range(4)]
    for rid, (how, sol) in got["cpu"].items():
        how_c, sol_c = got["cuda"][rid]
        assert how_c == how
        assert np.abs(sol_c - sol).max() <= 5e-3 * np.abs(sol).max()
    assert {got["cuda"][r][0] for r in ("req001", "req003")} == {"degrade"}


def test_stream_on_the_card_takes_the_torch_op_route(cuda, tmp_path):
    """The stream calibrator at f32 on the card over a MemFile stream:
    every window solved on the torch-op joint cost (``StreamConfig`` has
    no fused switch; ``choose_batched_path`` names the route "xla"),
    none of #1-#6 launched, and window results within 5e-3 of the CPU's
    (mode 1, no OS-LM randomization)."""
    import json

    from sagecal_tpu_torch.apps.config import StreamConfig
    from sagecal_tpu_torch.fleet.stream import (
        StreamCalibrator, make_synthetic_stream,
    )
    from sagecal_tpu_torch.io.memh5 import MemFile, remove
    from sagecal_tpu_torch.ops import rime_kernel as rk
    from sagecal_tpu_torch.solvers.batched import choose_batched_path

    ds, sky, clus = make_synthetic_stream(str(tmp_path / "fix"),
                                          open_file=MemFile, device=cuda)
    kernels = [getattr(rk, k) for k in (
        "fused_predict_fwd_cuda", "fused_predict_bwd_cuda",
        "fused_cost_fwd_cuda", "fused_cost_bwd_cuda",
        "fused_cost_batch_fwd_cuda", "fused_cost_batch_bwd_cuda")]
    docs = {}
    for dev in ("cpu", "cuda"):
        cfg = StreamConfig(dataset=ds, sky_model=sky, cluster_file=clus,
                           out_dir=str(tmp_path / dev), solver_mode=1,
                           randomize=False, use_f64=False,
                           checkpoint_every=1, max_windows=3)
        cal = StreamCalibrator(cfg, log=lambda *a: None, device=dev,
                               open_file=MemFile)
        cold, warm = cal._sage_configs()
        assert not cold.use_fused_predict and not warm.use_fused_predict
        for k in kernels:
            k.launches = 0
        summary = cal.run()
        assert [k.launches for k in kernels] == [0] * 6
        assert summary["solved"] == 3 and summary["warm"] == 2
        docs[dev] = [json.load(open(os.path.join(cfg.out_dir, n)))
                     for n in sorted(os.listdir(cfg.out_dir))
                     if n.endswith(".result.json")]
    assert choose_batched_path(None, None, None, cold)[0] == "xla"
    for c, g in zip(docs["cpu"], docs["cuda"]):
        assert (c["warm"], c["verdict"]) == (g["warm"], g["verdict"])
        assert g["res1"] < g["res0"]
        assert abs(g["res1"] - c["res1"]) <= 5e-3 * abs(c["res1"])
    remove(ds)
