"""Port vs JAX package: the fused predict (ops/rime_kernel.py,
``fused_predict_packed`` / ``fused_predict_packed_hybrid``).

The JAX side runs its Pallas predict kernels as its own tests run them
on the CPU (interpret mode) with ``tile=128``, rows padded to a multiple
of 128, clusters to 8 and stations to NPAD.  The port side is the wrapper
on CPU tensors, which runs ``fused_predict_packed_plain`` forward and its
autograd VJP backward, on the same padded inputs.

Tolerance: model error <= 1e-5 of the model's norm and gain-cotangent
error <= 1e-5 of the cotangent's norm, under a seeded upstream model
cotangent.  Both sides compute in f32 and differ in summation order only.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_port_common import norm_rel, to_np

TILE, MC = 128, 8
TOL = 1e-5


def _problem(seed=0, M=3, N=6, F=2, rows=120, nc=1):
    """Seeded gains, coherencies, indices, chunk map and upstream model
    cotangent in the JAX kernels' padded layout (numpy)."""
    from sagecal_tpu.ops.rime_kernel import NPAD, pad_to

    rng = np.random.default_rng(seed)
    mp, rowsp = pad_to(M, MC), pad_to(rows, TILE)
    shape = (M, nc, N, 2, 2) if nc > 1 else (M, N, 2, 2)
    jones = np.eye(2) + 0.3 * (rng.standard_normal(shape)
                               + 1j * rng.standard_normal(shape))
    coh_ri = np.zeros((mp, F, 8, rowsp), np.float32)
    coh_ri[:M, :, :, :rows] = rng.standard_normal((M, F, 8, rows))
    ant_p = rng.integers(0, N - 1, rows)
    ant_q = ant_p + rng.integers(1, N - ant_p)
    antp = np.zeros((1, rowsp), np.int32)
    antq = np.zeros((1, rowsp), np.int32)
    antp[0, :rows], antq[0, :rows] = ant_p, ant_q
    cmap = np.zeros((mp, rowsp), np.int32)
    cmap[:M, :rows] = rng.integers(0, nc, (M, rows))
    g = rng.standard_normal((F, 8, rowsp)).astype(np.float32)
    return dict(jones=jones, coh_ri=coh_ri, antp=antp, antq=antq, cmap=cmap,
                g=g, mp=mp, npad=NPAD, nc=nc)


def _jax_predict_vjp(p, bf16):
    from sagecal_tpu.ops.rime_kernel import (
        fused_predict_packed, fused_predict_packed_hybrid, pack_gain_tables,
    )

    tre, tim = pack_gain_tables(jnp.asarray(p["jones"]), p["mp"])
    coh = jnp.asarray(p["coh_ri"])
    if bf16:
        coh = coh.astype(jnp.bfloat16)
    antp, antq = jnp.asarray(p["antp"]), jnp.asarray(p["antq"])
    if p["nc"] > 1:
        cmap = jnp.asarray(p["cmap"])
        f = lambda a, b: fused_predict_packed_hybrid(a, b, coh, antp, antq,
                                                     cmap, p["nc"], TILE)
    else:
        f = lambda a, b: fused_predict_packed(a, b, coh, antp, antq, TILE)
    model, vjp = jax.vjp(f, tre, tim)
    ga, gb = vjp(jnp.asarray(p["g"]))
    return np.asarray(model), np.asarray(ga), np.asarray(gb)


def _port_inputs(p, bf16):
    from sagecal_tpu_torch.ops.rime_kernel import pack_gain_tables

    tre, tim = pack_gain_tables(torch.from_numpy(p["jones"]), p["mp"],
                                p["npad"])
    coh = torch.from_numpy(p["coh_ri"])
    if bf16:
        coh = coh.to(torch.bfloat16)
    cmap = torch.from_numpy(p["cmap"]) if p["nc"] > 1 else None
    return tre, tim, coh, torch.from_numpy(p["antp"]), \
        torch.from_numpy(p["antq"]), cmap


def _port_predict_vjp(p, bf16):
    from sagecal_tpu_torch.ops.rime_kernel import (
        fused_predict_packed, fused_predict_packed_hybrid,
    )

    tre, tim, coh, antp, antq, cmap = _port_inputs(p, bf16)
    a = tre.clone().requires_grad_(True)
    b = tim.clone().requires_grad_(True)
    if p["nc"] > 1:
        model = fused_predict_packed_hybrid(a, b, coh, antp, antq, cmap,
                                            p["nc"])
    else:
        model = fused_predict_packed(a, b, coh, antp, antq)
    ga, gb = torch.autograd.grad(model, (a, b), torch.from_numpy(p["g"]))
    return model.detach(), ga, gb


@pytest.mark.parametrize("nc,coh_dtype", [(1, "f32"), (2, "f32"), (2, "bf16")],
                         ids=["nc1-f32", "nc2-f32", "nc2-bf16"])
def test_predict_matches_jax_kernel(nc, coh_dtype):
    p = _problem(seed=nc, nc=nc)
    bf16 = coh_dtype == "bf16"
    mj, gja, gjb = _jax_predict_vjp(p, bf16)
    mt, gta, gtb = _port_predict_vjp(p, bf16)
    assert norm_rel(mt, mj) <= TOL
    assert norm_rel(np.concatenate([to_np(gta).ravel(), to_np(gtb).ravel()]),
                    np.concatenate([gja.ravel(), gjb.ravel()])) <= TOL
    # padded rows carry zero coherencies: zero model
    np.testing.assert_array_equal(to_np(mt)[:, :, 120:], 0.0)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    from sagecal_tpu_torch.ops import rime_kernel as rk

    p = _problem(seed=4, nc=2)
    tre, tim, coh, antp, antq, cmap = _port_inputs(p, False)
    g = torch.from_numpy(p["g"])
    before = (rk.fused_predict_fwd_cuda.launches,
              rk.fused_predict_bwd_cuda.launches)
    a = tre.clone().requires_grad_(True)
    m = rk.fused_predict_packed_hybrid(a, tim, coh, antp, antq, cmap, 2)
    (ga,) = torch.autograd.grad(m, a, g)
    a2 = tre.clone().requires_grad_(True)
    m2 = rk.fused_predict_packed_plain(a2, tim, coh, antp, antq, cmap, 2)
    (ga2,) = torch.autograd.grad(m2, a2, g)
    assert torch.equal(m, m2.detach())
    assert torch.equal(ga, ga2)
    assert (rk.fused_predict_fwd_cuda.launches,
            rk.fused_predict_bwd_cuda.launches) == before


@pytest.mark.parametrize("nc", [1, 2], ids=["nc1", "nc2"])
def test_coherency_gradient_raises(nc):
    """The fused predict has no coherency cotangent: asking for one
    raises FusedSkyGradientError, never a silent zero."""
    from sagecal_tpu_torch.ops import rime_kernel as rk

    assert rk.FUSED_COHERENCY_COTANGENT is False
    p = _problem(seed=5, nc=nc)
    tre, tim, coh, antp, antq, cmap = _port_inputs(p, False)
    coh = coh.clone().requires_grad_(True)
    model = rk.fused_predict_packed_hybrid(tre, tim, coh, antp, antq, cmap, nc)
    with pytest.raises(rk.FusedSkyGradientError):
        torch.autograd.grad(model.sum(), coh)


def test_predict_launchers_refuse_cpu_tensors():
    from sagecal_tpu_torch.ops import rime_kernel as rk

    p = _problem(seed=6)
    tre, tim, coh, antp, antq, _ = _port_inputs(p, False)
    with pytest.raises(ValueError, match="CUDA"):
        rk.fused_predict_fwd_cuda(tre, tim, coh, antp, antq)
    with pytest.raises(ValueError, match="CUDA"):
        rk.fused_predict_bwd_cuda(tre, tim, coh, antp, antq,
                                  torch.from_numpy(p["g"]))


def test_plain_predict_is_the_objectives_model():
    """The objective's plain version is the plain predict's model put
    through the masked Gaussian cost: one copy of the RIME products."""
    from sagecal_tpu_torch.kernels.parity import random_cost_problem
    from sagecal_tpu_torch.ops.rime_kernel import (
        fused_cost_packed_plain, fused_predict_packed_plain,
    )

    prob = random_cost_problem(M=3, N=6, F=2, rows=150, nc=2, device="cpu")
    m = fused_predict_packed_plain(prob.tab_re, prob.tab_im, prob.coh_ri,
                                   prob.ant_p, prob.ant_q, prob.cmap, 2)
    d = (prob.vis_ri - m) * prob.mask_p[:, None, :]
    want = fused_cost_packed_plain(prob.tab_re, prob.tab_im, *prob.inputs,
                                   None, prob.cmap, 2)
    assert abs(float((d * d).sum()) - float(want)) <= 1e-5 * float(want)


def test_predict_work_count():
    """The bound's byte count is each input read once and each output
    written once; the operations are the model's (forward) and the
    backward's four 2x2 products per (cluster, channel, row)."""
    from sagecal_tpu_torch.kernels.parity import (
        fused_predict_work, random_cost_problem,
    )

    prob = random_cost_problem(M=3, N=6, F=2, rows=150, nc=2, device="cpu")
    work = fused_predict_work(prob)
    tables = 4 * 2 * 4 * 6 * 6
    inputs = tables + 4 * (3 * 2 * 8 * 150 + 2 * 150 + 3 * 150)
    model = 4 * 2 * 8 * 150
    assert work["fwd"] == (inputs + model, 128 * 3 * 2 * 150)
    assert work["bwd"] == (inputs + model + tables, 256 * 3 * 2 * 150)
