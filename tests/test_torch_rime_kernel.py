"""Port vs JAX package: the fused calibration objective (ops/rime_kernel.py).

The JAX side runs its Pallas kernels as its own tests run them on the
CPU (interpret mode) through ``fused_cost_packed`` /
``fused_cost_packed_hybrid`` with ``tile=128``, rows padded to a
multiple of 128, clusters to 8 and stations to NPAD.  The port side is
``fused_cost_packed_plain`` (what the wrapper runs on CPU tensors), on
the same padded inputs and on the unpadded ones.

Tolerance: cost relative error <= 1e-5 and gradient error <= 1e-5 of the
gradient's norm.  Both sides compute in f32 and differ in summation order
only; gradients are compared by norm because elementwise f32 gradient
checks fail on summation order alone.  Packing is exact (bit-equal).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_port_common import norm_rel, rel, to_np

TILE, MC = 128, 8
TOL = 1e-5


def _problem(seed=0, M=3, N=6, F=2, rows=200, nc=1, drop=0.15,
             masked_rows=0):
    """Seeded inputs in the JAX kernels' padded layout (numpy)."""
    from sagecal_tpu.ops.rime_kernel import NPAD, pad_to

    rng = np.random.default_rng(seed)
    mp, rowsp = pad_to(M, MC), pad_to(rows, TILE)
    shape = (M, nc, N, 2, 2) if nc > 1 else (M, N, 2, 2)
    jones = np.eye(2) + 0.3 * (rng.standard_normal(shape)
                               + 1j * rng.standard_normal(shape))
    coh = rng.standard_normal((M, F, 4, rows)) + 1j * rng.standard_normal(
        (M, F, 4, rows))
    vis = rng.standard_normal((F, 4, rows)) + 1j * rng.standard_normal(
        (F, 4, rows))
    mask = (rng.random((F, rows)) > drop).astype(np.float64)
    if masked_rows:
        mask[:, :masked_rows] = 0.0  # rows flagged in every channel
    ant_p = rng.integers(0, N - 1, rows)
    ant_q = ant_p + rng.integers(1, N - ant_p)
    cmap = (np.arange(rows) * nc // rows)[None, :].repeat(M, 0)
    p = dict(jones=jones, coh=coh, vis=vis, mask=mask, ant_p=ant_p,
             ant_q=ant_q, cmap=cmap, M=M, N=N, nc=nc, mp=mp, npad=NPAD)
    coh_ri = np.zeros((mp, F, 8, rowsp), np.float32)
    coh_ri[:M, :, :4, :rows] = coh.real
    coh_ri[:M, :, 4:, :rows] = coh.imag
    vis_ri = np.zeros((F, 8, rowsp), np.float32)
    vis_ri[:, :4, :rows] = vis.real
    vis_ri[:, 4:, :rows] = vis.imag
    mask_p = np.zeros((F, rowsp), np.float32)
    mask_p[:, :rows] = mask
    antp = np.zeros((1, rowsp), np.int32)
    antq = np.zeros((1, rowsp), np.int32)
    antp[0, :rows], antq[0, :rows] = ant_p, ant_q
    cmap_p = np.zeros((mp, rowsp), np.int32)
    cmap_p[:M, :rows] = cmap
    p["padded"] = (coh_ri, antp, antq, vis_ri, mask_p)
    p["cmap_p"] = cmap_p
    return p


def _jax_value_and_grad(p, nu, coh_bf16=False):
    from sagecal_tpu.ops.rime_kernel import (
        fused_cost_packed, fused_cost_packed_hybrid, pack_gain_tables,
    )

    tre, tim = pack_gain_tables(jnp.asarray(p["jones"]), p["mp"])
    coh_ri, antp, antq, vis_ri, mask_p = map(jnp.asarray, p["padded"])
    if coh_bf16:
        coh_ri = coh_ri.astype(jnp.bfloat16)
    if p["nc"] > 1:
        cmap = jnp.asarray(p["cmap_p"])
        f = lambda a, b: fused_cost_packed_hybrid(
            a, b, coh_ri, antp, antq, vis_ri, mask_p, cmap, p["nc"], nu, TILE)
    else:
        f = lambda a, b: fused_cost_packed(
            a, b, coh_ri, antp, antq, vis_ri, mask_p, nu, TILE)
    v, (ga, gb) = jax.value_and_grad(f, argnums=(0, 1))(tre, tim)
    return float(v), np.asarray(ga), np.asarray(gb), np.asarray(tre)


def _torch_value_and_grad(tre, tim, inputs, nu, cmap, nc):
    from sagecal_tpu_torch.ops.rime_kernel import fused_cost_packed_plain

    a = tre.detach().clone().requires_grad_(True)
    b = tim.detach().clone().requires_grad_(True)
    v = fused_cost_packed_plain(a, b, *inputs, nu, cmap, nc)
    ga, gb = torch.autograd.grad(v, (a, b))
    return float(v.detach()), ga, gb


CASES = [
    # (nu, nc, coh dtype, fully masked rows)
    (None, 1, "f32", 0),
    (5.0, 1, "f32", 0),
    (None, 2, "f32", 0),
    (5.0, 2, "f32", 0),
    (None, 1, "bf16", 0),
    (5.0, 2, "bf16", 0),
    (5.0, 1, "f32", 40),
]


@pytest.mark.parametrize(
    "nu,nc,coh_dtype,masked_rows", CASES,
    ids=[f"{'robust' if c[0] else 'gauss'}-nc{c[1]}-{c[2]}"
         + ("-masked" if c[3] else "") for c in CASES])
def test_plain_matches_jax_kernel(nu, nc, coh_dtype, masked_rows):
    from sagecal_tpu_torch.ops.rime_kernel import pack_gain_tables

    p = _problem(nc=nc, masked_rows=masked_rows)
    bf16 = coh_dtype == "bf16"
    vj, gja, gjb, tre_j = _jax_value_and_grad(p, nu, bf16)

    # same padded inputs: tables bit-equal to the JAX packing
    tre, tim = pack_gain_tables(torch.from_numpy(p["jones"]), p["mp"],
                                p["npad"])
    np.testing.assert_array_equal(to_np(tre), tre_j)
    coh_ri, antp, antq, vis_ri, mask_p = map(torch.from_numpy, p["padded"])
    if bf16:
        coh_ri = coh_ri.to(torch.bfloat16)
    cmap = torch.from_numpy(p["cmap_p"]) if nc > 1 else None
    vt, gta, gtb = _torch_value_and_grad(
        tre, tim, (coh_ri, antp, antq, vis_ri, mask_p), nu, cmap, nc)
    assert rel(vt, vj) <= TOL
    assert norm_rel(np.concatenate([to_np(gta).ravel(), to_np(gtb).ravel()]),
                    np.concatenate([gja.ravel(), gjb.ravel()])) <= TOL


@pytest.mark.parametrize("nu", [None, 5.0], ids=["gauss", "robust"])
def test_unpadded_layout_matches_jax_kernel(nu):
    """The port needs no TPU padding: unpadded tables and rows give the
    JAX (padded) cost, and the gradients agree after unpacking."""
    from sagecal_tpu.ops.rime_kernel import unpack_gain_grads as junpack
    from sagecal_tpu_torch.ops.rime_kernel import (
        pack_gain_tables, pack_predict_inputs, unpack_gain_grads,
    )

    p = _problem(seed=3, rows=157)
    vj, gja, gjb, _ = _jax_value_and_grad(p, nu)
    tre, tim = pack_gain_tables(torch.from_numpy(p["jones"]), p["M"])
    assert tuple(tre.shape) == (4, p["M"], p["N"])
    vis_ri, mask_p, coh_ri, antp, antq, _ = pack_predict_inputs(
        torch.from_numpy(p["vis"]), torch.from_numpy(p["mask"]),
        torch.from_numpy(p["coh"]), torch.from_numpy(p["ant_p"]),
        torch.from_numpy(p["ant_q"]))
    vt, gta, gtb = _torch_value_and_grad(
        tre, tim, (coh_ri, antp, antq, vis_ri, mask_p), nu, None, 1)
    assert rel(vt, vj) <= TOL
    want = [np.asarray(g) for g in junpack(jnp.asarray(gja), jnp.asarray(gjb),
                                           p["M"], p["N"])]
    got = [to_np(g) for g in unpack_gain_grads(gta, gtb, p["M"], p["N"])]
    assert norm_rel(np.stack(got), np.stack(want)) <= TOL


def test_pack_predict_inputs_matches_jax():
    """With the TPU paddings passed as parameters the packed arrays are
    bit-equal to the JAX package's."""
    from sagecal_tpu.ops.rime_kernel import pack_predict_inputs as jpack
    from sagecal_tpu_torch.ops.rime_kernel import pack_predict_inputs

    p = _problem(seed=5, rows=157, nc=2)
    c64 = lambda x: x.astype(np.complex64)
    f32 = lambda x: x.astype(np.float32)
    want = jpack(jnp.asarray(c64(p["vis"])), jnp.asarray(f32(p["mask"])),
                 jnp.asarray(c64(p["coh"])), jnp.asarray(p["ant_p"]),
                 jnp.asarray(p["ant_q"]), jnp.asarray(p["cmap"]), TILE)
    got = pack_predict_inputs(
        torch.from_numpy(c64(p["vis"])), torch.from_numpy(f32(p["mask"])),
        torch.from_numpy(c64(p["coh"])), torch.from_numpy(p["ant_p"]),
        torch.from_numpy(p["ant_q"]), torch.from_numpy(p["cmap"]),
        row_pad=TILE, cluster_pad=MC)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


def test_wrapper_on_cpu_takes_plain_version_without_launching():
    from sagecal_tpu_torch.ops import rime_kernel as rk

    p = _problem(seed=7)
    tre, tim = rk.pack_gain_tables(torch.from_numpy(p["jones"]), p["mp"],
                                   p["npad"])
    inputs = tuple(map(torch.from_numpy, p["padded"]))
    before = (rk.fused_cost_fwd_cuda.launches, rk.fused_cost_bwd_cuda.launches)
    a = tre.clone().requires_grad_(True)
    v = rk.fused_cost_packed(a, tim, *inputs, 5.0)
    v.backward()
    vp, gp, _ = _torch_value_and_grad(tre, tim, inputs, 5.0, None, 1)
    assert float(v.detach()) == vp
    assert torch.equal(a.grad, gp)
    assert (rk.fused_cost_fwd_cuda.launches,
            rk.fused_cost_bwd_cuda.launches) == before


def test_kernel_launchers_refuse_cpu_tensors():
    """The launchers take CUDA tensors only; they never fall back."""
    from sagecal_tpu_torch.ops import rime_kernel as rk

    p = _problem(seed=7)
    tre, tim = rk.pack_gain_tables(torch.from_numpy(p["jones"]), p["mp"])
    inputs = tuple(map(torch.from_numpy, p["padded"]))
    nu = torch.ones((1,))
    for fn in (rk.fused_cost_fwd_cuda, rk.fused_cost_bwd_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(tre, tim, *inputs, nu, False)


def test_parity_problem_and_work_count_on_cpu():
    """The shared kernel-parity problem builds in the kernel layout, its
    plain cost matches the wrapper's, and the bound's byte count is each
    input read once plus the outputs written once."""
    from sagecal_tpu_torch.kernels.parity import (
        fused_cost_work, random_cost_problem, value_and_grad,
    )

    prob = random_cost_problem(M=3, N=6, F=2, rows=150, nc=2, device="cpu")
    assert tuple(prob.coh_ri.shape) == (3, 2, 8, 150)
    assert tuple(prob.tab_re.shape) == (4, 6, 6)
    c_plain = value_and_grad(prob, 5.0, plain=True)[0]
    c_wrap = value_and_grad(prob, 5.0)[0]
    assert float(c_plain) == float(c_wrap)
    work = fused_cost_work(prob)
    inputs = 4 * (2 * 4 * 6 * 6 + 3 * 2 * 8 * 150 + 2 * 150 + 2 * 8 * 150
                  + 2 * 150 + 3 * 150 + 1)
    assert work["fwd"][0] == inputs + 4
    assert work["bwd"][0] == inputs + 4 * 2 * 4 * 6 * 6
    assert work["fwd"][1] == 128 * 3 * 2 * 150 + 40 * 2 * 150


@pytest.mark.parametrize("nc", [1, 2])
def test_tile_cost_problem_is_the_solves_joint_cost(nc):
    """``tile_cost_problem`` packs a tile as ``sagefit``'s fused joint
    cost does: at one solution its plain cost and gradient are the
    solve's cost function's, bit for bit (CPU: both run the plain
    version), Gaussian and robust."""
    from sagecal_tpu_torch.core.types import jones_to_params, params_to_jones
    from sagecal_tpu_torch.io.simulate import (
        corrupt_and_observe, make_visdata, random_jones,
    )
    from sagecal_tpu_torch.kernels.parity import (
        tile_cost_problem, value_and_grad,
    )
    from sagecal_tpu_torch.ops.rime import point_source_batch
    from sagecal_tpu_torch.ops.rime_kernel import pack_gain_tables
    from sagecal_tpu_torch.solvers.sage import (
        _make_fused_joint_cost, build_cluster_data,
    )

    N, M = 6, 3
    data = make_visdata(nstations=N, tilesz=4, nchan=2, seed=2, device="cpu")
    clusters = [point_source_batch([0.01 * k], [-0.004 * k], [1.0 + k],
                                   device="cpu") for k in range(M)]
    data = corrupt_and_observe(data, clusters, noise_sigma=1e-2, seed=4,
                               jones=random_jones(M, N, seed=5, device="cpu"))
    cdata = build_cluster_data(data, clusters, [nc, 1, nc])
    p = jones_to_params(random_jones(M * nc, N, seed=6, amp=0.2,
                                     device="cpu")).reshape(M, nc, 8 * N)
    prob = tile_cost_problem(data, cdata, p)
    assert prob.nc == nc and tuple(prob.tab_re.shape) == (4, M * nc, N)
    for nu in (None, 5.0):
        cost_fn = _make_fused_joint_cost(data, cdata, M, nc, 8 * N,
                                         nu is not None, nu)
        x = p.reshape(-1).clone().requires_grad_(True)
        want = cost_fn(x)
        (g_want,) = torch.autograd.grad(want, x)
        got, ga, gb = value_and_grad(prob, nu, plain=True)
        assert float(got) == float(want.detach())
        # the tables' gradient, taken back through the packing to p
        y = p.reshape(-1).clone().requires_grad_(True)
        jones = params_to_jones(y.reshape(M, nc, 8 * N))
        tre, tim = pack_gain_tables(jones if nc > 1 else jones[:, 0], M)
        (g_got,) = torch.autograd.grad(
            (ga.detach() * tre).sum() + (gb.detach() * tim).sum(), y)
        assert torch.equal(g_got, g_want)
