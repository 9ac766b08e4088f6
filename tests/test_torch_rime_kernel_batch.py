"""Port vs JAX package: the batched fused objective (ops/rime_kernel.py,
``fused_cost_packed_batch``; Pallas kernels #5 and #6).

The problem is the JAX tests' own (``_batched_cost_problem`` of
tests/test_rime_kernel.py: B = 3 lanes sharing one baseline geometry,
M = 3, N = 6, F = 2, 200 rows), packed by the JAX package with its TPU
paddings (tile 128, clusters to 8, stations to NPAD).  The JAX side runs
its Pallas kernels in interpret mode; the port side is
``fused_cost_packed_batch_plain`` (what the wrapper runs on CPU tensors)
on the same packed inputs.

Tolerance: per-lane cost relative error <= 1e-5 and the gradient of a
per-lane-weighted total within 1e-5 of its norm (both sides compute in
f32 and differ in summation order only; elementwise f32 gradient checks
fail on summation order alone).  Packing is exact (bit-equal).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_rime_kernel import _batched_cost_problem, _pack_batch
from torch_port_common import norm_rel, rel, to_np

TOL = 1e-5
B, M, N = 3, 3, 6


def _weights():
    return np.random.default_rng(32).uniform(0.5, 1.5, B).astype(np.float32)


def _packed(seed, coh_bf16=False, valid=None):
    """The JAX-packed batch and the same arrays as port tensors."""
    prob = _batched_cost_problem(B=B, seed=seed, M=M, N=N)
    packed = list(_pack_batch(*prob, valid=valid))
    if coh_bf16:
        packed[2] = packed[2].astype(jnp.bfloat16)
    port_in = [torch.from_numpy(np.array(x, np.float32)) for x in packed[:7]]
    port_in[3:5] = [torch.from_numpy(np.array(x)) for x in packed[3:5]]
    if coh_bf16:
        port_in[2] = port_in[2].to(torch.bfloat16)
    return packed, port_in, prob


@functools.lru_cache(maxsize=None)
def _jax_batch(nu_case, seed=31, coh_bf16=False):
    """JAX per-lane costs and weighted-total gradient of one ``NU_CASES``
    case (cached: the interpret-mode kernels are the slow part)."""
    from sagecal_tpu.ops.rime_kernel import fused_cost_packed_batch

    nu = NU_CASES[nu_case]
    packed, port_in, prob = _packed(seed, coh_bf16)
    tre, tim, coh_ri, antp, antq, vis_ri, mask_p, mp = packed
    w = jnp.asarray(_weights())
    jnu = None if nu is None else jnp.asarray(nu)

    def ck(a, b):
        return fused_cost_packed_batch(a, b, coh_ri, antp, antq, vis_ri,
                                       mask_p, jnu, 128)

    costs = np.asarray(ck(tre, tim))
    ga, gb = jax.grad(lambda a, b: jnp.sum(w * ck(a, b)),
                      argnums=(0, 1))(tre, tim)
    return costs, np.asarray(ga), np.asarray(gb), port_in, mp, prob


def _port_value_and_grad(port_in, nu, weights=None):
    from sagecal_tpu_torch.ops.rime_kernel import fused_cost_packed_batch_plain

    a = port_in[0].clone().requires_grad_(True)
    b = port_in[1].clone().requires_grad_(True)
    tnu = None if nu is None else torch.as_tensor(nu)
    costs = fused_cost_packed_batch_plain(a, b, *port_in[2:], tnu)
    w = torch.ones(B) if weights is None else torch.from_numpy(weights)
    ga, gb = torch.autograd.grad(costs, (a, b), w)
    return costs.detach(), ga, gb


NU_CASES = {
    "gauss": None,
    "robust-scalar": 5.0,
    "robust-per-lane": np.array([3.0, 5.0, 9.0], np.float32),
}


CASES = [("gauss", "f32"), ("robust-scalar", "f32"),
         ("robust-per-lane", "f32"), ("robust-per-lane", "bf16")]


@pytest.mark.parametrize("nu_case,coh_dtype", CASES,
                         ids=[f"{n}-{d}" for n, d in CASES])
def test_batched_plain_matches_jax_kernel(nu_case, coh_dtype):
    nu = NU_CASES[nu_case]
    bf16 = coh_dtype == "bf16"
    cj, gja, gjb, port_in, mp, _ = _jax_batch(nu_case, coh_bf16=bf16)
    ct, gta, gtb = _port_value_and_grad(port_in, nu, _weights())
    assert ct.shape == (B,)
    for lane in range(B):
        assert rel(ct[lane], cj[lane]) <= TOL
    assert norm_rel(np.concatenate([to_np(gta).ravel(), to_np(gtb).ravel()]),
                    np.concatenate([gja.ravel(), gjb.ravel()])) <= TOL
    # padded cluster rows and station columns get exactly zero gradient
    for g in (to_np(gta), to_np(gtb)):
        for lane in range(B):
            np.testing.assert_array_equal(g[:, lane * mp + M:(lane + 1) * mp],
                                          0.0)
        np.testing.assert_array_equal(g[:, :, N:], 0.0)


@pytest.mark.parametrize("nu", [None, 5.0], ids=["gauss", "robust"])
def test_valid_guard_zeroes_pad_lane_and_leaves_real_lanes(nu):
    """Lane 1 is a replicated pad: it costs exactly 0 with an exactly
    zero cotangent, and the real lanes are bit-identical to the same pack
    without the guard."""
    valid = np.array([True, False, True])
    packed, guarded, _ = _packed(33, valid=valid)
    _, plain, _ = _packed(33)
    mp = packed[7]
    cv, gva, gvb = _port_value_and_grad(guarded, nu)
    cr, gra, grb = _port_value_and_grad(plain, nu)
    assert float(cv[1]) == 0.0
    assert torch.equal(cv[[0, 2]], cr[[0, 2]])
    for gv, gr in ((gva, gra), (gvb, grb)):
        assert (gv[:, mp:2 * mp] == 0).all()
        assert torch.equal(gv[:, :mp], gr[:, :mp])
        assert torch.equal(gv[:, 2 * mp:], gr[:, 2 * mp:])


def test_batched_packers_match_jax_bit_for_bit():
    from sagecal_tpu.ops.rime_kernel import unpack_gain_grads_batch as junpack
    from sagecal_tpu_torch.ops.rime_kernel import (
        pack_cost_inputs_batch, pack_gain_tables_batch,
        unpack_gain_grads_batch,
    )

    valid = np.array([True, True, False])
    jones_b, coh_b, vis_b, mask_b, ant_p, ant_q = _batched_cost_problem(
        B=B, seed=34, M=M, N=N)
    want = _pack_batch(jones_b, coh_b, vis_b, mask_b, ant_p, ant_q,
                       valid=valid)
    tre, tim = pack_gain_tables_batch(
        torch.from_numpy(jones_b.astype(np.complex64)), 8, 128)
    got = pack_cost_inputs_batch(
        torch.from_numpy(vis_b.astype(np.complex64)),
        torch.from_numpy(mask_b), torch.from_numpy(coh_b.astype(np.complex64)),
        torch.from_numpy(ant_p), torch.from_numpy(ant_q), row_pad=128,
        cluster_pad=8, valid=torch.from_numpy(valid))
    for g, w in zip((tre, tim) + got, want[:2] + want[5:7] + want[2:5]):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    # the cotangent unpacking inverts the table packing like the JAX one
    wr, wi = junpack(want[0], want[1], B, M, N)
    gr, gi = unpack_gain_grads_batch(tre, tim, B, M, N)
    np.testing.assert_array_equal(to_np(gr), np.asarray(wr))
    np.testing.assert_array_equal(to_np(gi), np.asarray(wi))


def test_unpadded_batch_layout_matches_jax_cost():
    """The port needs no TPU padding: unpadded batched tables and rows
    give the JAX (padded) per-lane costs."""
    from sagecal_tpu_torch.ops.rime_kernel import (
        fused_cost_packed_batch_plain, pack_cost_inputs_batch,
        pack_gain_tables_batch,
    )

    nu = NU_CASES["robust-per-lane"]
    cj, _, _, _, _, prob = _jax_batch("robust-per-lane")
    jones_b, coh_b, vis_b, mask_b, ant_p, ant_q = prob
    tre, tim = pack_gain_tables_batch(torch.from_numpy(jones_b))
    assert tuple(tre.shape) == (4, B * M, N)
    packed = pack_cost_inputs_batch(
        torch.from_numpy(vis_b.astype(np.complex64)),
        torch.from_numpy(mask_b), torch.from_numpy(coh_b.astype(np.complex64)),
        torch.from_numpy(ant_p), torch.from_numpy(ant_q))
    vis_ri, mask_p, coh_ri, antp, antq = packed
    ct = fused_cost_packed_batch_plain(tre, tim, coh_ri, antp, antq, vis_ri,
                                       mask_p, torch.from_numpy(nu))
    for lane in range(B):
        assert rel(ct[lane], cj[lane]) <= TOL


def test_batched_plain_equals_solo_plain_per_lane():
    from sagecal_tpu_torch.kernels.parity import random_cost_problem_batch
    from sagecal_tpu_torch.ops.rime_kernel import (
        fused_cost_packed_batch_plain, fused_cost_packed_plain,
    )

    prob = random_cost_problem_batch(3, 3, 6, 2, 150, seed=4, device="cpu")
    nu = torch.tensor([2.0, 4.0, 8.0])
    got = fused_cost_packed_batch_plain(prob.tab_re, prob.tab_im,
                                        *prob.inputs, nu)
    for b in range(3):
        rows = slice(3 * b, 3 * b + 3)
        want = fused_cost_packed_plain(
            prob.tab_re[:, rows], prob.tab_im[:, rows], prob.coh_ri[rows],
            prob.ant_p, prob.ant_q, prob.vis_ri[b], prob.mask_p[b], nu[b])
        assert float(got[b]) == float(want)


def test_batched_wrapper_on_cpu_launches_nothing_and_launchers_refuse():
    from sagecal_tpu_torch.kernels.parity import (
        random_cost_problem_batch, value_and_grad_batch,
    )
    from sagecal_tpu_torch.ops import rime_kernel as rk

    prob = random_cost_problem_batch(3, 3, 6, 2, 150, seed=5, nvalid=2,
                                     device="cpu")
    before = (rk.fused_cost_batch_fwd_cuda.launches,
              rk.fused_cost_batch_bwd_cuda.launches,
              rk.fused_cost_fwd_cuda.launches, rk.fused_cost_bwd_cuda.launches)
    cw, gwa, _ = value_and_grad_batch(prob, 5.0)
    cp, gpa, _ = value_and_grad_batch(prob, 5.0, plain=True)
    assert torch.equal(cw, cp) and torch.equal(gwa, gpa)
    assert float(cw[2]) == 0.0
    assert (rk.fused_cost_batch_fwd_cuda.launches,
            rk.fused_cost_batch_bwd_cuda.launches,
            rk.fused_cost_fwd_cuda.launches,
            rk.fused_cost_bwd_cuda.launches) == before
    nu = torch.ones((3,))
    for fn in (rk.fused_cost_batch_fwd_cuda, rk.fused_cost_batch_bwd_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(prob.tab_re, prob.tab_im, *prob.inputs, nu, True)


def test_batch_parity_problem_and_work_count_on_cpu():
    """The shared batched parity problem builds in the kernel layout with
    its pad lanes zeroed, and the bound's byte count is each input read
    once plus the outputs written once."""
    from sagecal_tpu_torch.kernels.parity import (
        fused_cost_batch_work, random_cost_problem_batch,
    )

    prob = random_cost_problem_batch(4, 3, 6, 2, 150, seed=6, nvalid=3,
                                     device="cpu")
    assert tuple(prob.coh_ri.shape) == (12, 2, 8, 150)
    assert tuple(prob.tab_re.shape) == (4, 12, 6)
    assert tuple(prob.vis_ri.shape) == (4, 2, 8, 150)
    assert (prob.mask_p[3] == 0).all() and prob.valid.tolist() == [
        True, True, True, False]
    work = fused_cost_batch_work(prob)
    inputs = 4 * (2 * 4 * 12 * 6 + 12 * 2 * 8 * 150 + 2 * 150
                  + 4 * 2 * 8 * 150 + 4 * 2 * 150 + 4)
    assert work["fwd"][0] == inputs + 4 * 4
    assert work["bwd"][0] == inputs + 4 * 2 * 4 * 12 * 6
    assert work["fwd"][1] == 128 * 12 * 2 * 150 + 40 * 4 * 2 * 150
