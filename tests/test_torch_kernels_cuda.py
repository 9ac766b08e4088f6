"""Fused-objective CUDA kernels vs their plain PyTorch version, on the card.

Marked ``cuda``: each test needs an NVIDIA GPU and skips without one
(decided in the fixture, never at import).  This file imports torch
only, so it runs on a machine without JAX; from the repo root::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances: cost relative error <= 1e-5 and gradient error <= 1e-5 of
the gradient's norm — both versions compute in f32 and differ only in
summation order (cluster sum per row, block tree, then block sum in the
kernels; torch's reductions in the plain version).  The backward must be
bit-identical on repeat: it uses no floating-point atomics.
"""

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
