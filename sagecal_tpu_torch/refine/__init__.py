"""Differentiable sky-model refinement (counterpart of
``sagecal_tpu/refine/``).

Bilevel calibration: an outer LBFGS over sky parameters (fluxes,
spectral indices, positions, shapelet coefficients; see
:class:`~sagecal_tpu_torch.refine.skyparams.SkySpec`) wrapped around
the inner gain solve, with gradients through the inner fixed point by
the implicit function theorem (a ``torch.autograd.Function`` and a CG
adjoint) or by unrolling.  The coherencies are recomputed from the sky
inside the objective on the torch-op predict; the hand kernels have no
coherency cotangent and refuse
(``ops.rime_kernel.FusedSkyGradientError``).
"""

from sagecal_tpu_torch.refine.implicit import (
    cg_solve,
    gauss_newton_solve,
    make_inner_solver,
)
from sagecal_tpu_torch.refine.objective import (
    RefineProblem,
    cluster_coherencies,
    cluster_data_from_theta,
    inner_cost,
    outer_cost,
    require_xla_predict,
    residual_vec,
)
from sagecal_tpu_torch.refine.outer import (
    RefineResult,
    make_outer_value_and_grad,
    run_refine,
)
from sagecal_tpu_torch.refine.skyparams import SkySpec

__all__ = [
    "RefineProblem",
    "RefineResult",
    "SkySpec",
    "cg_solve",
    "cluster_coherencies",
    "cluster_data_from_theta",
    "gauss_newton_solve",
    "inner_cost",
    "make_inner_solver",
    "make_outer_value_and_grad",
    "outer_cost",
    "require_xla_predict",
    "residual_vec",
    "run_refine",
]
