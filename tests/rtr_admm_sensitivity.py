"""Where the RTR-ADMM x-step and the mode-5 consensus ADMM stop
reproducing themselves: how far ``p`` moves when the input moves by one
part in 1e13, the size of the two packages' rounding differences (why
tests/test_torch_admm.py and the ``cuda`` mesh test hold these paths to
1e-8 at the depths they use, and the port to the JAX package's own
spread past them).

Run from the repository root on the CPU::

    JAX_PLATFORMS=cpu python tests/rtr_admm_sensitivity.py

``admm_sagefit`` runs itmax+5 steepest-descent and itmax+10
trust-region steps a cluster solve.  For each depth it prints the
largest relative change of ``p`` (of the largest magnitude):

- the JAX package's ``admm_sagefit`` in modes 4 and 5 on
  ``test_torch_admm.py``'s near-solution inputs (rho 20/8) at p0 times
  (1 +- 1e-13) against p0, and the port's against the JAX package's at
  p0 (a port fault shows as a port column far above the JAX one where
  the JAX one is small);
- the port's mode-5 ``make_admm_mesh_fn`` on ``test_torch_kernels_cuda``'s
  4-band problem at the data times (1 +- 1e-13) against the data.
"""

import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import conftest  # noqa: E402,F401  (CPU JAX with 8 devices and x64)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

EPS = 1e-13


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def xstep(mode: int, emiter: int, itmax: int) -> None:
    from sagecal_tpu.parallel.admm import admm_sagefit as jfit
    from sagecal_tpu.solvers.lm import LMConfig as JLM
    from sagecal_tpu_torch.parallel.admm import admm_sagefit
    from sagecal_tpu_torch.solvers.lm import LMConfig
    from test_torch_admm import _port_band, _xstep_inputs

    data, cdata, p0, Y, BZ = _xstep_inputs(near=True)
    rho = np.asarray([20.0, 8.0])
    kw = dict(max_emiter=emiter, solver_mode=mode)
    outs = [np.asarray(jfit(data, cdata, jnp.asarray(p0 * (1 + e)),
                            jnp.asarray(Y), jnp.asarray(BZ),
                            jnp.asarray(rho), lm_config=JLM(itmax=itmax),
                            **kw).p)
            for e in (0.0, EPS, -EPS)]
    d, c, pt = _port_band(data, cdata, p0)
    port = admm_sagefit(d, c, pt, torch.as_tensor(Y), torch.as_tensor(BZ),
                        torch.as_tensor(rho), lm_config=LMConfig(itmax=itmax),
                        **kw).p.numpy()
    print(f"x-step mode {mode}, {emiter} EM, itmax {itmax:2d} "
          f"({max(itmax + 5, 0)} SD + {itmax + 10} TR): JAX vs JAX "
          f"{max(_rel(o, outs[0]) for o in outs[1:]):.2e}; port vs JAX "
          f"{_rel(port, outs[0]):.2e}", flush=True)


def mesh_mode5(nadmm: int, itmax: int) -> None:
    from sagecal_tpu_torch.parallel.mesh import make_admm_mesh_fn
    from sagecal_tpu_torch.solvers.lm import LMConfig
    from test_torch_kernels_cuda import _mesh_problem

    d, c, p0, rho, B = _mesh_problem(4, near=True)
    fn = make_admm_mesh_fn(4, nadmm=nadmm, max_emiter=1, plain_emiter=1,
                           lm_config=LMConfig(itmax=itmax), solver_mode=5,
                           bb_rho=True, device="cpu")
    outs = [fn(dataclasses.replace(d, vis=d.vis * (1 + e)), c, p0, rho,
               B).p.numpy() for e in (0.0, EPS, -EPS)]
    print(f"mesh mode 5, {nadmm} rounds, itmax {itmax:2d}: port vs port "
          f"{max(_rel(o, outs[0]) for o in outs[1:]):.2e}", flush=True)


if __name__ == "__main__":
    for mode in (4, 5):
        for emiter, itmax in ((1, -5), (1, -4), (2, -5), (1, -2), (1, 4),
                              (2, 4)):
            xstep(mode, emiter, itmax)
    for nadmm, itmax in ((1, -4), (5, -5), (5, -4), (5, 4)):
        mesh_mode5(nadmm, itmax)
