"""Port vs JAX package: federated averaging over sub-bands
(``parallel/federated.py``) and the federated app's band reset
(``apps/federated.py::_reset_band``).

Four bands of tests/test_torch_mesh_spatial.py's problem (6 stations, 3
point clusters, tilesz 2), made by the JAX package and carried across
as numpy; the JAX mesh runs one band a device on 4 of the conftest's CPU
devices, the port one virtual shard a band.  The state crosses with
``interop.federated_state_from_numpy``.  Bar: 1e-8 relative (of the
largest magnitude) at float64 for every field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from test_torch_mesh_spatial import NF, _bands
from torch_port_common import free_jax_programs, tile_arrays  # noqa: F401

TOL = 1e-8


def _close(a, b, tol=TOL, what=""):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if not np.any(b):
        np.testing.assert_array_equal(a, b)
        return
    err = float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))
    assert err < tol, (what, err)


def _close_state(st, sj):
    from sagecal_tpu_torch.interop import federated_state_to_numpy

    a, b = federated_state_to_numpy(st), federated_state_to_numpy(sj)
    assert set(a) == set(b)
    for k in b:
        _close(a[k], b[k], what=k)


def _inputs():
    from sagecal_tpu.parallel.mesh import stack_for_mesh as jstack
    from sagecal_tpu_torch.interop import batch_from_numpy

    bands, p0s, B = _bands()
    rho = np.tile(np.asarray([[10.0, 8.0, 12.0]]), (NF, 1))
    jargs = (jstack([b[0] for b in bands]), jstack([b[1] for b in bands]),
             jnp.stack(p0s), jnp.asarray(rho), jnp.asarray(B))
    d, c, p0 = batch_from_numpy([tile_arrays(b[0], b[1], p0s[i])
                                 for i, b in enumerate(bands)], device="cpu")
    return jargs, (d, c, p0, torch.from_numpy(rho),
                   torch.from_numpy(np.array(B)))


def _mesh():
    return Mesh(np.array(jax.devices()[:NF]), ("freq",))


@pytest.mark.parametrize("avg_cadence", [1, 2])
def test_federated_mesh_fn_matches_jax(devices8, avg_cadence):
    from sagecal_tpu.parallel.federated import make_federated_mesh_fn as jfm
    from sagecal_tpu.solvers.lm import LMConfig as JLM
    from sagecal_tpu_torch.parallel.federated import make_federated_mesh_fn
    from sagecal_tpu_torch.solvers.lm import LMConfig

    jargs, targs = _inputs()
    kw = dict(nadmm=3, max_emiter=1, plain_emiter=1, alpha=5.0,
              avg_cadence=avg_cadence)
    oj = jfm(_mesh(), lm_config=JLM(itmax=3), **kw)(*jargs)
    ot = make_federated_mesh_fn(NF, lm_config=LMConfig(itmax=3),
                                device="cpu", **kw)(*targs)
    for k in ("p", "Z", "dual_res"):
        _close(getattr(ot, k), np.asarray(getattr(oj, k)), what=k)
    assert float(ot.dual_res[-1]) > 0.0
    with pytest.raises(ValueError, match="shard count"):
        make_federated_mesh_fn(2, 2, device="cpu")(*targs)


def test_federated_minibatch_round_and_average_match_jax(devices8):
    """Two minibatch rounds (the LBFGS memory persists between them),
    the average, a third round; then a band reset on that state."""
    from sagecal_tpu.apps.federated import _reset_band as jreset
    from sagecal_tpu.parallel.federated import (
        init_federated_state as jinit, make_fed_avg_fn as javg,
        make_federated_minibatch_fn as jmb,
    )
    from sagecal_tpu_torch.apps.federated import _reset_band
    from sagecal_tpu_torch.interop import federated_state_from_numpy
    from sagecal_tpu_torch.parallel.federated import (
        init_federated_state, make_fed_avg_fn, make_federated_minibatch_fn,
    )

    jargs, targs = _inputs()
    M, n8 = jargs[2].shape[1], jargs[2].shape[3]
    sj = jinit(NF, M, 1, n8, 2, 5, jnp.float64)
    st = federated_state_from_numpy(sj, device="cpu")
    _close_state(init_federated_state(NF, M, 1, n8, 2, 5, torch.float64,
                                      device="cpu"), sj)
    step_j = jmb(_mesh(), itmax=4, lbfgs_m=5, alpha=5.0)
    step_t = make_federated_minibatch_fn(NF, itmax=4, lbfgs_m=5, alpha=5.0,
                                         device="cpu")
    avg_j, avg_t = javg(_mesh(), alpha=5.0), make_fed_avg_fn(
        NF, alpha=5.0, device="cpu")
    dj, cj, _, rj, Bj = jargs
    dt, ct, _, rt, Bt = targs
    for r in range(3):
        sj, dres_j, cost_j = step_j(dj, cj, sj, rj, Bj)
        st, dres_t, cost_t = step_t(dt, ct, st, rt, Bt)
        _close(dres_t, np.asarray(dres_j), what=f"dres {r}")
        _close(cost_t, np.asarray(cost_j), what=f"cost {r}")
        _close_state(st, sj)
        if r == 1:
            sj, st = avg_j(sj), avg_t(st)
            _close_state(st, sj)
    assert [m.nfilled for m in st.mem] == [
        int(x) for x in np.asarray(sj.mem.nfilled)]
    p_init = np.array(jinit(1, M, 1, n8, 2, 5, jnp.float64).p[0])
    _close_state(_reset_band(st, 2, torch.from_numpy(p_init)),
                 jreset(sj, 2, jnp.asarray(p_init)))
