"""Port vs JAX package: the consensus ADMM over sub-bands
(``parallel/mesh.py``, ``make_admm_mesh_fn``).

The bands are tests/test_admm_mesh.py's (8 stations, 2 point-source
clusters, tilesz 2, one channel, true gains linear in frequency over
120-180 MHz; tests/test_torch_admm.py's ``_band_problem``).  The JAX mesh
runs on as many of the conftest's 8 CPU devices as the port has virtual
shards.  Bar: 1e-8 relative (of the largest magnitude) at f64 for every
field of the result, the ``collect_trace`` fields included.

The JAX package's reduced z-step does not trace under ``shard_map``'s
replication check on the installed JAX (out_specs of replicated outputs
"could not infer replication"); the JAX mesh here runs with that check
off (``_jax_mesh``), which changes none of its numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from test_torch_admm import _band_problem, _close
from torch_port_common import free_jax_programs, tile_arrays  # noqa: F401


def _jax_mesh(monkeypatch, nshards, itmax=4, **kw):
    import sagecal_tpu.parallel.mesh as jm
    from sagecal_tpu.solvers.lm import LMConfig as JLM

    sm = jm._shard_map
    monkeypatch.setattr(jm, "_shard_map",
                        lambda *a, **k: sm(*a, **{**k, "check_vma": False}))
    mesh = Mesh(np.array(jax.devices()[:nshards]), ("freq",))
    return jm.make_admm_mesh_fn(mesh, lm_config=JLM(itmax=itmax), **kw)


def _run_both(monkeypatch, Nf, nshards, ccfg=None, nadmm=5, itmax=4, **kw):
    from sagecal_tpu.parallel import consensus as jc
    from sagecal_tpu.parallel.mesh import stack_for_mesh as jstack
    from sagecal_tpu_torch.interop import (
        admm_state_from_numpy, batch_from_numpy, consensus_config_from_numpy,
    )
    from sagecal_tpu_torch.parallel.mesh import make_admm_mesh_fn
    from sagecal_tpu_torch.solvers.lm import LMConfig

    bands, p0s, B = _band_problem(Nf)
    rho = np.tile(np.asarray([[20.0, 12.0]]), (Nf, 1))
    base = dict(nadmm=nadmm, max_emiter=1, plain_emiter=1, **kw)
    jcfg = None if ccfg is None else jc.ConsensusConfig(**ccfg)
    fnj = _jax_mesh(monkeypatch, nshards, itmax, consensus_cfg=jcfg, **base)
    oj = fnj(jstack([b[0] for b in bands]), jstack([b[1] for b in bands]),
             jnp.stack(p0s), jnp.asarray(rho), jnp.asarray(B))
    d, c, p0 = batch_from_numpy([tile_arrays(b[0], b[1], p0s[i])
                                 for i, b in enumerate(bands)], device="cpu")
    tcfg = None if ccfg is None else consensus_config_from_numpy(jcfg)
    fnt = make_admm_mesh_fn(nshards, lm_config=LMConfig(itmax=itmax),
                            consensus_cfg=tcfg, device="cpu", **base)
    st = admm_state_from_numpy({"rho": rho, "B": B}, device="cpu")
    ot = fnt(d, c, p0, st["rho"], st["B"])
    return oj, ot


def _close_results(oj, ot):
    from sagecal_tpu_torch.interop import admm_result_to_numpy

    a, b = admm_result_to_numpy(ot), admm_result_to_numpy(oj)
    assert set(a) == set(b), (set(a), set(b))
    for k in ("p", "Y", "Z", "rho", "dual_res", "primal_res",
              "primal_res_band", "dual_res_band", "rho_trace"):
        if k in b:
            if not np.any(b[k]):
                np.testing.assert_array_equal(a[k], b[k])
            else:
                _close(a[k], b[k])


@pytest.mark.parametrize("Nf,nshards,ccfg,kw", [
    (8, 8, None, dict(bb_rho=True, collect_trace=True)),
    (16, 8, None, dict(collect_trace=True)),
    (8, 8, dict(zstep="reduced"), dict(collect_trace=False)),
    (8, 8, dict(zstep="reduced"), dict(bb_rho=True, collect_trace=True)),
    (8, 4, dict(cluster_groups=2), dict(bb_rho=True, collect_trace=True)),
    (8, 4, dict(cluster_groups=2, zstep="reduced"), dict()),
    (16, 8, dict(staleness=1, staleness_discount=0.5),
     dict(collect_trace=True)),
], ids=["8on8_bb", "16on8", "reduced_scatter", "reduced_gather_bb",
        "groups2_bb", "groups2_reduced", "stale1_disc05"])
def test_mesh_matches_jax(monkeypatch, Nf, nshards, ccfg, kw):
    oj, ot = _run_both(monkeypatch, Nf, nshards, ccfg, nadmm=5, **kw)
    _close_results(oj, ot)
    # the consensus converges (tests/test_admm_mesh.py's bar)
    assert float(ot.primal_res[-1]) < 0.05


def test_mesh_robust_rtr_matches_jax(monkeypatch):
    """Robust RTR-ADMM (mode 5) with the BB rho, at itmax=-5 (5
    trust-region steps a cluster solve, none of steepest descent):
    before the trust region reaches the rounding floor, where the
    mesh's p moves by ~1e-13 when the data move by 1e-13
    (tests/rtr_admm_sensitivity.py)."""
    oj, ot = _run_both(monkeypatch, 4, 4, nadmm=5, itmax=-5, solver_mode=5,
                       bb_rho=True, collect_trace=True)
    _close_results(oj, ot)


def test_mesh_rebalanced_schedule_matches_jax(monkeypatch):
    """Static per-shard slot and group schedules (factor_schedule with
    band weights, as the distributed app builds for cluster groups)."""
    from sagecal_tpu.parallel.admm import factor_schedule

    slot_s, group_s = factor_schedule(6, 2, cluster_groups=2,
                                      band_weights=[3, 1, 1, 2, 1, 1, 2, 1],
                                      ndev=4)
    oj, ot = _run_both(monkeypatch, 8, 4, dict(
        cluster_groups=2, slot_schedule=slot_s, group_schedule=group_s),
        nadmm=6, collect_trace=True)
    _close_results(oj, ot)


def test_mesh_padding_band_matches_jax(monkeypatch):
    """A zero-weight pad band (mask 0, rho 0), as the distributed app
    pads 3 bands to 4 shards."""
    from sagecal_tpu.parallel.mesh import stack_for_mesh as jstack
    from sagecal_tpu_torch.interop import batch_from_numpy
    from sagecal_tpu_torch.parallel.mesh import make_admm_mesh_fn
    from sagecal_tpu_torch.solvers.lm import LMConfig

    bands, p0s, B = _band_problem(4)
    d3, c3 = bands[0]
    bands[3] = (d3.replace(mask=jnp.zeros_like(d3.mask)), c3)
    B = B.copy()
    B[3] = B[2]
    rho = np.tile(np.asarray([[20.0, 12.0]]), (4, 1))
    rho[3] = 0.0
    base = dict(nadmm=5, max_emiter=1, plain_emiter=1, bb_rho=True,
                collect_trace=True)
    oj = _jax_mesh(monkeypatch, 2, **base)(
        jstack([b[0] for b in bands]), jstack([b[1] for b in bands]),
        jnp.stack(p0s), jnp.asarray(rho), jnp.asarray(B))
    d, c, p0 = batch_from_numpy([tile_arrays(b[0], b[1], p0s[i])
                                 for i, b in enumerate(bands)], device="cpu")
    ot = make_admm_mesh_fn(2, lm_config=LMConfig(itmax=4), device="cpu",
                           **base)(d, c, p0, torch.as_tensor(rho),
                                   torch.as_tensor(B))
    _close_results(oj, ot)


def test_mesh_refuses_spatial_and_bad_configs():
    from sagecal_tpu_torch.parallel import consensus
    from sagecal_tpu_torch.parallel.mesh import make_admm_mesh_fn

    with pytest.raises(NotImplementedError, match="A7"):
        make_admm_mesh_fn(2, 3, spatial=object(), device="cpu")
    with pytest.raises(ValueError, match="staleness"):
        make_admm_mesh_fn(2, 3, device="cpu",
                          consensus_cfg=consensus.ConsensusConfig(
                              staleness=1, cluster_groups=2))
    with pytest.raises(ValueError, match="zstep"):
        make_admm_mesh_fn(2, 3, device="cpu",
                          consensus_cfg=consensus.ConsensusConfig(
                              zstep="other"))
