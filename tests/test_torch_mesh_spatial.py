"""Port vs JAX package: the consensus ADMM with spatial regularization
(``parallel/mesh.py`` with ``spatial=``).

Four bands of 6 stations and 3 point clusters around the phase centre
(tilesz 2, one channel, gains common to every direction and linear in
frequency over 130-170 MHz) on 2 shards, made by the JAX package and
carried across as numpy with the ``SpatialConfig``.  Both bases, with
and without the diffuse constraint's ``Z_diff0``, and a reduced z-step
(its gather form).  Bar: 1e-8 relative (of the largest magnitude) at
float64 for every field of the result, ``Zspat``, ``spat_res`` and
``Zspat_diff`` included.  The JAX mesh runs with shard_map's replication
check off, as tests/test_torch_mesh.py explains.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torch_port_common import free_jax_programs, tile_arrays  # noqa: F401

TOL = 1e-8
NF, M, N = 4, 3, 6
LLS = 0.02 * np.cos(2 * np.pi * np.arange(M) / M)
MMS = 0.02 * np.sin(2 * np.pi * np.arange(M) / M)


def _bands(seed=7):
    from sagecal_tpu.core.types import jones_to_params
    from sagecal_tpu.io.simulate import (
        corrupt_and_observe, make_visdata, random_jones,
    )
    from sagecal_tpu.ops.rime import point_source_batch
    from sagecal_tpu.parallel import consensus as jc
    from sagecal_tpu.solvers.sage import build_cluster_data

    freqs = np.linspace(130e6, 170e6, NF)
    f0 = 150e6
    J0 = np.asarray(random_jones(1, N, seed=seed, amp=0.2,
                                 dtype=np.complex128))[0]
    J1 = 0.1 * np.asarray(random_jones(1, N, seed=seed + 1, amp=1.0,
                                       dtype=np.complex128))[0]
    clusters = [point_source_batch([LLS[k]], [MMS[k]], [1.5 + 0.2 * k],
                                   f0=f0, dtype=jnp.float64)
                for k in range(M)]
    bands = []
    for f in range(NF):
        data = make_visdata(nstations=N, tilesz=2, nchan=1, freq0=f0,
                            seed=seed + f, dtype=np.float64)
        J = J0 + (freqs[f] - f0) / f0 * J1
        data = corrupt_and_observe(
            data, clusters, jones=jnp.asarray(np.broadcast_to(J, (M, N, 2, 2))),
            noise_sigma=1e-3, seed=seed + 10 + f)
        data = data.replace(freqs=jnp.asarray([freqs[f]]))
        bands.append((data, build_cluster_data(data, clusters, [1] * M)))
    p0 = np.asarray(jones_to_params(random_jones(M, N, seed=500, amp=0.0,
                                                 dtype=np.complex128)))
    p0s = [p0[:, None, :] for _ in range(NF)]
    B = np.asarray(jc.setup_polynomials(freqs, f0, 2, jc.POLY_ORDINARY))
    return bands, p0s, B


def _spatial(basis, diffuse, cadence, B):
    from sagecal_tpu.parallel import spatial as js
    from sagecal_tpu.parallel.mesh import SpatialConfig as JSpat

    modes, _ = js.spatial_basis_modes(LLS, MMS, 2, 0.05, basis)
    Phi = js.basis_blocks(modes)
    return JSpat(
        Phi=Phi, Phikk=js.phikk_matrix(Phi, lam=1e-6),
        alpha=jnp.asarray([8.0, 5.0, 6.0]), mu=1e-4, cadence=cadence,
        fista_maxiter=25,
        Z_diff0=js.find_initial_spatial(B, modes, N) if diffuse else None,
        gamma=0.3 if diffuse else 0.0, lam_diff=1e-3 if diffuse else 0.0)


@pytest.mark.parametrize("basis,diffuse,cadence,zstep", [
    ("shapelet", False, 1, "grouped"),
    ("shapelet", True, 1, "grouped"),
    ("sharmonic", False, 2, "grouped"),
    ("shapelet", True, 1, "reduced"),
])
def test_mesh_spatial_matches_jax(monkeypatch, devices8, basis, diffuse,
                                  cadence, zstep):
    import sagecal_tpu.parallel.mesh as jm
    from sagecal_tpu.parallel import consensus as jc
    from sagecal_tpu.solvers.lm import LMConfig as JLM
    from sagecal_tpu_torch.interop import (
        admm_result_to_numpy, batch_from_numpy, consensus_config_from_numpy,
        spatial_config_from_numpy,
    )
    from sagecal_tpu_torch.parallel.mesh import make_admm_mesh_fn
    from sagecal_tpu_torch.solvers.lm import LMConfig

    bands, p0s, B = _bands()
    spat = _spatial(basis, diffuse, cadence, B)
    rho = np.tile(np.asarray([[10.0, 8.0, 12.0]]), (NF, 1))
    base = dict(nadmm=3, max_emiter=1, plain_emiter=1)
    jcfg = jc.ConsensusConfig(zstep=zstep)
    sm = jm._shard_map
    monkeypatch.setattr(jm, "_shard_map",
                        lambda *a, **k: sm(*a, **{**k, "check_vma": False}))
    mesh = Mesh(np.array(devices8[:2]), ("freq",))
    oj = jm.make_admm_mesh_fn(mesh, lm_config=JLM(itmax=3), spatial=spat,
                              consensus_cfg=jcfg, **base)(
        jm.stack_for_mesh([b[0] for b in bands]),
        jm.stack_for_mesh([b[1] for b in bands]), jnp.stack(p0s),
        jnp.asarray(rho), jnp.asarray(B))
    d, c, p0 = batch_from_numpy([tile_arrays(b[0], b[1], p0s[i])
                                 for i, b in enumerate(bands)], device="cpu")
    ot = make_admm_mesh_fn(
        2, lm_config=LMConfig(itmax=3), device="cpu",
        spatial=spatial_config_from_numpy(spat, device="cpu"),
        consensus_cfg=consensus_config_from_numpy(jcfg), **base)(
        d, c, p0, torch.from_numpy(rho), torch.from_numpy(np.array(B)))
    a, b = admm_result_to_numpy(ot), admm_result_to_numpy(oj)
    assert set(a) == set(b)
    for k in b:
        assert a[k].shape == b[k].shape, (k, a[k].shape, b[k].shape)
        if not np.any(b[k]):
            np.testing.assert_array_equal(a[k], b[k])
            continue
        scale = float(np.max(np.abs(b[k])))
        err = float(np.max(np.abs(a[k] - b[k]))) / scale
        assert err < TOL, (k, err)
    # the refit ran and its state came back
    assert np.count_nonzero(a["spat_res"]) >= 1
    assert a["Zspat"].shape == (2 * 2 * N, 2 * 4)
    if diffuse:
        assert a["Zspat_diff"].shape == a["Zspat"].shape
