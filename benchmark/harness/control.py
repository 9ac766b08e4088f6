"""The controls: the reference put in the place of a stage of the
program and computed one precision down.  The configurations state
float32 with TF32 off, so each control computes its stage in float32
with the inputs of its products rounded to TF32 (10-bit mantissas), as
a TF32 matrix product takes them: the step that would tempt a later
change, which the check has to call wrong.

- :func:`coherencies`: the app's coherency stage
  (``apps/fullbatch.py``'s ``build_cluster_data``, both views) formed by
  :func:`benchmark.reference.rime.coherencies_tf32` (the phase and
  tangent-plane products, rows x 3 by 3 x sources, in TF32).
- :func:`joint_cost`: the joint LBFGS's cost and gradient (#3 and #4
  on the card, ``solvers/sage.py``'s ``_make_fused_joint_cost``) formed
  by the reference's model and robust cost from the tile's own data and
  coherencies, the gains and coherencies rounded to TF32 before the
  products, float32 sums, the gradient by autograd.

Each is a program patch ``(apps.fullbatch module, observation) ->
undo``; used by ``benchmark/readings.py`` and the CPU tests, never by a
run.
"""

from __future__ import annotations

import torch

from benchmark.reference import rime


def coherencies(fb, obs):
    """Replace ``fb.build_cluster_data`` for this observation's sky;
    returns the undo."""
    from sagecal_tpu_torch.solvers.sage import ClusterData

    real = fb.build_cluster_data
    cache = {}

    def build(data, clusters, nchunks, fdelta=None, shapelets=None):
        dev = data.u.device
        if dev not in cache:
            cache[dev] = [rime.source_table(c, obs.ra0, obs.dec0, dev)
                          for c in obs.clusters]
        fd = float(data.deltaf if fdelta is None else fdelta)
        R = data.u.shape[0]
        coh = torch.stack([
            torch.cat([rime.coherencies_tf32(t, data.u[a:a + rime.ROW_BLOCK],
                                             data.v[a:a + rime.ROW_BLOCK],
                                             data.w[a:a + rime.ROW_BLOCK],
                                             data.freqs, fd)
                       for a in range(0, R, rime.ROW_BLOCK)], dim=-1)
            for t in cache[dev]])
        M = coh.shape[0]
        return ClusterData(
            coh=coh.to(data.vis.dtype),
            chunk_map=torch.zeros((M, R), dtype=torch.int64, device=dev),
            nchunk=torch.ones((M,), dtype=torch.int64, device=dev))

    fb.build_cluster_data = build

    def undo():
        fb.build_cluster_data = real

    return undo


def _tf32c(z: torch.Tensor) -> torch.Tensor:
    return torch.complex(rime.tf32(z.real.float()), rime.tf32(z.imag.float()))


def joint_cost(fb, obs):
    """Replace the solver's joint-cost builder; returns the undo."""
    from sagecal_tpu_torch.solvers import sage

    real = sage._make_fused_joint_cost

    def make(data, cdata, M, nchunk_max, n8, robust, mean_nu, *a, **kw):
        if nchunk_max != 1:
            raise ValueError("the control covers one chunk a cluster")
        coh = _tf32c(cdata.coh)
        vis = data.vis.to(torch.complex64)
        mask = data.mask.float()
        nu = float(mean_nu) if robust else None

        def cost_fn(pflat):
            p = pflat.reshape(M, n8).float()
            # TF32 inputs, the gradient passed straight through
            p = p + (rime.tf32(p.detach()) - p.detach())
            r = (vis - rime.model(coh, rime.jones(p), data.ant_p,
                                  data.ant_q)) * mask[:, None, :]
            if nu is None:
                return (r.real ** 2 + r.imag ** 2).sum()
            return rime.robust_cost(r, nu)

        return cost_fn

    sage._make_fused_joint_cost = make

    def undo():
        sage._make_fused_joint_cost = real

    return undo


CONTROLS = {"coherencies": coherencies, "joint_cost": joint_cost}
