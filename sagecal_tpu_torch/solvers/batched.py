"""Batched solver entry points for the serve path (counterpart of
``sagecal_tpu/solvers/batched.py``).

A serve bucket is B independent same-shape tile solves.  Layout contract
(what :func:`stack_lanes` builds):

- every tensor field of ``data`` (:class:`VisData`) and ``cdata``
  (:class:`ClusterData`) carries a leading lane axis B;
- the static fields (tilesz, nbase, nstations, freq0, ...) are shared by
  the batch: that is what a bucket means (``serve/bucket.py``);
- ``p0`` is (B, M, nchunk_max, 8N);
- padded lanes of a ragged bucket replicate real entries round-robin
  (``serve.bucket.pad_indices``); their results are discarded by the
  caller.

Routes (:func:`choose_batched_path`): ``"fused_batch"`` solves the
bucket's joint LBFGS in lock-step on the batched fused-objective kernels
(:func:`sagecal_tpu_torch.solvers.sage.sagefit_batched_fused`); ``"fused"``
and ``"xla"`` solve lane by lane with the solo fused kernels or the
torch-op joint cost (the reference's vmap of ``sagefit_packed``; the
route names are the reference's, "xla" being the torch-op cost here).
On the lane-by-lane routes each lane's quality (``collect_quality``) is
stacked on the leading lane axis, as the reference's vmap returns it.
:func:`lbfgs_minibatch_batch` runs B minibatch joint-LBFGS steps
(``solvers/batchmode.py``) lane by lane, each lane with its own
curvature memory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from sagecal_tpu_torch.core.types import VisData
from sagecal_tpu_torch.ops.quality import stack_quality
from sagecal_tpu_torch.solvers.batchmode import bfgsfit_minibatch
from sagecal_tpu_torch.solvers.lbfgs import LBFGSMemory, batched_memory
from sagecal_tpu_torch.solvers.sage import (
    ClusterData, SageConfig, SageResult, lane_of, sagefit,
    sagefit_batched_fused,
)


def derive_lane_generators(seed: int, lane_ids) -> list:
    """One CPU ``torch.Generator`` per lane, seeded by a pure function of
    ``(seed, lane_id)``: a request's random draws (OS-LM subsets) depend
    on the request's identity, not on the batch slot it lands in."""
    gens = []
    for lane_id in lane_ids:
        state = np.random.SeedSequence([int(seed), int(lane_id)])
        gens.append(torch.Generator().manual_seed(
            int(state.generate_state(1, np.uint64)[0])))
    return gens


def choose_batched_path(data, cdata, p0, config: SageConfig):
    """Host-side capability check routing a batch to a kernel path.

    Returns ``(path, reason)``, path one of ``"fused_batch"`` (the
    batched kernels), ``"fused"`` (lane by lane on the solo fused
    kernels) or ``"xla"`` (lane by lane on the torch-op cost).  Every
    check and reason string is the reference's, except two TPU limits
    that the CUDA kernels do not have: the 128-station ``NPAD`` cap and
    the VMEM bound on B * pad8(M) (``batch_rows_bound``,
    ``KERNEL_VMEM_TABLE.json``).  A bucket that the reference sends to
    ``"fused"`` only for that bound goes to ``"fused_batch"`` here.
    ``data``/``cdata`` carry the leading lane axis; ``p0`` is
    (B, M, nchunk_max, 8N), a tensor or a numpy array."""
    if not config.use_fused_predict:
        return "xla", "fused predict disabled in config"
    B, M, nchunk_max, n8 = p0.shape
    if isinstance(p0, torch.Tensor):
        f32 = p0.dtype == torch.float32
    else:
        f32 = np.asarray(p0).dtype == np.float32
    if not f32:
        return "xla", "fused kernels require float32 parameters/data"
    if config.param_bound > 0.0:
        return "xla", "param_bound uses the (XLA-only) bounded LBFGS"
    if config.collect_telemetry:
        return "xla", "telemetry traces are XLA-path only"
    if nchunk_max > 1:
        return "fused", "hybrid time chunks: batched kernel is nc==1 only"
    ant_p = torch.as_tensor(data.ant_p)
    ant_q = torch.as_tensor(data.ant_q)
    if not (bool((ant_p == ant_p[:1]).all())
            and bool((ant_q == ant_q[:1]).all())):
        return "fused", "lanes do not share baseline geometry"
    return "fused_batch", "all batched-kernel capability checks passed"


def stack_lanes(lanes: Sequence[tuple]):
    """``[(VisData, ClusterData, p0), ...]`` of one bucket -> the stacked
    ``(VisData, ClusterData, p0)`` of the layout contract (every tensor
    stacked on a new leading axis; the static fields must agree)."""
    datas, cdatas, p0s = zip(*lanes)
    statics = [f.name for f in dataclasses.fields(VisData)
               if not isinstance(getattr(datas[0], f.name), torch.Tensor)]
    for d in datas[1:]:
        for k in statics:
            if getattr(d, k) != getattr(datas[0], k):
                raise ValueError(f"lanes differ in static field {k}: not "
                                 f"one bucket")

    def stack(objs):
        return dataclasses.replace(objs[0], **{
            f.name: torch.stack([getattr(o, f.name) for o in objs])
            for f in dataclasses.fields(objs[0])
            if isinstance(getattr(objs[0], f.name), torch.Tensor)})

    return (stack(datas), stack(cdatas),
            torch.stack([torch.as_tensor(p) for p in p0s]))


def _stack_results(results) -> SageResult:
    quality = None
    if results[0].quality is not None:
        quality = {k: stack_quality([r.quality[k] for r in results])
                   for k in ("em", "final")}
    return SageResult(
        **{k: torch.stack([getattr(r, k) for r in results])
           for k in ("p", "res_0", "res_1", "mean_nu", "diverged")},
        phase_seconds={k: sum(r.phase_seconds[k] for r in results)
                       for k in ("em", "lbfgs")},
        lbfgs_iterations=[r.lbfgs_iterations for r in results],
        quality=quality)


def sagefit_packed_batch(data: VisData, cdata: ClusterData, vis_re, vis_im,
                         coh_re, coh_im, p0,
                         config: SageConfig = SageConfig(),
                         generators: Optional[Sequence[torch.Generator]] = None,
                         valid=None, batched_fused: bool = False,
                         device=None) -> SageResult:
    """``B`` independent tile solves: the reference's signature, with
    per-lane generators in place of PRNG keys.

    ``vis_*`` (B, F, 4, rows) and ``coh_*`` (B, M, F, 4, rows) are the
    real and imaginary parts that replace ``data.vis`` and ``cdata.coh``;
    ``p0`` (B, M, nchunk_max, 8N).  ``batched_fused`` (set it from
    :func:`choose_batched_path`) solves the joint LBFGS of all lanes on
    the batched kernels (:func:`sagefit_batched_fused`), where ``valid``
    (B,) pins padded lanes to zero cost and cotangent.  Otherwise each
    lane is solved by :func:`sagefit` in turn (fused or torch-op joint
    cost as ``config`` says; ``valid`` ignored), the reference's vmap.
    Returns a :class:`SageResult` with a leading B on every tensor."""
    B = vis_re.shape[0]
    if generators is None:
        generators = derive_lane_generators(0, range(B))
    data = data.replace(vis=torch.complex(torch.as_tensor(vis_re),
                                          torch.as_tensor(vis_im)))
    cdata = cdata.replace(coh=torch.complex(torch.as_tensor(coh_re),
                                            torch.as_tensor(coh_im)))
    if batched_fused:
        return sagefit_batched_fused(data, cdata, p0, config, generators,
                                     valid, device=device)
    p0 = torch.as_tensor(p0)
    return _stack_results([
        sagefit(lane_of(data, b), lane_of(cdata, b), p0[b], config,
                generators[b], device=device)
        for b in range(B)])


def _lane_memory(mem: LBFGSMemory, b: int) -> LBFGSMemory:
    return LBFGSMemory(s=mem.s[b], y=mem.y[b], rho=mem.rho[b],
                       vacant=int(mem.vacant[b]), nfilled=int(mem.nfilled[b]),
                       niter=int(mem.niter[b]),
                       running_avg=mem.running_avg[b],
                       running_avg_sq=mem.running_avg_sq[b])


def _stack_memory(mems) -> LBFGSMemory:
    dev = mems[0].s.device
    ints = lambda k: torch.tensor([getattr(m, k) for m in mems],
                                  dtype=torch.int64, device=dev)
    stack = lambda k: torch.stack([getattr(m, k) for m in mems])
    return LBFGSMemory(s=stack("s"), y=stack("y"), rho=stack("rho"),
                       vacant=ints("vacant"), nfilled=ints("nfilled"),
                       niter=ints("niter"), running_avg=stack("running_avg"),
                       running_avg_sq=stack("running_avg_sq"))


def lbfgs_minibatch_batch(data: VisData, cdata: ClusterData, p0,
                          memory: Optional[LBFGSMemory] = None,
                          itmax: int = 10, lbfgs_m: int = 7,
                          robust_nu: Optional[float] = None):
    """``B`` independent minibatch joint-LBFGS steps: lane ``b`` is
    :func:`bfgsfit_minibatch` on lane ``b`` of ``data``/``cdata`` from
    ``p0[b]`` (the reference vmaps the same function).

    ``p0`` is (B, M, nchunk_max, 8N); ``memory`` (when resuming a stream)
    is an :class:`LBFGSMemory` whose every field carries the lane axis,
    the layout of :func:`sagecal_tpu_torch.solvers.lbfgs.batched_memory`
    (``vacant``/``nfilled``/``niter`` as (B,) int64 tensors), so each
    tenant's curvature pairs persist independently across its
    minibatches.  Returns ``(p_new, memory)`` in the same layouts."""
    p0 = torch.as_tensor(p0)
    B = p0.shape[0]
    if memory is None:
        memory = batched_memory(B, p0[0].numel(), lbfgs_m, p0.dtype,
                                p0.device)
    outs = [bfgsfit_minibatch(lane_of(data, b), lane_of(cdata, b), p0[b],
                              memory=_lane_memory(memory, b), itmax=itmax,
                              lbfgs_m=lbfgs_m, robust_nu=robust_nu)
            for b in range(B)]
    return (torch.stack([p for p, _ in outs]),
            _stack_memory([m for _, m in outs]))
