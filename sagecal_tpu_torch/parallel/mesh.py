"""Consensus ADMM over frequency sub-bands, the mesh program on one
device (counterpart of ``sagecal_tpu/parallel/mesh.py``).

The JAX package runs the consensus ADMM as one SPMD program over a
``('freq',)`` device mesh: each device owns a contiguous group of G
sub-bands, solves its x-steps, and the master's z-step of the reference
(``sagecal_master.cpp``) becomes collectives.  Here the mesh is
``nshards`` virtual shards on one device, visited in a fixed order inside
every round; band ``d * G + g`` is slot g of shard d, as on the mesh.
Each collective becomes an operation over the shard axis:

- ``psum``: a sum of the shards' partial sums, in shard order;
- ``pmean``: that sum divided by ``nshards``;
- ``all_gather``: a concatenation; ``psum_scatter``: a sum, then a slice
  of the solution axis per shard;
- ``all_to_all``: an index shuffle (each shard's active target B_f Z
  assembled from every shard's slice);
- ``axis_index``: the loop variable.

The shards run one after another; their x-steps
(``parallel/admm.py::admm_sagefit``) run on torch ops, as the JAX
package's run on XLA ops, and launch no CUDA kernel.  The result does not
depend on the device: a round reads only the state of the previous one.

Iteration protocol (sagecal_slave.cpp:727-895):
  admm 0:  plain (unaugmented) solve of every band; align the solutions
           across bands on the quotient manifold; Yhat = rho J; z-step;
           Y = Yhat - rho BZ.
  admm>0:  each shard solves its active slot (the Sbegin/Scurrent/Send
           rotation, or a static schedule) with (Y, BZ); Yhat = Y + rho
           J; z-step over every band's stored Yhat (stale for inactive
           slots); Y = Yhat - rho BZ_new; optionally the Barzilai-Borwein
           rho update every other visit of a slot.

Every :class:`~sagecal_tpu_torch.parallel.consensus.ConsensusConfig`
route of the JAX package is here: the grouped z-step, the reduced
z-step (transpose reduction: the numerator kept as per-shard slices of
the solution axis, an incremental Gram delta per round, and the active
target gathered back from the slices; its "gather" form when the full Z
is needed every round, as with ``collect_trace``), fine-grained cluster
groups, static slot and group schedules, in-mesh staleness weights and
the BB rho cadence.  The spatial regularization of the loop (``spatial=``)
belongs to ROADMAP.md's A7 and raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from sagecal_tpu_torch.core.types import jones_to_params, params_to_jones
from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.parallel import consensus
from sagecal_tpu_torch.parallel.admm import admm_sagefit, factor_schedule
from sagecal_tpu_torch.parallel.manifold import manifold_average
from sagecal_tpu_torch.solvers.lm import LMConfig
from sagecal_tpu_torch.solvers.sage import SM_LM_LBFGS, lane_of
from sagecal_tpu_torch.utils.precision import full_f32


class AdmmResult(NamedTuple):
    p: torch.Tensor  # (Nf, M, nchunk_max, 8N) per-band solutions
    Y: torch.Tensor  # (Nf, M, nchunk_max, 8N) duals
    Z: torch.Tensor  # (M, Npoly, nchunk_max*8N) consensus variable
    rho: torch.Tensor  # (Nf, M) final penalties
    dual_res: torch.Tensor  # (nadmm,) dual residual trace
    primal_res: torch.Tensor  # (nadmm,) mean primal residual ||J - BZ||
    Zspat: Optional[torch.Tensor] = None  # spatial model (A7: placeholder)
    spat_res: Optional[torch.Tensor] = None  # (nadmm,) zeros
    Zspat_diff: Optional[torch.Tensor] = None  # diffuse model (A7)
    # collect_trace only:
    primal_res_band: Optional[torch.Tensor] = None  # (nadmm, Nf) ||J-BZ||
    dual_res_band: Optional[torch.Tensor] = None  # (nadmm, Nf) rho||B dZ||
    rho_trace: Optional[torch.Tensor] = None  # (nadmm, Nf, M)


def _flat(x):
    return x.reshape(x.shape[:-2] + (-1,))


def _unflat(x, nchunk, n8):
    return x.reshape(x.shape[:-1] + (nchunk, n8))


def _shard_sum(parts):
    """``psum``: the shards' partial sums added in shard order."""
    out = parts[0]
    for x in parts[1:]:
        out = out + x
    return out


def make_admm_mesh_fn(nshards: int, nadmm: int, max_emiter: int = 1,
                      plain_emiter: int = 2,
                      lm_config: LMConfig = LMConfig(),
                      use_manifold_align: bool = True, bb_rho: bool = False,
                      rho_upper: float = 1e3,
                      solver_mode: int = SM_LM_LBFGS,
                      robust_nu: Optional[float] = None, spatial=None,
                      collect_trace: bool = False,
                      consensus_cfg: Optional[
                          consensus.ConsensusConfig] = None,
                      device=None):
    """Build the consensus ADMM function over ``nshards`` virtual shards
    on ``device`` (CUDA unless ``device="cpu"``).

    The returned ``fn(data_stack, cdata_stack, p0, rho, B)`` takes
    leading-axis-``Nf`` stacks (:func:`stack_for_mesh`; Nf a multiple of
    ``nshards``: pad with zero-weight bands), ``p0`` (Nf, M, nchunk_max,
    8N), ``rho`` (Nf, M) and ``B`` (Nf, Npoly), moves them to the device,
    and returns an :class:`AdmmResult`.  The arguments are the JAX
    package's, with ``nshards`` for the mesh: ``solver_mode`` /
    ``robust_nu`` select the x-step solver, ``collect_trace`` adds the
    per-band residuals and the rho trajectory, ``consensus_cfg`` the
    round structure (module doc)."""
    if spatial is not None:
        raise NotImplementedError(
            "not ported yet: spatial regularization of the consensus ADMM "
            "(parallel/spatial.py, ROADMAP.md, A7)")
    dev = resolve_device(device)
    ccfg = (consensus_cfg if consensus_cfg is not None
            else consensus.ConsensusConfig())
    if ccfg.zstep not in ("grouped", "reduced"):
        raise ValueError(f"unknown zstep {ccfg.zstep!r}")
    cg = max(int(ccfg.cluster_groups), 1)
    fine = cg > 1
    use_staleness = (ccfg.staleness is not None
                     or ccfg.staleness_discount != 1.0)
    if use_staleness and (fine or ccfg.slot_schedule is not None
                          or ccfg.group_schedule is not None):
        raise ValueError(
            "in-mesh bounded staleness composes with the uniform "
            "whole-band rotation only; fine-grained / rebalanced "
            "staleness is the minibatch async-consensus path")
    reduced = ccfg.zstep == "reduced"
    if reduced and ccfg.group_schedule is not None:
        gs = np.asarray(ccfg.group_schedule)
        if gs.ndim == 2 and not np.all(gs == gs[:, :1]):
            raise ValueError(
                "reduced z-step needs a shard-uniform group schedule (the "
                "incremental Gram delta rows must align across shards)")
    # the reduced z-step keeps its slices but concatenates Z back every
    # round when the full Z is needed (the per-band telemetry)
    zmode = "grouped" if not reduced else (
        "reduced_gather" if collect_trace else "reduced_scatter")
    # fixed rho and no staleness: the reduced Bii never changes
    den_static = reduced and not bb_rho and not use_staleness
    have_sched = (fine or ccfg.slot_schedule is not None
                  or ccfg.group_schedule is not None)
    ndev = int(nshards)

    def run(data_stack, cdata_stack, p0, rho, B):
        Nf, M, nchunk_max, n8 = p0.shape
        if Nf % ndev != 0:
            raise ValueError(
                f"sub-band count {Nf} must be a multiple of the shard "
                f"count {ndev}; pad with zero-weight bands (rho=0, mask=0) "
                "first")
        G = Nf // ndev
        K = nchunk_max * n8
        Npoly = B.shape[-1]
        dtype = p0.dtype
        if M % cg != 0:
            raise ValueError(
                f"cluster_groups {cg} must divide the cluster count {M}")
        Mg = M // cg
        if reduced:
            if K % ndev != 0:
                raise ValueError(
                    f"reduced z-step needs the solution size {K} divisible "
                    f"by the shard count {ndev}; use zstep='grouped'")
            Ks = K // ndev
        if have_sched:
            slot_np, group_np = factor_schedule(nadmm, G, cluster_groups=cg,
                                                ndev=ndev)
            if ccfg.slot_schedule is not None:
                s = np.asarray(ccfg.slot_schedule, np.int32)
                slot_np = np.broadcast_to(s[:, None] if s.ndim == 1 else s,
                                          (nadmm - 1, ndev))
            if ccfg.group_schedule is not None:
                s = np.asarray(ccfg.group_schedule, np.int32)
                group_np = np.broadcast_to(s[:, None] if s.ndim == 1 else s,
                                           (nadmm - 1, ndev))

        datas = [lane_of(data_stack, b) for b in range(Nf)]
        cdatas = [lane_of(cdata_stack, b) for b in range(Nf)]
        plans = [{} for _ in range(Nf)]  # per band, kept across rounds
        nchunks = cdata_stack.nchunk.tolist()  # the tile's one host read

        def fit(b, p_b, Y_b, BZ_b, rho_b, emiter, csl=None):
            return admm_sagefit(
                datas[b], cdatas[b], p_b, Y_b, BZ_b, rho_b,
                max_emiter=emiter, lm_config=lm_config,
                solver_mode=solver_mode, robust_nu=robust_nu,
                cluster_slice=csl, plans=plans[b], nchunks=nchunks[b]).p

        def bz_of(Z_, b):
            return _unflat(consensus.bz_for_freq(Z_, B[b]), nchunk_max, n8)

        def band_weights(w):
            """(G,) slot weights -> (Nf,), each shard's slots alike."""
            return None if w is None else w.repeat(ndev)

        def numerator(Yhat_flat, w=None):
            """sum_f w_f outer(B_f, Yhat_f), Yhat_flat (Nf, M, K): per
            shard over its slots, then psum."""
            terms = B[:, None, :, None] * Yhat_flat[:, :, None, :]
            wf = band_weights(w)
            if wf is not None:
                terms = wf[:, None, None, None] * terms
            return _shard_sum([terms[d * G:(d + 1) * G].sum(dim=0)
                               for d in range(ndev)])

        def den_inv(rho_cur, w=None):
            """pinv(psum_f w_f rho_f B_f B_f^T): (M, Npoly, Npoly)."""
            parts = []
            for d in range(ndev):
                sl_ = slice(d * G, (d + 1) * G)
                if w is None:
                    parts.append(torch.einsum("gm,gp,gq->mpq", rho_cur[sl_],
                                              B[sl_], B[sl_]))
                else:
                    parts.append(torch.einsum("g,gm,gp,gq->mpq", w, rho_cur[sl_],
                                              B[sl_], B[sl_]))
            return consensus.pinv(_shard_sum(parts))

        def kslices(x):
            """``psum_scatter`` over the solution axis: shard e's slice."""
            return [x[..., e * Ks:(e + 1) * Ks] for e in range(ndev)]

        def a2a_bz(Zsh_, band_d, start_d):
            """Shard d's active target B_f Z (Mg rows from ``start_d``)
            assembled from every shard's solution slice."""
            parts = [torch.einsum("p,mpk->mk", B[band_d],
                                  Zsh_[e][start_d:start_d + Mg])
                     for e in range(ndev)]
            return _unflat(torch.cat(parts, dim=-1), nchunk_max, n8)

        # ---- admm 0: plain solve of every band -------------------------
        zeros_b = torch.zeros_like(p0[0])
        p = torch.stack([fit(b, p0[b], zeros_b, zeros_b,
                             torch.zeros_like(rho[b]), plain_emiter)
                         for b in range(Nf)])
        if use_manifold_align:
            # the master's unitary-ambiguity fix over all Nf bands
            # (sagecal_master.cpp:826-838)
            jones = params_to_jones(p)  # (Nf, M, nchunk, N, 2, 2)
            aligned = manifold_average(jones.reshape(Nf, M, -1, 2, 2),
                                       niter=20)
            p = jones_to_params(aligned.reshape(jones.shape)).to(dtype)
        Yhat = rho[:, :, None, None] * p  # Y = 0, so Yhat = rho J

        # ---- round-0 consensus -----------------------------------------
        if zmode == "grouped":
            Z = consensus.update_global_z(numerator(_flat(Yhat)),
                                          den_inv(rho))
            Zsh = num_sh = None
        else:
            num_sh = kslices(numerator(_flat(Yhat)))
            Bii0 = den_inv(rho)
            Zsh = [consensus.update_global_z(n, Bii0) for n in num_sh]
            Z = torch.cat(Zsh, dim=2)
        BZ_all = torch.stack([bz_of(Z, b) for b in range(Nf)])
        Y = Yhat - rho[:, :, None, None] * BZ_all

        def band_residuals(p_cur, Z_new, Z_old, rho_cur):
            """Per-band primal ||J - BZ|| and dual rho ||B dZ||, each
            over sqrt(M K)."""
            BZn = torch.stack([bz_of(Z_new, b) for b in range(Nf)])
            BZo = torch.stack([bz_of(Z_old, b) for b in range(Nf)])
            pr = _flat(p_cur - BZn)
            rn = float(pr[0].numel()) ** 0.5
            prn = torch.sqrt((pr * pr).sum(dim=(1, 2))) / rn
            dd = _flat(rho_cur[:, :, None, None] * (BZn - BZo))
            ddn = torch.sqrt((dd * dd).sum(dim=(1, 2))) / rn
            return prn, ddn

        dres_t, pres_t, prn_t, ddn_t, rho_t = [], [], [], [], []
        if collect_trace:
            # round-0 rows: the plain solve against the first consensus
            prn0, _ = band_residuals(p, Z, Z, rho)
            prn_t.append(prn0)
            ddn_t.append(torch.zeros_like(prn0))
            rho_t.append(rho)
        Yhat_all, Yhat_prev, p_prev = Yhat, Yhat, p

        # ---- admm > 0: rotate over local slots -------------------------
        for it in range(1, nadmm):
            if have_sched:
                slot_row = slot_np[it - 1]
                group_row = group_np[it - 1]
                gs = [int(slot_row[d]) for d in range(ndev)]
                c0s = [int(group_row[d]) * Mg for d in range(ndev)]
            else:
                gs = [(it - 1) % G] * ndev  # active slot (Scurrent)
                c0s = [0] * ndev
            bands = [d * G + gs[d] for d in range(ndev)]
            w = None
            if use_staleness:
                ages = consensus.slot_staleness_ages(gs[0], G)
                w = consensus.staleness_weights(
                    ages, ccfg.staleness, ccfg.staleness_discount,
                    dtype=dtype).to(dev)

            def sl(x, d):
                """Shard d's active cluster-factor rows (identity for
                whole-band rounds)."""
                return x[c0s[d]:c0s[d] + Mg] if fine else x

            # x-steps of every shard, all on the previous round's state
            p1, Yhat_all1 = p.clone(), Yhat_all.clone()
            p1_act, Yhat_act = [], []
            for d in range(ndev):
                b = bands[d]
                if zmode == "reduced_scatter":
                    BZ_g = a2a_bz(Zsh, b, c0s[d])
                    if fine:
                        pad = torch.zeros((M,) + BZ_g.shape[1:], dtype=dtype,
                                          device=dev)
                        pad[c0s[d]:c0s[d] + Mg] = BZ_g
                        BZ_g = pad
                else:
                    BZ_g = bz_of(Z, b)
                p1_g = fit(b, p[b], Y[b], BZ_g, rho[b], max_emiter,
                           (c0s[d], Mg) if fine else None)
                ya = sl(Y[b], d) + sl(rho[b], d)[:, None, None] * sl(p1_g, d)
                Yhat_all1[b, c0s[d]:c0s[d] + ya.shape[0]] = ya
                p1[b] = p1_g
                p1_act.append(sl(p1_g, d))
                Yhat_act.append(ya)

            # z-step
            if zmode == "grouped":
                Z1 = consensus.update_global_z(
                    numerator(_flat(Yhat_all1), w), den_inv(rho, w))
                BZ1_act = [sl(bz_of(Z1, bands[d]), d) for d in range(ndev)]
                dres = consensus.admm_dual_residual(Z1, Z)
            else:
                if use_staleness:
                    num_sh1 = kslices(numerator(_flat(Yhat_all1), w))
                else:
                    # incremental transpose reduction: only the active
                    # factors' Yhat moved, so only their Gram delta is
                    # summed over shards (rows c0 alike on every shard)
                    deltas = []
                    for d in range(ndev):
                        b = bands[d]
                        old = Yhat_all[b, c0s[d]:c0s[d] + Yhat_act[d].shape[0]]
                        deltas.append(consensus.accumulate_z_term(
                            B[b], _flat(Yhat_act[d] - old)))
                    dsh = kslices(_shard_sum(deltas))
                    if fine:
                        num_sh1 = []
                        for e in range(ndev):
                            n = num_sh[e].clone()
                            n[c0s[0]:c0s[0] + Mg] = (
                                num_sh[e][c0s[0]:c0s[0] + Mg] + dsh[e])
                            num_sh1.append(n)
                    else:
                        num_sh1 = [num_sh[e] + dsh[e] for e in range(ndev)]
                Bii = Bii0 if den_static else den_inv(rho, w)
                Zsh1 = [consensus.update_global_z(n, Bii) for n in num_sh1]
                if zmode == "reduced_gather":
                    Z1 = torch.cat(Zsh1, dim=2)
                    BZ1_act = [sl(bz_of(Z1, bands[d]), d)
                               for d in range(ndev)]
                    dres = consensus.admm_dual_residual(Z1, Z)
                else:
                    BZ1_act = [a2a_bz(Zsh1, bands[d], c0s[d])
                               for d in range(ndev)]
                    ss = _shard_sum([((Zsh1[e] - Zsh[e]) ** 2).sum()
                                     for e in range(ndev)])
                    dres = torch.sqrt(ss) / float(M * Npoly * K) ** 0.5
                    Z1 = None
                Zsh, num_sh = Zsh1, num_sh1

            # dual update, primal residual, BB rho
            Y1, rho1 = Y.clone(), rho.clone()
            Yhat_prev1, p_prev1 = Yhat_prev.clone(), p_prev.clone()
            pres_parts = []
            for d in range(ndev):
                b, c0 = bands[d], c0s[d]
                rows = slice(c0, c0 + Yhat_act[d].shape[0])
                rho_g = sl(rho[b], d)
                Y1[b, rows] = Yhat_act[d] - rho_g[:, None, None] * BZ1_act[d]
                pr = _flat(p1_act[d] - BZ1_act[d])
                pres_parts.append(torch.linalg.norm(pr.reshape(-1))
                                  / float(pr.numel()) ** 0.5)
                if bb_rho:
                    dY = _flat(Yhat_act[d]) - _flat(Yhat_prev[b, rows])
                    dJ = _flat(p1_act[d]) - _flat(p_prev[b, rows])
                    rho_new = consensus.update_rho_bb(
                        rho_g, torch.full_like(rho_g, rho_upper), dY, dJ)
                    # every other visit of this slot (sagecal_slave.cpp:899)
                    visit = (it - 1) // (G * cg if fine else G)
                    rho1[b, rows] = rho_new if visit % 2 == 1 else rho_g
                Yhat_prev1[b, rows] = Yhat_act[d]
                p_prev1[b, rows] = p1_act[d]
            pres = _shard_sum(pres_parts) / ndev
            if collect_trace:
                prn, ddn = band_residuals(p1, Z1, Z, rho1)
                prn_t.append(prn)
                ddn_t.append(ddn)
                rho_t.append(rho1)
            dres_t.append(dres)
            pres_t.append(pres)
            p, Y, rho = p1, Y1, rho1
            Yhat_all, Yhat_prev, p_prev = Yhat_all1, Yhat_prev1, p_prev1
            if Z1 is not None:
                Z = Z1

        if zmode == "reduced_scatter":
            Z = torch.cat(Zsh, dim=2)  # one-time reassembly
        zero = torch.zeros((1,), dtype=dtype, device=dev)
        dres = torch.cat([zero] + [x.reshape(1) for x in dres_t])
        pres = torch.cat([zero] + [x.reshape(1) for x in pres_t])
        extra = {}
        if collect_trace:
            extra = dict(primal_res_band=torch.stack(prn_t),
                         dual_res_band=torch.stack(ddn_t),
                         rho_trace=torch.stack(rho_t))
        empty = torch.zeros((1, 1), dtype=torch.complex64, device=dev)
        return AdmmResult(p=p, Y=Y, Z=Z, rho=rho, dual_res=dres,
                          primal_res=pres, Zspat=empty,
                          spat_res=torch.zeros_like(dres), Zspat_diff=empty,
                          **extra)

    def fn(data_stack, cdata_stack, p0, rho, B):
        from sagecal_tpu_torch.obs.trace import get_tracer

        to = lambda x: torch.as_tensor(x).to(dev)  # noqa: E731
        args = (data_stack.to(dev), cdata_stack.to(dev), to(p0), to(rho),
                to(B).to(torch.as_tensor(p0).dtype))
        with full_f32(), get_tracer().span(
                "mesh.admm", kind="collective", nf=int(args[2].shape[0]),
                ndev=ndev, nadmm=nadmm):
            return run(*args)

    return fn


def stack_for_mesh(items):
    """Stack a list of per-band ``VisData`` / ``ClusterData`` (or
    tensors) on a new leading axis.  Static (non-tensor) fields must be
    identical across items."""
    if isinstance(items[0], torch.Tensor):
        return torch.stack(list(items))
    fields = dataclasses.fields(items[0])
    for it in items[1:]:
        for f in fields:
            a = getattr(items[0], f.name)
            if not isinstance(a, torch.Tensor) and getattr(it, f.name) != a:
                raise ValueError(f"bands differ in static field {f.name}")
    return dataclasses.replace(items[0], **{
        f.name: torch.stack([getattr(it, f.name) for it in items])
        for f in fields if isinstance(getattr(items[0], f.name),
                                      torch.Tensor)})
