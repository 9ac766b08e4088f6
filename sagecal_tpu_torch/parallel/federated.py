"""Federated averaging over sub-bands: local consensus tied to a global
quotient-manifold average (counterpart of
``sagecal_tpu/parallel/federated.py``; the stochastic MPI pair
``sagecal_stochastic_master.cpp`` / ``sagecal_stochastic_slave.cpp``).

The master never solves for Z: each band keeps a local Z_f, and a round
(1) averages the bands' Z on the unitary quotient manifold and projects
the mean back into each band's frame
(``calculate_manifold_average_projectback``, stochastic_master.cpp:347),
and (2) ties each local Z to that average with an alpha-weighted term
and a Lagrange multiplier X (the federated pseudo-inverse with
+alpha I, ``find_prod_inverse_full_fed``, consensus_poly.c:547).

The JAX package runs one band a device of a ``('freq',)`` mesh; here the
mesh is ``nshards`` virtual shards, one a band, on one device, visited in
band order.  Its ``all_gather`` is a stack in band order and its
``pmean`` a sum in band order over the band count.  The x-steps are the
torch-op solvers (``parallel/admm.py::admm_sagefit`` and the minibatch
LBFGS of ``solvers/batchmode.py``) and launch no CUDA kernel.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from sagecal_tpu_torch.core.types import (
    complex_dtype_of, identity_jones, jones_to_params, params_to_jones,
)
from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.parallel import consensus
from sagecal_tpu_torch.parallel.admm import admm_sagefit
from sagecal_tpu_torch.parallel.manifold import manifold_average_projectback
from sagecal_tpu_torch.parallel.mesh import _flat, _shard_sum, _unflat
from sagecal_tpu_torch.solvers.batchmode import (
    _data_cost, bfgsfit_minibatch_consensus,
)
from sagecal_tpu_torch.solvers.lbfgs import LBFGSMemory
from sagecal_tpu_torch.solvers.lm import LMConfig
from sagecal_tpu_torch.solvers.sage import lane_of
from sagecal_tpu_torch.utils.precision import full_f32


class FederatedResult(NamedTuple):
    p: torch.Tensor  # (Nf, M, nchunk_max, 8N)
    Z: torch.Tensor  # (Nf, M, Npoly, K) per-band local consensus
    dual_res: torch.Tensor  # (nadmm,)


def _fed_zavg(Z_all: torch.Tensor, niter: int = 10) -> torch.Tensor:
    """Every band's local Z (Nf, M, Npoly, K) replaced by the quotient-
    manifold mean projected into its own frame.

    As in the reference, N*Npoly is passed as the station count
    (stochastic_master.cpp:347): each cluster's whole (2*N*Npoly x 2)
    coefficient stack is aligned by one unitary per (cluster, band),
    never one per polynomial coefficient."""
    Nf, M, Npoly, K = Z_all.shape
    jones = params_to_jones(Z_all.reshape(Nf, M, Npoly * K))
    avg = manifold_average_projectback(jones, niter=niter)
    return jones_to_params(avg).reshape(Nf, M, Npoly, K).to(Z_all.dtype)


def _bii_fed(rho_b, B_b, alpha_v):
    """pinv(rho_f B_f B_f^T + alpha I): (M, Npoly, Npoly)."""
    P = torch.einsum("m,p,q->mpq", rho_b, B_b, B_b)
    eye = torch.eye(B_b.shape[0], dtype=P.dtype, device=P.device)
    return consensus.pinv(P + alpha_v[:, None, None] * eye[None])


def _zstep_fed(B_b, Yhat_flat, Zbar, X, alpha_v, Bii):
    """z_f = Bii (B_f (x) Yhat + alpha Zbar - X)."""
    z = consensus.accumulate_z_term(B_b, Yhat_flat)
    return consensus.update_global_z(z + alpha_v[:, None, None] * Zbar - X,
                                     Bii)


def _check_bands(nf: int, ndev: int):
    if nf != ndev:
        raise ValueError(f"sub-band axis {nf} != shard count {ndev}")


def make_federated_mesh_fn(nshards: int, nadmm: int, max_emiter: int = 1,
                           plain_emiter: int = 2,
                           lm_config: LMConfig = LMConfig(),
                           alpha: float = 1.0, avg_cadence: int = 1,
                           device=None):
    """Federated calibration over ``nshards`` bands (one a shard) on
    ``device`` (CUDA unless ``device="cpu"``).

    ``fn(data_stack, cdata_stack, p0 (Nf, M, nchunk, 8N), rho (Nf, M),
    B (Nf, Npoly)) -> FederatedResult``.  A round per band, as the
    stochastic slave: the x-step with (Y, B_f Z_f), the local z-step
    z_f = pinv(rho_f B_f B_f^T + alpha I)(B_f (x) (Y + rho J) + alpha
    Zbar - X), the Y update, and every ``avg_cadence`` rounds the
    federated average and the X update."""
    dev = resolve_device(device)
    ndev = int(nshards)

    def run(data_stack, cdata_stack, p0, rho, B):
        Nf, M, nchunk_max, n8 = p0.shape
        _check_bands(Nf, ndev)
        K = nchunk_max * n8
        Npoly = B.shape[-1]
        dtype = p0.dtype
        alpha_v = torch.full((M,), alpha, dtype=dtype, device=dev)
        datas = [lane_of(data_stack, b) for b in range(Nf)]
        cdatas = [lane_of(cdata_stack, b) for b in range(Nf)]
        plans = [{} for _ in range(Nf)]
        nchunks = cdata_stack.nchunk.tolist()
        Bii = [_bii_fed(rho[b], B[b], alpha_v) for b in range(Nf)]

        def fit(b, p_b, Y_b, BZ_b, rho_b, emiter):
            return admm_sagefit(datas[b], cdatas[b], p_b, Y_b, BZ_b, rho_b,
                                max_emiter=emiter, lm_config=lm_config,
                                plans=plans[b], nchunks=nchunks[b]).p

        def zstep(Yhat, Zbar, X):
            return torch.stack([_zstep_fed(B[b], _flat(Yhat[b]), Zbar[b], X[b],
                                           alpha_v, Bii[b])
                                for b in range(Nf)])

        def bz(Z_):
            return torch.stack([_unflat(consensus.bz_for_freq(Z_[b], B[b]),
                                        nchunk_max, n8) for b in range(Nf)])

        # round 0: plain solve, the first local Z and average
        zeros = torch.zeros_like(p0[0])
        p = torch.stack([fit(b, p0[b], zeros, zeros, torch.zeros_like(rho[b]),
                             plain_emiter) for b in range(Nf)])
        Yhat = rho[:, :, None, None] * p
        X = torch.zeros((Nf, M, Npoly, K), dtype=dtype, device=dev)
        Z = zstep(Yhat, torch.zeros_like(X), X)
        Zbar = _fed_zavg(Z)
        X = X + alpha_v[None, :, None, None] * (Z - Zbar)
        Y = Yhat - rho[:, :, None, None] * bz(Z)
        dres_t = []
        for it in range(1, nadmm):
            BZ = bz(Z)
            p = torch.stack([fit(b, p[b], Y[b], BZ[b], rho[b], max_emiter)
                             for b in range(Nf)])
            Yhat = Y + rho[:, :, None, None] * p
            Z1 = zstep(Yhat, Zbar, X)
            if it % avg_cadence == 0:
                Zbar = _fed_zavg(Z1)
                X = X + alpha_v[None, :, None, None] * (Z1 - Zbar)
            Y = Yhat - rho[:, :, None, None] * bz(Z1)
            # pmean of each band's local-Z change
            dres_t.append(_shard_sum([consensus.admm_dual_residual(Z1[b], Z[b])
                                      for b in range(Nf)]) / ndev)
            Z = Z1
        zero = torch.zeros((1,), dtype=dtype, device=dev)
        dres = torch.cat([zero] + [x.reshape(1) for x in dres_t])
        return FederatedResult(p=p, Z=Z, dual_res=dres)

    def fn(data_stack, cdata_stack, p0, rho, B):
        from sagecal_tpu_torch.obs.trace import get_tracer

        to = lambda x: torch.as_tensor(x).to(dev)  # noqa: E731
        p0 = to(p0)
        args = (data_stack.to(dev), cdata_stack.to(dev), p0, to(rho),
                to(B).to(p0.dtype))
        with full_f32(), get_tracer().span(
                "mesh.federated", kind="collective", nf=int(p0.shape[0]),
                ndev=ndev, nadmm=nadmm):
            return run(*args)

    return fn


class FederatedState(NamedTuple):
    """Carried state of the stochastic federated mode, band-major: the
    stochastic slave's Z/Zavg/X/Y/pfreq and persistent LBFGS memory
    (sagecal_stochastic_slave.cpp:441-470, 637-638)."""

    p: torch.Tensor  # (Nf, M, nchunk_max, 8N) per-band solutions
    Y: torch.Tensor  # (Nf, M, nchunk_max, 8N) consensus duals
    Z: torch.Tensor  # (Nf, M, Npoly, K) per-band local consensus
    Zbar: torch.Tensor  # (Nf, M, Npoly, K) federated average (per frame)
    X: torch.Tensor  # (Nf, M, Npoly, K) federation duals
    mem: List[LBFGSMemory]  # one a band


def init_federated_state(Nf, M, nchunk_max, n8, npoly, lbfgs_m, dtype,
                         device=None) -> FederatedState:
    """Identity solutions, zero duals and consensus, empty LBFGS memory,
    on ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    K = nchunk_max * n8
    zeros_p = torch.zeros((Nf, M, nchunk_max, n8), dtype=dtype, device=dev)
    zeros_z = torch.zeros((Nf, M, npoly, K), dtype=dtype, device=dev)
    eye = jones_to_params(identity_jones(n8 // 8, complex_dtype_of(dtype),
                                         device=dev))
    p0 = eye.expand(Nf, M, nchunk_max, n8).clone()
    mem = [LBFGSMemory.init(M * K, lbfgs_m, dtype, dev) for _ in range(Nf)]
    return FederatedState(p=p0, Y=zeros_p, Z=zeros_z, Zbar=zeros_z.clone(),
                          X=zeros_z.clone(), mem=mem)


def make_federated_minibatch_fn(nshards: int, itmax: int = 10,
                                lbfgs_m: int = 7, alpha: float = 1.0,
                                robust_nu=None, device=None):
    """One federated-stochastic minibatch round: per band the consensus
    minibatch LBFGS with persistent memory (bfgsfit_minibatch_consensus,
    robust_batchmode_lbfgs.c:1504), the Y ascent and the local federated
    z-step (stochastic_slave.cpp:756-850).  The average itself is
    :func:`make_fed_avg_fn`, called at the reference's cadence.

    ``fn(data_stack, cdata_stack, state, rho (Nf, M), B (Nf, Npoly))
    -> (state, dual_res, data_cost (Nf,))``."""
    dev = resolve_device(device)
    ndev = int(nshards)

    def run(data_stack, cdata_stack, st, rho, B):
        Nf, M, nchunk_max, n8 = st.p.shape
        _check_bands(Nf, ndev)
        dtype = st.p.dtype
        alpha_v = torch.full((M,), alpha, dtype=dtype, device=dev)
        shape = (M, nchunk_max, n8)
        ps, Ys, Zs, mems, dres, costs = [], [], [], [], [], []
        for b in range(Nf):
            data, cdata = lane_of(data_stack, b), lane_of(cdata_stack, b)
            BZ = _unflat(consensus.bz_for_freq(st.Z[b], B[b]), nchunk_max, n8)
            p1, mem1 = bfgsfit_minibatch_consensus(
                data, cdata, st.p[b], st.Y[b], BZ, rho[b], memory=st.mem[b],
                itmax=itmax, lbfgs_m=lbfgs_m, robust_nu=robust_nu)
            Yhat = st.Y[b] + rho[b][:, None, None] * p1
            Z1 = _zstep_fed(B[b], _flat(Yhat), st.Zbar[b], st.X[b], alpha_v,
                            _bii_fed(rho[b], B[b], alpha_v))
            BZ1 = _unflat(consensus.bz_for_freq(Z1, B[b]), nchunk_max, n8)
            ps.append(p1)
            Ys.append(Yhat - rho[b][:, None, None] * BZ1)
            Zs.append(Z1)
            mems.append(mem1)
            dres.append(consensus.admm_dual_residual(Z1, st.Z[b]))
            with torch.no_grad():
                costs.append(_data_cost(p1.reshape(-1), data, cdata, shape,
                                        robust_nu))
        st1 = st._replace(p=torch.stack(ps), Y=torch.stack(Ys),
                          Z=torch.stack(Zs), mem=mems)
        return st1, _shard_sum(dres) / ndev, torch.stack(costs)

    def fn(data_stack, cdata_stack, state, rho, B):
        to = lambda x: torch.as_tensor(x).to(dev)  # noqa: E731
        with full_f32():
            return run(data_stack.to(dev), cdata_stack.to(dev), state,
                       to(rho), to(B).to(state.p.dtype))

    return fn


def make_fed_avg_fn(nshards: int, alpha: float = 1.0, niter: int = 10,
                    device=None):
    """The federated averaging round: Zbar <- the manifold average of
    every band's Z projected back per frame, X <- X + alpha (Z - Zbar)
    (stochastic_master.cpp:347, slave:856-868).  ``fn(state) -> state``."""
    resolve_device(device)
    ndev = int(nshards)

    def fn(state: FederatedState) -> FederatedState:
        _check_bands(state.Z.shape[0], ndev)
        with full_f32():
            Zbar = _fed_zavg(state.Z, niter=niter)
            return state._replace(Zbar=Zbar,
                                  X=state.X + alpha * (state.Z - Zbar))

    return fn
