"""Diffuse-sky re-predict under a spatial model (counterpart of
``sagecal_tpu/ops/diffuse.py``; ``recalculate_diffuse_coherencies``,
diffuse_predict.c:295-586).

A shapelet diffuse cluster's coherencies are predicted again with the
spatial model Z applied as per-station Jones-valued shapelet
corrections, S_p x S_k x S_q^H: S_p is station p's spatial model (its
rows of Z) and S_k the source's shapelet decomposition times its Stokes
coherency.  The three combine in shapelet space through the product
tensors (``ops/shapelets.py``), so the uv evaluation stays one mode sum
per row.

The per-station and per-pair products are two einsums over (N, N,
modes); each row takes its pair's modes by an index select on
``ant_p * N + ant_q`` (exact, no one-hot product); each channel's
contribution is added to its slice of the accumulator in channel order
(no atomics).  Everything stays on the tile's device, in the
coherencies' precision.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from sagecal_tpu_torch.core.types import VisData
from sagecal_tpu_torch.ops.rime import ST_SHAPELET, ShapeletTable, SourceBatch
from sagecal_tpu_torch.ops.shapelets import (
    shapelet_product_jones, shapelet_product_tensor, uv_mode_vectors,
)
from sagecal_tpu_torch.ops.special import sinc_abs
from sagecal_tpu_torch.solvers.sage import ClusterData


def spatial_station_modes(Zspat: torch.Tensor, N: int,
                          sh_n0: int) -> torch.Tensor:
    """Spatial model Z (2N, 2G) -> per-station Jones mode sets (N, G, 2,
    2): station s is rows 2s:2s+2, mode g columns 2g:2g+2 (the Zt
    transpose of diffuse_predict.c:375-386)."""
    G = sh_n0 * sh_n0
    return Zspat.reshape(N, 2, G, 2).permute(0, 2, 1, 3)


def recalculate_diffuse_coherencies(data: VisData, cdata: ClusterData,
                                    cid: int, src: SourceBatch,
                                    table: ShapeletTable,
                                    Zspat: torch.Tensor, sh_n0: int,
                                    sh_beta: float,
                                    fdelta: Optional[float] = None
                                    ) -> ClusterData:
    """``cdata`` with cluster ``cid``'s coherencies replaced by the
    spatial-model-corrected diffuse prediction.

    ``src``: the cluster's sources, every one ST_SHAPELET (the reference
    aborts otherwise, diffuse_predict.c:395-399); ``table``: their mode
    sets; ``Zspat``: (2N, 2G) complex, G = sh_n0^2."""
    if not bool((src.stype == ST_SHAPELET).all()):
        raise ValueError("diffuse cluster must contain only shapelet sources")
    N = data.nstations
    rows = data.ant_p.shape[0]
    F = data.nchan
    if fdelta is None:
        fdelta = data.deltaf
    cdt = cdata.coh.dtype
    dev = cdata.coh.device
    Zt = spatial_station_modes(Zspat.to(dev, cdt), N, sh_n0)  # (N, G, 2, 2)
    pair = data.ant_p * N + data.ant_q  # (rows,)
    n0 = table.n0max
    # the per-source scalars, read once: host floats of the sky model
    idx = src.shapelet_idx.tolist()
    betas = table.beta.tolist()
    stokes = torch.stack([src.sI0, src.sQ0, src.sU0, src.sV0]).tolist()
    freqs = data.freqs.tolist()

    acc = torch.zeros((F, 4, rows), dtype=cdt, device=dev)
    for s in range(src.nsources):
        beta = betas[idx[s]]
        beta_img = beta / (2.0 * math.pi)  # model FT scale -> image scale
        modes = table.modes[idx[s]].to(cdt)  # (n0^2,)
        I0, Q0, U0, V0 = (row[s] for row in stokes)
        C_st = torch.tensor([[I0 + Q0, U0 + 1j * V0],
                             [U0 - 1j * V0, I0 - Q0]], dtype=cdt, device=dev)
        s_coh = modes[:, None, None] * C_st[None]  # (n0^2, 2, 2)
        # C J_q^H per station (diffuse_predict.c:454)
        T1 = shapelet_product_tensor(n0, n0, sh_n0, beta_img, beta_img,
                                     sh_beta)
        C_Jq = shapelet_product_jones(
            T1, s_coh.expand((N,) + s_coh.shape), Zt, hermitian=True)
        # J_p (C J_q^H) per station pair (diffuse_predict.c:501)
        T2 = shapelet_product_tensor(n0, sh_n0, n0, beta_img, sh_beta,
                                     beta_img)
        Jp_C_Jq = shapelet_product_jones(
            T2, Zt[:, None].expand((N, N) + Zt.shape[1:]),
            C_Jq[None].expand((N, N) + C_Jq.shape[1:]))  # (N, N, n0^2, 2, 2)
        rowmodes = torch.index_select(
            Jp_C_Jq.reshape(N * N, n0 * n0, 2, 2), 0, pair)  # (rows, m, 2, 2)
        ll, mm, nn = src.ll[s], src.mm[s], src.nn[s]
        G = 2.0 * math.pi * (data.u * ll + data.v * mm + data.w * nn)
        smear = sinc_abs(G * (0.5 * fdelta))
        for f in range(F):
            freq = freqs[f]
            ang = freq * G
            fac = (torch.complex(torch.cos(ang), torch.sin(ang))
                   * smear).to(cdt)
            # uv in wavelengths, u negated (shapelet_contrib convention)
            Av = uv_mode_vectors(-data.u * freq, data.v * freq, beta,
                                 n0).to(cdt)  # (rows, n0^2)
            coh_rows = torch.einsum("rm,rmij->rij", Av, rowmodes)
            contrib = coh_rows * fac[:, None, None]  # (rows, 2, 2)
            acc[f] += contrib.reshape(rows, 4).transpose(0, 1)
    coh = cdata.coh.clone()
    coh[cid] = acc
    return cdata.replace(coh=coh)
