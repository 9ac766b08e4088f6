"""The backwards' station plan (``ops/rime_kernel.py::BwdPlan``) on the
CPU.

The plan orders each row tile's (role, row) items by (chunk, station)
for the gradient kernel of the backwards #4, #6 and #2.  Here it is held
against a numpy stable argsort, built twice, and used for a gradient:
per-item contributions (autograd through each row's gathered gains,
float64) summed segment by segment through the plan give the tables that
``fused_cost_packed_plain`` gives, and, on f32 inputs, those of the JAX
package's Pallas kernel in interpret mode.  The predict backward and the
batched objective (B lanes sharing one plan) are held to theirs in
``test_torch_bwd_plan_batch.py``, with the plan's refusal of indices it
was not built from.

Tolerances: the plan is exact (integer equality).  The f64 segment sums
agree with autograd's f64 gradient to 1e-12 of its norm (summation order
only); against the JAX kernel, which computes in f32, 1e-5 of the norm
(as ``test_torch_rime_kernel.py``).
"""

import numpy as np
import pytest
import torch

from torch_port_common import norm_rel

TILE = 256


def _indices(rng, N, rows):
    ant_p = rng.integers(0, N - 1, rows)
    return ant_p, ant_p + rng.integers(1, N - ant_p)


def _cmaps(rng, M, rows, nc):
    """Chunk maps that differ by cluster: contiguous time chunks of 1..nc
    pieces, and one random map."""
    maps = [(np.arange(rows) * max(1, k % nc + 1) // rows) for k in range(M)]
    maps[-1] = rng.integers(0, nc, rows)
    return np.stack(maps).astype(np.int32)


def _plan(ant_p, ant_q, cmap, nc, npad):
    from sagecal_tpu_torch.ops.rime_kernel import BwdPlan

    t = lambda x: torch.as_tensor(x, dtype=torch.int32)[None, :]
    return BwdPlan(t(ant_p), t(ant_q),
                   None if cmap is None else torch.as_tensor(cmap), nc, npad)


def _numpy_plan(ant_p, ant_q, cmap_row, nc, npad):
    """(pos, seg) of one chunk map by numpy's stable argsort."""
    rows = ant_p.size
    K, ntiles = nc * npad, -(-rows // TILE)
    c = np.zeros(rows, np.int64) if cmap_row is None else cmap_row
    pos, seg = [], []
    for b in range(ntiles):
        sl = slice(b * TILE, min(rows, (b + 1) * TILE))
        keys = np.full(2 * TILE, K, np.int64)
        n = sl.stop - sl.start
        keys[:n] = c[sl] * npad + ant_p[sl]
        keys[TILE:TILE + n] = c[sl] * npad + ant_q[sl]
        order = np.argsort(keys, kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(2 * TILE)
        pos.append(inv)
        seg.append(np.searchsorted(keys[order], np.arange(K + 1), "left"))
    return np.stack(pos), np.stack(seg)


CASES = [  # (N stations, npad, rows, nc, M)
    (7, 7, 1000, 1, 3),       # ragged last tile
    (62, 62, 1891 * 2, 1, 2),
    (150, 200, 700, 1, 2),    # npad 200 > 128, stations < npad
    (9, 9, 600, 3, 4),        # nc 3, maps differ by cluster
    (30, 200, 333, 3, 3),     # all at once
]
IDS = [f"N{c[0]}-npad{c[1]}-rows{c[2]}-nc{c[3]}" for c in CASES]


@pytest.mark.parametrize("N,npad,rows,nc,M", CASES, ids=IDS)
def test_plan_matches_numpy_stable_argsort(N, npad, rows, nc, M):
    rng = np.random.default_rng(rows + nc)
    ant_p, ant_q = _indices(rng, N, rows)
    cmap = _cmaps(rng, M, rows, nc) if nc > 1 else None
    plan = _plan(ant_p, ant_q, cmap, nc, npad)
    ntiles = -(-rows // TILE)
    assert plan.ntiles == ntiles and plan.rowsp == rows
    assert tuple(plan.pos.shape[1:]) == (ntiles, 2 * TILE)
    assert tuple(plan.seg.shape[1:]) == (ntiles, nc * npad + 1)
    assert plan.pos.dtype == plan.seg.dtype == torch.int32
    for m in range(M if nc > 1 else 1):
        pi = int(plan.of_cluster[m])
        pos, seg = _numpy_plan(ant_p, ant_q, None if cmap is None
                               else cmap[m].astype(np.int64), nc, npad)
        np.testing.assert_array_equal(plan.pos[pi].numpy(), pos)
        np.testing.assert_array_equal(plan.seg[pi].numpy(), seg)
    # every valid item is in exactly one segment: the last start counts them
    valid = np.minimum(TILE, rows - TILE * np.arange(ntiles)) * 2
    np.testing.assert_array_equal(plan.seg[:, :, -1].numpy(),
                                  np.broadcast_to(valid, plan.seg.shape[:2]))


def test_plan_dedups_chunk_maps_and_is_identical_on_repeat():
    rng = np.random.default_rng(4)
    ant_p, ant_q = _indices(rng, 12, 900)
    cmap = _cmaps(rng, 5, 900, 3)
    cmap[3] = cmap[1]
    a = _plan(ant_p, ant_q, cmap, 3, 12)
    b = _plan(ant_p, ant_q, cmap, 3, 12)
    assert a.pos.shape[0] == len({tuple(r) for r in cmap.tolist()}) == 4
    assert int(a.of_cluster[3]) == int(a.of_cluster[1])
    for x, y in ((a.pos, b.pos), (a.seg, b.seg), (a.of_cluster, b.of_cluster)):
        assert torch.equal(x, y)


def _colliding_rows():
    """Two different rows with the same weighted sum under the seeded
    weights, so the dedup must fall back to comparing whole rows."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randint(1, 1 << 20, (6,), generator=gen)
    x = torch.zeros((3, 6), dtype=torch.long)
    x[0, 0], x[1, 1] = w[1], w[0]
    x[2] = x[0]
    return x


@pytest.mark.parametrize("case", ["duplicates", "colliding_sums"])
def test_distinct_rows_groups_equal_rows_exactly(case):
    from sagecal_tpu_torch.ops.rime_kernel import _distinct_rows

    if case == "duplicates":
        x = torch.as_tensor(np.random.default_rng(6).integers(0, 3, (40, 7)))
        x[5] = x[9] = x[2]
        x[11] = x[0]
    else:
        x = _colliding_rows()
    rows, index = _distinct_rows(x)
    assert torch.equal(rows[index], x)
    assert rows.shape[0] == len({tuple(r) for r in x.tolist()})


def test_plan_refuses_bad_indices_and_other_shapes():
    from sagecal_tpu_torch.ops.rime_kernel import BwdPlan

    rng = np.random.default_rng(5)
    ant_p, ant_q = _indices(rng, 8, 300)
    t = lambda x: torch.as_tensor(x, dtype=torch.int32)[None, :]
    with pytest.raises(ValueError, match="station"):
        BwdPlan(t(ant_p), t(ant_q), None, 1, 6)  # stations up to 7
    bad = _cmaps(rng, 2, 300, 2)
    bad[0, 0] = 2
    with pytest.raises(ValueError, match="chunk"):
        BwdPlan(t(ant_p), t(ant_q), torch.as_tensor(bad), 2, 8)
    ap, aq = t(ant_p), t(ant_q)
    plan = BwdPlan(ap, aq, None, 1, 8)
    plan.check(ap, aq, None, 8, 1, 4)
    for args in ((ap[:, 1:], aq[:, 1:], 8, 1), (ap, aq, 9, 1),
                 (ap, aq, 8, 2)):
        with pytest.raises(ValueError):
            plan.check(args[0], args[1], None, *args[2:], 4)


def _problem(rng, M, N, npad, F, rows, nc, dtype):
    """Packed inputs (torch, ``dtype`` tables / data; f32-representable
    coherencies) with per-cluster chunk maps."""
    from sagecal_tpu_torch.ops.rime_kernel import pack_gain_tables

    shape = (M, nc, N, 2, 2) if nc > 1 else (M, N, 2, 2)
    jones = np.eye(2) + 0.3 * (rng.standard_normal(shape)
                               + 1j * rng.standard_normal(shape))
    tre, tim = pack_gain_tables(torch.as_tensor(jones), M, npad)
    ant_p, ant_q = _indices(rng, N, rows)
    f32 = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32))
    cmap = _cmaps(rng, M, rows, nc) if nc > 1 else None
    return dict(
        tab_re=tre.to(dtype), tab_im=tim.to(dtype), coh_ri=f32(M, F, 8, rows),
        ant_p=torch.as_tensor(ant_p, dtype=torch.int32)[None, :],
        ant_q=torch.as_tensor(ant_q, dtype=torch.int32)[None, :],
        vis_ri=f32(F, 8, rows).to(dtype),
        mask_p=torch.as_tensor((rng.random((F, rows)) > 0.1)
                               .astype(np.float32)).to(dtype),
        cmap=None if cmap is None else torch.as_tensor(cmap), nc=nc)


def plan_gradient(p, plan, nu=None, g=None):
    """d cost / d (tab_re, tab_im) — or, given an upstream model
    cotangent ``g`` (F, 8, rowsp), d sum(g * model) / d (tab_re, tab_im)
    as the predict backward #2 gives it — from per-item contributions
    (autograd through each row's gathered gains, float64) summed per
    segment of the plan, tile by tile, in sorted order."""
    from sagecal_tpu_torch.ops.rime_kernel import (
        _cost_of_model, _model_from_gains,
    )

    tab = torch.complex(p["tab_re"].double(), p["tab_im"].double())
    mp, rows = p["coh_ri"].shape[0], p["coh_ri"].shape[3]
    nc, npad = p["nc"], tab.shape[2]
    c = (torch.zeros((mp, rows), dtype=torch.long) if p["cmap"] is None
         else p["cmap"].long())
    mrow = torch.arange(mp)[:, None] * nc + c
    ap, aq = p["ant_p"].reshape(-1).long(), p["ant_q"].reshape(-1).long()
    leaves = [torch.stack([tab[k][mrow, ant] for k in range(4)])
              .clone().requires_grad_(True) for ant in (ap, aq)]
    gains = [tuple(x[k][:, None] for k in range(4)) for x in leaves]
    V = _model_from_gains(gains[0], gains[1], p["coh_ri"].double())
    if g is None:
        scalar = _cost_of_model(V, p["vis_ri"].double(),
                                p["mask_p"].double(), nu)
    else:
        scalar = (g.double() * torch.cat([V.real, V.imag], dim=1)).sum()
    dgp, dgq = torch.autograd.grad(scalar, leaves)
    # torch gives a real cost's gradient in a complex leaf as
    # d/d re + i d/d im: its real and imaginary parts are the items' 8 sums
    item = torch.cat([torch.cat([d.real, d.imag]) for d in (dgp, dgq)], 2)
    item = item.permute(1, 2, 0).numpy()  # (mp, 2 rows, 8): role-major
    pos, seg = plan.pos.numpy(), plan.seg.numpy()
    out = np.zeros((8, mp * nc, npad))
    for m in range(mp):
        pi = int(plan.of_cluster[m]) if nc > 1 else 0
        for b in range(plan.ntiles):
            lo, hi = b * TILE, min(rows, (b + 1) * TILE)
            sorted_items = np.empty((2 * TILE, 8))
            for role in range(2):
                ids = np.arange(hi - lo)
                sorted_items[pos[pi, b, role * TILE + ids]] = \
                    item[m, role * rows + lo + ids]
            for kk in np.flatnonzero(np.diff(seg[pi, b])):
                cc, st = divmod(kk, npad)
                out[:, m * nc + cc, st] += sorted_items[
                    seg[pi, b, kk]:seg[pi, b, kk + 1]].sum(0)
    return out[:4], out[4:]


GRAD_CASES = [  # (nu, nc, npad, rows)
    (None, 1, 7, 600),
    (5.0, 1, 7, 600),
    (5.0, 3, 7, 700),
    (None, 3, 200, 333),
]


@pytest.mark.parametrize("nu,nc,npad,rows", GRAD_CASES,
                         ids=[f"{'robust' if c[0] else 'gauss'}-nc{c[1]}-"
                              f"npad{c[2]}-rows{c[3]}" for c in GRAD_CASES])
def test_plan_segment_sums_give_the_plain_gradient_f64(nu, nc, npad, rows):
    from sagecal_tpu_torch.ops.rime_kernel import (
        BwdPlan, fused_cost_packed_plain,
    )

    rng = np.random.default_rng(rows + nc)
    p = _problem(rng, 3, 7, npad, 2, rows, nc, torch.float64)
    plan = BwdPlan(p["ant_p"], p["ant_q"], p["cmap"], nc, npad)
    a = p["tab_re"].clone().requires_grad_(True)
    b = p["tab_im"].clone().requires_grad_(True)
    cost = fused_cost_packed_plain(a, b, p["coh_ri"], p["ant_p"], p["ant_q"],
                                   p["vis_ri"], p["mask_p"], nu, p["cmap"], nc)
    want = [g.numpy() for g in torch.autograd.grad(cost, (a, b))]
    got = plan_gradient(p, plan, nu)
    assert norm_rel(np.stack(got), np.stack(want)) <= 1e-12


@pytest.mark.parametrize("nu,nc", [(None, 1), (5.0, 2)],
                         ids=["gauss-nc1", "robust-nc2"])
def test_plan_segment_sums_match_jax_kernel(nu, nc):
    """On the JAX package's padded layout (rows to 128, stations to
    NPAD), the plan's sums give the Pallas kernel's gradient."""
    from test_torch_rime_kernel import _jax_value_and_grad
    from test_torch_rime_kernel import _problem as jax_problem

    from sagecal_tpu_torch.ops.rime_kernel import BwdPlan, pack_gain_tables

    jp = jax_problem(seed=11, nc=nc)
    _, gja, gjb, _ = _jax_value_and_grad(jp, nu)
    tre, tim = pack_gain_tables(torch.from_numpy(jp["jones"]), jp["mp"],
                                jp["npad"])
    coh_ri, antp, antq, vis_ri, mask_p = map(torch.from_numpy, jp["padded"])
    cmap = torch.from_numpy(jp["cmap_p"]) if nc > 1 else None
    p = dict(tab_re=tre, tab_im=tim, coh_ri=coh_ri, ant_p=antp, ant_q=antq,
             vis_ri=vis_ri, mask_p=mask_p, cmap=cmap, nc=nc)
    plan = BwdPlan(antp, antq, cmap, nc, jp["npad"])
    got = plan_gradient(p, plan, nu)
    assert norm_rel(np.stack(got), np.stack([gja, gjb])) <= 1e-5
