"""Host-side source tree: a fixed-depth quadtree (2^d-ary over the
(l, m) tangent plane) built into FIXED-SHAPE index/offset arrays.

A copy of the JAX package's numpy module ``sagecal_tpu/sky/tree.py``
(the port imports nothing of that package); its index and offset arrays
equal the JAX package's element for element.

The hierarchical predict (:mod:`sagecal_tpu_torch.sky.predict`) needs
two things from the tree:

- a per-level node assignment for every source, so per-node aggregate
  moments are one sum per level (a fixed number of
  destinations = the level's node count);
- a routing of (node, baseline-tile) pairs into an admissible
  FAR-FIELD list (low-rank expansion) and a residual NEAR-FIELD source
  list per tile, padded to the maxima so every downstream gather and
  contraction has a static shape.

Everything in this module is plain numpy executed once per (uvw tile,
sky) on the host — the analog of the reference's cluster bookkeeping
that precedes ``precalculate_coherencies``.  The torch consumers move
the returned arrays to the device once per plan.

Geometry conventions match :mod:`sagecal_tpu_torch.ops.rime`: positions are
direction cosines (l, m) with ``nn = n - 1``; node radii are measured
in the full (l, m, n) 3-space so the Cauchy–Schwarz admissibility
bound ``|u·Δl + v·Δm + w·Δn| <= |b| * r`` holds exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SourceTree:
    """Fixed-depth quadtree over source positions (all host numpy).

    Nodes of every level live in ONE flat index space: level ``lev``
    occupies ``[level_offset[lev], level_offset[lev] + 4**lev)``.
    """

    depth: int                      # leaves are level `depth`
    level_offset: np.ndarray        # (depth+2,) flat offsets; [-1] = nnodes
    node_center: np.ndarray         # (nnodes, 3) member centroid (l, m, n-1)
    node_radius: np.ndarray         # (nnodes,) max member distance to center
    node_count: np.ndarray          # (nnodes,) member sources
    node_of_source: np.ndarray      # (depth+1, S) flat node id per level
    # leaf -> member sources: perm[leaf_start[i] : leaf_start[i]+leaf_count[i]]
    perm: np.ndarray                # (S,) source ids sorted by leaf
    leaf_start: np.ndarray          # (4**depth,)
    leaf_count: np.ndarray          # (4**depth,)

    @property
    def nnodes(self) -> int:
        return int(self.level_offset[-1])

    @property
    def nsources(self) -> int:
        return int(self.perm.shape[0])


def choose_depth(nsources: int, leaf_size: int, max_depth: int = 6) -> int:
    """Smallest depth whose 4^d leaves hold ~``leaf_size`` sources on
    average (the error knob does not depend on this — only the
    far/near work split does)."""
    d = 0
    while 4 ** d * max(int(leaf_size), 1) < nsources and d < max_depth:
        d += 1
    return d


def build_source_tree(
    ll, mm, nn, leaf_size: int = 32, depth: Optional[int] = None,
) -> SourceTree:
    """Build the fixed-depth tree over concrete source positions.

    ``ll``/``mm``/``nn`` are the (S,) position arrays of a
    :class:`~sagecal_tpu_torch.ops.rime.SourceBatch` (``nn`` = n - 1),
    materialized host-side.  ``depth`` overrides the leaf-size-derived
    choice (``depth=0`` degenerates to one root node = one dense
    far-field expansion for the whole sky).
    """
    ll = np.asarray(ll, np.float64)
    mm = np.asarray(mm, np.float64)
    nn = np.asarray(nn, np.float64)
    S = ll.shape[0]
    if S == 0:
        raise ValueError("build_source_tree: empty source batch")
    if depth is None:
        depth = choose_depth(S, leaf_size)
    depth = int(depth)

    # bounding square over (l, m); epsilon keeps the max coordinate
    # strictly inside the last cell
    lmin, mmin = float(ll.min()), float(mm.min())
    extent = max(float(ll.max()) - lmin, float(mm.max()) - mmin, 1e-12)
    extent *= 1.0 + 1e-9

    nlev = depth + 1
    level_sizes = [4 ** lev for lev in range(nlev)]
    level_offset = np.concatenate(
        [[0], np.cumsum(level_sizes)]).astype(np.int64)
    nnodes = int(level_offset[-1])

    node_of_source = np.zeros((nlev, S), np.int64)
    for lev in range(nlev):
        ncell = 2 ** lev
        ix = np.floor((ll - lmin) / extent * ncell).astype(np.int64)
        iy = np.floor((mm - mmin) / extent * ncell).astype(np.int64)
        ix = np.clip(ix, 0, ncell - 1)
        iy = np.clip(iy, 0, ncell - 1)
        node_of_source[lev] = level_offset[lev] + iy * ncell + ix

    # member centroids / radii / counts over the flat node space
    pos = np.stack([ll, mm, nn], axis=1)  # (S, 3)
    node_count = np.zeros(nnodes, np.int64)
    node_center = np.zeros((nnodes, 3), np.float64)
    for lev in range(nlev):
        idx = node_of_source[lev]
        node_count += np.bincount(idx, minlength=nnodes)
        for k in range(3):
            node_center[:, k] += np.bincount(
                idx, weights=pos[:, k], minlength=nnodes)
    cnt = np.maximum(node_count, 1)
    node_center /= cnt[:, None]

    node_radius = np.zeros(nnodes, np.float64)
    for lev in range(nlev):
        idx = node_of_source[lev]
        d2 = np.sum((pos - node_center[idx]) ** 2, axis=1)
        np.maximum.at(node_radius, idx, np.sqrt(d2))

    # leaf membership lists (offset/count into one permutation)
    leaf_local = node_of_source[depth] - level_offset[depth]
    perm = np.argsort(leaf_local, kind="stable").astype(np.int64)
    leaf_count = np.bincount(leaf_local, minlength=4 ** depth).astype(
        np.int64)
    leaf_start = np.concatenate([[0], np.cumsum(leaf_count)[:-1]]).astype(
        np.int64)

    return SourceTree(
        depth=depth, level_offset=level_offset, node_center=node_center,
        node_radius=node_radius, node_count=node_count,
        node_of_source=node_of_source, perm=perm,
        leaf_start=leaf_start, leaf_count=leaf_count,
    )


@dataclasses.dataclass(frozen=True)
class HierRouting:
    """Fixed-shape far/near routing of one uvw tile set against one
    tree (all host numpy; padded to the per-tile maxima)."""

    ntiles: int
    tile_rows: int                  # rows per tile (uvw padded to fill)
    rows: int                       # true (unpadded) row count
    far_idx: np.ndarray             # (T, Fmax) flat node ids (0-padded)
    far_valid: np.ndarray           # (T, Fmax) float64 0/1
    near_src: np.ndarray            # (T, Nmax) source ids (0-padded)
    near_valid: np.ndarray          # (T, Nmax) float64 0/1
    # bookkeeping for the a-priori bound / stats
    theta: float = 0.0
    far_pairs: int = 0
    near_sources_total: int = 0

    @property
    def max_far(self) -> int:
        return int(self.far_idx.shape[1])

    @property
    def max_near(self) -> int:
        return int(self.near_src.shape[1])


def _pad_up(n: int, mult: int) -> int:
    return max(mult, -(-n // mult) * mult)


def route_tiles(
    tree: SourceTree,
    u, v, w,
    fmax: float,
    theta: float,
    tile_rows: int = 128,
    pad_far: int = 8,
    pad_near: int = 64,
) -> HierRouting:
    """Admissibility-route every (leaf node, baseline tile) pair.

    A leaf is ADMISSIBLE for a tile when the worst-case phase-argument
    excursion across it satisfies the well-separation criterion

        ``x_max = 2*pi * fmax * max|b|_tile * r_leaf <= theta``

    (``u``/``v``/``w`` in seconds, ``fmax`` in Hz, so ``fmax*|b|`` is
    the baseline length in wavelengths; ``r_leaf`` is the leaf's OWN
    member radius, so the Taylor remainder bound is tight per expanded
    node).  Admissible occupied leaves join the tile's FAR list; the
    rest spill their member sources into the tile's NEAR list.
    Expanding at one fixed level keeps the aggregate moments to a
    single segment-sum pass over the sources — the multi-level variant
    pays one full (S, F, 4, Q) materialization per level for a small
    far-list saving.  ``theta <= 0`` forces everything near-field (the
    exact-fallback mode the parity tests pin).

    Lists are padded to shared maxima (rounded up to ``pad_far`` /
    ``pad_near`` so repeated tiles share few shapes).
    """
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    w = np.asarray(w, np.float64)
    rows = int(u.shape[0])
    tile_rows = int(min(tile_rows, max(rows, 1)))
    ntiles = -(-rows // tile_rows)

    blen = np.sqrt(u * u + v * v + w * w)
    bmax = np.zeros(ntiles, np.float64)
    for t in range(ntiles):
        seg = blen[t * tile_rows:(t + 1) * tile_rows]
        bmax[t] = float(seg.max()) if seg.size else 0.0

    depth = tree.depth
    off = int(tree.level_offset[depth])
    occ = np.nonzero(tree.leaf_count > 0)[0]          # occupied leaf locals
    r_occ = tree.node_radius[off + occ]
    scale = 2.0 * math.pi * float(fmax) * bmax        # (T,)
    # (T, nocc) admissibility in one outer comparison
    adm = (scale[:, None] * r_occ[None, :] <= theta) if theta > 0 else (
        np.zeros((ntiles, occ.size), bool))

    far_lists = []
    near_lists = []
    far_pairs = 0
    for t in range(ntiles):
        far_t = list(off + occ[adm[t]])
        near_t: list = []
        for local in occ[~adm[t]]:
            s0 = int(tree.leaf_start[local])
            near_t.extend(tree.perm[s0:s0 + int(tree.leaf_count[local])])
        far_pairs += len(far_t)
        far_lists.append(far_t)
        near_lists.append(near_t)

    fmax_n = _pad_up(max((len(x) for x in far_lists), default=0), pad_far)
    nmax_n = _pad_up(max((len(x) for x in near_lists), default=0), pad_near)
    far_idx = np.zeros((ntiles, fmax_n), np.int64)
    far_valid = np.zeros((ntiles, fmax_n), np.float64)
    near_src = np.zeros((ntiles, nmax_n), np.int64)
    near_valid = np.zeros((ntiles, nmax_n), np.float64)
    for t in range(ntiles):
        nf, nn_ = len(far_lists[t]), len(near_lists[t])
        if nf:
            far_idx[t, :nf] = far_lists[t]
            far_valid[t, :nf] = 1.0
        if nn_:
            near_src[t, :nn_] = near_lists[t]
            near_valid[t, :nn_] = 1.0

    return HierRouting(
        ntiles=ntiles, tile_rows=tile_rows, rows=rows,
        far_idx=far_idx, far_valid=far_valid,
        near_src=near_src, near_valid=near_valid,
        theta=float(theta), far_pairs=far_pairs,
        near_sources_total=int(near_valid.sum()),
    )


def partition_by_tree(tree: SourceTree, nclusters: int) -> list:
    """Group sources into at most ``nclusters`` spatially compact
    EFFECTIVE clusters using the shallowest tree level with enough
    occupied nodes — the host-side "hierarchical collapse" the
    widefield workload feeds to the packed solver.  Returns a list of
    (S_k,) source-index arrays (every source in exactly one group,
    groups ordered by descending membership)."""
    if nclusters < 1:
        raise ValueError("nclusters must be >= 1")
    lev = 0
    for cand in range(tree.depth + 1):
        lo, hi = int(tree.level_offset[cand]), int(tree.level_offset[cand + 1])
        if int(np.count_nonzero(tree.node_count[lo:hi])) >= nclusters:
            lev = cand
            break
        lev = cand
    idx = tree.node_of_source[lev]
    order = np.argsort(idx, kind="stable")
    groups = [
        order[s] for s in _split_runs(idx[order])
    ]
    groups.sort(key=len, reverse=True)
    while len(groups) > nclusters:
        # merge the smallest group into the smallest survivor
        small = groups.pop()
        tgt = min(range(nclusters), key=lambda i: len(groups[i]))
        groups[tgt] = np.concatenate([groups[tgt], small])
    return [np.sort(g) for g in groups]


def _split_runs(sorted_vals: np.ndarray) -> list:
    """Slices of equal-value runs in an already-sorted array."""
    if sorted_vals.size == 0:
        return []
    bounds = np.nonzero(np.diff(sorted_vals))[0] + 1
    edges = np.concatenate([[0], bounds, [sorted_vals.size]])
    return [slice(int(edges[i]), int(edges[i + 1]))
            for i in range(len(edges) - 1)]
