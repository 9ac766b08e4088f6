"""Fixed-order sums by destination: the port's scatter-add.

``index_add_`` (and the backward of ``index_select``) adds with
floating-point atomics on CUDA, in an order that changes from run to
run, so the last bits of a sum do too, and the LM iterations of the EM
amplify them.  A :class:`SegmentPlan` replaces it on the solve path:
built once from a destination index (a stable sort of the items by
destination, laid out as a padded ``(destinations, width)`` block of
item numbers, ``width`` the largest count), it sums any values given
per item by gathering them into that block and reducing along it.  The
order is fixed (item order within each destination), so a sum is
bit-identical on repeat, on the CPU and on CUDA; no float atomics.

Memory: ``destinations * width`` values per sum.  At the north-star
tile the LM's station blocks hold 3,660 rows each (62 x 3,660 8x8 f32
blocks, 58 MB); callers give each class of destination its own plan
so that a few crowded destinations do not pad every other.
"""

from __future__ import annotations

import torch


class SegmentPlan:
    """Sums of per-item values by destination, in a fixed order.

    ``dest``: (n,) integer destination of each item, each in
    ``[0, ndest)``.  :meth:`sum` maps (n, ...) values to the (ndest, ...)
    sums; a destination with no item gets zero."""

    def __init__(self, dest: torch.Tensor, ndest: int):
        dest = dest.reshape(-1).long()
        n = dest.numel()
        counts = torch.bincount(dest, minlength=ndest)
        width = max(int(counts.max()), 1) if ndest else 1
        order = torch.argsort(dest, stable=True)
        sdest = dest[order]
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(n, device=dest.device) - starts[sdest]
        # item n is the zero row appended by sum(): the padding
        index = torch.full((ndest, width), n, dtype=torch.int64,
                           device=dest.device)
        index[sdest, rank] = order  # (destination, rank) pairs are unique
        self.index = index
        self.n = n
        self.ndest = ndest

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """(n, ...) values -> (ndest, ...) per-destination sums."""
        if values.shape[0] != self.n:
            raise ValueError(f"{values.shape[0]} values for a plan of "
                             f"{self.n} items")
        padded = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
        return padded[self.index].sum(dim=1)


class _GatherRows(torch.autograd.Function):
    """``tab.index_select(0, idx)`` whose backward sums the row
    cotangents per table row with a :class:`SegmentPlan`."""

    @staticmethod
    def forward(ctx, tab, idx):
        ctx.save_for_backward(idx)
        ctx.ntab = tab.shape[0]
        return tab.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        return SegmentPlan(idx, ctx.ntab).sum(grad), None


def gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``tab`` (``tab.index_select(0, idx)``),
    differentiable with a fixed-order backward (module doc)."""
    return _GatherRows.apply(tab, idx)
