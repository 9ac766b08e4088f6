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
        self.dest = dest
        self.n = n
        self.ndest = ndest

    def _sum(self, values: torch.Tensor) -> torch.Tensor:
        padded = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
        return padded[self.index].sum(dim=1)

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """(n, ...) values -> (ndest, ...) per-destination sums.
        Differentiable: the backward is the gather of the cotangent by
        destination (and its backward this sum again), so no derivative
        order adds values with atomics."""
        if values.shape[0] != self.n:
            raise ValueError(f"{values.shape[0]} values for a plan of "
                             f"{self.n} items")
        if values.requires_grad:
            return _SegmentSum.apply(values, self)
        return self._sum(values)


class _SegmentSum(torch.autograd.Function):
    """:meth:`SegmentPlan.sum` whose backward gathers the cotangent by
    destination (the padded-index backward would accumulate every pad
    slot into one row)."""

    @staticmethod
    def forward(ctx, values, plan):
        ctx.plan = plan
        return plan._sum(values)

    @staticmethod
    def backward(ctx, grad):
        return _DestGather.apply(grad, ctx.plan), None


class _DestGather(torch.autograd.Function):
    """``grad[plan.dest]``, the transpose of a segment sum; its backward
    is the segment sum."""

    @staticmethod
    def forward(ctx, grad, plan):
        ctx.plan = plan
        return grad.index_select(0, plan.dest)

    @staticmethod
    def backward(ctx, grad):
        return ctx.plan.sum(grad), None


class _GatherRows(torch.autograd.Function):
    """``tab.index_select(0, idx)`` whose backward sums the row
    cotangents per table row with a :class:`SegmentPlan` (``plan``, or
    one built from ``idx``)."""

    @staticmethod
    def forward(ctx, tab, idx, plan):
        ctx.save_for_backward(idx)
        ctx.ntab = tab.shape[0]
        ctx.plan = plan
        return tab.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (idx,) = ctx.saved_tensors
        plan = ctx.plan if ctx.plan is not None else SegmentPlan(idx,
                                                                 ctx.ntab)
        return plan.sum(grad), None, None


def gather_rows(tab: torch.Tensor, idx: torch.Tensor,
                plan: "SegmentPlan" = None) -> torch.Tensor:
    """Rows ``idx`` of ``tab`` (``tab.index_select(0, idx)``),
    differentiable with a fixed-order backward (module doc).  ``plan``:
    a :class:`SegmentPlan` of ``idx`` into ``tab.shape[0]`` rows, for a
    caller that gathers by the same index many times (built at each
    backward otherwise)."""
    return _GatherRows.apply(tab, idx, plan)
