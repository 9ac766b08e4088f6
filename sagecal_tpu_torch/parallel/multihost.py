"""Multi-process runs over ``torch.distributed``: the port's
``--multihost``.

The JAX package runs one SPMD program over a device mesh that may span
hosts: ``jax.distributed.initialize()`` joins the processes, and the
mesh's ``psum`` and ``all_gather`` cross them
(``sagecal_tpu/parallel/mesh.py``, ``tests/test_multihost.py``).  The
port's mesh is ``nshards`` virtual shards visited in a fixed order
(``parallel/mesh.py``); under a :class:`ShardGroup` each process (rank)
takes a contiguous range of those shards and two collectives join the
ranks:

- :func:`gather_shards`: an ``all_gather`` of per-shard blocks, every
  rank's block in rank order, so every rank holds all shards' blocks;
- :func:`shard_sum`: the fixed-order shard sum, the ``psum``: the
  per-shard partials are gathered and added in global shard order.

Neither reorders a sum, so a run of W ranks gives the bits of the
one-process run with the same ``nshards``.

:func:`init_from_env` joins the process group from the usual
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``LOCAL_RANK``; what ``torchrun`` sets).  The backend is ``nccl`` for a
CUDA device and ``gloo`` for the CPU; ``SAGECAL_DIST_BACKEND`` names
another one.  Each rank uses ``cuda:LOCAL_RANK``.  NCCL cannot put two
ranks on one GPU, so two ranks on one card run ``gloo`` with CUDA
tensors (``SAGECAL_DIST_BACKEND=gloo``, both ``LOCAL_RANK=0``); gloo
takes CUDA tensors for ``all_gather`` and reads them through host
memory itself.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import torch

from sagecal_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """The ranks of one run (the default ``torch.distributed`` group):
    this process's ``rank`` of ``world``."""

    rank: int
    world: int

    def shard_range(self, nshards: int) -> range:
        """This rank's contiguous range of ``nshards`` virtual shards
        (``nshards`` a multiple of the world size)."""
        if nshards % self.world != 0:
            raise ValueError(
                f"{nshards} shards do not split evenly over {self.world} "
                "ranks; give a shard count that the world size divides")
        per = nshards // self.world
        return range(self.rank * per, (self.rank + 1) * per)


def _env_int(name: str, default: Optional[int] = None) -> int:
    val = os.environ.get(name)
    if val is None:
        if default is None:
            raise RuntimeError(
                f"--multihost needs {name} in the environment (RANK, "
                "WORLD_SIZE, MASTER_ADDR, MASTER_PORT; torchrun sets them)")
        return default
    return int(val)


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for a CUDA device given
    without an index (None means CUDA), else ``device`` as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _env_int("LOCAL_RANK", 0))
    return dev


def init_from_env(device=None) -> ShardGroup:
    """Join (or reuse) the default process group from the environment
    and return this rank's :class:`ShardGroup`.  ``device``: the rank's
    device (:func:`rank_device`), which picks the backend."""
    import torch.distributed as dist

    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = os.environ.get(
            "SAGECAL_DIST_BACKEND", "nccl" if dev.type == "cuda" else "gloo")
        rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
        _env_int("MASTER_PORT")
        os.environ.setdefault("MASTER_ADDR", "localhost")
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, **kw)
    return ShardGroup(rank=dist.get_rank(), world=dist.get_world_size())


def close(group: Optional[ShardGroup], ok: bool = True) -> None:
    """Leave the process group.  After a run that ended normally
    (``ok``), a barrier first, so no rank leaves while another still
    waits in a collective.  After a failure, no barrier: the other ranks
    may be waiting in a collective that this rank will never enter, and
    a barrier would not match it.  They see this rank's connections
    close, fail in turn and exit non-zero."""
    import torch.distributed as dist

    if group is not None and dist.is_initialized():
        if ok:
            dist.barrier()
        dist.destroy_process_group()


def gather_shards(local: torch.Tensor, group: Optional[ShardGroup]
                  ) -> torch.Tensor:
    """``all_gather`` of shard blocks: ``local`` (n_local, ...), this
    rank's shards' blocks in shard order -> (world * n_local, ...), every
    rank's in rank order.  No group: ``local`` itself."""
    if group is None:
        return local
    import torch.distributed as dist

    x = local.contiguous()
    cplx = x.is_complex()
    if cplx:
        x = torch.view_as_real(x)
    bufs = [torch.empty_like(x) for _ in range(group.world)]
    dist.all_gather(bufs, x)
    out = torch.cat(bufs)
    return torch.view_as_complex(out) if cplx else out


def gather_list(local: List[torch.Tensor], group: Optional[ShardGroup]
                ) -> List[torch.Tensor]:
    """:func:`gather_shards` of a list of equal-shape per-shard tensors:
    the list over every shard."""
    if group is None:
        return list(local)
    return list(gather_shards(torch.stack(local), group).unbind(0))


def shard_sum(local: List[torch.Tensor], group: Optional[ShardGroup]
              ) -> torch.Tensor:
    """The fixed-order shard sum (``psum``): this rank's per-shard
    partials (its shards in order) are gathered from every rank and
    added in global shard order, ``((s0 + s1) + s2) + ...``."""
    parts = gather_list(local, group)
    out = parts[0]
    for x in parts[1:]:
        out = out + x
    return out
