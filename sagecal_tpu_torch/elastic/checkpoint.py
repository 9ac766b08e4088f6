"""Versioned, atomically-written solver checkpoints (counterpart of
``sagecal_tpu/elastic/checkpoint.py``; a copy of its stdlib and numpy
code, which cannot be imported without JAX).

Format contract (schema v1), shared with the reference: one ``.npz`` per
checkpoint holding

- ``__meta__``: a UTF-8 JSON document (uint8 array) with
  ``schema_version``, ``app``, ``fingerprint``, ``tile_index``,
  ``intervals_written``, ``ts`` and app-specific scalars (epoch and
  minibatch counters, ...);
- every other entry: one named solver-state array (gain bundles ``p``,
  ADMM ``Z``/``Y`` duals, ``rho``, trajectories).

Random draws: where the reference stores its ``jax.random`` key chain
(``rng_key``), the port stores what its own draws depend on.  The apps
derive a fresh ``torch.Generator`` from ``(seed, tile_no)`` for every
tile (``solvers/batched.py::derive_lane_generators``), so a resumed tile
draws what the uninterrupted run drew without any stored state; the
checkpoint records the seed as ``rng_seed``.  A port checkpoint therefore
cannot resume a JAX run, nor a JAX checkpoint a port run, though both
read each other's files.

Bounded-staleness ledger contract: an async consensus run additionally
stores ``ledger.ages``, ``ledger.zterms`` and ``ledger.round``; with Z/Y
they are the whole async trajectory state, so ``--resume`` stays
bit-exact in async mode too.  Checkpoints of sync runs omit the keys.

Writes are crash-consistent: the payload goes to a temp file in the
checkpoint directory, is ``fsync``\\ ed, then ``os.replace``\\ d into
place, and the directory entry is fsynced too.  A reader never sees a
torn checkpoint; a kill between two checkpoints resumes from the older.

Resume safety: every checkpoint embeds a :func:`config_fingerprint` of
the run's identity; :meth:`CheckpointManager.resume` refuses a
checkpoint of another configuration.

Stdlib and numpy at import time (the crash-path flusher must never be
what initializes CUDA); :func:`flatten_state` moves torch tensors to the
host.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

CHECKPOINT_SCHEMA_VERSION = 1

_CKPT_RE = re.compile(r"^ckpt_t(\d+)\.npz$")


class ResumeRefused(RuntimeError):
    """--resume found a checkpoint that does not belong to this run
    configuration (fingerprint mismatch) or is from an incompatible
    schema.  The CLI maps this to its own exit code (see apps/cli.py)
    so supervisors can tell 'stale checkpoint dir' from a solver
    failure."""


def config_fingerprint(**fields) -> str:
    """Stable hex digest of a run's identity.

    Callers pass everything that must match for a resumed tile loop to
    be a continuation of the original run: dataset path(s) and shape
    metadata, sky/cluster file paths, and the solver options that
    change the numerics.  Values must be JSON-able scalars / lists."""
    doc = json.dumps(fields, sort_keys=True, separators=(",", ":"),
                     default=str)
    return hashlib.sha256(doc.encode("utf-8")).hexdigest()


def _fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory entry (makes the rename itself
    durable; not supported on every platform/filesystem)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_checkpoint(path: str, arrays: Dict[str, np.ndarray],
                     meta: Dict[str, Any]) -> str:
    """Atomically write one checkpoint file (temp + fsync + rename)."""
    meta = dict(meta)
    meta.setdefault("schema_version", CHECKPOINT_SCHEMA_VERSION)
    meta.setdefault("ts", time.time())
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    payload = {"__meta__": np.frombuffer(
        json.dumps(meta, default=str).encode("utf-8"), dtype=np.uint8)}
    for k, v in arrays.items():
        if k == "__meta__":
            raise ValueError("array name '__meta__' is reserved")
        payload[k] = np.asarray(v)
    tmp = os.path.join(d, f".tmp.{os.getpid()}.{os.path.basename(path)}")
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    _fsync_dir(d)
    return path


def read_checkpoint(path: str) -> Tuple[Dict[str, Any],
                                        Dict[str, np.ndarray]]:
    """Read one checkpoint -> (meta, arrays).  Raises ``ValueError`` on
    a wrong/garbled schema (a torn file raises from numpy itself)."""
    with np.load(path, allow_pickle=False) as z:
        if "__meta__" not in z.files:
            raise ValueError(f"{path}: not a sagecal checkpoint "
                             f"(no __meta__ entry)")
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode("utf-8"))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    ver = meta.get("schema_version")
    if ver != CHECKPOINT_SCHEMA_VERSION:
        raise ValueError(
            f"{path}: checkpoint schema v{ver} != "
            f"v{CHECKPOINT_SCHEMA_VERSION} (this build)")
    return meta, arrays


def checkpoint_path(directory: str, tile_index: int) -> str:
    return os.path.join(directory, f"ckpt_t{tile_index:06d}.npz")


def list_checkpoints(directory: str) -> List[str]:
    """Checkpoint files in ``directory``, newest (highest tile) first."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    found = []
    for n in names:
        m = _CKPT_RE.match(n)
        if m:
            found.append((int(m.group(1)), os.path.join(directory, n)))
    return [p for _, p in sorted(found, reverse=True)]


def find_latest_checkpoint(directory: str, log=None):
    """Newest checkpoint in ``directory`` that loads cleanly, as
    (meta, arrays, path); None when the directory holds no usable
    checkpoint.  An unreadable file is skipped (never fatal): the
    atomic writer means corruption is a disk-level event, and an older
    intact checkpoint is still a correct resume point."""
    for path in list_checkpoints(directory):
        try:
            meta, arrays = read_checkpoint(path)
            return meta, arrays, path
        except Exception as e:  # torn/garbled: fall through to older
            if log is not None:
                log(f"checkpoint {path} unreadable ({e}); trying older")
    return None


def check_owner_lease(meta: Dict[str, Any], owner: str,
                      now: Optional[float] = None) -> None:
    """Refuse to adopt a checkpoint another process still owns.

    Streaming/fleet runs stamp ``owner`` and ``lease_expires_at`` into
    every checkpoint's meta (renewed simply by the checkpoint cadence).
    A restarted or stolen-over process calls this before resuming: a
    live lease held by a DIFFERENT owner means the original worker is
    probably still writing, and adopting its state would fork the
    stream.  An expired lease (or one we hold ourselves) is adoptable.
    Raises :class:`ResumeRefused` on a live foreign lease; meta without
    lease fields (single-process runs) always passes."""
    holder = meta.get("owner")
    if holder is None or holder == owner:
        return
    expires = meta.get("lease_expires_at")
    if expires is None:
        return
    now = time.time() if now is None else float(now)
    if float(expires) > now:
        raise ResumeRefused(
            f"checkpoint owned by {holder!r} with a live lease "
            f"(expires in {float(expires) - now:.1f}s); refusing to "
            f"adopt a stream another worker is still writing")


class CheckpointManager:
    """Owns one run's checkpoint directory: cadence, retention, the
    final crash-time flush, and fingerprint-checked resume.

    The app calls :meth:`update` at every tile boundary with HOST
    (numpy) state; the manager writes a checkpoint every ``every``
    tiles and keeps the newest ``keep`` files.  :meth:`flush` writes
    any boundary state newer than the last file — it is registered
    with the obs/flight.py crash handlers so a SIGTERM or uncaught
    exception persists the last completed tile before the process
    dies (a mid-solve kill therefore resumes by recomputing only the
    interrupted tile)."""

    def __init__(self, directory: str, fingerprint: str, app: str,
                 every: int = 1, keep: int = 2, elog=None, log=None):
        self.directory = directory
        self.fingerprint = fingerprint
        self.app = app
        self.every = max(int(every), 1)
        self.keep = max(int(keep), 1)
        self.elog = elog
        self.log = log or (lambda *_: None)
        self._lock = threading.Lock()
        self._pending: Optional[Tuple[int, Dict[str, np.ndarray],
                                      Dict[str, Any]]] = None
        self._written_tile: Optional[int] = None
        self._registered = False
        self.last_path: Optional[str] = None

    # -- write side ---------------------------------------------------

    def _register(self) -> None:
        if self._registered:
            return
        from sagecal_tpu_torch.obs.flight import register_crash_flusher

        register_crash_flusher(self.flush)
        self._registered = True

    def close(self) -> None:
        """Unhook from the crash handlers (success path; the state on
        disk stays — a finished run's checkpoints age out on the next
        run's retention sweep or an operator rm)."""
        if not self._registered:
            return
        from sagecal_tpu_torch.obs.flight import unregister_crash_flusher

        unregister_crash_flusher(self.flush)
        self._registered = False

    def update(self, tile_index: int, arrays: Dict[str, Any],
               **meta) -> Optional[str]:
        """Record tile ``tile_index`` as COMPLETE with its end-of-tile
        solver state; writes a checkpoint when the cadence is due.
        Arrays (tensors on any device) are copied to host numpy here, so
        a later signal-time flush never has to touch the device."""
        host = {k: _host(v) for k, v in arrays.items() if v is not None}
        with self._lock:
            self._pending = (int(tile_index), host, dict(meta))
        self._register()
        due = (int(tile_index) + 1) % self.every == 0
        return self._write_pending() if due else None

    def flush(self) -> Optional[str]:
        """Write the newest boundary state if it is not on disk yet
        (idempotent; called from the SIGTERM/excepthook path)."""
        return self._write_pending()

    def _write_pending(self) -> Optional[str]:
        with self._lock:
            pending = self._pending
            if pending is None or pending[0] == self._written_tile:
                return None
            tile_index, arrays, meta = pending
        doc = {
            "app": self.app,
            "fingerprint": self.fingerprint,
            "tile_index": tile_index,
        }
        doc.update(meta)
        path = write_checkpoint(
            checkpoint_path(self.directory, tile_index), arrays, doc)
        with self._lock:
            self._written_tile = tile_index
            self.last_path = path
        self._retention_sweep(tile_index)
        if self.elog is not None:
            try:
                self.elog.emit("checkpoint_written", path=path,
                               tile_index=tile_index, app=self.app)
            except Exception:
                pass
        from sagecal_tpu_torch.obs.flight import note_checkpoint

        note_checkpoint(path)
        return path

    def _retention_sweep(self, newest_tile: int) -> None:
        for path in list_checkpoints(self.directory)[self.keep:]:
            m = _CKPT_RE.match(os.path.basename(path))
            if m and int(m.group(1)) < newest_tile:
                try:
                    os.remove(path)
                except OSError:
                    pass

    # -- resume side --------------------------------------------------

    def resume(self):
        """Newest valid checkpoint as (meta, arrays, path), or None for
        a fresh start.  A checkpoint written by a DIFFERENT run
        configuration raises :class:`ResumeRefused` (after emitting a
        ``resume_refused`` event) — never silently recalibrates the
        wrong observation."""
        found = find_latest_checkpoint(self.directory, log=self.log)
        if found is None:
            return None
        meta, arrays, path = found
        if meta.get("app") != self.app or \
                meta.get("fingerprint") != self.fingerprint:
            detail = ("app" if meta.get("app") != self.app
                      else "config/data fingerprint")
            if self.elog is not None:
                try:
                    self.elog.emit(
                        "resume_refused", path=path, mismatch=detail,
                        checkpoint_app=meta.get("app"),
                        checkpoint_fingerprint=meta.get("fingerprint"),
                        run_fingerprint=self.fingerprint, app=self.app)
                except Exception:
                    pass
            raise ResumeRefused(
                f"checkpoint {path} was written by a different run "
                f"({detail} mismatch); refusing to resume — move or "
                f"delete the checkpoint directory to start fresh")
        if self.elog is not None:
            try:
                self.elog.emit("resume_started", path=path,
                               tile_index=meta.get("tile_index"),
                               app=self.app)
            except Exception:
                pass
        from sagecal_tpu_torch.obs.flight import note_checkpoint

        note_checkpoint(path)
        with self._lock:
            self._written_tile = int(meta.get("tile_index", -1))
            self.last_path = path
        return meta, arrays, path


# ---------------------------------------------------------------------------
# nested state <-> named arrays (federated/minibatch state has nested
# structure; the npz format stores flat named arrays)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def state_leaves(tree) -> list:
    """Leaves of a nested state in ``jax.tree_util``'s order for the same
    structure: tuples, lists and NamedTuples in order, dicts by sorted
    key, dataclasses by field, ``None`` an empty subtree; anything else
    (tensor, array, scalar) is a leaf."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in state_leaves(x)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in state_leaves(tree[k])]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in state_leaves(getattr(tree, f.name))]
    return [tree]


def _rebuild(template, leaves):
    """``template``'s structure with its leaves taken from the iterator
    ``leaves`` (each leaf keeps the template leaf's dtype and device when
    the template leaf is a tensor, its type when it is a Python
    scalar)."""
    import torch

    if template is None:
        return None
    if _is_namedtuple(template):
        return type(template)(*[_rebuild(x, leaves) for x in template])
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(x, leaves) for x in template)
    if isinstance(template, dict):
        out = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    leaf = next(leaves)
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.asarray(leaf)).to(
            dtype=template.dtype, device=template.device)
    if isinstance(template, (bool, int, float)):
        return type(template)(np.asarray(leaf).item())
    return leaf


def _host(x) -> np.ndarray:
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def flatten_state(prefix: str, tree) -> Dict[str, np.ndarray]:
    """Flatten a nested state of tensors into ``{prefix}.{i}`` host
    arrays (leaf order as :func:`state_leaves`, so the names equal the
    reference's for the same structure)."""
    return {f"{prefix}.{i}": _host(x)
            for i, x in enumerate(state_leaves(tree))}


def unflatten_state(prefix: str, arrays: Dict[str, np.ndarray], template):
    """Rebuild a nested state from :func:`flatten_state` entries using a
    same-structure ``template`` (e.g. a freshly initialized state)."""
    n = len(state_leaves(template))
    return _rebuild(template,
                    iter([arrays[f"{prefix}.{i}"] for i in range(n)]))
