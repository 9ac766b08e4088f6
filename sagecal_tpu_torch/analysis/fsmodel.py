"""Deterministic simulated filesystem for protocol model checking
(counterpart of ``sagecal_tpu/analysis/fsmodel.py``, a copy).

:class:`SimFS` implements exactly the surface the fleet protocol code
relies on (the :class:`sagecal_tpu_torch.fleet.queue.RealFS` contract) with
exactly the atomicity semantics the real code assumes of a POSIX
filesystem:

- ``publish_excl`` — stage + fsync + hard-link: the name appears with
  its full content in one indivisible step, exactly one publisher wins
  (``EEXIST``), and a crash loses only invisible tmp state;
- ``open_excl`` — ``O_CREAT|O_EXCL``: exactly one creator wins, but
  the file is *visible and empty* until ``commit`` — the torn-window
  primitive the shipped protocol deliberately avoids (the seeded
  ``torn-publish`` mutation uses it to re-introduce the bug);
- ``write_atomic`` — the tmp + fsync + ``os.replace`` idiom as one
  indivisible transition.  The real sequence stages a uniquely-named
  tmp file first; since no reader and no recovery path ever opens a
  tmp name, every intermediate state is observably identical to
  "nothing happened yet", and collapsing the staging into a single
  transition loses no distinguishable state.  Crash-before ≡ the op
  never ran (un-renamed tmp state is arbitrary lost garbage, exactly
  the POSIX contract); crash-after ≡ the file is durably replaced;
- ``unlink`` / ``unlink_matching`` / ``listdir`` / ``read_text`` /
  ``exists`` — plain name-space ops, each one transition.

Every public operation first calls the installed :attr:`SimFS.gate`
hook (when set) — the interleaving explorer's scheduling point.  The
hook may raise :class:`SimCrash` to crash the calling logical worker
*at that boundary*: the op does not execute, the worker's stack
unwinds (``SimCrash`` derives from ``BaseException`` so the protocol
code's ``except OSError`` clauses cannot swallow it), and any file the
worker had ``open_excl``-created but not yet committed stays behind
torn.  That is precisely "crash injection at every fs-operation
boundary".

The simulator is fully deterministic: ``unique_suffix`` is a counter,
there is no wall clock (logical time lives in :class:`SimClock`), and
``listdir`` is sorted.  ``tests/test_protocol.py`` runs the same
lease-protocol script against a tmpdir (``RealFS``) and this simulator
and pins identical observable outcomes on crash-free schedules.

Stdlib only; importing this module never imports jax or numpy (the
checker must run on any host, backend or no backend — same contract as
the rest of :mod:`sagecal_tpu_torch.analysis`).
"""

from __future__ import annotations

import posixpath
from typing import Callable, Dict, List, Optional, Tuple


class SimCrash(BaseException):
    """Injected fail-stop crash of one logical worker at an
    fs-operation boundary.  Derives from ``BaseException`` on purpose:
    the protocol code's defensive ``except OSError`` / ``except
    Exception`` clauses must not be able to swallow a crash."""


class SimClock:
    """Logical time: advances only when the explorer says so."""

    def __init__(self, t: float = 1000.0):
        self.t = float(t)

    def now(self) -> float:
        return self.t

    def advance_to(self, t: float) -> None:
        if t < self.t:
            raise ValueError(f"clock cannot go backward "
                             f"({t} < {self.t})")
        self.t = float(t)


class _SimFD:
    """One open ``open_excl`` handle (torn until committed)."""

    __slots__ = ("path", "open")

    def __init__(self, path: str):
        self.path = path
        self.open = True


class SimFS:
    """In-memory filesystem with the RealFS op surface.

    ``files`` maps path -> text; a path created by ``open_excl`` holds
    ``""`` until its fd is committed (the torn-file state).  ``gate``
    (when set) is invoked as ``gate(op_name, detail)`` before every
    operation executes.
    """

    def __init__(self, gate: Optional[Callable[[str, str], None]] = None):
        self.files: Dict[str, str] = {}
        self.dirs = {"/"}
        self.gate = gate
        self._seq = 0

    # -- explorer plumbing (not part of the fs op surface) ------------

    def _op(self, name: str, detail: str = "") -> None:
        if self.gate is not None:
            self.gate(name, detail)

    def snapshot(self) -> Tuple[Dict[str, str], set]:
        return dict(self.files), set(self.dirs)

    def restore(self, snap: Tuple[Dict[str, str], set]) -> None:
        self.files, self.dirs = dict(snap[0]), set(snap[1])

    def clone(self) -> "SimFS":
        c = SimFS()
        c.files = dict(self.files)
        c.dirs = set(self.dirs)
        c._seq = self._seq
        return c

    def fingerprint(self) -> Tuple:
        """Visible state only — open fds and the suffix counter do not
        influence what any worker can observe from here on."""
        return tuple(sorted(self.files.items()))

    # -- the RealFS contract ------------------------------------------

    def makedirs(self, path: str) -> None:
        self._op("makedirs", path)
        self.dirs.add(posixpath.normpath(path))

    def exists(self, path: str) -> bool:
        self._op("exists", path)
        return path in self.files \
            or posixpath.normpath(path) in self.dirs

    def listdir(self, path: str) -> List[str]:
        self._op("listdir", path)
        d = posixpath.normpath(path)
        if d not in self.dirs:
            raise FileNotFoundError(f"[sim] no such directory: {path}")
        return sorted(posixpath.basename(p) for p in self.files
                      if posixpath.dirname(posixpath.normpath(p)) == d)

    def read_text(self, path: str) -> str:
        self._op("read_text", path)
        if path not in self.files:
            raise FileNotFoundError(f"[sim] no such file: {path}")
        return self.files[path]

    def open_excl(self, path: str) -> _SimFD:
        self._op("open_excl", path)
        if path in self.files:
            raise FileExistsError(f"[sim] exists: {path}")
        self.files[path] = ""  # visible and torn until commit
        return _SimFD(path)

    def create(self, path: str) -> _SimFD:
        """Plain truncating create (``O_CREAT|O_TRUNC``) — exists so
        seeded mutations can model a claim that skips ``O_EXCL``."""
        self._op("create", path)
        self.files[path] = ""
        return _SimFD(path)

    def commit(self, fd: _SimFD, text: str) -> None:
        self._op("commit", fd.path)
        if not fd.open:
            raise OSError(f"[sim] fd already closed: {fd.path}")
        fd.open = False
        if fd.path in self.files:
            self.files[fd.path] = text

    def publish_excl(self, path: str, text: str) -> None:
        self._op("publish_excl", path)
        if path in self.files:
            raise FileExistsError(f"[sim] exists: {path}")
        self.files[path] = text

    def write_atomic(self, path: str, text: str) -> None:
        self._op("write_atomic", path)
        self.files[path] = text

    def unlink(self, path: str) -> None:
        self._op("unlink", path)
        if path not in self.files:
            raise FileNotFoundError(f"[sim] no such file: {path}")
        del self.files[path]

    def unlink_matching(self, dirpath: str, prefix: str) -> int:
        self._op("unlink_matching", f"{dirpath}/{prefix}*")
        d = posixpath.normpath(dirpath)
        victims = [p for p in self.files
                   if posixpath.dirname(posixpath.normpath(p)) == d
                   and posixpath.basename(p).startswith(prefix)]
        for p in victims:
            del self.files[p]
        return len(victims)

    def unique_suffix(self) -> str:
        # pure naming, not a scheduling point: the name never escapes
        # to another worker before the op that publishes it
        self._seq += 1
        return f"sim{self._seq:06d}"
