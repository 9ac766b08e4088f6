"""Cross-worker store of built kernel libraries (the port's counterpart
of ``sagecal_tpu/serve/aot_store.py``).

The reference stores serialized XLA executables so that the second
worker of a fleet compiles nothing.  The port compiles nothing per
bucket; what a second worker would otherwise repeat is ``nvcc`` for its
kernel libraries (``kernels/build.py``).  So the store is one directory
of built libraries shared by a fleet: whichever worker needs a library
first builds it into the store, and every later worker loads it — zero
builds, pinned by the ``serve_executable_cache_*`` counters (a worker
that finds every library records ``aot_hits`` and no ``compiles``).

Key contract: a library is valid only for the exact sources and flags it
was built from and for the runtime that loads it, so the key digests

- the build digest of ``kernels/build.py`` (flags, the source and every
  header beside it),
- the torch version, the CUDA version torch was built with, and the
  device's compute capability.

File format: ``lib<name>-<key>.so`` with a JSON sidecar
``lib<name>-<key>.json`` (magic, schema, the version fields, the
library's size and sha256).  The sidecar is checked before
``ctypes.CDLL`` ever sees the file: an absent, truncated, corrupt or
version-mismatched artifact counts as a miss and is rebuilt, never a
crash.  Writes are atomic (tmp + ``os.replace``; the sidecar is written
last, so a reader sees either no artifact or a whole one), and one
``flock`` per artifact makes concurrent workers build it once: the
second waits for the first and then loads.

Import-light: stdlib only at import time; torch is read inside calls.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import json
import os
import shutil
from typing import Optional

AOT_STORE_SCHEMA_VERSION = 1

_MAGIC = "sagecal-kernel-artifact"


def version_fields(capability: Optional[str] = None) -> dict:
    """The runtime an artifact is valid for: torch and CUDA versions and
    the device's compute capability (``"9.0"`` on an H100; None without
    CUDA, unless given)."""
    import torch

    if capability is None and torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability()
        capability = f"{major}.{minor}"
    return {
        "schema": AOT_STORE_SCHEMA_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "capability": capability,
    }


def artifact_key(name: str, digest: str, versions: dict) -> str:
    """Stable digest naming one (library, build digest, runtime)
    artifact."""
    doc = json.dumps({"name": name, "digest": digest, **versions},
                     sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(doc.encode("utf-8")).hexdigest()[:32]


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class AOTArtifactStore:
    """One directory of ``lib<name>-<key>.so`` artifacts shared by a
    fleet.

    :meth:`lookup` gives the path of a checked artifact or None;
    the build module (``kernels/build.py``) builds a miss under
    :meth:`locked` and hands it to :meth:`save`.  Plain
    int counters (``hits``, ``builds``, ``errors``, ``saves``) mirror
    the registry's ``serve_executable_cache_*_total`` series, so tests
    can assert reuse with telemetry off.  ``versions`` overrides the
    runtime fields (tests on the CPU)."""

    def __init__(self, root: str, versions: Optional[dict] = None):
        self.root = root
        self._versions = versions
        self.hits = 0
        self.builds = 0
        self.errors = 0
        self.saves = 0
        #: human-readable detail of the most recent load/save failure
        self.last_error: Optional[str] = None

    @property
    def versions(self) -> dict:
        if self._versions is None:
            self._versions = version_fields()
        return self._versions

    def paths_for(self, name: str, digest: str):
        """(library path, sidecar path) of one artifact."""
        key = artifact_key(name, digest, self.versions)
        base = os.path.join(self.root, f"lib{name}-{key}")
        return base + ".so", base + ".json"

    def artifacts(self) -> int:
        """Number of artifacts (sidecars) in the store."""
        try:
            return sum(1 for n in os.listdir(self.root)
                       if n.startswith("lib") and n.endswith(".json"))
        except OSError:
            return 0

    # -- read side ----------------------------------------------------

    def check(self, name: str, digest: str) -> Optional[str]:
        """The artifact's library path when its sidecar matches this
        runtime and the file's size and sha256, else None (an absent
        artifact is a plain miss; anything else is counted as an
        error)."""
        lib, side = self.paths_for(name, digest)
        if not os.path.exists(side):
            return None
        try:
            with open(side, "r", encoding="utf-8") as f:
                header = json.load(f)
            if header.get("magic") != _MAGIC:
                raise ValueError("bad magic")
            for k, v in self.versions.items():
                if header.get(k) != v:
                    raise ValueError(f"version mismatch: {k}="
                                     f"{header.get(k)!r} (this process: "
                                     f"{v!r})")
            if header.get("digest") != digest:
                raise ValueError("build digest mismatch")
            if os.path.getsize(lib) != int(header["size"]):
                raise ValueError("truncated library")
            if _sha256_file(lib) != header["sha256"]:
                raise ValueError("library checksum mismatch")
        except Exception as e:  # torn, corrupt or stale: rebuild
            self.errors += 1
            self._count("aot_errors", name)
            self.last_error = f"{side}: {e!r}"
            return None
        return lib

    # -- write side ---------------------------------------------------

    def lookup(self, name: str, digest: str) -> Optional[str]:
        """:meth:`check`, counted as a hit or a miss."""
        found = self.check(name, digest)
        if found is not None:
            self.hits += 1
            self._count("aot_hits", name)
        else:
            self._count("aot_misses", name)
        return found

    @contextlib.contextmanager
    def locked(self, name: str, digest: str):
        """An exclusive lock on one artifact for the span of a lookup and
        its build: a concurrent worker waits for the build, then hits."""
        lib, _ = self.paths_for(name, digest)
        os.makedirs(self.root, exist_ok=True)
        with open(lib + ".lock", "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    def save(self, name: str, digest: str, built: str) -> str:
        """Move the library this process just built at ``built`` into the
        store with its sidecar (library first, sidecar last, each
        atomically); counted as a build."""
        self.builds += 1
        self._count("compiles", name)
        lib, side = self.paths_for(name, digest)
        os.makedirs(self.root, exist_ok=True)
        tmp = f"{lib}.tmp.{os.getpid()}"
        shutil.copyfile(built, tmp)
        os.replace(tmp, lib)
        header = dict(self.versions, magic=_MAGIC, name=name,
                      digest=digest, size=os.path.getsize(lib),
                      sha256=_sha256_file(lib))
        tmp = f"{side}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(header, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, side)
        self.saves += 1
        self._count("aot_saves", name)
        return lib

    def stats(self) -> dict:
        return {"aot_hits": self.hits, "compiles": self.builds,
                "aot_errors": self.errors, "aot_saves": self.saves,
                "artifacts": self.artifacts()}

    # -- counters -----------------------------------------------------

    @staticmethod
    def _count(kind: str, name: str) -> None:
        from sagecal_tpu_torch.obs.registry import get_registry

        get_registry().counter_inc(
            f"serve_executable_cache_{kind}_total",
            help=f"cross-worker kernel store lookups ({kind})",
            library=name)
