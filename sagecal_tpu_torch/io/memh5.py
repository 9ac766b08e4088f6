"""An in-memory stand-in for the part of ``h5py.File`` that
``io/dataset.py`` uses.

A machine without ``h5py`` can still run the dataset reader, the tile
prefetcher and the fullbatch app: pass ``open_file=MemFile`` where they
take an opener.  It is not a file format and writes nothing to disk.
Files live in a process-wide registry keyed by absolute path, so a
second handle on the same path (the prefetcher's reader) sees the same
arrays.  The subset, with h5py's semantics:

- ``MemFile(path, mode)``: ``"r"`` and ``"r+"`` need an existing file,
  ``"w"`` creates or truncates, ``"a"`` opens or creates; a context
  manager, ``close()``;
- ``f[name]`` -> a :class:`MemDataset`; ``name in f``; ``f.keys()``;
  ``f.attrs`` (a mapping shared by the file's handles; values stored as
  numpy scalars, as h5py returns them);
- ``f.create_dataset(name, data=...)`` or ``(name, shape=, dtype=)``
  (zero-filled), ``chunks=`` accepted and ignored;
- a dataset has ``shape``, ``dtype``, numpy conversion, and
  slice reads (a copy) and writes (cast to its dtype).
"""

from __future__ import annotations

import os
import threading
from collections.abc import MutableMapping

import numpy as np

_FILES: dict = {}  # absolute path -> {"data": {name: ndarray}, "attrs": {}}
_LOCK = threading.Lock()


class MemDataset:
    """One array of a :class:`MemFile`."""

    def __init__(self, array: np.ndarray, writable: bool):
        self._a = array
        self._writable = writable

    @property
    def shape(self):
        return self._a.shape

    @property
    def dtype(self):
        return self._a.dtype

    def __array__(self, dtype=None, copy=None):
        return np.array(self._a, dtype=dtype)

    def __getitem__(self, key):
        return np.array(self._a[key])

    def __setitem__(self, key, value):
        if not self._writable:
            raise OSError("dataset opened read-only")
        self._a[key] = np.asarray(value)


class _Attrs(MutableMapping):
    """A file's attributes, shared by its handles; values are stored as
    numpy scalars, as h5py stores and returns them."""

    def __init__(self, store: dict, handle: "MemFile"):
        self._store = store
        self._handle = handle

    def __getitem__(self, key):
        return self._store[key]

    def __setitem__(self, key, value):
        if not self._handle._writable:
            raise OSError("file opened read-only")
        self._store[key] = np.asarray(value)[()]

    def __delitem__(self, key):
        del self._store[key]

    def __iter__(self):
        return iter(self._store)

    def __len__(self) -> int:
        return len(self._store)


class MemFile:
    """``h5py.File``-like handle on an in-memory file (module doc)."""

    def __init__(self, path: str, mode: str = "r"):
        key = os.path.abspath(path)
        with _LOCK:
            if mode in ("r", "r+"):
                if key not in _FILES:
                    raise FileNotFoundError(f"no in-memory file {path!r}")
            elif mode == "w":
                _FILES[key] = {"data": {}, "attrs": {}}
            elif mode == "a":
                _FILES.setdefault(key, {"data": {}, "attrs": {}})
            else:
                raise ValueError(f"mode {mode!r} not in r, r+, w, a")
            self._store = _FILES[key]
        self.filename = path
        self.mode = mode
        self._writable = mode != "r"
        self.attrs = _Attrs(self._store["attrs"], self)

    def __getitem__(self, name: str) -> MemDataset:
        return MemDataset(self._store["data"][name], self._writable)

    def __contains__(self, name: str) -> bool:
        return name in self._store["data"]

    def keys(self):
        return self._store["data"].keys()

    def create_dataset(self, name: str, shape=None, dtype=None, data=None,
                       chunks=None) -> MemDataset:
        if not self._writable:
            raise OSError("file opened read-only")
        if data is not None:
            arr = np.array(data, dtype=dtype)
        else:
            arr = np.zeros(shape, dtype=dtype)
        with _LOCK:
            if name in self._store["data"]:
                raise ValueError(f"dataset {name!r} exists")
            self._store["data"][name] = arr
        return MemDataset(arr, True)

    def close(self) -> None:
        self._writable = False

    def __enter__(self) -> "MemFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def remove(path: str) -> None:
    """Drop an in-memory file (frees its arrays)."""
    with _LOCK:
        _FILES.pop(os.path.abspath(path), None)
