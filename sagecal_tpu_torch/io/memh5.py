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
- ``f[name]`` -> a :class:`MemDataset` or a :class:`MemGroup`;
  ``name in f``; ``f.keys()``; ``f.attrs`` (a mapping shared by the
  file's handles; values stored as numpy scalars, as h5py returns
  them);
- ``f.create_dataset(name, data=...)`` or ``(name, shape=, dtype=)``
  (zero-filled), ``chunks=`` accepted and ignored;
  ``f.create_group(name)``: a group has the file's item access,
  ``create_dataset``, ``create_group`` and ``attrs`` (one level of names
  each, no ``a/b`` paths);
- a dataset has ``shape``, ``dtype``, numpy conversion, and
  slice reads (a copy) and writes (cast to its dtype).
"""

from __future__ import annotations

import os
import threading
from collections.abc import MutableMapping

import numpy as np

# absolute path -> a node {"data": {name: ndarray or node}, "attrs": {}}
_FILES: dict = {}
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


def _node() -> dict:
    return {"data": {}, "attrs": {}}


class _Group:
    """Item access, creation and attributes of a file or group node."""

    def _bind(self, store: dict, handle: "MemFile") -> None:
        self._store = store
        self._handle = handle
        self.attrs = _Attrs(store["attrs"], handle)

    def __getitem__(self, name: str):
        item = self._store["data"][name]
        if isinstance(item, dict):
            return MemGroup(item, self._handle)
        return MemDataset(item, self._handle._writable)

    def __contains__(self, name: str) -> bool:
        return name in self._store["data"]

    def keys(self):
        return self._store["data"].keys()

    def _add(self, name: str, item):
        if not self._handle._writable:
            raise OSError("file opened read-only")
        with _LOCK:
            if name in self._store["data"]:
                raise ValueError(f"{name!r} exists")
            self._store["data"][name] = item
        return item

    def create_dataset(self, name: str, shape=None, dtype=None, data=None,
                       chunks=None) -> MemDataset:
        if data is not None:
            arr = np.array(data, dtype=dtype)
        else:
            arr = np.zeros(shape, dtype=dtype)
        return MemDataset(self._add(name, arr), True)

    def create_group(self, name: str) -> "MemGroup":
        return MemGroup(self._add(name, _node()), self._handle)


class MemGroup(_Group):
    """A group of a :class:`MemFile`."""

    def __init__(self, store: dict, handle: "MemFile"):
        self._bind(store, handle)


class MemFile(_Group):
    """``h5py.File``-like handle on an in-memory file (module doc)."""

    def __init__(self, path: str, mode: str = "r"):
        key = os.path.abspath(path)
        with _LOCK:
            if mode in ("r", "r+"):
                if key not in _FILES:
                    raise FileNotFoundError(f"no in-memory file {path!r}")
            elif mode == "w":
                _FILES[key] = _node()
            elif mode == "a":
                _FILES.setdefault(key, _node())
            else:
                raise ValueError(f"mode {mode!r} not in r, r+, w, a")
            store = _FILES[key]
        self.filename = path
        self.mode = mode
        self._writable = mode != "r"
        self._bind(store, self)

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
