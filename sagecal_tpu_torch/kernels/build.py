"""Build and load the port's CUDA kernels (``sagecal_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds.  Libraries go to ``sagecal_tpu_torch/_build/`` (git
ignored), named by a hash of the source, the headers beside it and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused.  Nothing is built when this module is imported: :func:`load`
builds at first use, and :func:`build_all` starts one ``nvcc`` per
source, all at once.

With a kernel store attached (:func:`attach_store`, a
``serve/aot_store.py::AOTArtifactStore`` shared by a fleet's workers),
libraries are looked up in the store first, by the same digest plus the
runtime's versions; a miss is built in a temporary directory and saved
into the store, so a second worker builds nothing.  ``builds`` counts
the ``nvcc`` runs of this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import contextlib
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# C signatures of every exported function, per source.
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "fused_cost": {
        "fused_cost_num_blocks": ([_I], _I),
        # tab_re, tab_im, coh, coh_bf16, ant_p, ant_q, cmap, vis, mask, nu,
        # mp, nc, npad, F, rowsp, robust, partial, stream
        "fused_cost_fwd": ([_P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _P, _P], _I),
        # ..., robust, plan_pos, plan_seg, plan_of, stages, g, partial,
        # out, stream
        "fused_cost_bwd": ([_P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _P, _P, _P,
                            _I, _P, _P, _P, _P], _I),
        # rowsp
        "fused_cost_bwd_num_tables": ([_I], _I),
        # tab_re, tab_im, coh, coh_bf16, ant_p, ant_q, vis, mask, nu,
        # lanes, mp, npad, F, rowsp, robust, partial, stream
        "fused_cost_batch_fwd": ([_P, _P, _P, _I, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _P, _P], _I),
        # ..., robust, plan_pos, plan_seg, stages, g, partial, out, stream
        "fused_cost_batch_bwd": ([_P, _P, _P, _I, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _P, _P,
                                  _I, _P, _P, _P, _P], _I),
        # tab_re, tab_im, coh, coh_bf16, ant_p, ant_q, cmap, mp, nc, npad,
        # F, rowsp, out, stream
        "fused_predict_fwd": ([_P, _P, _P, _I, _P, _P, _P,
                               _I, _I, _I, _I, _I, _P, _P], _I),
        # tab_re, tab_im, coh, coh_bf16, ant_p, ant_q, cmap, g, mp, nc,
        # npad, F, rowsp, plan_pos, plan_seg, plan_of, stages, partial,
        # out, stream
        "fused_predict_bwd": ([_P, _P, _P, _I, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _P, _P, _P,
                               _I, _P, _P, _P], _I),
    },
    # the kbisect probes #7-#10, one source each (tools/kbisect.py)
    # tab, oh, mp, npad, T, partial, out, stream; mp
    "kbisect_c": {"kbisect_c": ([_P, _P, _I, _I, _I, _P, _P, _P], _I),
                  "kbisect_c_row_tiles": ([_I], _I)},
    # coh, mp, rows, out, stream
    "kbisect_b": {"kbisect_b": ([_P, _I, _I, _P, _P], _I)},
    # antp, tab, mp, npad, R, T, stages, S, out, stream; ; mp, npad, T
    "kbisect_a": {"kbisect_a": ([_P, _P, _I, _I, _I, _I, _I, _P, _P, _P], _I),
                  "kbisect_a_one_launch_max_npad": ([], _I),
                  "kbisect_a_default_stages": ([_I, _I, _I], _I)},
    # antp, tab, mp, npad, T, stages, P, out, stream; ; mp, npad, T
    "kbisect_f": {"kbisect_f": ([_P, _P, _I, _I, _I, _I, _P, _P, _P], _I),
                  "kbisect_f_one_launch_max_npad": ([], _I),
                  "kbisect_f_default_stages": ([_I, _I, _I], _I)},
}

_loaded: dict = {}
# the kernel store in use (None: BUILD_DIR) and the nvcc runs made by
# this process
_store = None
builds = 0
# compiler output (ptxas register/shared-memory report) of builds made by
# this process, per source name
build_logs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source on a machine with the CUDA toolkit")


def source_digest(name: str) -> str:
    """Digest of the flags, ``csrc/<name>.cu`` and every header beside
    it (which it may include)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
    return digest.hexdigest()[:16]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{source_digest(name)}.so")


def attach_store(store) -> None:
    """Build into and load from ``store`` (an ``AOTArtifactStore``; None
    detaches).  Libraries this process already loaded stay loaded."""
    global _store
    _store = store


def _start(name: str, out: str = None):
    """Start nvcc for ``csrc/<name>.cu`` into ``out`` (default: its
    BUILD_DIR path; None when already built there)."""
    out = out or _lib_path(name)
    if os.path.exists(out):
        return None
    out_dir = os.path.dirname(out)
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    global builds
    if started is None:
        return
    builds += 1
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=None) -> dict:
    """Build every source (one nvcc each, started together); returns
    {name: library path}."""
    names = list(SIGNATURES) if names is None else list(names)
    if _store is not None:
        return _build_into_store(_store, names)
    started = {n: _start(n) for n in names}
    for n in names:
        _finish(n, started[n])
    return {n: _lib_path(n) for n in names}


def _build_into_store(store, names) -> dict:
    """Every library from ``store``; the misses built together (one nvcc
    each) in a temporary directory under the artifacts' locks, then
    saved into the store."""
    digests = {n: source_digest(n) for n in names}
    paths, started = {}, {}
    with contextlib.ExitStack() as stack:
        for n in sorted(names):
            stack.enter_context(store.locked(n, digests[n]))
        tmpdir = stack.enter_context(tempfile.TemporaryDirectory())
        for n in names:
            paths[n] = store.lookup(n, digests[n])
            if paths[n] is None:
                started[n] = _start(n, os.path.join(tmpdir, f"lib{n}.so"))
        for n, st in started.items():
            _finish(n, st)
            paths[n] = store.save(n, digests[n],
                                  os.path.join(tmpdir, f"lib{n}.so"))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed, with
    argtypes/restype declared for every exported function."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = build_all([name])[name]
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    _loaded[name] = lib
    return lib
