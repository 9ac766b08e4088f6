"""Build and load the port's CUDA kernels (``sagecal_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds.  Libraries go to ``sagecal_tpu_torch/_build/`` (git
ignored), named by a hash of the source and flags, so an edited source
is rebuilt and an unchanged one is reused.  Nothing is built when this
module is imported: :func:`load` builds at first use, and
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
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
        # ... partial, out, stream
        "fused_cost_bwd": ([_P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _P, _P, _P], _I),
    },
}

_loaded: dict = {}
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


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu`` (None when already built)."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
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
    started = {n: _start(n) for n in names}
    for n in names:
        _finish(n, started[n])
    return {n: _lib_path(n) for n in names}


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
