"""Bisect which kernel feature fails to build or to run on the card: the
port of the root ``kbisect.py``, with its four probe kernels (#7-#10 of
PERF.md's table) hand-written in CUDA.

Run from the root of the repository, on a machine with one CUDA card::

    python3 -m sagecal_tpu_torch.tools.kbisect c b a d

Tiny shapes throughout; variants ordered by increasing complexity.  Each
variant prints ``[x] building...`` and then ``[x] ok: <s> val=<v>``; the
first one that never prints "ok" is the culprit.  ``a``, ``b``, ``c``
and ``f`` are the probes, each with a source of its own
(``csrc/kbisect_<x>.cu``), so ``building`` covers that probe's own
``nvcc`` build and a build failure names its variant.  ``d`` and ``e``
run the fused predict (kernel #1, and #2 for ``e``'s gradient) at the
same tiny shape.  Without a CUDA device the command exits non-zero: the
probes exist to exercise the card, and there is no CPU fallback.

Each variant returns ``(fn, args)`` like the JAX tool's: ``args`` are
drawn with ``numpy.random.default_rng(0)`` in the JAX tool's order (the
same bytes) and moved to the device, and ``fn(*args)`` is the sum of
the probe's output.  ``T, MP, NPAD, F, R`` are read when a variant is
called, as the JAX tool reads them.

For each probe ``x``: :func:`probe_x` is the wrapper (CUDA tensors launch
the kernel or raise; CPU tensors, and only those, take the plain
version), ``probe_x_plain`` the plain PyTorch version and
``probe_x_cuda`` the launcher, with a ``launches`` counter.  What each
computes (a station index outside ``[0, npad)`` selects nothing, as its
one-hot column in the TPU kernel is all zero):

- c (#7): ``g = tab @ oh``; ``out[t] = sum_m g[4m,t] g[4m+1,t] +
  g[4m+2,t] g[4m+3,t]``, tab (4 MP, NPAD), oh (NPAD, T) -> (1, T);
- b (#8): ``out[0,k,r] = sum_m coh[m,0,k,r]^2``, coh (MP, 1, 8, R T) ->
  (1, 8, R T); defined for F = 1 only (F != 1 raises ValueError);
- a (#9): ``out[0,k,t] = sum_r sum_m tab[4m+k, antp[r T + t]]``, antp
  (1, R T) int32, tab (4 MP, NPAD) -> (1, 4, T);
- f (#10): ``out[t] = sum_m tab[0,m,a] tab[1,m,a] + tab[2,m,a]
  tab[3,m,a]``, a = antp[t], antp (1, T) int32, tab (4, MP, NPAD) ->
  (1, T).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.ops.rime_kernel import (
    _check_tensors, _raise_on, _scratch, fused_predict_packed,
)
from sagecal_tpu_torch.utils.precision import full_f32

T, MP, NPAD, F, R = 256, 8, 128, 1, 2

_F32, _I32 = (torch.float32,), (torch.int32,)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _on_cuda(*xs) -> bool:
    """Whether any input lies on the card: such a call launches the
    kernel (and a CPU/CUDA mix is refused by its checks)."""
    return any(x.is_cuda for x in xs)


def _in_range(antp, npad: int):
    """(flat indices clamped into the table, mask of those in range)."""
    a = antp.reshape(-1).long()
    valid = (a >= 0) & (a < npad)
    return torch.where(valid, a, 0), valid


# ------------------------------------------------------- #7: variant c


def probe_c_plain(tab, oh):
    """Plain version of probe c: (1, T) f32 (full f32, no TF32)."""
    with full_f32():
        g = tab @ oh
    g = g.reshape(tab.shape[0] // 4, 4, -1)
    return (g[:, 0] * g[:, 1] + g[:, 2] * g[:, 3]).sum(0, keepdim=True)


def probe_c_cuda(tab, oh):
    """Launch kernel #7 (``csrc/kbisect_c.cu``): (1, T) f32.  Replaces
    ``kbisect.py``'s ``variant_c``."""
    from sagecal_tpu_torch.kernels.build import load

    rows, npad = tab.shape
    if rows % 4:
        raise ValueError(f"tab rows {rows} are not 4 per cluster")
    cols = oh.shape[1] if oh.ndim == 2 else -1
    _check_tensors(tab.device, {"tab": (tab, (rows, npad), _F32),
                                "oh": (oh, (npad, cols), _F32)})
    lib = load("kbisect_c")
    partial = torch.empty((lib.kbisect_c_row_tiles(rows // 4), cols),
                          dtype=torch.float32, device=tab.device)
    out = torch.empty((1, cols), dtype=torch.float32, device=tab.device)
    _raise_on(lib.kbisect_c(
        tab.data_ptr(), oh.data_ptr(), rows // 4, npad, cols,
        partial.data_ptr(), out.data_ptr(), _stream(tab)), "kbisect_c")
    probe_c_cuda.launches += 1
    return out


def probe_c(tab, oh):
    """Probe c's output (module doc) before the sum."""
    if _on_cuda(tab, oh):
        return probe_c_cuda(tab, oh)
    return probe_c_plain(tab, oh)


# ------------------------------------------------------- #8: variant b


def _one_channel(coh):
    if coh.ndim != 4 or coh.shape[1] != 1 or coh.shape[2] != 8:
        raise ValueError(f"probe b is defined for coh (MP, 1, 8, rows) only "
                         f"(F = 1), got {tuple(coh.shape)}")


def probe_b_plain(coh):
    """Plain version of probe b: (1, 8, rows) f32."""
    _one_channel(coh)
    return (coh[:, 0] * coh[:, 0]).sum(0)[None]


def probe_b_cuda(coh):
    """Launch kernel #8 (``csrc/kbisect_b.cu``): (1, 8, rows) f32.
    Replaces ``kbisect.py``'s ``variant_b``."""
    from sagecal_tpu_torch.kernels.build import load

    _one_channel(coh)
    mp, _, _, rows = coh.shape
    _check_tensors(coh.device, {"coh": (coh, (mp, 1, 8, rows), _F32)})
    out = torch.empty((1, 8, rows), dtype=torch.float32, device=coh.device)
    _raise_on(load("kbisect_b").kbisect_b(
        coh.data_ptr(), mp, rows, out.data_ptr(), _stream(coh)), "kbisect_b")
    probe_b_cuda.launches += 1
    return out


def probe_b(coh):
    """Probe b's output (module doc) before the sum."""
    if _on_cuda(coh):
        return probe_b_cuda(coh)
    return probe_b_plain(coh)


# ------------------------------------------ #9 and #10: the gather probes
#
# Probes a and f depend on a column only through its station, so each
# kernel reduces the table per station first ("sums": a (npad, 4), f
# (npad,)) and gathers second, in one of two forms: two launches (the
# reduction into "sums", then the gather; ``stages`` 3, or bit 1 and bit 2
# one at a time on a ``scratch`` dict), or one launch in which every block
# reduces the whole table into its own shared memory before its gather
# (``stages`` 4; npad up to the kernel's ``*_one_launch_max_npad``).
# ``stages=None`` takes the kernel's default for the shape
# (``*_default_stages``): one launch where few blocks each reduce a small
# table, two otherwise (as measured on the H100: PERF.md).


def _gather_buffers(lib, name: str, mp: int, npad: int, cols: int, stages,
                    scratch, shapes: dict, dev):
    """(stages, buffers) of one gather-probe launch: ``stages`` resolved
    (None -> the kernel's default for mp, npad and ``cols`` columns), and
    ``scratch`` (filled on first use and reused) or new buffers.
    ValueError for a stage value other than 1-4, for a partial launch (1
    or 2) without ``scratch``, and for the one-launch form above its
    npad."""
    if stages is None:
        stages = getattr(lib, f"kbisect_{name}_default_stages")(mp, npad,
                                                                  cols)
    if stages not in (1, 2, 3, 4):
        raise ValueError(f"stages {stages}: 1 reduce, 2 gather, 3 both, "
                         f"4 the one-launch form")
    if stages in (1, 2) and scratch is None:
        raise ValueError(f"stages {stages} launches half of the probe and "
                         f"leaves its output unwritten: pass the scratch "
                         f"dict it fills")
    cap = getattr(lib, f"kbisect_{name}_one_launch_max_npad")()
    if stages == 4 and npad > cap:
        raise ValueError(f"the one-launch form holds at most {cap} stations "
                         f"in shared memory, got npad {npad}")
    return stages, _scratch(scratch, shapes, dev)


# ------------------------------------------------------- #9: variant a


def _revisits(antp) -> int:
    n = antp.shape[-1]
    if antp.ndim != 2 or antp.shape[0] != 1 or n % T:
        raise ValueError(f"antp {tuple(antp.shape)} is not (1, R * {T})")
    return n // T


def probe_a_plain(antp, tab):
    """Plain version of probe a: (1, 4, T) f32, T (the TPU grid's row
    block) read from the module."""
    _revisits(antp)
    rows, npad = tab.shape
    idx, valid = _in_range(antp, npad)
    g = torch.where(valid, tab.index_select(1, idx), 0.0)  # (4 mp, R T)
    return g.reshape(rows // 4, 4, -1, T).sum(0).sum(1)[None]


def probe_a_cuda(antp, tab, stages=None, scratch=None):
    """Launch kernel #9 (``csrc/kbisect_a.cu``): (1, 4, T) f32.
    Replaces ``kbisect.py``'s ``variant_a``.  ``stages`` and ``scratch``:
    the form of the launch (the gather probes' section)."""
    from sagecal_tpu_torch.kernels.build import load

    nrev = _revisits(antp)
    rows, npad = tab.shape
    if rows % 4:
        raise ValueError(f"tab rows {rows} are not 4 per cluster")
    _check_tensors(antp.device, {"antp": (antp, (1, nrev * T), _I32),
                                 "tab": (tab, (rows, npad), _F32)})
    lib = load("kbisect_a")
    stages, bufs = _gather_buffers(
        lib, "a", rows // 4, npad, T, stages, scratch,
        {"sums": (npad, 4), "out": (1, 4, T)}, antp.device)
    _raise_on(lib.kbisect_a(
        antp.data_ptr(), tab.data_ptr(), rows // 4, npad, nrev, T, stages,
        bufs["sums"].data_ptr(), bufs["out"].data_ptr(), _stream(antp)),
        "kbisect_a")
    probe_a_cuda.launches += 1
    return bufs["out"]


def probe_a(antp, tab):
    """Probe a's output (module doc) before the sum."""
    if _on_cuda(antp, tab):
        return probe_a_cuda(antp, tab)
    return probe_a_plain(antp, tab)


# ------------------------------------------------------ #10: variant f


def probe_f_plain(antp, tab):
    """Plain version of probe f: (1, T) f32."""
    idx, valid = _in_range(antp, tab.shape[2])
    g = torch.where(valid, tab.index_select(2, idx), 0.0)  # (4, mp, T)
    return (g[0] * g[1] + g[2] * g[3]).sum(0, keepdim=True)


def probe_f_cuda(antp, tab, stages=None, scratch=None):
    """Launch kernel #10 (``csrc/kbisect_f.cu``): (1, T) f32.  Replaces
    ``kbisect.py``'s ``variant_f``.  ``stages`` and ``scratch``: the form
    of the launch (the gather probes' section)."""
    from sagecal_tpu_torch.kernels.build import load

    cols = antp.shape[-1]
    mp, npad = (tab.shape[1], tab.shape[2]) if tab.ndim == 3 else (-1, -1)
    _check_tensors(antp.device, {"antp": (antp, (1, cols), _I32),
                                 "tab": (tab, (4, mp, npad), _F32)})
    lib = load("kbisect_f")
    stages, bufs = _gather_buffers(
        lib, "f", mp, npad, cols, stages, scratch,
        {"sums": (npad,), "out": (1, cols)}, antp.device)
    _raise_on(lib.kbisect_f(
        antp.data_ptr(), tab.data_ptr(), mp, npad, cols, stages,
        bufs["sums"].data_ptr(), bufs["out"].data_ptr(), _stream(antp)),
        "kbisect_f")
    probe_f_cuda.launches += 1
    return bufs["out"]


def probe_f(antp, tab):
    """Probe f's output (module doc) before the sum."""
    if _on_cuda(antp, tab):
        return probe_f_cuda(antp, tab)
    return probe_f_plain(antp, tab)


for _launcher in (probe_a_cuda, probe_b_cuda, probe_c_cuda, probe_f_cuda):
    _launcher.launches = 0


# ------------------------------------------------------------ variants


def _to(device, *arrays):
    dev = resolve_device(device)
    return tuple(torch.from_numpy(x).to(dev) for x in arrays)


def variant_c(device=None):
    """No grid: dense product + component-pair reduce (probe #7)."""
    rng = np.random.default_rng(0)
    tab = rng.standard_normal((4 * MP, NPAD)).astype(np.float32)
    oh = rng.standard_normal((NPAD, T)).astype(np.float32)
    return (lambda tab, oh: probe_c(tab, oh).sum()), _to(device, tab, oh)


def variant_b(device=None):
    """Grid over rows, 4D coh block + middle-index slicing + reduce
    (probe #8)."""
    rng = np.random.default_rng(0)
    coh = rng.standard_normal((MP, F, 8, R * T)).astype(np.float32)
    return (lambda coh: probe_b(coh).sum()), _to(device, coh)


def variant_a(device=None):
    """int32 input + one-hot selection + output revisit accumulation
    across the grid (probe #9)."""
    rng = np.random.default_rng(0)
    antp = rng.integers(0, 62, (1, R * T)).astype(np.int32)
    tab = rng.standard_normal((4 * MP, NPAD)).astype(np.float32)
    return (lambda antp, tab: probe_a(antp, tab).sum()), _to(device, antp, tab)


def _predict_inputs(device):
    rng = np.random.default_rng(0)
    coh = rng.standard_normal((MP, F, 8, R * T)).astype(np.float32)
    tre = rng.standard_normal((4, MP, NPAD)).astype(np.float32)
    tim = rng.standard_normal((4, MP, NPAD)).astype(np.float32)
    antp = rng.integers(0, 62, (1, R * T)).astype(np.int32)
    antq = rng.integers(0, 62, (1, R * T)).astype(np.int32)
    return _to(device, tre, tim, coh, antp, antq)


def variant_d(device=None):
    """The fused predict forward (kernel #1) at tiny shape."""
    def f(tre, tim, coh, antp, antq):
        return fused_predict_packed(tre, tim, coh, antp, antq).sum()

    return f, _predict_inputs(device)


def variant_e(device=None):
    """The fused predict backward (kernel #2, under an all-ones
    cotangent) at tiny shape."""
    def f(tre, tim, coh, antp, antq):
        a = tre.detach().requires_grad_(True)
        b = tim.detach().requires_grad_(True)
        loss = fused_predict_packed(a, b, coh, antp, antq).sum()
        ga, gb = torch.autograd.grad(loss, (a, b))
        return ga.sum() + gb.sum()

    return f, _predict_inputs(device)


def variant_f(device=None):
    """Reshape-free gains: component-major tables, one selection per
    component (probe #10)."""
    rng = np.random.default_rng(0)
    antp = rng.integers(0, 62, (1, T)).astype(np.int32)
    tab = rng.standard_normal((4, MP, NPAD)).astype(np.float32)
    return (lambda antp, tab: probe_f(antp, tab).sum()), _to(device, antp, tab)


VARIANTS = {"a": variant_a, "b": variant_b, "c": variant_c,
            "d": variant_d, "e": variant_e, "f": variant_f}


def run(names, device=None) -> dict:
    """Run the named variants in order on ``device`` (None: CUDA),
    printing the JAX tool's two lines for each; returns {name: {"val",
    "seconds"}} (seconds include the first call's kernel build)."""
    out = {}
    for name in names:
        print(f"[{name}] building...", flush=True)
        f, args = VARIANTS[name](device)
        t0 = time.perf_counter()
        v = float(f(*args))
        secs = time.perf_counter() - t0
        print(f"[{name}] ok: {secs:.1f}s val={v:.5g}", flush=True)
        out[name] = {"val": v, "seconds": secs}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", choices=sorted(VARIANTS),
                    help="variants to run, in order")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device (torch.cuda.is_available() is False): the "
                 "probes run on the card only")
    run(args.variants)


if __name__ == "__main__":
    main()
