"""The port's kbisect tool (``sagecal_tpu_torch/tools/kbisect.py``)
against the root ``kbisect.py`` on the CPU.

The JAX probes run in Pallas interpret mode (exact f32); the port's
probes take their plain PyTorch versions on CPU tensors.  Tolerances:
the six variant values within 1e-5 relative (f32 sums of up to 4,096
terms in another order; variant d's JAX value is itself 3.9e-6 from its
float64 value); every plain output within 1e-6 of its max abs of a
float64 numpy evaluation of its formula.
"""

import numpy as np
import pytest
import torch

import kbisect as jk
from sagecal_tpu_torch.kernels import parity
from sagecal_tpu_torch.tools import kbisect as tk

NAMES = ("c", "b", "a", "d", "e", "f")
PROBES = ("c", "b", "a", "f")


def _jax_value(name):
    f, args = jk.VARIANTS[name]()
    return float(np.asarray(f(*args))), args


@pytest.fixture(scope="module")
def jax_values():
    """Each JAX variant's (value, numpy inputs), computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _jax_value(name)
        return cache[name]

    return get


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("name", NAMES)
def test_variant_inputs_are_kbisects_bytes(name, jax_values):
    _, jargs = jax_values(name)
    _, targs = tk.VARIANTS[name]("cpu")
    assert len(jargs) == len(targs)
    for j, t in zip(jargs, targs):
        j = np.asarray(j)
        assert t.device.type == "cpu"
        assert j.dtype == t.numpy().dtype and j.shape == tuple(t.shape)
        assert j.tobytes() == t.numpy().tobytes()


@pytest.mark.parametrize("name", NAMES)
def test_variant_values_match_jax(name, jax_values):
    want, _ = jax_values(name)
    f, args = tk.VARIANTS[name]("cpu")
    assert _rel(f(*args), want) <= 1e-5


@pytest.mark.parametrize("name", NAMES)
def test_recorded_jax_values_are_jaxs_live_output(name, jax_values):
    want, _ = jax_values(name)
    assert _rel(parity.KBISECT_JAX_VALUES[name], want) <= 1e-6


@pytest.mark.parametrize("name", PROBES)
def test_probes_match_jax_at_patched_shapes(name, monkeypatch):
    """MP 16 and R 3, set in both modules as the tools read them."""
    for mod in (jk, tk):
        monkeypatch.setattr(mod, "MP", 16)
        monkeypatch.setattr(mod, "R", 3)
    want, jargs = _jax_value(name)
    f, targs = tk.VARIANTS[name]("cpu")
    assert tuple(targs[-1].shape) == np.asarray(jargs[-1]).shape
    assert _rel(f(*targs), want) <= 1e-5


@pytest.mark.parametrize("name", ["a", "f"])
def test_out_of_range_indices_select_nothing_as_in_jax(name):
    """Station indices -1, NPAD and 200 mixed into seeded inputs: the
    JAX one-hot selects nothing for them, and so does the port."""
    gen = torch.Generator().manual_seed(3)
    inputs = parity.random_probe_inputs(name, gen, mp=tk.MP, T=tk.T,
                                        R=tk.R if name == "a" else 1)
    (antp, tab), zero = parity.mix_out_of_range(name, inputs)
    jf, _ = jk.VARIANTS[name]()
    want = float(np.asarray(jf(antp.numpy(), tab.numpy())))
    tf, _ = tk.VARIANTS[name]("cpu")
    assert _rel(tf(antp, tab), want) <= 1e-5
    assert int(zero.sum()) > 0


def test_probe_b_is_defined_for_one_channel_only(monkeypatch):
    for mod in (jk, tk):
        monkeypatch.setattr(mod, "F", 2)
    jf, jargs = jk.variant_b()
    with pytest.raises(ValueError):
        jf(*jargs)
    tf, targs = tk.variant_b("cpu")
    with pytest.raises(ValueError):
        tf(*targs)


def _formula64(name, inputs):
    """Float64 numpy evaluation of each probe's formula (module doc of
    the tool), out-of-range station indices selecting nothing."""
    x = [np.asarray(t, dtype=np.float64) if t.dtype == torch.float32
         else np.asarray(t) for t in inputs]
    if name == "c":
        tab, oh = x
        g = (tab @ oh).reshape(tab.shape[0] // 4, 4, -1)
        return (g[:, 0] * g[:, 1] + g[:, 2] * g[:, 3]).sum(0)[None]
    if name == "b":
        return (x[0][:, 0] ** 2).sum(0)[None]
    antp, tab = x
    a = antp.reshape(-1)
    ok = (a >= 0) & (a < tab.shape[-1])
    sel = np.where(ok, tab[..., np.where(ok, a, 0)], 0.0)
    if name == "a":
        return sel.reshape(tab.shape[0] // 4, 4, -1, tk.T).sum((0, 2))[None]
    return (sel[0] * sel[1] + sel[2] * sel[3]).sum(0)[None]


@pytest.mark.parametrize("name", PROBES)
def test_plain_versions_match_their_formula_in_f64(name, monkeypatch):
    monkeypatch.setattr(tk, "T", 64)
    gen = torch.Generator().manual_seed(1)
    inputs = parity.random_probe_inputs(name, gen, mp=13, T=tk.T, R=3,
                                        npad=100)
    zero = None
    if name in ("a", "f"):
        inputs, zero = parity.mix_out_of_range(name, inputs)
    got = getattr(tk, f"probe_{name}")(*inputs)
    want = _formula64(name, inputs)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    if zero is not None:
        assert (got[..., zero] == 0).all()


@pytest.mark.parametrize("name", PROBES)
def test_cpu_wrappers_take_the_plain_version_and_launchers_refuse_cpu(
        name, monkeypatch):
    monkeypatch.setattr(tk, "T", 32)
    gen = torch.Generator().manual_seed(2)
    inputs = parity.random_probe_inputs(name, gen, mp=3, T=tk.T, R=2)
    launcher = getattr(tk, f"probe_{name}_cuda")
    before = launcher.launches
    out = getattr(tk, f"probe_{name}")(*inputs)
    plain = getattr(tk, f"probe_{name}_plain")(*inputs)
    assert torch.equal(out, plain)
    assert launcher.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        launcher(*inputs)


@pytest.mark.parametrize("name", PROBES)
def test_library_call_computes_the_probes_function(name):
    """``probe_library_call`` (timed beside each kernel on the card) is
    the probe's whole function in one PyTorch call, for c and b; a and f
    have none."""
    gen = torch.Generator().manual_seed(4)
    inputs = parity.random_probe_inputs(name, gen, mp=13, T=tk.T, R=3,
                                        npad=100)
    lib = parity.probe_library_call(name, inputs)
    if name in ("a", "f"):
        assert lib is None
        return
    got = lib()
    want = _formula64(name, inputs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("name", ["a", "f"])
def test_least_work_route_computes_the_probes_function(name, monkeypatch):
    """The work ``kbisect_work`` counts for a and f (the bound chip_smoke
    prints) is enough for their function: one reduction of the table per
    station, then 4 gathered words (a) or 1 (f) per in-range index, give
    the formula's output, out-of-range indices included."""
    monkeypatch.setattr(tk, "T", 64)
    gen = torch.Generator().manual_seed(5)
    inputs = parity.random_probe_inputs(name, gen, mp=13, T=tk.T, R=3,
                                        npad=100)
    (antp, tab), _ = parity.mix_out_of_range(name, inputs)
    a = antp.numpy().reshape(-1)
    ok = (a >= 0) & (a < tab.shape[-1])
    t64 = tab.numpy().astype(np.float64)
    if name == "a":
        per_station = t64.reshape(-1, 4, t64.shape[-1]).sum(0)  # (4, npad)
        picked = np.where(ok, per_station[:, np.where(ok, a, 0)], 0.0)
        got = picked.reshape(4, -1, tk.T).sum(1)[None]
    else:
        per_station = (t64[0] * t64[1] + t64[2] * t64[3]).sum(0)  # (npad,)
        got = np.where(ok, per_station[np.where(ok, a, 0)], 0.0)[None]
    want = _formula64(name, (antp, tab))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    nbytes, flops, gathers = parity.kbisect_work(name, (antp, tab))
    words = 4 if name == "a" else 1
    out_words = 4 * tk.T if name == "a" else a.size
    assert gathers == words * int(ok.sum())
    assert flops == tab.numel() + (gathers if name == "a" else 0)
    assert nbytes == 4 * (antp.numel() + tab.numel() + out_words)


class _GatherLib:
    """The two shape functions of a gather probe's library, as the
    kernels define them (``csrc/kbisect_a.cu``, ``kbisect_f.cu``)."""

    def __init__(self, name):
        self.name, self.cap = name, {"a": 2048, "f": 12288}[name]

    def __getattr__(self, fn):
        if fn.endswith("_one_launch_max_npad"):
            return lambda: self.cap
        return lambda mp, npad, T: 4 if mp * npad <= 4096 else 3


@pytest.mark.parametrize("name", ["a", "f"])
@pytest.mark.parametrize("stages,with_scratch,error", [
    (0, False, "1 reduce"), (5, False, "1 reduce"),
    (1, False, "scratch"), (2, False, "scratch"),
    (4, False, None), (3, False, None), (1, True, None), (None, False, None)])
def test_gather_probe_launch_forms_are_checked(name, stages, with_scratch,
                                               error):
    """The gather probes' launch forms (#9/#10): stage values 1-4 only, a
    half launch only with the scratch it fills, the one-launch form only
    up to its npad; None takes the library's default; a scratch dict is
    filled with the buffers and reused."""
    shapes = {"sums": (100, 4) if name == "a" else (100,), "out": (1, 8)}
    scratch = {} if with_scratch else None
    lib = _GatherLib(name)
    if error:
        with pytest.raises(ValueError, match=error):
            tk._gather_buffers(lib, name, 8, 100, 8, stages, scratch, shapes,
                               "cpu")
        return
    got, bufs = tk._gather_buffers(lib, name, 8, 100, 8, stages, scratch,
                                   shapes, "cpu")
    assert got == (4 if stages is None else stages)
    assert {k: tuple(v.shape) for k, v in bufs.items()} == shapes
    if scratch is not None:
        assert bufs is scratch
        again, _ = tk._gather_buffers(lib, name, 8, 100, 8, stages, scratch,
                                      shapes, "cpu")
        assert scratch["sums"] is bufs["sums"] and again == stages
    with pytest.raises(ValueError, match="one-launch"):
        tk._gather_buffers(lib, name, 8, lib.cap + 1, 8, 4, None,
                           shapes, "cpu")


def test_probe_outputs_compare_reports_bits(tmp_path, capsys):
    """``tools/probe_outputs.py compare``: bitwise equality and the max
    abs difference of each saved output; exit 1 when a save lacks one."""
    from sagecal_tpu_torch.tools import probe_outputs

    x = torch.arange(6, dtype=torch.float32)
    a, b, c = (str(tmp_path / f"{n}.pt") for n in "abc")
    torch.save({"f kbisect": x, "a kbisect": x}, a)
    torch.save({"f kbisect": x.clone(), "a kbisect": x + 0.5}, b)
    torch.save({"f kbisect": x}, c)
    assert probe_outputs.compare(a, b) == 0
    out = capsys.readouterr().out
    assert "f kbisect: bitwise equal True, max abs difference 0.000e+00" in out
    assert "a kbisect: bitwise equal False, max abs difference 5.000e-01" in out
    assert probe_outputs.compare(a, c) == 1


def test_run_prints_an_ok_line_for_each_variant(capsys):
    out = tk.run(list(NAMES), device="cpu")
    lines = capsys.readouterr().out.splitlines()
    for name in NAMES:
        assert f"[{name}] building..." in lines
        assert any(ln.startswith(f"[{name}] ok: ") and "val=" in ln
                   for ln in lines)
        assert _rel(out[name]["val"], parity.KBISECT_JAX_VALUES[name]) <= 1e-5


def test_cli_exits_nonzero_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tk.main(["c", "b"])
    assert exc.value.code not in (0, None)
