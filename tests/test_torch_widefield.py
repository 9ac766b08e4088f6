"""Port vs JAX package: the ``widefield`` app (``apps/widefield.py``).

Both apps on the same synthetic wide field (300 point sources in 6
blobs, 6 stations of the compact 30 MHz array, two tiles, 3 effective
clusters) at f64: ``widefield.json`` (every number of the JAX package's
keys, the per-tile seconds aside) and ``solutions.npz`` within 1e-8 in
mode 1 (LM + LBFGS).  Mode 3 draws its OS-LM subsets from another
generator (ROADMAP.md, Queue C), so there the port is held to
converging and to the a-priori bound.
"""

import json

import numpy as np
import pytest

from torch_port_common import free_jax_programs  # noqa: F401

ARGV = ["-n", "6", "--ntiles", "2", "-t", "2", "-S", "300", "--nblobs", "6",
        "-k", "3", "--nchan", "1", "-e", "1", "-g", "2", "-l", "4"]


def _summary(d):
    with open(d / "widefield.json") as fh:
        return json.load(fh)


def _num_close(a, b, tol):
    if isinstance(b, float):
        assert abs(a - b) <= tol * max(abs(b), 1e-300) or abs(a - b) <= 1e-14
    else:
        assert a == b


def test_widefield_app_matches_jax(tmp_path):
    from sagecal_tpu.apps.widefield import main as jmain
    from sagecal_tpu_torch.apps.widefield import main

    tdir, jdir = tmp_path / "t", tmp_path / "j"
    assert main(ARGV + ["-j", "1", "--out-dir", str(tdir)], device="cpu") == 0
    assert jmain(ARGV + ["-j", "1", "--out-dir", str(jdir)]) == 0
    a, b = _summary(tdir), _summary(jdir)
    for k, v in b.items():
        if k in ("tiles", "seconds"):
            continue
        if k == "hier_max_rel_err":
            assert abs(a[k] - v) <= 1e-10
        else:
            _num_close(a[k], v, 1e-8)
    for ta, tb in zip(a["tiles"], b["tiles"]):
        for k, v in tb.items():
            if k == "seconds":
                continue
            if k == "rel_err":
                assert abs(ta[k] - v) <= 1e-10
            else:
                _num_close(ta[k], v, 1e-8)
        assert min(ta["plan_s"], ta["predict_s"], ta["solve_s"]) >= 0.0
    ga = np.load(tdir / "solutions.npz")
    gb = np.load(jdir / "solutions.npz")
    np.testing.assert_array_equal(ga["cluster_sizes"], gb["cluster_sizes"])
    np.testing.assert_allclose(ga["gains"], gb["gains"], rtol=0,
                               atol=1e-8 * np.abs(gb["gains"]).max())
    assert a["hier_watchdog_ok"] and a["hier_max_rel_err"] < a[
        "apriori_bound"]


@pytest.mark.parametrize("extra", [["-j", "3"], ["-j", "1", "--exact"]])
def test_widefield_app_converges(tmp_path, extra):
    """Mode 3 (OS-LM subsets from the port's generator) and the exact
    predict: every tile's residual falls, the sampled error stays under
    the a-priori bound (none is sampled under --exact)."""
    from sagecal_tpu_torch.apps.widefield import main

    assert main(ARGV + extra + ["--out-dir", str(tmp_path)],
                device="cpu") == 0
    s = _summary(tmp_path)
    for tile in s["tiles"]:
        assert tile["res_1"] < tile["res_0"]
        assert tile["solve_verdict"] == "ok"
    if "--exact" in extra:
        assert s["hier_max_rel_err"] is None
        assert all(t["rel_err"] is None for t in s["tiles"])
    else:
        assert s["hier_max_rel_err"] < s["apriori_bound"]


def test_widefield_abort_exits_3(tmp_path, monkeypatch, capsys):
    """--abort-on-divergence with a residual-ratio guard no solve can
    meet (the test lowers it): exit 3 with the abort event."""
    import sagecal_tpu_torch.apps.widefield as wf

    cfg_of = wf.config_from_args

    def strict(args):
        cfg = cfg_of(args)
        cfg.res_ratio = 1e-9
        return cfg

    monkeypatch.setattr(wf, "config_from_args", strict)
    rc = wf.main(ARGV + ["-j", "1", "--ntiles", "1", "--abort-on-divergence",
                         "--out-dir", str(tmp_path)], device="cpu")
    assert rc == 3
    assert "diverged" in capsys.readouterr().err
