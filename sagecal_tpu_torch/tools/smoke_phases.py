"""Wall time of each phase of a checkout's ``chip_smoke.py``.

Run as a file (not with ``-m``), on a machine with one CUDA card::

    python3 sagecal_tpu_torch/tools/smoke_phases.py [DIR] [--phases-out FILE]
        [chip_smoke.py's arguments]

It imports ``chip_smoke.py`` from DIR (default: the current directory),
with DIR first on the import path so that the script runs on that
checkout's own package, wraps each phase that the script's ``main``
calls with a wall clock, and runs ``main`` with the arguments that are
not this tool's (give paths absolute: the run is from DIR).  After the
script's own output it prints one line ``[phases] {...}``: the seconds of
each phase in the order they ran, and ``rest``, the run's seconds outside
them.  Two checkouts (a parent and a change) are timed the same way, so
their lines compare phase by phase.  ``--phases-out`` also writes the
line's object to FILE.
"""

import argparse
import importlib
import json
import os
import sys
import time

# the phases chip_smoke.main calls, in order; a name a checkout lacks is
# skipped
PHASES = ("phase_device", "phase_build", "phase_parity", "main_tile",
          "phase_main", "phase_warm", "phase_extended", "phase_fullbatch",
          "phase_elastic", "phase_stream", "phase_beam", "phase_predict",
          "phase_bisect",
          "phase_times", "serve_parity", "phase_serve", "serve_times",
          "phase_service", "phase_fleet", "phase_load", "phase_audit",
          "phase_distributed", "phase_minibatch",
          "phase_spatial", "phase_federated", "phase_spatial_app",
          "phase_sharded", "phase_multihost", "phase_widefield",
          "phase_refine", "phase_tools")


def timed(module, seconds: dict):
    """Wrap ``module``'s phase functions so that each adds its wall
    seconds to ``seconds``; a phase called from inside another (the warm
    phase builds its tile with ``main_tile``) counts in the outer one
    only."""
    running = []
    for name in PHASES:
        fn = getattr(module, name, None)
        if fn is None:
            continue

        def run(*args, _fn=fn, _name=name, **kwargs):
            if running:
                return _fn(*args, **kwargs)
            running.append(_name)
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                running.pop()
                seconds[_name] = (seconds.get(_name, 0.0)
                                  + time.perf_counter() - t0)

        setattr(module, name, run)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir", nargs="?", default=".",
                    help="checkout whose chip_smoke.py to run")
    ap.add_argument("--phases-out", default=None,
                    help="also write the phases' seconds to this file")
    args, rest = ap.parse_known_args(argv)
    root = os.path.abspath(args.dir)
    out = os.path.abspath(args.phases_out) if args.phases_out else None
    sys.path[0] = root  # this file's own directory would come first
    os.chdir(root)
    smoke = importlib.import_module("chip_smoke")
    seconds = {}
    timed(smoke, seconds)
    sys.argv = [os.path.join(root, "chip_smoke.py")] + rest
    t0 = time.perf_counter()
    try:
        smoke.main()
    finally:
        seconds["rest"] = time.perf_counter() - t0 - sum(seconds.values())
        print("[phases] " + json.dumps(seconds), flush=True)
        if out:
            with open(out, "w") as fh:
                json.dump(seconds, fh, indent=1)


if __name__ == "__main__":
    main()
