"""Save a checkout's kbisect probe outputs, and compare two saves bit for
bit: whether a redesigned probe kernel keeps its predecessor's bits.

Run as a file (not with ``-m``), on a machine with one CUDA card::

    python3 sagecal_tpu_torch/tools/probe_outputs.py save DIR FILE
    python3 sagecal_tpu_torch/tools/probe_outputs.py compare FILE_A FILE_B

``save`` imports DIR's own package and ``chip_smoke.py`` (DIR first on
the import path, as ``smoke_phases.py`` does), draws each probe's inputs
with that package's ``kernels.parity.random_probe_inputs`` from a CUDA
generator seeded 0 at the script's probe shapes (``BISECT_SHAPES``:
kbisect's own and the north-star width), calls the probe's wrapper on
the card, and saves the outputs with ``torch.save``.  ``compare``
prints, for each probe and shape, whether the two saves are bitwise
equal and their max abs difference, and exits 1 if any output is
missing from either save.
"""

import argparse
import importlib
import os
import sys

import torch

PROBES = ("c", "b", "a", "f")


def save(root: str, path: str):
    root = os.path.abspath(root)
    path = os.path.abspath(path)
    sys.path[0] = root  # this file's own directory would come first
    parity = importlib.import_module("sagecal_tpu_torch.kernels.parity")
    kb = importlib.import_module("sagecal_tpu_torch.tools.kbisect")
    shapes = importlib.import_module("chip_smoke").BISECT_SHAPES
    out = {}
    for shape, probes in shapes.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        for name in PROBES:
            inputs = parity.random_probe_inputs(name, gen, **probes[name])
            out[f"{name} {shape}"] = getattr(kb, f"probe_{name}")(
                *inputs).cpu()
    torch.save(out, path)
    print(f"[probe-outputs] {root}: {len(out)} outputs saved to {path}")


def compare(path_a: str, path_b: str) -> int:
    a, b = torch.load(path_a), torch.load(path_b)
    missing = sorted(set(a) ^ set(b))
    for key in sorted(set(a) & set(b)):
        diff = float((a[key].double() - b[key].double()).abs().max())
        print(f"[probe-outputs] {key}: bitwise equal "
              f"{torch.equal(a[key], b[key])}, max abs difference {diff:.3e}")
    if missing:
        print(f"[probe-outputs] in one save only: {missing}")
    return 1 if missing else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser("save")
    sv.add_argument("dir")
    sv.add_argument("file")
    cp = sub.add_parser("compare")
    cp.add_argument("file_a")
    cp.add_argument("file_b")
    args = ap.parse_args(argv)
    if args.cmd == "save":
        if not torch.cuda.is_available():
            sys.exit("no CUDA device (torch.cuda.is_available() is False)")
        save(args.dir, args.file)
    else:
        sys.exit(compare(args.file_a, args.file_b))


if __name__ == "__main__":
    main()
