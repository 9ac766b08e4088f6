"""torchlint command line: argument parsing, baseline gate, exit codes
(counterpart of ``sagecal_tpu/analysis/cli.py``).

Exit codes: 0 clean (or all findings baselined / report-only), 1 new
gate findings, 2 usage error (an unknown rule, a rule of the JAX
package with no counterpart here, a missing path).  Reached two ways
with identical semantics:

- ``python -m sagecal_tpu_torch.analysis [paths...]``
- ``python -m sagecal_tpu_torch.apps.cli diag lint [paths...]``

With no paths it lints the installed ``sagecal_tpu_torch`` (its Python
modules and ``csrc/``) against the in-package baseline
``analysis/lint_baseline.json``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence

from sagecal_tpu_torch.analysis import baseline as baseline_mod
from sagecal_tpu_torch.analysis import engine
from sagecal_tpu_torch.analysis.rules import NO_COUNTERPART


def default_paths() -> List[str]:
    """The installed package, when invoked with no paths."""
    return [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="torchlint",
        description="AST-based PyTorch/CUDA-discipline analyzer for the "
                    "sagecal-tpu port",
    )
    p.add_argument("paths", nargs="*",
                   help="files or directories to lint, .py and .cu "
                        "(default: the sagecal_tpu_torch package)")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="report format (default: text)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="baseline JSON of recorded findings (default: "
                        "the package's analysis/lint_baseline.json)")
    p.add_argument("--update-baseline", action="store_true",
                   help="write current findings to the baseline file "
                        "(keeping each recorded why) and exit 0")
    p.add_argument("--rules", default=None, metavar="IDS",
                   help="comma-separated rule ids to run "
                        "(default: all, e.g. JL002,JL014)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def select_rules(spec: Optional[str]):
    """The rules ``spec`` names (all when None); raises ValueError with
    the reason for an unknown id or one with no counterpart."""
    rules = engine.default_rules()
    if spec is None:
        return rules
    wanted = {r.strip().upper() for r in spec.split(",") if r.strip()}
    absent = sorted(wanted & set(NO_COUNTERPART))
    if absent:
        raise ValueError("; ".join(
            f"torchlint: {rid} has no counterpart in the port: "
            f"{NO_COUNTERPART[rid]}" for rid in absent))
    known = {r.id for r in rules}
    unknown = wanted - known
    if unknown:
        raise ValueError(
            f"torchlint: unknown rule id(s): {', '.join(sorted(unknown))} "
            f"(known: {', '.join(sorted(known))})")
    return [r for r in rules if r.id in wanted]


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for r in engine.default_rules():
            tag = " [report-only]" if r.report_only else ""
            print(f"{r.id}  {r.title}{tag}")
        for rid, why in sorted(NO_COUNTERPART.items()):
            print(f"{rid}  (no counterpart: {why})")
        return 0

    try:
        rules = select_rules(args.rules)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2

    paths = list(args.paths) or default_paths()
    for p in paths:
        if not os.path.exists(p):
            print(f"torchlint: no such path: {p}", file=sys.stderr)
            return 2

    findings, stats, _graph = engine.analyze_paths(paths, rules)
    baseline_path = args.baseline or baseline_mod.DEFAULT_BASELINE

    if args.update_baseline:
        baseline_mod.save_baseline(baseline_path, findings)
        n = sum(1 for f in findings if not f.report_only)
        print(f"torchlint: wrote {n} finding(s) + {len(findings) - n} "
              f"report-only to {baseline_path}")
        return 0

    new, old = baseline_mod.partition(
        findings, baseline_mod.load_baseline(baseline_path))
    new_keys = {f.key() for f in new}
    if args.format == "json":
        print(engine.format_json(findings, stats, new_keys, len(old)))
    else:
        print(engine.format_text(findings, stats, new_keys, len(old)))
    return 1 if new else 0


def run(argv: Optional[Sequence[str]] = None) -> int:
    """Console entry: :func:`main`, but a closed stdout pipe
    (``torchlint ... | head``) exits 141 instead of a traceback."""
    try:
        return main(argv if argv is not None else sys.argv[1:])
    except BrokenPipeError:
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 141
