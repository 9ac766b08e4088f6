"""Fault-injection harness: prove elastic resume by killing real runs
(counterpart of ``sagecal_tpu/elastic/faultinject.py``, copied).

The harness runs a calibration as a subprocess (so SIGTERM exercises the
real signal path: ``obs/flight.py``'s handler runs the crash flushers —
final checkpoint write, event-log ``run_aborted`` — then re-delivers the
signal), kills it at a tile boundary (just after the Nth checkpoint
lands) or mid-solve (after a chosen delay), re-runs it with ``--resume``
and compares the end-state files byte for byte against an uninterrupted
run.  :func:`cli_argv` gives the port's CLI as the subprocess:
``python -m sagecal_tpu_torch.apps.cli``.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from sagecal_tpu_torch.elastic.checkpoint import list_checkpoints


def cli_argv(args: Sequence[str]) -> List[str]:
    """The port's CLI with ``args``, as a subprocess command line."""
    return [sys.executable, "-m", "sagecal_tpu_torch.apps.cli", *args]


def run_subprocess(
    args: Sequence[str],
    env: Optional[Dict[str, str]] = None,
    timeout: float = 600.0,
    cwd: Optional[str] = None,
) -> Tuple[int, str, str]:
    """Run a command to completion.  Returns (returncode, stdout, stderr)."""
    full_env = dict(os.environ)
    if env:
        full_env.update(env)
    r = subprocess.run(
        list(args), env=full_env, timeout=timeout, cwd=cwd,
        capture_output=True, text=True,
    )
    return r.returncode, r.stdout, r.stderr


def _spawn(args, env, cwd):
    full_env = dict(os.environ)
    if env:
        full_env.update(env)
    return subprocess.Popen(
        list(args), env=full_env, cwd=cwd,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def _finish(proc, timeout: float) -> Tuple[int, str, str]:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out or "", err or ""


def kill_at_checkpoint(
    args: Sequence[str],
    ckpt_dir: str,
    n_checkpoints: int,
    sig: int = signal.SIGTERM,
    env: Optional[Dict[str, str]] = None,
    timeout: float = 600.0,
    poll: float = 0.1,
    cwd: Optional[str] = None,
) -> Tuple[int, str, str]:
    """Start the run, send ``sig`` as soon as ``n_checkpoints``
    checkpoints exist in ``ckpt_dir`` — i.e. kill at a tile boundary,
    right after a checkpoint landed.  Retention may cap the visible
    count (CheckpointManager keep=2), so the trigger counts DISTINCT
    tile indices ever observed, not files currently on disk.  If the
    run finishes before the trigger fires, its natural exit is returned
    (the caller should then pick a smaller ``n_checkpoints``)."""
    proc = _spawn(args, env, cwd)
    seen: set = set()
    deadline = time.monotonic() + timeout
    while proc.poll() is None and time.monotonic() < deadline:
        for p in list_checkpoints(ckpt_dir):
            seen.add(os.path.basename(p))
        if len(seen) >= n_checkpoints:
            proc.send_signal(sig)
            break
        time.sleep(poll)
    return _finish(proc, max(deadline - time.monotonic(), 5.0))


def kill_after_delay(
    args: Sequence[str],
    delay: float,
    sig: int = signal.SIGTERM,
    env: Optional[Dict[str, str]] = None,
    timeout: float = 600.0,
    cwd: Optional[str] = None,
) -> Tuple[int, str, str]:
    """Start the run and send ``sig`` after ``delay`` seconds — a
    mid-solve kill when the delay lands inside a tile's device work
    (pick the delay from a randomized range to sample different
    interrupt points).  If the run exits first, its natural exit is
    returned."""
    proc = _spawn(args, env, cwd)
    deadline = time.monotonic() + timeout
    t_kill = time.monotonic() + delay
    while proc.poll() is None and time.monotonic() < deadline:
        if time.monotonic() >= t_kill:
            proc.send_signal(sig)
            break
        time.sleep(min(0.05, max(t_kill - time.monotonic(), 0.0) + 0.01))
    return _finish(proc, max(deadline - time.monotonic(), 5.0))


def compare_files(
    reference: Sequence[str], candidate: Sequence[str]
) -> List[str]:
    """Byte-compare file pairs.  Returns human-readable mismatch
    descriptions (empty list = all pairs identical)."""
    problems = []
    for ref, cand in zip(reference, candidate):
        if not os.path.exists(ref):
            problems.append(f"missing reference file {ref}")
            continue
        if not os.path.exists(cand):
            problems.append(f"missing candidate file {cand}")
            continue
        with open(ref, "rb") as f:
            a = f.read()
        with open(cand, "rb") as f:
            b = f.read()
        if a != b:
            problems.append(
                f"{cand} differs from {ref} "
                f"({len(b)} vs {len(a)} bytes)")
    return problems


def interrupted_run_matches(
    run_args: Sequence[str],
    resume_args: Sequence[str],
    ckpt_dir: str,
    reference_files: Sequence[str],
    candidate_files: Sequence[str],
    kill_mode: str = "checkpoint",
    n_checkpoints: int = 1,
    delay: float = 1.0,
    env: Optional[Dict[str, str]] = None,
    timeout: float = 600.0,
    cwd: Optional[str] = None,
) -> Tuple[bool, str]:
    """One full fault-injection round: run ``run_args``, kill it
    (``kill_mode``: "checkpoint" = tile boundary via
    :func:`kill_at_checkpoint`, "delay" = mid-solve via
    :func:`kill_after_delay`), re-run ``resume_args`` to completion,
    then byte-compare candidate vs reference files.  Returns
    (matched, report)."""
    if kill_mode == "checkpoint":
        rc, out, err = kill_at_checkpoint(
            run_args, ckpt_dir, n_checkpoints, env=env, timeout=timeout,
            cwd=cwd)
    else:
        rc, out, err = kill_after_delay(
            run_args, delay, env=env, timeout=timeout, cwd=cwd)
    report = [f"interrupted run exit={rc}"]
    if rc == 0:
        report.append("(run finished before the kill trigger fired)")
    else:
        rc2, out2, err2 = run_subprocess(
            resume_args, env=env, timeout=timeout, cwd=cwd)
        report.append(f"resume exit={rc2}")
        if rc2 != 0:
            return False, "\n".join(report + [out2[-2000:], err2[-2000:]])
    problems = compare_files(reference_files, candidate_files)
    report.extend(problems if problems else ["all files bit-exact"])
    return not problems, "\n".join(report)


def main(argv=None):
    """``python -m sagecal_tpu_torch.elastic.faultinject kill-at-ckpt N
    CKPT_DIR -- cmd...`` / ``kill-after SECONDS -- cmd...``: the shell
    entry."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    mode = argv[0]
    if mode == "kill-at-ckpt":
        n, ckpt_dir = int(argv[1]), argv[2]
        cmd = argv[argv.index("--") + 1:]
        rc, out, err = kill_at_checkpoint(cmd, ckpt_dir, n)
    elif mode == "kill-after":
        delay = float(argv[1])
        cmd = argv[argv.index("--") + 1:]
        rc, out, err = kill_after_delay(cmd, delay)
    else:
        print(f"unknown mode {mode!r}", file=sys.stderr)
        return 2
    sys.stdout.write(out)
    sys.stderr.write(err)
    print(f"faultinject: child exit={rc}")
    # the kill is the EXPECTED outcome; exit 0 when the child died from
    # our signal (negative returncode) or finished cleanly
    return 0 if rc <= 0 else rc


if __name__ == "__main__":
    sys.exit(main())
