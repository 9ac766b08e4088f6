#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

It imports no JAX and nothing of ``sagecal_tpu``.  Phases, in order,
each printing lines of its own; any failure exits non-zero:

1. device   the card's name, the device count and ``nvidia-smi``'s name
            and power limit; no CUDA device -> exit 1;
2. build    ``nvcc`` builds every kernel source of
            ``sagecal_tpu_torch/csrc`` (one process per source, started
            together) and prints the ptxas register/shared-memory report;
3. parity   the fused kernels against their plain PyTorch versions at
            the north-star tile (62 stations, 100 clusters, 60 timeslots
            x 2 channels = 113,460 rows), nc 1 and 2, f32 and bf16
            coherencies: the objective #3/#4 Gaussian and robust (nu = 5),
            cost relative error <= 1e-5, gradient error <= 1e-5 of its
            norm; the predict #1/#2 under a random upstream cotangent,
            model error <= 1e-5 of its max abs, gain cotangent <= 1e-5 of
            its norm, and FusedSkyGradientError raised for a coherency
            gradient; every backward bit-identical on repeat; each
            problem's backward station plan (``BwdPlan``) built once, as
            a solve builds it, and its build time printed beside the
            garbage collector's pauses in it and its two host calls
            of most self time;
4. main     the port's main path from files, as a user runs it: an LSM
            sky of 100 point clusters and its cluster file -> ``load_sky``
            -> ``make_visdata`` -> ``corrupt_and_observe`` (noise 1e-3) ->
            ``build_cluster_data`` -> ``solve_tile`` (mode
            SM_OSLM_OSRLM_RLBFGS, fused joint cost) -> ``append_solutions``
            and ``read_solutions``; ``solve_tile`` again, then twice with
            the torch-op joint cost, all in torch's default mode.  Checks
            res_1 < res_0, each route's two runs bit-identical in ``p`` and
            res_1, fused and torch-op res_1 within 5e-3, and that both
            objective kernels launched during the first fused run (launch
            counts set to 0 just before it); then the residual step on the
            solution: ``calculate_residuals`` launches kernel #1 exactly
            once, its ``residual_norm`` is res_1 within 1e-5, it matches
            ``vis - predict_full_model`` within 1e-5 of that's max abs,
            ``simulate_visibilities`` modes 1-3 agree with their
            definitions and the ``ccid_index`` correction runs;
5. warm     a warm-started tile: the north-star geometry with an LSM sky
            of 8 point clusters (the serve lane's), built from files as
            in phase 4, solved once by ``solve_tile`` (fused, the main
            path's depth), then twice from that solution: res_1 below
            res_0 cold, warm res_1 not above warm res_0, both objective
            kernels launched in a warm run (counts set to 0 just before
            it), the two warm runs bit-identical; its wall time printed;
6. extended the rest of the single-tile solve at the north-star geometry:
            an LSM sky of 8 clusters of points, Gaussians, disks, rings
            and one n0 = 10 shapelet source with its ``.fits.modes``
            file -> ``load_sky`` (with its shapelet table) ->
            ``make_visdata`` -> ``corrupt_and_observe`` (noise 1e-3) ->
            ``build_cluster_data(shapelets=...)``; ``solve_tile`` (fused,
            the main path's depth) in modes 5 (robust RTR), 6 (robust
            NSD) and 4 (RTR), then mode 3 with ``param_bound`` (LBFGS-B):
            each res_1 < res_0 and both objective kernels #3/#4 launched
            (counts set to 0 just before), every |p| <= the bound under
            LBFGS-B, a second mode-5 run bit-identical, a mode-5 run on
            the torch-op joint cost launching neither and within the
            5e-3 bar of the fused res_1; #3/#4 held against their plain
            version at this shape (a seeded problem of 8 clusters, and
            the tile's own packed inputs at its start), Gaussian and
            robust; the residual step
            on the mode-5 solution launches #1 once; a bucket of 8 lanes
            (the sky under 8 sets of true gains) in mode 5 routed to
            "fused_batch" by ``choose_batched_path`` and solved by
            ``sagefit_packed_batch``: #5/#6 launched, every lane res_1 <
            res_0.  Each solve's wall, EM and LBFGS seconds, the RTR/NSD
            host syncs per cluster solve and peak device memory;
7. fullbatch the fullbatch app, through the CLI's parser and config
            (``-j 3 -e 1 -g 3 -l 10 -t 60 --f32 --fused``) and
            ``run_fullbatch`` on an in-memory ``vis.h5``
            (``io/memh5.py::MemFile``; the card's machine has no h5py)
            made by the port's ``create_dataset``/``simulate_dataset``:
            two tiles of the north-star geometry, phase 4's 100-cluster
            sky under true gains, noise 1e-3.  Checks: two solution
            intervals, res_1 < res_0 on each tile, #3/#4 launched in each
            tile's solve and #1 exactly once in its residual step (counts
            set to 0 before each tile, read at its closing log line), the
            residual column equal to ``vis - predict_full_model`` on the
            tile's gains within 1e-5 of its max abs, a second run
            bit-identical; ``-a 1`` from the solutions file launches #1
            once a tile and writes the model.  Then telemetry off and on,
            on the warm phase's 8-cluster sky: ``solve_tile`` in mode 5
            bit-identical in p and res_1, with the same #3/#4 launches and
            no more RTR host reads; the app over one tile with
            SAGECAL_TELEMETRY 0 and 1, the same results and residual
            column, and an event log with ``cluster_convergence`` and
            ``solve_quality``.  Per tile it prints the app's phase seconds
            and launches, EM/LBFGS seconds and host reads with telemetry
            off and on, and peak device memory;
8. predict  ``tools/profile_kernel.py``'s profile at the same tile: the
            fused predict, the composed robust cost on it, its gradient
            and a 20-iteration LBFGS that must lower the cost; kernels #1
            and #2 must launch (counts set to 0 just before; the launches
            the LBFGS itself made are the path's count); then
            ``kdiag.py``'s three rungs for kernel #1, on the device alone
            and host-paced;
9. bisect   ``tools/kbisect.py``, the port of ``kbisect.py``: ``run`` of
            variants c b a d e f on the card (counts set to 0 just
            before): every variant prints ok, each value within 1e-5
            relative of the JAX package's (``KBISECT_JAX_VALUES``), the
            probes #7-#10 (c, b, a, f) launched once each, #1 twice (d,
            e) and #2 once (e); then each probe against its plain version
            at kbisect's shapes and at the north-star width (Mp 104,
            113,664 columns or rows; a: R 444 x T 256), random inputs
            from a CUDA generator seeded 0: max abs error <= 1e-5 of the
            plain output's max abs, bit-identical on repeat, station
            indices -1, NPAD and 200 giving exactly the plain version's
            zeros (a, f), and probe b refusing F = 2; each probe's time
            at both shapes, on the device alone and host-paced, beside
            its bound (a and f: the least work of their function, one
            reduction of the table per station, then 4 or 1 gathered
            words per index, ``kernels/parity.py::kbisect_work``) and its
            plain version's (and, for c and b, one ``torch.einsum``
            computing the same function); a and f also in each form of
            their launch (two launches, each of them alone, one launch),
            beside the launch floor (an empty launch on the device alone);
10. times   phase wall times, each solo kernel's time from CUDA events
            over many launches beside its bound and the plain version's
            time (#4 and #2 with the tile's station plan built once, as
            the solve does, and split on the device alone into their
            kernels: #4 cotangent, gradient and sum, #2 gradient and sum),
            and peak device memory, each beside the card's name and power
            limit;
11. serve   the batched serve solve of one bucket of 8 requests, each a
            north-star-geometry tile (62 stations, 113,460 rows) with its
            own LSM sky of 8 point clusters and its own true gains:
            batched kernels #5/#6 against their plain version at that
            width (Gaussian and robust with per-lane nu, f32 and bf16
            coherencies, and 6 valid lanes of 8; bars as in phase 3,
            bit-identical repeat, exactly zero pad lanes; one plan for
            the lanes, its build time printed); the requests
            built from files, one bucket, routed to "fused_batch" by
            ``choose_batched_path`` and solved by ``sagefit_packed_batch``
            (mode 3, 3 EM passes, max_iter 2, max_lbfgs 10; every lane
            res_1 < res_0; both batched kernels launched, the solo ones
            not; counts set to 0 just before); batched vs sequential
            ``solve_tile`` solves/s; a second fused_batch run bit-identical
            to the first; the same bucket on the per-lane torch-op route
            (res_1 within 5e-3) and a ragged bucket of 6 padded to 8 (real
            lanes within 1e-5 of the full bucket's), all in default mode;
            the batched kernels' times beside their bounds (#6 on one
            station plan for the bucket, split into its cotangent,
            gradient and sum kernels on the device alone), and the plan
            build times of phases 3 and 11;
12. service the calibration service through the serve CLI's parser and
            config (``--f32 --fused --batch 8 -j 3 -e 3 -g 2 -l 10
            --shadow-rate 0.25``, the reference serve defaults) and
            ``apps.serve.run_serve`` over an in-memory ``vis.h5`` of 8
            north-star tiles (``MemFile``) with an LSM sky of 8 point
            clusters: tenant A's 16 requests make two full buckets of one
            shape on "fused_batch" (each lane its own tile; the second
            bucket a cache hit), tenant B's 3 (two clusters at 2 hybrid
            chunks) one ragged bucket padded to 8 on "fused".  Per
            dispatch (counts set to 0 just before the solve the cache
            lookup hands out, read just after it): route and reason (from
            the result manifests), pack and solve seconds, launches
            (#5/#6 on "fused_batch", #3/#4 on "fused", each route none of
            the other's) and peak device memory; no kernel launched
            outside the solves (tile loading, manifests, shadow
            re-solves); per run: solves/s, p50 latency, cache stats (2
            misses, 1 hit, 2 entries), verdicts (none diverged, every
            res_1 below res_0) and one line per drift record (a valid
            ledger with a record for every sampled id; verdicts
            reported, not gated); #3/#4 against their plain version on
            a real lane of the hybrid bucket (its per-cluster chunk maps,
            its station plan, at the gains it returned and at those
            under a seeded kick, nu None and the lane's mean nu); then
            tenant A's first 8 requests served again by a new service:
            solutions files and residuals bit-identical;
13. beam    beam-aware calibration (run between phases 7 and 8): an
            in-memory ``vis.h5`` of one north-star tile with a LOFAR-HBA-
            like ``/beam`` group (STAT_TILE: 16 dipoles a tile, then 48
            tile centroids for the 38 remote stations and 24, masked to
            64, for the 24 core ones), its visibilities phase 4's
            100-cluster sky through that beam (-B 2, the HBA element
            table at 150 MHz) under true gains, noise 1e-3.  Checks:
            ``build_cluster_data_withbeam`` for -B 1, 2, 3 and 5
            (wideband), each timed with its peak device memory, finite,
            and -B 2's with off-diagonal (XY) power; #3/#4 against their
            plain version on the -B 2 coherencies at identity and random
            gains, Gaussian and robust, at phase 3's tolerances; the CLI
            with ``-j 3 -e 1 -g 3 -l 10 -t 60 --f32 --fused -B 2
            --element-coeffs hba`` (``-g 6`` until phases 14-15):
            res_1 < res_0, #3/#4 launched in the solve and #1 once in
            the residual step (counts set to 0 before the tile, read at
            its closing log line); a second run with SAGECAL_TRACE=1 and
            SAGECAL_FLIGHT=1 bit-identical (results, solutions file,
            residual column), its span JSONL and ``trace.json`` loading
            with the run, tile and phase spans, and the flight
            recorder's closing heartbeat written; the same tile with
            ``-i``: every influence value finite, the split of
            ``influence_function``'s seconds (residual, Hessians with
            the least squares, dR, host eigensolves) printed;
14. distributed  the multi-band consensus ADMM (graded config 4, cut to
            4 sub-bands and -A 3) through the CLI (``-f 'band*.h5' -t 60
            --f32 -j 1 -e 1 -g 2 -A 3 -P 2 -Q 2 -r 5 -C 1``, with
            SAGECAL_TELEMETRY=1) and ``apps.distributed.run_distributed``
            over four in-memory band datasets of the north-star geometry
            at 130-170 MHz, phase 4's 100-cluster sky under true gains
            linear in frequency, noise 1e-3.  Prints the seconds of each
            band's x-step in each round (CUDA events, read after the
            run: the clock adds no sync), the dual and primal traces, rho
            before and after the BB step, the launches (counts set to 0
            just before the run), the global-Z file's rows, each band's
            res_0 -> res_1 over its x-steps and its residual column over
            its data, peak memory.  Fails unless #1 launched exactly 4
            times (once per band in the tile's residual step) and #3-#6
            never, the Z file holds 2 x 8 x 62 rows, every band's res_1
            is below its res_0, the final primal residual is below round
            1's and every residual column below its data;
15. minibatch  the minibatch bandpass app in consensus (graded config 2)
            through the CLI (``-N 1 -M 2 -w 4 -A 2 -j 2 --f32 -t 60 -l
            10``, SAGECAL_TELEMETRY=1) over one in-memory dataset of the
            north-star geometry at 8 channels and 120 timeslots (two
            minibatches of 113,460 rows), the 100-cluster sky.  Prints
            the seconds per minibatch, the primal residual per band and
            round, each band's res_0 -> res_1 and the launches; fails
            unless #1 launched once per band per minibatch (8) and every
            band's res_1 is below its res_0.

The line before the last two is one JSON object ``{"kernels": [...]}``
(all ten kernels; the probes at the north-star width),
the line before the last is nvidia-smi's ``name, power.limit``, and the
last line is ``{"ok": true, "device": {...}}``.  The main path's EM and
LBFGS depth can be cut with the options below; the widths cannot.
"""

import argparse
import gc
import inspect
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# north-star tile
NSTATIONS, NCLUSTERS, TILESZ, NCHAN = 62, 100, 60, 2
ROWS = NSTATIONS * (NSTATIONS - 1) // 2 * TILESZ  # 113,460
RA0, DEC0 = math.pi / 6, 0.9

COST_TOL = 1e-5
GRAD_TOL = 1e-5
MODEL_TOL = 1e-5  # predict parity and the residual step, relative
RES1_TOL = 5e-3

# serve bucket: the reference's ServeConfig.batch default, requests of
# 8 point clusters each on the north-star geometry
SERVE_B, SERVE_CLUSTERS, SERVE_RAGGED = 8, 8, 6
# the serve defaults' depth: mode 3, 3 EM passes, max_iter 2, max_lbfgs 10
SERVE_MAX_EMITER, SERVE_MAX_ITER, SERVE_MAX_LBFGS = 3, 2, 10
SEED = 0  # lane generators: derive_lane_generators(SEED, request ids)
# the warm-started tile: the serve lane's sky size at the north-star
# geometry (~1 s an EM pass), at the main path's depth
WARM_CLUSTERS = SERVE_CLUSTERS
# the extended-sky tile: per cluster, the types of its sources (the
# first letter of an LSM name: P point, G Gaussian, D disk, R ring,
# S shapelet), at the north-star geometry
EXT_CLUSTERS = ("PP", "GP", "D", "R", "GG", "DR", "SP", "PG")
EXT_N0, EXT_BETA = 10, 1e-3  # the shapelet source's orders and scale
EXT_MODES = (5, 6, 4)  # robust RTR, robust NSD, RTR (fused joint LBFGS)
EXT_BOUND = 1.5  # param_bound of the LBFGS-B solve (mode 3)
# the extended bucket: B lanes in mode 5, at the serve phase's max_iter
# and one EM pass (cut depth; the width is the north-star tile's)
EXT_BUCKET_MAX_EMITER, EXT_BUCKET_MAX_ITER = 1, SERVE_MAX_ITER
# the fullbatch app: two tiles of the north-star geometry through the
# CLI's flags (APP_FLAGS, with -g cut from 6 to 3 since the beam phase
# joined, to keep the script near 400 s on an "NVIDIA H100 80GB HBM3,
# 700.00 W"); telemetry off/on in robust RTR
# (the mode with counted host reads) on the warm phase's sky
FB_NTIME = 2 * TILESZ
APP_FLAGS = ("--f32", "--fused", "-j", "3", "-e", "1", "-g", "6", "-l", "10",
             "-t", str(TILESZ))
FB_FLAGS = APP_FLAGS[:6] + ("-g", "3") + APP_FLAGS[8:]
FB_TEL_MODE = 5

# the calibration service: the reference serve defaults (-j 3 -e 3 -g 2
# -l 10 --batch 8) with --f32 --fused and a quarter of the requests
# shadow-audited, over one in-memory dataset of SVC_TILES north-star
# tiles: tenant A's SVC_A requests make two full buckets of one shape,
# tenant B's SVC_B (SVC_HYBRID hybrid chunks on two clusters) one ragged
# bucket
SVC_SHADOW_RATE = 0.25
SVC_FLAGS = ("--f32", "--fused", "--batch", str(SERVE_B), "-j", "3",
             "-e", str(SERVE_MAX_EMITER), "-g", str(SERVE_MAX_ITER),
             "-l", str(SERVE_MAX_LBFGS), "--shadow-rate",
             str(SVC_SHADOW_RATE))
SVC_TILES, SVC_A, SVC_B, SVC_HYBRID = 8, 16, 3, 2

# the multi-band consensus ADMM (graded config 4: 32 sub-bands of the
# north-star tile, sagecal-mpi -f -A 10 -P 2 -Q 2; cut to DIST_BANDS
# bands and -A 3, the least depth at which -C 1's BB update fires), run
# with SAGECAL_TELEMETRY=1 for the per-band residuals and rho trajectory
DIST_BANDS = 4
DIST_FREQS = (130e6, 170e6)
DIST_FLAGS = ("-t", str(TILESZ), "--f32", "-j", "1", "-e", "1", "-g", "2",
              "-A", "3", "-P", "2", "-Q", "2", "-r", "5", "-C", "1")
# the minibatch bandpass app (graded config 2: -N 1, Student's-t, 100
# clusters on one observation): 8 channels in 4 mini-bands in consensus,
# two minibatches of TILESZ timeslots
MB_NCHAN, MB_NTIME = 8, 2 * TILESZ
MB_FLAGS = ("-N", "1", "-M", "2", "-w", "4", "-A", "2", "-j", "2", "--f32",
            "-t", str(TILESZ), "-l", "10")

# the kbisect tool's run: every variant, in the JAX tool's documented order
BISECT_VARIANTS = ("c", "b", "a", "d", "e", "f")
# probe shapes: kbisect's own, and the north-star width (Mp 104 clusters
# as kdiag.py's top rung, 113,664 = 444 x 256 columns or rows)
BISECT_SHAPES = {"kbisect": {p: dict(mp=8, T=256, R=2) for p in "cbaf"},
                 "north-star": {"c": dict(mp=104, T=113664),
                                "b": dict(mp=104, T=256, R=444),
                                "a": dict(mp=104, T=256, R=444),
                                "f": dict(mp=104, T=113664)}}
PROBE_TOL = 1e-5  # probe vs plain, relative to the plain output's max abs
BISECT_VAL_TOL = 1e-5  # tool values vs the JAX package's, relative

KERNELS = ("fused_predict_fwd", "fused_predict_bwd", "fused_cost_fwd",
           "fused_cost_bwd", "fused_cost_batch_fwd", "fused_cost_batch_bwd")
PROBES = {"kbisect_c": "c", "kbisect_b": "b", "kbisect_a": "a",
          "kbisect_f": "f"}
SOURCE = {k: "sagecal_tpu_torch/csrc/fused_cost.cu" for k in KERNELS}
SOURCE.update({k: f"sagecal_tpu_torch/csrc/{k}.cu" for k in PROBES})
REPLACES = {
    "fused_predict_fwd": "sagecal_tpu/ops/rime_kernel.py:265",
    "fused_predict_bwd": "sagecal_tpu/ops/rime_kernel.py:407",
    "fused_cost_fwd": "sagecal_tpu/ops/rime_kernel.py:842",
    "fused_cost_bwd": "sagecal_tpu/ops/rime_kernel.py:877",
    "fused_cost_batch_fwd": "sagecal_tpu/ops/rime_kernel.py:1250",
    "fused_cost_batch_bwd": "sagecal_tpu/ops/rime_kernel.py:1273",
    "kbisect_c": "kbisect.py:23",
    "kbisect_b": "kbisect.py:49",
    "kbisect_a": "kbisect.py:77",
    "kbisect_f": "kbisect.py:158",
}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def sync_clock() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def phase_device():
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(1)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(f"[device] {name} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvidia-smi: {card}", flush=True)
    return name, count, card


def phase_build():
    from sagecal_tpu_torch.kernels import build

    t = time.perf_counter()
    paths = build.build_all()
    secs = time.perf_counter() - t
    for name in paths:
        for line in build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {len(paths)} source(s) built in {secs:.1f} s", flush=True)


def timed_plan(prob, where: str, case: str):
    """The problem's backward station plan, built once as a solve builds
    it, with its build time printed beside where the host spent it: the
    garbage collector's pauses within the build and the two host calls
    (aten ops or CUDA runtime calls, from a CPU-only ``torch.profiler``)
    of most self time; a call that waits on the device holds that
    wait."""
    from torch.profiler import ProfilerActivity, profile

    from sagecal_tpu_torch.kernels.parity import plan_of

    marks = []  # (gc phase, host time)
    on_gc = lambda phase, info: marks.append((phase, time.perf_counter()))
    gc.callbacks.append(on_gc)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t = sync_clock()
            plan = plan_of(prob)
            secs = sync_clock() - t
    finally:
        gc.callbacks.remove(on_gc)
    starts = [m for phase, m in marks if phase == "start"]
    stops = [m for phase, m in marks if phase == "stop"]
    gc_s = sum(b - a for a, b in zip(starts, stops) if a >= t)
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    top = ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.3f} ms"
                    for e in ops[:2])
    print(f"[{where}] BwdPlan {case}: built in {secs * 1e3:.3f} ms (gc "
          f"pauses {gc_s * 1e3:.3f} ms; most host time: {top})", flush=True)
    return plan, secs


def phase_parity():
    from sagecal_tpu_torch.kernels.parity import (
        compare_predict_with_plain, compare_with_plain, random_cost_problem,
    )

    worst = {k: 0.0 for k in KERNELS[:4]}
    plan_s = {}
    for nc, dt in itertools.product((1, 2), (torch.float32, torch.bfloat16)):
        prob = random_cost_problem(NCLUSTERS, NSTATIONS, NCHAN, ROWS, nc=nc,
                                   coh_dtype=dt, seed=1, device="cuda")
        case = f"nc={nc} coh={str(dt).split('.')[-1]}"
        plan, plan_s[case] = timed_plan(prob, "parity", case)
        out = compare_predict_with_plain(prob, seed=5, plan=plan)
        ok = (out["model_rel"] <= MODEL_TOL and out["grad_rel"] <= GRAD_TOL
              and out["bitwise_repeat"] and out["sky_error_raised"])
        print(f"[parity] predict {case}: model_rel={out['model_rel']:.3e} "
              f"grad_rel={out['grad_rel']:.3e} "
              f"bitwise_repeat={out['bitwise_repeat']} "
              f"sky_error_raised={out['sky_error_raised']} "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            fail(f"predict kernel parity {case}: {out}")
        worst["fused_predict_fwd"] = max(worst["fused_predict_fwd"],
                                         out["model_max_abs_err"])
        worst["fused_predict_bwd"] = max(worst["fused_predict_bwd"],
                                         out["grad_max_abs_err"])
        for nu in (None, 5.0):
            out = compare_with_plain(prob, nu, plan)
            ok = (out["cost_rel"] <= COST_TOL and out["grad_rel"] <= GRAD_TOL
                  and out["bitwise_repeat"])
            print(f"[parity] objective {'robust' if nu else 'gaussian'} "
                  f"{case}: cost_rel={out['cost_rel']:.3e} "
                  f"grad_rel={out['grad_rel']:.3e} "
                  f"bitwise_repeat={out['bitwise_repeat']} "
                  f"{'ok' if ok else 'FAILED'}", flush=True)
            if not ok:
                fail(f"objective kernel parity {case} nu={nu}: {out}")
            worst["fused_cost_fwd"] = max(worst["fused_cost_fwd"],
                                          out["cost_abs_err"])
            worst["fused_cost_bwd"] = max(worst["fused_cost_bwd"],
                                          out["grad_max_abs_err"])
        del prob, plan
        torch.cuda.empty_cache()
    return worst, plan_s


def write_sky(dirname: str, seed: int = 7, nclusters: int = NCLUSTERS,
              name: str = "sky"):
    """An LSM sky of ``nclusters`` point sources within ~2 degrees of the
    phase centre, one per cluster, and its cluster file."""
    rng = np.random.default_rng(seed)
    sky = os.path.join(dirname, f"{name}.txt")
    clus = sky + ".cluster"
    with open(sky, "w") as fs, open(clus, "w") as fc:
        fs.write("# name h m s d m s I Q U V si RM eX eY eP f0\n")
        for k in range(nclusters):
            dec = DEC0 + math.radians(rng.uniform(-2.0, 2.0))
            ra = RA0 + math.radians(rng.uniform(-2.0, 2.0)) / math.cos(DEC0)
            hrs, deg = math.degrees(ra) / 15.0, math.degrees(dec)
            h, rem = int(hrs), (hrs - int(hrs)) * 60.0
            d, drem = int(deg), (deg - int(deg)) * 60.0
            flux = rng.uniform(1.0, 10.0)
            fs.write(f"P{k} {h} {int(rem)} {(rem - int(rem)) * 60.0:.6f} "
                     f"{d} {int(drem)} {(drem - int(drem)) * 60.0:.6f} "
                     f"{flux:.6f} 0 0 0 0 0 0 0 0 150e6\n")
            fc.write(f"{k} 1 P{k}\n")
    return sky, clus


def main_tile(dirname: str, nclusters: int = NCLUSTERS):
    """The main path's tile as a user builds it from files: sky and
    cluster file -> observed visibilities -> coherencies, ``nclusters``
    point clusters at the north-star geometry.  Returns (VisData,
    ClusterData, p0, seconds spent on the coherencies)."""
    from sagecal_tpu_torch.core.types import jones_to_params
    from sagecal_tpu_torch.io.simulate import (
        corrupt_and_observe, make_visdata, random_jones,
    )
    from sagecal_tpu_torch.io.skymodel import load_sky
    from sagecal_tpu_torch.solvers.sage import build_cluster_data

    sky, clus = write_sky(dirname, nclusters=nclusters)
    clusters, cdefs, _ = load_sky(sky, clus, RA0, DEC0)
    data = make_visdata(nstations=NSTATIONS, tilesz=TILESZ, nchan=NCHAN,
                        dec0=DEC0, seed=0)
    assert data.rows == ROWS, data.rows
    truth = random_jones(nclusters, NSTATIONS, seed=3, amp=0.2)
    data = corrupt_and_observe(data, clusters, jones=truth, noise_sigma=1e-3,
                               seed=1, fdelta=data.deltaf)
    t = sync_clock()
    cdata = build_cluster_data(data, clusters, [c.nchunk for c in cdefs])
    coh_s = sync_clock() - t
    p0 = jones_to_params(random_jones(nclusters, NSTATIONS, seed=9, amp=0.0))
    return data, cdata, p0[:, None, :], coh_s


def main_config(args):
    from sagecal_tpu_torch.solvers.sage import SM_OSLM_OSRLM_RLBFGS, SageConfig

    return SageConfig(solver_mode=SM_OSLM_OSRLM_RLBFGS, use_fused_predict=True,
                      max_emiter=args.max_emiter, max_iter=args.max_iter,
                      max_lbfgs=args.max_lbfgs)


def bitwise(a, b) -> bool:
    """Two solves gave the same bits in ``p`` and res_1."""
    return bool(torch.equal(a.p, b.p) and torch.equal(a.res_1, b.res_1))


def phase_main(args, dirname: str, data, cdata, p0):
    from sagecal_tpu_torch.core.types import params_to_jones
    from sagecal_tpu_torch.io.solutions import (
        append_solutions, read_solutions, write_header,
    )
    from sagecal_tpu_torch.ops.rime_kernel import (
        fused_cost_bwd_cuda, fused_cost_fwd_cuda,
    )
    from sagecal_tpu_torch.solvers.sage import solve_tile

    cfg = main_config(args)
    torch.cuda.reset_peak_memory_stats()
    fused_cost_fwd_cuda.launches = 0
    fused_cost_bwd_cuda.launches = 0
    res = solve_tile(data, cdata, p0, cfg)
    launches = {"fused_cost_fwd": fused_cost_fwd_cuda.launches,
                "fused_cost_bwd": fused_cost_bwd_cuda.launches}
    peak = torch.cuda.max_memory_allocated()

    sol = os.path.join(dirname, "tile.solutions")
    jones = params_to_jones(res.p[:, 0]).detach().cpu().numpy()
    with open(sol, "w") as fh:
        write_header(fh, data.freq0, data.deltaf, data.deltat * TILESZ / 60.0,
                     NSTATIONS, NCLUSTERS, NCLUSTERS)
        append_solutions(fh, jones)
    meta, back = read_solutions(sol)
    sol_err = float(np.abs(back[0] - jones).max() / np.abs(jones).max())

    res2 = solve_tile(data, cdata, p0, cfg)
    unfused = cfg.replace(use_fused_predict=False)
    res_u = solve_tile(data, cdata, p0, unfused)
    res_u2 = solve_tile(data, cdata, p0, unfused)
    same_fused, same_u = bitwise(res, res2), bitwise(res_u, res_u2)

    r0, r1, r1u = float(res.res_0), float(res.res_1), float(res_u.res_1)
    floor = 1e-3 / math.sqrt(ROWS * NCHAN * 8)  # res of the noise alone
    print(f"[main] rows={ROWS} clusters={NCLUSTERS} stations={NSTATIONS} "
          f"channels={NCHAN} emiter={args.max_emiter} "
          f"max_iter={args.max_iter} max_lbfgs={args.max_lbfgs}", flush=True)
    print(f"[main] fused: res_0={r0:.6e} res_1={r1:.6e} "
          f"mean_nu={float(res.mean_nu):.3f} "
          f"lbfgs_iterations={res.lbfgs_iterations} "
          f"(noise alone would give {floor:.3e})", flush=True)
    print(f"[main] torch-op joint cost: res_0={float(res_u.res_0):.6e} "
          f"res_1={r1u:.6e} rel diff fused vs torch-op="
          f"{abs(r1 - r1u) / r1u:.3e} (bar {RES1_TOL})", flush=True)
    print(f"[main] default mode, two runs each: fused bit-identical "
          f"{same_fused}, torch-op bit-identical {same_u}", flush=True)
    print(f"[main] solutions file: {meta['nclus_eff']} columns x "
          f"{meta['nstations']} stations, max rel diff on read-back "
          f"{sol_err:.2e}", flush=True)
    print(f"[main] launches in the fused run: {launches}", flush=True)

    if not (np.isfinite(r0) and np.isfinite(r1) and np.isfinite(r1u)):
        fail("non-finite residuals")
    if not torch.isfinite(res.p).all():
        fail("non-finite solutions")
    if not r1 < r0:
        fail(f"fused run did not reduce the residual: {r1} >= {r0}")
    if not r1u < float(res_u.res_0):
        fail("torch-op run did not reduce the residual")
    if abs(r1 - r1u) / r1u > RES1_TOL:
        fail(f"fused vs torch-op res_1 differ by more than {RES1_TOL}")
    if not (same_fused and same_u):
        fail("two default-mode runs of one route gave different bits")
    if back.shape != (1, NCLUSTERS, NSTATIONS, 2, 2) or sol_err > 1e-5:
        fail("solutions file did not read back")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")
    residual = phase_residual(data, cdata, res)
    return {
        "launches": launches, "lbfgs_iterations": res.lbfgs_iterations,
        "em_s": [res.phase_seconds["em"], res2.phase_seconds["em"]],
        "lbfgs_s": [res.phase_seconds["lbfgs"], res2.phase_seconds["lbfgs"]],
        "em_s_torch_op": [res_u.phase_seconds["em"],
                          res_u2.phase_seconds["em"]],
        "lbfgs_s_torch_op": [res_u.phase_seconds["lbfgs"],
                             res_u2.phase_seconds["lbfgs"]],
        "peak_bytes": peak, "nu": float(res.mean_nu), "res_0": r0,
        "res_1": r1, "res_1_torch_op": r1u, "bitwise_fused": same_fused,
        "bitwise_torch_op": same_u, "residual": residual,
    }


def phase_residual(data, cdata, res):
    """The residual step on the main path's solution (module doc, phase 4)."""
    from sagecal_tpu_torch.ops.residual import (
        SIMUL_ADD, SIMUL_ONLY, SIMUL_SUB, apply_correction,
        calculate_residuals, correction_jones, residual_norm,
        simulate_visibilities,
    )
    from sagecal_tpu_torch.ops.rime_kernel import fused_predict_fwd_cuda
    from sagecal_tpu_torch.solvers.sage import predict_full_model

    p = res.p
    fused_predict_fwd_cuda.launches = 0
    t = sync_clock()
    xres = calculate_residuals(data, cdata, p)
    secs = sync_clock() - t
    launches = fused_predict_fwd_cuda.launches
    rnorm = float(residual_norm(xres, data.mask))
    norm_rel = abs(rnorm - float(res.res_1)) / float(res.res_1)
    with torch.no_grad():
        ref = data.vis - predict_full_model(p, cdata, data)
    err = float((xres - ref).abs().max())
    ref_max = float(ref.abs().max())
    model = simulate_visibilities(data, cdata, p, SIMUL_ONLY)
    modes_ok = bool(
        torch.equal(simulate_visibilities(data, cdata, p, SIMUL_ADD),
                    data.vis + model)
        and torch.equal(simulate_visibilities(data, cdata, p, SIMUL_SUB),
                        xres)
        and torch.equal(data.vis - model, xres))
    corrected = calculate_residuals(data, cdata, p, ccid_index=0)
    want = apply_correction(xres, correction_jones(p[0]), data.ant_p,
                            data.ant_q, cdata.chunk_map[0])
    corr_err = float((corrected - want).abs().max() / want.abs().max())
    print(f"[residual] calculate_residuals: {secs * 1e3:.3f} ms, kernel #1 "
          f"launches {launches}; residual_norm {rnorm:.6e} vs res_1 "
          f"{float(res.res_1):.6e} (rel {norm_rel:.2e}); max abs error vs "
          f"vis - predict_full_model {err:.3e} of max abs {ref_max:.3e}",
          flush=True)
    print(f"[residual] simulate_visibilities modes 1-3 agree with their "
          f"definitions: {modes_ok}; ccid_index=0 correction rel error "
          f"{corr_err:.2e}, finite {bool(torch.isfinite(corrected).all())}",
          flush=True)
    if launches != 1:
        fail(f"calculate_residuals launched kernel #1 {launches} times")
    if not norm_rel <= MODEL_TOL:
        fail(f"residual_norm differs from res_1 by {norm_rel}")
    if not err <= MODEL_TOL * ref_max:
        fail(f"residual differs from vis - predict_full_model by {err}")
    if not modes_ok:
        fail("simulate_visibilities modes disagree with their definitions")
    if not (torch.isfinite(corrected).all() and corr_err <= MODEL_TOL):
        fail(f"ccid_index correction: rel error {corr_err}")
    return {"seconds": secs, "launches": launches, "norm_rel": norm_rel,
            "max_abs_err": err, "ref_max_abs": ref_max,
            "correction_rel": corr_err}


def phase_warm(args, dirname: str):
    """The warm-started tile (module doc, phase 5)."""
    from sagecal_tpu_torch.ops.rime_kernel import (
        fused_cost_bwd_cuda, fused_cost_fwd_cuda,
    )
    from sagecal_tpu_torch.solvers.sage import solve_tile

    t0 = sync_clock()
    data, cdata, p0, _ = main_tile(dirname, WARM_CLUSTERS)
    cfg = main_config(args)
    cold = solve_tile(data, cdata, p0, cfg)
    fused_cost_fwd_cuda.launches = 0
    fused_cost_bwd_cuda.launches = 0
    warm = solve_tile(data, cdata, cold.p, cfg)
    launches = {"fused_cost_fwd": fused_cost_fwd_cuda.launches,
                "fused_cost_bwd": fused_cost_bwd_cuda.launches}
    warm2 = solve_tile(data, cdata, cold.p, cfg)
    secs = sync_clock() - t0
    r = {"cold_res_0": float(cold.res_0), "cold_res_1": float(cold.res_1),
         "warm_res_0": float(warm.res_0), "warm_res_1": float(warm.res_1)}
    start_rel = abs(r["warm_res_0"] - r["cold_res_1"]) / r["cold_res_1"]
    same = bitwise(warm, warm2)
    print(f"[warm] {WARM_CLUSTERS} clusters at the north-star geometry, "
          f"fused: cold res_0={r['cold_res_0']:.6e} res_1="
          f"{r['cold_res_1']:.6e}; warm res_0={r['warm_res_0']:.6e} "
          f"(rel {start_rel:.2e} from the cold res_1) res_1="
          f"{r['warm_res_1']:.6e}; two warm runs bit-identical {same}; "
          f"launches in a warm run {launches}; wall time {secs:.1f} s",
          flush=True)
    if not all(np.isfinite(v) for v in r.values()):
        fail("warm-started tile: non-finite residuals")
    if not torch.isfinite(warm.p).all():
        fail("warm-started tile: non-finite solutions")
    if not r["cold_res_1"] < r["cold_res_0"]:
        fail("warm-started tile: the cold solve did not reduce the residual")
    if not r["warm_res_1"] <= r["warm_res_0"]:
        fail(f"warm-started tile: res_1 {r['warm_res_1']} rose above res_0 "
             f"{r['warm_res_0']}")
    if not same:
        fail("warm-started tile: two warm runs gave different bits")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched in the warm solve")
    return {**r, "start_rel": start_rel, "bitwise": same,
            "launches": launches, "seconds": secs}


def write_extended_sky(dirname: str, seed: int = 21):
    """An LSM sky of the EXT_CLUSTERS clusters within ~2 degrees of the
    phase centre, its cluster file, and the shapelet source's
    ``.fits.modes`` file (EXT_N0 orders, a dominant zeroth mode)."""
    rng = np.random.default_rng(seed)
    sky = os.path.join(dirname, "ext.txt")
    clus = sky + ".cluster"
    with open(sky, "w") as fs, open(clus, "w") as fc:
        fs.write("# name h m s d m s I Q U V si RM eX eY eP f0\n")
        for k, types in enumerate(EXT_CLUSTERS):
            names = []
            for j, t in enumerate(types):
                dec = DEC0 + math.radians(rng.uniform(-2.0, 2.0))
                ra = RA0 + math.radians(rng.uniform(-2.0, 2.0)) / math.cos(DEC0)
                hrs, deg = math.degrees(ra) / 15.0, math.degrees(dec)
                h, rem = int(hrs), (hrs - int(hrs)) * 60.0
                d, drem = int(deg), (deg - int(deg)) * 60.0
                ex, ey, ep = {
                    "P": (0.0, 0.0, 0.0),
                    "G": (rng.uniform(3e-4, 1e-3), rng.uniform(3e-4, 1e-3),
                          rng.uniform(0.0, math.pi)),
                    "D": (rng.uniform(2e-4, 6e-4), 0.0, 0.0),
                    "R": (rng.uniform(2e-4, 6e-4), 0.0, 0.0),
                    "S": (1.2, 0.8, 0.3),
                }[t]
                name = f"{t}{k}x{j}"
                names.append(name)
                fs.write(f"{name} {h} {int(rem)} {(rem - int(rem)) * 60.0:.6f} "
                         f"{d} {int(drem)} {(drem - int(drem)) * 60.0:.6f} "
                         f"{rng.uniform(1.0, 10.0):.6f} 0 0 0 "
                         f"{rng.uniform(-0.9, 0.0):.4f} 0 {ex:.6e} {ey:.6e} "
                         f"{ep:.6f} 150e6\n")
                if t == "S":
                    modes = 0.3 * rng.standard_normal(EXT_N0 * EXT_N0)
                    modes[0] = 3.0
                    with open(os.path.join(dirname, name + ".fits.modes"),
                              "w") as fm:
                        fm.write(f"# ra dec\n0 0 0 51 0 0\n{EXT_N0} "
                                 f"{EXT_BETA}\n")
                        fm.writelines(f"{i} {m:.8f}\n"
                                      for i, m in enumerate(modes))
            fc.write(f"{k} 1 {' '.join(names)}\n")
    return sky, clus


def extended_tile(dirname: str):
    """The extended-sky tile from files (module doc, phase 6) ->
    (VisData, ClusterData, p0, clusters, shapelet table, seconds spent
    on the coherencies)."""
    from sagecal_tpu_torch.core.types import jones_to_params
    from sagecal_tpu_torch.io.simulate import (
        corrupt_and_observe, make_visdata, random_jones,
    )
    from sagecal_tpu_torch.io.skymodel import load_sky
    from sagecal_tpu_torch.solvers.sage import build_cluster_data

    sky, clus = write_extended_sky(dirname)
    clusters, cdefs, tab = load_sky(sky, clus, RA0, DEC0)
    M = len(clusters)
    data = make_visdata(nstations=NSTATIONS, tilesz=TILESZ, nchan=NCHAN,
                        dec0=DEC0, seed=0)
    truth = random_jones(M, NSTATIONS, seed=31, amp=0.2)
    data = corrupt_and_observe(data, clusters, jones=truth, noise_sigma=1e-3,
                               seed=32, fdelta=data.deltaf,
                               shapelet_tables=[tab] * M)
    t = sync_clock()
    cdata = build_cluster_data(data, clusters, [c.nchunk for c in cdefs],
                               shapelets=tab)
    coh_s = sync_clock() - t
    p0 = jones_to_params(random_jones(M, NSTATIONS, seed=9, amp=0.0))
    return data, cdata, p0[:, None, :], clusters, tab, coh_s


def extended_parity(data, cdata, p0, nu_solve: float):
    """Kernels #3/#4 against their plain version at the extended tile's
    shape (EXT_CLUSTERS clusters, nc 1): a seeded random problem of that
    size (Gaussian and nu 5) and the tile's own packed inputs at its
    start ``p0`` (Gaussian and the mode-5 solve's nu), each through the
    station plan a solve builds from its indices.  At a solution the
    residual is the noise's size, and the cost's relative error would
    measure f32 cancellation rather than the kernels' arithmetic."""
    from sagecal_tpu_torch.kernels.parity import (
        compare_with_plain, plan_of, random_cost_problem, tile_cost_problem,
    )

    probs = {"random": (random_cost_problem(len(EXT_CLUSTERS), NSTATIONS,
                                            NCHAN, ROWS, nc=1, seed=3,
                                            device="cuda"), (None, 5.0)),
             "tile at p0": (tile_cost_problem(data, cdata, p0),
                            (None, nu_solve))}
    worst = {"fused_cost_fwd": 0.0, "fused_cost_bwd": 0.0}
    rows = []
    for label, (prob, nus) in probs.items():
        plan = plan_of(prob)
        for nu in nus:
            o = compare_with_plain(prob, nu, plan)
            ok = (o["cost_rel"] <= COST_TOL and o["grad_rel"] <= GRAD_TOL
                  and o["bitwise_repeat"])
            print(f"[extended] objective parity, {label}, nu={nu}: "
                  f"cost_rel={o['cost_rel']:.3e} grad_rel={o['grad_rel']:.3e}"
                  f" bitwise_repeat={o['bitwise_repeat']} "
                  f"{'ok' if ok else 'FAILED'}", flush=True)
            if not ok:
                fail(f"objective kernel parity at the extended tile, {label}"
                     f" nu={nu}: {o}")
            worst["fused_cost_fwd"] = max(worst["fused_cost_fwd"],
                                          o["cost_abs_err"])
            worst["fused_cost_bwd"] = max(worst["fused_cost_bwd"],
                                          o["grad_max_abs_err"])
            rows.append(dict(o, problem=label, nu=nu))
    return {"worst": worst, "cases": rows}


def _ext_solve(data, cdata, p0, cfg, label: str):
    """One ``solve_tile`` with the objective kernels' counts and the RTR
    host reads set to 0 just before -> (result, record).  A fused solve
    must launch #3/#4, a torch-op one neither."""
    from sagecal_tpu_torch.ops.rime_kernel import (
        fused_cost_bwd_cuda, fused_cost_fwd_cuda,
    )
    from sagecal_tpu_torch.solvers import rtr
    from sagecal_tpu_torch.solvers.sage import solve_tile

    torch.cuda.reset_peak_memory_stats()
    fused_cost_fwd_cuda.launches = 0
    fused_cost_bwd_cuda.launches = 0
    rtr.host_read.count = 0
    t0 = sync_clock()
    res = solve_tile(data, cdata, p0, cfg)
    wall = sync_clock() - t0
    solves = cdata.coh.shape[0] * cfg.max_emiter
    rec = {"mode": cfg.solver_mode, "param_bound": cfg.param_bound,
           "wall_s": wall, "em_s": res.phase_seconds["em"],
           "lbfgs_s": res.phase_seconds["lbfgs"],
           "lbfgs_iterations": res.lbfgs_iterations,
           "res_0": float(res.res_0), "res_1": float(res.res_1),
           "mean_nu": float(res.mean_nu),
           "host_syncs_per_cluster_solve": rtr.host_read.count / solves,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": {"fused_cost_fwd": fused_cost_fwd_cuda.launches,
                        "fused_cost_bwd": fused_cost_bwd_cuda.launches}}
    print(f"[extended] {label}: {wall:.3f} s (EM {rec['em_s']:.3f} s, "
          f"LBFGS {rec['lbfgs_s']:.3f} s, {rec['lbfgs_iterations']} "
          f"iterations), res_0={rec['res_0']:.6e} res_1={rec['res_1']:.6e} "
          f"nu={rec['mean_nu']:.3f}, RTR/NSD host syncs per cluster solve "
          f"{rec['host_syncs_per_cluster_solve']:.1f}, peak "
          f"{rec['peak_bytes'] / 2**30:.2f} GiB, launches {rec['launches']}",
          flush=True)
    if not (np.isfinite(rec["res_1"]) and torch.isfinite(res.p).all()):
        fail(f"extended tile, {label}: non-finite result")
    if not rec["res_1"] < rec["res_0"]:
        fail(f"extended tile, {label}: res_1 {rec['res_1']} >= res_0 "
             f"{rec['res_0']}")
    for k, n in rec["launches"].items():
        if cfg.use_fused_predict and n <= 0:
            fail(f"extended tile, {label}: kernel {k} was not launched")
        if not cfg.use_fused_predict and n != 0:
            fail(f"extended tile, {label}: kernel {k} launched {n} times on "
                 "the torch-op route")
    return res, rec


def phase_extended(args, dirname: str):
    """The extended-sky tile: solves, residual step, bucket (module doc,
    phase 6)."""
    from sagecal_tpu_torch.ops.residual import calculate_residuals, residual_norm
    from sagecal_tpu_torch.ops.rime_kernel import fused_predict_fwd_cuda
    from sagecal_tpu_torch.solvers import rtr

    t_start = sync_clock()
    torch.cuda.reset_peak_memory_stats()
    data, cdata, p0, clusters, tab, coh_s = extended_tile(dirname)
    build_peak = torch.cuda.max_memory_allocated()
    kinds = "".join(EXT_CLUSTERS)
    print(f"[extended] {len(clusters)} clusters ({kinds.count('P')} points, "
          f"{kinds.count('G')} Gaussians, {kinds.count('D')} disks, "
          f"{kinds.count('R')} rings, {kinds.count('S')} shapelet n0="
          f"{tab.n0max}) at rows={data.rows} stations={NSTATIONS} "
          f"channels={NCHAN}: coherencies {coh_s:.3f} s, peak device memory "
          f"of building the tile {build_peak / 2**30:.2f} GiB", flush=True)
    if not torch.isfinite(cdata.coh).all():
        fail("extended tile: non-finite coherencies")
    base = main_config(args)
    out = {"coherencies_s": coh_s, "build_peak_bytes": build_peak,
           "rows": data.rows, "solves": {}}
    results = {}
    for mode in EXT_MODES:
        results[mode], out["solves"][f"mode{mode}"] = _ext_solve(
            data, cdata, p0, base.replace(solver_mode=mode), f"mode {mode}")
    again, rec = _ext_solve(data, cdata, p0, base.replace(solver_mode=5),
                            "mode 5 again")
    out["solves"]["mode5_again"] = rec
    same = bitwise(results[5], again)
    print(f"[extended] two mode-5 runs bit-identical in p and res_1: {same}",
          flush=True)
    if not same:
        fail("extended tile: two mode-5 runs gave different bits")
    out["bitwise_mode5"] = same
    top, rec = _ext_solve(data, cdata, p0,
                          base.replace(solver_mode=5, use_fused_predict=False),
                          "mode 5 torch-op joint cost")
    r1, r1u = float(results[5].res_1), float(top.res_1)
    rec["res_1_rel_fused"] = abs(r1 - r1u) / r1u
    print(f"[extended] mode 5 res_1 rel diff fused vs torch-op "
          f"{rec['res_1_rel_fused']:.3e} (bar {RES1_TOL})", flush=True)
    if not rec["res_1_rel_fused"] <= RES1_TOL:
        fail(f"extended tile: mode-5 fused vs torch-op res_1 differ by more "
             f"than {RES1_TOL}")
    out["solves"]["mode5_torch_op"] = rec
    del top
    out["parity"] = extended_parity(data, cdata, p0,
                                    float(results[5].mean_nu))
    bnd, rec = _ext_solve(data, cdata, p0,
                          base.replace(param_bound=EXT_BOUND),
                          f"mode {base.solver_mode} param_bound {EXT_BOUND}")
    pmax = float(bnd.p.abs().max())
    nbound = int((bnd.p.abs() == EXT_BOUND).sum())
    print(f"[extended] LBFGS-B: max |p| {pmax:.6f} <= {EXT_BOUND}: "
          f"{pmax <= EXT_BOUND}; {nbound} parameters on the bound",
          flush=True)
    if not pmax <= EXT_BOUND:
        fail(f"extended tile: LBFGS-B left |p| = {pmax} > {EXT_BOUND}")
    rec.update(max_abs_p=pmax, on_bound=nbound)
    out["solves"]["lbfgsb"] = rec

    fused_predict_fwd_cuda.launches = 0
    t = sync_clock()
    xres = calculate_residuals(data, cdata, results[5].p)
    res_s = sync_clock() - t
    launches = fused_predict_fwd_cuda.launches
    norm_rel = (abs(float(residual_norm(xres, data.mask))
                    - float(results[5].res_1)) / float(results[5].res_1))
    print(f"[extended] residual step on the mode-5 solution: "
          f"{res_s * 1e3:.3f} ms, kernel #1 launches {launches}, "
          f"residual_norm vs res_1 rel {norm_rel:.2e}", flush=True)
    if launches != 1:
        fail(f"extended residual step launched kernel #1 {launches} times")
    if not norm_rel <= MODEL_TOL:
        fail(f"extended residual_norm differs from res_1 by {norm_rel}")
    out["residual"] = {"seconds": res_s, "launches": launches,
                       "norm_rel": norm_rel}
    del xres
    out["bucket"] = extended_bucket(data, cdata, p0, clusters, tab)
    out["seconds"] = sync_clock() - t_start
    out["host_reads_total"] = rtr.host_read.count
    print(f"[extended] phase wall time {out['seconds']:.1f} s", flush=True)
    return out


def extended_bucket(data, cdata, p0, clusters, tab):
    """SERVE_B lanes of the extended sky, each under its own true gains
    and noise, in mode 5: routed and solved as the serve path does."""
    from sagecal_tpu_torch.io.simulate import corrupt_and_observe, random_jones
    from sagecal_tpu_torch.solvers import rtr
    from sagecal_tpu_torch.solvers.batched import (
        choose_batched_path, derive_lane_generators, sagefit_packed_batch,
        stack_lanes,
    )
    from sagecal_tpu_torch.solvers.sage import SM_RTR_OSRLM_RLBFGS, SageConfig

    M = len(clusters)
    lanes = []
    for b in range(SERVE_B):
        truth = random_jones(M, NSTATIONS, seed=400 + b, amp=0.2)
        lane = corrupt_and_observe(data, clusters, jones=truth,
                                   noise_sigma=1e-3, seed=500 + b,
                                   fdelta=data.deltaf,
                                   shapelet_tables=[tab] * M)
        lanes.append((lane, cdata, p0.clone()))
    data_b, cdata_b, p0_b = stack_lanes(lanes)
    del lanes
    cfg = SageConfig(solver_mode=SM_RTR_OSRLM_RLBFGS, use_fused_predict=True,
                     max_emiter=EXT_BUCKET_MAX_EMITER,
                     max_iter=EXT_BUCKET_MAX_ITER, max_lbfgs=SERVE_MAX_LBFGS)
    path, reason = choose_batched_path(data_b, cdata_b, p0_b, cfg)
    print(f"[extended] bucket of {SERVE_B} lanes, mode 5 (emiter "
          f"{cfg.max_emiter}, max_iter {cfg.max_iter}, max_lbfgs "
          f"{cfg.max_lbfgs}): route {path} ({reason})", flush=True)
    if path != "fused_batch":
        fail(f"extended bucket routed to {path!r}: {reason}")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    rtr.host_read.count = 0
    t0 = sync_clock()
    res = sagefit_packed_batch(
        data_b, cdata_b, data_b.vis.real, data_b.vis.imag, cdata_b.coh.real,
        cdata_b.coh.imag, p0_b, cfg, derive_lane_generators(SEED,
                                                            range(SERVE_B)),
        batched_fused=True)
    wall = sync_clock() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    syncs = rtr.host_read.count / (SERVE_B * M * cfg.max_emiter)
    r0, r1 = res.res_0.double().cpu(), res.res_1.double().cpu()
    print(f"[extended] bucket: {wall:.3f} s (EM {res.phase_seconds['em']:.3f}"
          f" s, LBFGS {res.phase_seconds['lbfgs']:.3f} s), LBFGS iterations "
          f"{res.lbfgs_iterations}, RTR host syncs per cluster solve "
          f"{syncs:.1f}, peak {peak / 2**30:.2f} GiB, launches {launches}",
          flush=True)
    print(f"[extended] bucket res_0 {[f'{x:.4e}' for x in r0.tolist()]} "
          f"res_1 {[f'{x:.4e}' for x in r1.tolist()]}", flush=True)
    if not (torch.isfinite(r1).all() and (r1 < r0).all()):
        fail("an extended bucket lane did not reduce its residual")
    for k in ("fused_cost_batch_fwd", "fused_cost_batch_bwd"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched in the extended bucket")
    return {"route": path, "wall_s": wall, "em_s": res.phase_seconds["em"],
            "lbfgs_s": res.phase_seconds["lbfgs"],
            "lbfgs_iterations": res.lbfgs_iterations,
            "host_syncs_per_cluster_solve": syncs, "peak_bytes": peak,
            "launches": launches, "res_0": r0.tolist(), "res_1": r1.tolist()}


def fullbatch_dataset(dirname: str, nclusters: int, ntime: int, name: str):
    """An in-memory ``vis.h5`` (``io/memh5.py::MemFile``) at the
    north-star geometry, ``ntime`` timeslots x NCHAN channels, made by
    the port's ``simulate_dataset`` from ``write_sky``'s LSM sky of
    ``nclusters`` point clusters under true gains, noise 1e-3; its phase
    centre set to the sky's.  Returns (path, sky file, cluster file)."""
    from sagecal_tpu_torch.io.dataset import simulate_dataset
    from sagecal_tpu_torch.io.memh5 import MemFile
    from sagecal_tpu_torch.io.simulate import random_jones
    from sagecal_tpu_torch.io.skymodel import load_sky

    sky, clus = write_sky(dirname, nclusters=nclusters, name=name)
    clusters, _, _ = load_sky(sky, clus, RA0, DEC0, dtype=torch.float64)
    truth = random_jones(nclusters, NSTATIONS, seed=3, amp=0.2,
                         dtype=np.complex128)
    path = os.path.join(dirname, f"{name}.h5")
    simulate_dataset(path, nstations=NSTATIONS, ntime=ntime, nchan=NCHAN,
                     clusters=clusters, jones=truth, noise_sigma=1e-3, seed=0,
                     dec0=DEC0, open_file=MemFile)
    MemFile(path, "r+").attrs["ra0"] = RA0
    return path, sky, clus


class TileLog:
    """The app's ``log``: prints each line, and at each tile's closing
    line reads the kernels' launch counts of that tile (solve, residual
    or simulation) and its phase seconds, then sets the counts to 0."""

    def __init__(self):
        from sagecal_tpu_torch.ops import rime_kernel as rk

        self.kernels = {"fused_cost_fwd": rk.fused_cost_fwd_cuda,
                        "fused_cost_bwd": rk.fused_cost_bwd_cuda,
                        "fused_predict_fwd": rk.fused_predict_fwd_cuda}
        self.tiles = []
        self.reset()

    def reset(self):
        for k in self.kernels.values():
            k.launches = 0

    def __call__(self, msg: str):
        print(f"[fullbatch] {msg}", flush=True)
        if re.match(r"tile \d+: (residual|simulated)", msg):
            phases = {k: float(v) for k, v in
                      re.findall(r"([\w+-]+)=([0-9.]+)s", msg)}
            self.tiles.append({
                "launches": {k: c.launches for k, c in self.kernels.items()},
                "phase_s": phases})
            self.reset()


def fullbatch_cli(path: str, sky: str, clus: str, sol: str, extra=(),
                  log=None, flags=FB_FLAGS):
    """The CLI's path: ``apps.cli``'s parser and config over ``flags`` and
    ``extra``, then ``run_fullbatch`` on the CUDA device over the
    in-memory file."""
    from sagecal_tpu_torch.apps.cli import (
        _warn_dropped_fused, build_parser, config_from_args,
    )
    from sagecal_tpu_torch.apps.fullbatch import run_fullbatch
    from sagecal_tpu_torch.io.memh5 import MemFile

    args = build_parser().parse_args(["-d", path, "-s", sky, "-c", clus, "-p",
                                      sol, *flags, *extra])
    _warn_dropped_fused(args, log or print)
    return run_fullbatch(config_from_args(args), log=log or print,
                         open_file=MemFile)


def fullbatch_check(run: dict, seen: list, sol: str) -> list:
    """One app run's checks (module doc, phase 7): two solution
    intervals, res_1 < res_0 and the kernels' launches per tile, and each
    tile's residual column against ``vis - predict_full_model`` on the
    tile's data, coherencies and gains as the residual step got them
    (``seen``)."""
    from sagecal_tpu_torch.core.types import params_to_jones
    from sagecal_tpu_torch.io.solutions import read_solutions
    from sagecal_tpu_torch.solvers.sage import predict_full_model

    meta, jsol = read_solutions(sol)
    ntiles = FB_NTIME // TILESZ
    print(f"[fullbatch] solutions file: {jsol.shape[0]} intervals of "
          f"{meta['nclus_eff']} columns", flush=True)
    if jsol.shape != (ntiles, NCLUSTERS, NSTATIONS, 2, 2):
        fail(f"fullbatch: solutions file holds {jsol.shape}")
    if len(run["results"]) != ntiles or len(seen) != ntiles:
        fail(f"fullbatch: {len(run['results'])} tiles solved")
    for i, ((r0, r1), tile) in enumerate(zip(run["results"], run["tiles"])):
        n = tile["launches"]
        if not (np.isfinite(r1) and r1 < r0):
            fail(f"fullbatch tile {i}: res_1 {r1} not below res_0 {r0}")
        if n["fused_cost_fwd"] <= 0 or n["fused_cost_bwd"] <= 0:
            fail(f"fullbatch tile {i}: objective kernels not launched: {n}")
        if n["fused_predict_fwd"] != 1:
            fail(f"fullbatch tile {i}: kernel #1 launched "
                 f"{n['fused_predict_fwd']} times in the residual step")
    worst = []
    for i, (full, cdata_full, p) in enumerate(seen):
        with torch.no_grad():
            ref = full.vis - predict_full_model(p, cdata_full, full)
        rows = ref.shape[-1]
        got = torch.as_tensor(run["column"][i * TILESZ:(i + 1) * TILESZ]).to(
            ref.device).reshape(rows, NCHAN, 4).permute(1, 2, 0)
        err = float((got.to(ref.dtype) - ref).abs().max())
        ref_max = float(ref.abs().max())
        jt = params_to_jones(p).reshape(jsol.shape[1:]).cpu().numpy()
        file_rel = float(np.abs(jsol[i] - jt).max() / np.abs(jt).max())
        worst.append({"max_abs_err": err, "ref_max_abs": ref_max,
                      "solutions_file_rel": file_rel})
        print(f"[fullbatch] tile {i}: residual column vs vis - "
              f"predict_full_model max abs error {err:.3e} of max abs "
              f"{ref_max:.3e}; solutions file vs the gains rel {file_rel:.1e}",
              flush=True)
        if not err <= MODEL_TOL * ref_max:
            fail(f"fullbatch tile {i}: residual column off by {err}")
        if not file_rel <= 1e-6:
            fail(f"fullbatch tile {i}: solutions file off by {file_rel}")
    return worst


def phase_fullbatch(args, dirname: str):
    """The fullbatch app (module doc, phase 7)."""
    import sagecal_tpu_torch.apps.fullbatch as fb
    from sagecal_tpu_torch.io.memh5 import MemFile, remove

    t_start = sync_clock()
    t = sync_clock()
    path, sky, clus = fullbatch_dataset(dirname, NCLUSTERS, FB_NTIME, "fb")
    make_s = sync_clock() - t
    print(f"[fullbatch] {FB_NTIME // TILESZ} tiles of {ROWS} rows, "
          f"{NCLUSTERS} clusters, made in {make_s:.1f} s; flags "
          f"{' '.join(FB_FLAGS)}", flush=True)
    out = {"dataset_s": make_s}
    # the residual step's inputs, kept to recompute each tile's residual
    seen = []
    real = fb.calculate_residuals

    def spy(full, cdata_full, p, **kw):
        seen.append((full, cdata_full, p))
        return real(full, cdata_full, p, **kw)

    sol = os.path.join(dirname, "fb.solutions")
    runs = []
    for k in range(2):
        log = TileLog()
        fb.calculate_residuals = spy if k == 0 else real
        torch.cuda.reset_peak_memory_stats()
        t = sync_clock()
        try:
            results = fullbatch_cli(path, sky, clus, sol, log=log)
        finally:
            fb.calculate_residuals = real
        wall = sync_clock() - t
        runs.append({"results": results, "tiles": log.tiles, "wall_s": wall,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "solutions": open(sol).read(),
                     "column": np.asarray(MemFile(path, "r")["corrected"])})
        print(f"[fullbatch] run {k + 1}: {wall:.1f} s, peak device memory "
              f"{runs[-1]['peak_bytes'] / 2**30:.2f} GiB; launches per tile "
              f"{[tile['launches'] for tile in log.tiles]}", flush=True)
        if k == 0:
            out["residual"] = fullbatch_check(runs[0], seen, sol)
            seen.clear()  # frees the tiles before the second run
    a, b = runs
    same = (a["results"] == b["results"] and a["solutions"] == b["solutions"]
            and np.array_equal(a["column"], b["column"]))
    print(f"[fullbatch] second run bit-identical (res, solutions file, "
          f"residual column): {same}", flush=True)
    if not same:
        fail("fullbatch: a second run gave different bits")

    # -a 1: the model of the solutions just written, through #1
    log = TileLog()
    t = sync_clock()
    sim = fullbatch_cli(path, sky, clus, sol + ".sim",
                        extra=("-a", "1", "-q", sol), log=log)
    sim_s = sync_clock() - t
    vis = np.asarray(MemFile(path, "r")["vis"])
    model = np.asarray(MemFile(path, "r")["model"])
    want = vis - a["column"]
    sim_err = float(np.abs(model - want).max() / np.abs(want).max())
    sim_launches = [tile["launches"]["fused_predict_fwd"]
                    for tile in log.tiles]
    print(f"[fullbatch] -a 1 simulation: {sim_s:.1f} s, kernel #1 launches "
          f"per tile {sim_launches}, model column vs vis - residual column "
          f"rel {sim_err:.2e}", flush=True)
    if sim != [] or sim_launches != [1] * (FB_NTIME // TILESZ):
        fail(f"fullbatch -a 1: launches {sim_launches}")
    if not sim_err <= MODEL_TOL:
        fail(f"fullbatch -a 1: model column off by {sim_err}")
    remove(path)
    out.update(runs=[{k: r[k] for k in ("results", "tiles", "wall_s",
                                        "peak_bytes")} for r in runs],
               bitwise=same,
               simulation={"seconds": sim_s, "launches": sim_launches,
                           "rel": sim_err},
               telemetry=fullbatch_telemetry(args, dirname))
    out["seconds"] = sync_clock() - t_start
    print(f"[fullbatch] phase wall time {out['seconds']:.1f} s", flush=True)
    return out


def fullbatch_telemetry(args, dirname: str):
    """Telemetry off and on: one tile of the warm phase's 8-cluster sky
    solved by ``solve_tile`` in mode FB_TEL_MODE (robust RTR, fused) with
    ``collect_telemetry``/``collect_quality`` off, then on (bit-identical
    p and res_1, the same objective launches, no more RTR host reads),
    and the app over one tile of it with SAGECAL_TELEMETRY unset, then 1
    (the same results and residual column; an event log holding
    ``cluster_convergence`` and ``solve_quality``)."""
    from sagecal_tpu_torch.io.memh5 import MemFile, remove
    from sagecal_tpu_torch.obs.events import read_events, validate_manifest
    from sagecal_tpu_torch.ops import rime_kernel as rk
    from sagecal_tpu_torch.solvers import rtr
    from sagecal_tpu_torch.solvers.sage import solve_tile

    data, cdata, p0, _ = main_tile(dirname, WARM_CLUSTERS)
    cfg = main_config(args).replace(solver_mode=FB_TEL_MODE)
    rec, res = {}, {}
    for on in (False, True):
        rk.fused_cost_fwd_cuda.launches = 0
        rk.fused_cost_bwd_cuda.launches = 0
        rtr.host_read.count = 0
        res[on] = solve_tile(data, cdata, p0, cfg.replace(
            collect_telemetry=on, collect_quality=on))
        rec["on" if on else "off"] = {
            "em_s": res[on].phase_seconds["em"],
            "lbfgs_s": res[on].phase_seconds["lbfgs"],
            "rtr_host_reads": rtr.host_read.count,
            "launches": [rk.fused_cost_fwd_cuda.launches,
                         rk.fused_cost_bwd_cuda.launches]}
    off, on = rec["off"], rec["on"]
    same = bitwise(res[False], res[True])
    nrec = len(res[True].telemetry["em"])
    print(f"[fullbatch] telemetry off/on, mode {FB_TEL_MODE}, "
          f"{WARM_CLUSTERS} clusters: EM {off['em_s']:.3f}/{on['em_s']:.3f} "
          f"s, LBFGS {off['lbfgs_s']:.3f}/{on['lbfgs_s']:.3f} s, "
          f"rtr.host_read.count {off['rtr_host_reads']}/"
          f"{on['rtr_host_reads']}, #3/#4 launches {off['launches']}/"
          f"{on['launches']}; p and res_1 bit-identical {same}; {nrec} EM "
          f"traces", flush=True)
    if not same:
        fail("fullbatch telemetry: p or res_1 changed with telemetry on")
    if on["rtr_host_reads"] > off["rtr_host_reads"]:
        fail("fullbatch telemetry: more host reads with telemetry on")
    if on["launches"] != off["launches"] or min(on["launches"]) <= 0:
        fail(f"fullbatch telemetry: launches {off['launches']} vs "
             f"{on['launches']}")
    del data, cdata, res

    path, sky, clus = fullbatch_dataset(dirname, WARM_CLUSTERS, TILESZ, "tel")
    events = os.path.join(dirname, "events.jsonl")
    app = {}
    for flag in ("0", "1"):
        os.environ["SAGECAL_TELEMETRY"] = flag
        os.environ["SAGECAL_EVENT_LOG"] = events
        try:
            results = fullbatch_cli(path, sky, clus,
                                    os.path.join(dirname, "tel.solutions"),
                                    log=lambda msg: None)
        finally:
            del os.environ["SAGECAL_TELEMETRY"], os.environ["SAGECAL_EVENT_LOG"]
        app[flag] = (results, np.asarray(MemFile(path, "r")["corrected"]))
    remove(path)
    kinds = [e["type"] for e in read_events(events)]
    manifest = read_events(events)[0]
    app_same = (app["0"][0] == app["1"][0]
                and np.array_equal(app["0"][1], app["1"][1]))
    counts = {k: kinds.count(k) for k in ("run_manifest", "cluster_convergence",
                                          "solve_quality", "tile_done",
                                          "run_done")}
    print(f"[fullbatch] app, SAGECAL_TELEMETRY 0/1: results and residual "
          f"column bit-identical {app_same}; event log {counts}, manifest "
          f"problems {validate_manifest(manifest)}, device_kind "
          f"{manifest.get('device_kind')!r}, kernel_path "
          f"{manifest.get('kernel_path')!r}", flush=True)
    if not app_same:
        fail("fullbatch telemetry: the app's results changed with telemetry")
    if (counts["cluster_convergence"] < WARM_CLUSTERS
            or counts["solve_quality"] < 1 or counts["run_done"] != 1):
        fail(f"fullbatch telemetry: event log {counts}")
    if validate_manifest(manifest) or manifest.get("platform") != "gpu":
        fail(f"fullbatch telemetry: manifest {manifest}")
    return {"solve": rec, "bitwise": same, "app_bitwise": app_same,
            "events": counts}


# the beam phase: one north-star tile with a LOFAR-HBA-like /beam group
# (STAT_TILE: 16 dipoles of a tile, then the tile centroids), the
# reference -B codes timed, and the CLI with -B 2 and --element-coeffs
BEAM_CODES = (1, 2, 3, 5)  # array, array x element, element, wideband full
BEAM_CORE, BEAM_REMOTE_TILES, BEAM_CORE_TILES = 24, 48, 24
# at phase 7's depth (-g 3; -g 6 until the consensus phases joined, to
# keep the script near 450 s on an "NVIDIA H100 80GB HBM3, 700.00 W")
BEAM_FLAGS = FB_FLAGS + ("-B", "2", "--element-coeffs", "hba")


def hba_beam_group(seed: int = 11) -> dict:
    """A LOFAR-HBA-like ``/beam`` group for NSTATIONS stations, STAT_TILE:
    per station the 16 dipoles of a tile (a 4 x 4 grid at 1.25 m), then
    its tile centroids, 48 for the NSTATIONS - BEAM_CORE remote stations
    (a 41 m field) and 24 for the BEAM_CORE core stations (a 31 m field,
    masked to 64 entries); core stations within ~2 km of the array
    centre, remote ones within ~60 km."""
    rng = np.random.default_rng(seed)
    K = 16 + BEAM_REMOTE_TILES
    g = np.arange(4) * 1.25 - 1.875
    dx, dy = (a.reshape(-1) for a in np.meshgrid(g, g))
    x, y = np.zeros((NSTATIONS, K)), np.zeros((NSTATIONS, K))
    mask = np.zeros((NSTATIONS, K), bool)
    x[:, :16], y[:, :16] = dx, dy
    mask[:, :16] = True
    lon0, lat0 = math.radians(6.869837), math.radians(52.915122)
    lon, lat = np.empty(NSTATIONS), np.empty(NSTATIONS)
    for s in range(NSTATIONS):
        core = s < BEAM_CORE
        ntile = BEAM_CORE_TILES if core else BEAM_REMOTE_TILES
        radius = 15.5 if core else 20.5
        r = radius * np.sqrt(rng.uniform(0.0, 1.0, ntile))
        th = rng.uniform(0.0, 2 * np.pi, ntile)
        x[s, 16:16 + ntile], y[s, 16:16 + ntile] = r * np.cos(th), r * np.sin(th)
        mask[s, 16:16 + ntile] = True
        spread = 2e3 if core else 6e4  # metres
        lon[s] = lon0 + rng.uniform(-1, 1) * spread / 6.371e6 / math.cos(lat0)
        lat[s] = lat0 + rng.uniform(-1, 1) * spread / 6.371e6
    return dict(longitude=lon, latitude=lat, elem_x=x, elem_y=y,
                elem_z=np.zeros((NSTATIONS, K)), elem_mask=mask,
                b_ra0=RA0, b_dec0=DEC0, bf_type=2, beam_f0=150e6)


def beam_dataset(dirname: str):
    """An in-memory ``vis.h5`` of one north-star tile (TILESZ timeslots x
    NCHAN channels) with ``hba_beam_group``'s ``/beam`` group, its phase
    centre the sky's, and visibilities of write_sky's 100 point clusters
    through the beam (-B 2, the HBA element table) under true gains,
    noise 1e-3.  Returns (path, sky file, cluster file)."""
    from sagecal_tpu_torch.apps.fullbatch import _REF_BEAM_MODES
    from sagecal_tpu_torch.core.types import jones_to_params
    from sagecal_tpu_torch.io.dataset import (
        VisDataset, simulate_dataset, write_beam_group,
    )
    from sagecal_tpu_torch.io.memh5 import MemFile
    from sagecal_tpu_torch.io.simulate import random_jones
    from sagecal_tpu_torch.io.skymodel import load_sky
    from sagecal_tpu_torch.ops.beam import ElementCoeffs
    from sagecal_tpu_torch.solvers.sage import (
        build_cluster_data_withbeam, predict_full_model,
    )

    sky, clus = write_sky(dirname, nclusters=NCLUSTERS, name="beam")
    path = os.path.join(dirname, "beam.h5")
    simulate_dataset(path, nstations=NSTATIONS, ntime=TILESZ, nchan=NCHAN,
                     seed=0, dec0=DEC0, open_file=MemFile)
    with MemFile(path, "r+") as f:
        f.attrs["ra0"] = RA0
        write_beam_group(f, hba_beam_group())
    with VisDataset(path, "r+", MemFile) as ds:
        meta = ds.meta
        geom, pointing = ds.load_beam()
        full = ds.load_tile(0, TILESZ, average_channels=False)
        clusters, cdefs, _ = load_sky(sky, clus, meta.ra0, meta.dec0,
                                      dtype=torch.float64)
        mode, wideband = _REF_BEAM_MODES[2]
        cdata = build_cluster_data_withbeam(
            full, clusters, [c.nchunk for c in cdefs], geom, pointing,
            ElementCoeffs.from_table("hba", meta.freq0), mode,
            ds.time_jd(0, TILESZ), meta.ra0, meta.dec0,
            fdelta=meta.deltaf / NCHAN, wideband=wideband)
        truth = jones_to_params(random_jones(NCLUSTERS, NSTATIONS, seed=3,
                                             amp=0.2, dtype=np.complex128))
        with torch.no_grad():
            model = predict_full_model(truth[:, None, :], cdata, full)
        rng = np.random.default_rng(5)
        vis = model.permute(2, 0, 1).reshape(ROWS, NCHAN, 2, 2).cpu().numpy()
        vis = vis + 1e-3 * (rng.standard_normal(vis.shape)
                            + 1j * rng.standard_normal(vis.shape))
        ds.write_tile(0, vis, column="vis")
    return path, sky, clus


def beam_coherencies(path: str, sky: str, clus: str):
    """``build_cluster_data_withbeam`` at the north-star tile (the
    solver's channel-averaged view, f32) for each of BEAM_CODES, each
    timed with its peak device memory; returns (rows, the tile, the -B 2
    ClusterData)."""
    from sagecal_tpu_torch.apps.fullbatch import _REF_BEAM_MODES
    from sagecal_tpu_torch.io.dataset import VisDataset
    from sagecal_tpu_torch.io.memh5 import MemFile
    from sagecal_tpu_torch.io.skymodel import load_sky
    from sagecal_tpu_torch.ops.beam import DOBEAM_ARRAY, ElementCoeffs
    from sagecal_tpu_torch.solvers.sage import build_cluster_data_withbeam

    with VisDataset(path, "r", MemFile) as ds:
        meta = ds.meta
        geom, pointing = ds.load_beam()
        data = ds.load_tile(0, TILESZ, dtype=np.float32)
        jd = ds.time_jd(0, TILESZ)
    clusters, cdefs, _ = load_sky(sky, clus, meta.ra0, meta.dec0)
    coeff = ElementCoeffs.from_table("hba", meta.freq0)
    rows, keep = [], None
    for code in BEAM_CODES:
        mode, wideband = _REF_BEAM_MODES[code]
        torch.cuda.reset_peak_memory_stats()
        t = sync_clock()
        cd = build_cluster_data_withbeam(
            data, clusters, [c.nchunk for c in cdefs], geom, pointing,
            None if mode == DOBEAM_ARRAY else coeff, mode, jd, meta.ra0,
            meta.dec0, wideband=wideband)
        secs = sync_clock() - t
        peak = torch.cuda.max_memory_allocated()
        off = float(cd.coh[:, :, 1].abs().max() / cd.coh.abs().max())
        finite = bool(torch.isfinite(cd.coh).all())
        rows.append({"code": code, "seconds": secs, "peak_bytes": peak,
                     "offdiag_rel": off, "finite": finite})
        print(f"[beam] build_cluster_data_withbeam -B {code} (mode {mode}, "
              f"wideband {wideband}): {secs:.3f} s, peak device memory "
              f"{peak / 2**30:.3f} GiB, coherencies {tuple(cd.coh.shape)}, "
              f"max |XY|/max |C| {off:.3e}", flush=True)
        if not finite:
            fail(f"beam coherencies -B {code} not finite")
        if code == 2:
            keep = cd
        del cd
    if not rows[1]["offdiag_rel"] > 1e-4:
        fail("-B 2 coherencies have no off-diagonal (XY) power")
    return rows, data, keep


def beam_parity(data, cdata) -> dict:
    """#3/#4 against their plain version on the -B 2 coherencies (complex
    off-diagonal 2x2s, which an unpolarized unbeamed point sky never
    has): the tile's packed inputs at identity gains (the solve's start)
    and at seeded random gains, Gaussian and robust (nu 5), through the
    station plan a solve builds, at phase 3's tolerances."""
    from sagecal_tpu_torch.core.types import jones_to_params
    from sagecal_tpu_torch.io.simulate import random_jones
    from sagecal_tpu_torch.kernels.parity import (
        compare_with_plain, plan_of, tile_cost_problem,
    )

    worst = {"fused_cost_fwd": 0.0, "fused_cost_bwd": 0.0}
    cases = []
    for label, amp in (("identity gains", 0.0), ("random gains", 0.2)):
        p = jones_to_params(random_jones(NCLUSTERS, NSTATIONS, seed=9,
                                         amp=amp))[:, None, :]
        prob = tile_cost_problem(data, cdata, p)
        plan = plan_of(prob)
        for nu in (None, 5.0):
            o = compare_with_plain(prob, nu, plan)
            ok = (o["cost_rel"] <= COST_TOL and o["grad_rel"] <= GRAD_TOL
                  and o["bitwise_repeat"])
            print(f"[beam] objective parity on -B 2 coherencies, {label}, "
                  f"nu={nu}: cost_rel={o['cost_rel']:.3e} "
                  f"grad_rel={o['grad_rel']:.3e} bitwise_repeat="
                  f"{o['bitwise_repeat']} {'ok' if ok else 'FAILED'}",
                  flush=True)
            if not ok:
                fail(f"objective kernel parity on beam coherencies, {label} "
                     f"nu={nu}: {o}")
            worst["fused_cost_fwd"] = max(worst["fused_cost_fwd"],
                                          o["cost_abs_err"])
            worst["fused_cost_bwd"] = max(worst["fused_cost_bwd"],
                                          o["grad_max_abs_err"])
            cases.append(dict(o, problem=label, nu=nu))
    return {"worst": worst, "cases": cases}


def beam_cli(path, sky, clus, sol, extra=(), env=None):
    """One app run through the CLI with BEAM_FLAGS, its
    kernel launches counted from 0 (``TileLog`` for a residual tile), the
    environment ``env`` set around it; returns (results, TileLog, wall
    seconds, launches of the whole run)."""
    log = TileLog()
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    torch.cuda.reset_peak_memory_stats()
    t = sync_clock()
    try:
        results = fullbatch_cli(path, sky, clus, sol, extra=extra, log=log,
                                flags=BEAM_FLAGS)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = sync_clock() - t
    launches = {k: c.launches for k, c in log.kernels.items()}
    return results, log, wall, launches


def phase_beam(dirname: str):
    """Beam-aware calibration and influence diagnostics (module doc,
    phase 13)."""
    from sagecal_tpu_torch.io.memh5 import MemFile, remove
    from sagecal_tpu_torch.obs.trace import default_chrome_path, read_spans
    from sagecal_tpu_torch.ops import diagnostics

    t_start = sync_clock()
    t = sync_clock()
    path, sky, clus = beam_dataset(dirname)
    out = {"dataset_s": sync_clock() - t}
    print(f"[beam] one tile of {ROWS} rows x {NCHAN} channels, "
          f"{NCLUSTERS} clusters, STAT_TILE geometry ({BEAM_CORE} core "
          f"stations of {BEAM_CORE_TILES} tiles, {NSTATIONS - BEAM_CORE} "
          f"remote of {BEAM_REMOTE_TILES}, 16 dipoles a tile), made through "
          f"the beam in {out['dataset_s']:.1f} s; flags "
          f"{' '.join(BEAM_FLAGS)}", flush=True)
    out["coherencies"], data, cdata = beam_coherencies(path, sky, clus)
    out["parity"] = beam_parity(data, cdata)
    del data, cdata
    torch.cuda.empty_cache()

    # the CLI with -B 2, twice: the second with the span tracer and the
    # flight recorder on, which must change no bit
    sol = os.path.join(dirname, "beam.solutions")
    trace_log = os.path.join(dirname, "beam.spans.jsonl")
    hb = os.path.join(dirname, "beam.heartbeat")
    runs = []
    for k, env in enumerate((None, {
            "SAGECAL_TRACE": "1", "SAGECAL_TRACE_LOG": trace_log,
            "SAGECAL_FLIGHT": "1", "SAGECAL_HEARTBEAT_FILE": hb})):
        results, log, wall, _ = beam_cli(path, sky, clus, sol, env=env)
        runs.append({"results": results, "tiles": log.tiles, "wall_s": wall,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "solutions": open(sol).read(),
                     "column": np.asarray(MemFile(path, "r")["corrected"])})
        print(f"[beam] -B 2 run {k + 1}{' (traced)' if env else ''}: "
              f"{wall:.1f} s, peak device memory "
              f"{runs[-1]['peak_bytes'] / 2**30:.2f} GiB, per tile "
              f"{log.tiles}", flush=True)
        (r0, r1), = results
        n = log.tiles[0]["launches"]
        if not (np.isfinite(r1) and r1 < r0):
            fail(f"beam -B 2: res_1 {r1} not below res_0 {r0}")
        if n["fused_cost_fwd"] <= 0 or n["fused_cost_bwd"] <= 0:
            fail(f"beam -B 2: objective kernels not launched: {n}")
        if n["fused_predict_fwd"] != 1:
            fail(f"beam -B 2: kernel #1 launched {n['fused_predict_fwd']} "
                 f"times in the residual step")
    a, b = runs
    same = (a["results"] == b["results"] and a["solutions"] == b["solutions"]
            and np.array_equal(a["column"], b["column"]))
    print(f"[beam] -B 2 res_0 {a['results'][0][0]:.6e} res_1 "
          f"{a['results'][0][1]:.6e}; second (traced) run bit-identical "
          f"(res, solutions file, residual column): {same}", flush=True)
    if not same:
        fail("beam -B 2: a second run gave different bits")

    spans = read_spans(trace_log)
    with open(default_chrome_path(trace_log)) as f:
        chrome = json.load(f)
    with open(hb) as f:
        beat = json.load(f)
    names = sorted({s["name"] for s in spans})
    xev = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    print(f"[beam] trace: {len(spans)} spans {names}, trace.json "
          f"{len(xev)} events; heartbeat {beat}", flush=True)
    if (len(xev) != len(spans) or "fullbatch" not in names
            or "tile" not in names or "solve" not in names):
        fail(f"beam trace: spans {names}, {len(xev)} trace events")
    if not beat.get("closed") or beat.get("pid") != os.getpid():
        fail(f"beam trace: heartbeat {beat}")

    # -i: the influence eigenvalues in place of the residuals
    results, log, wall, launches = beam_cli(path, sky, clus, sol + ".i",
                                            extra=("-i",))
    infl = np.asarray(MemFile(path, "r")["influence"])
    split = dict(diagnostics.last_seconds)
    finite = bool(np.isfinite(infl).all())
    (r0, r1), = results
    print(f"[beam] -i: {wall:.1f} s, res_0 {r0:.6e} res_1 {r1:.6e}, "
          f"influence column {infl.shape} finite {finite}, max |lambda| "
          f"{np.abs(infl).max():.3e}; influence_function seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; launches {launches}", flush=True)
    if not finite or not np.abs(infl).max() > 0:
        fail("beam -i: influence column not finite or all zero")
    if launches["fused_cost_fwd"] <= 0 or launches["fused_predict_fwd"] != 0:
        fail(f"beam -i: launches {launches}")
    remove(path)
    out.update(runs=[{k: r[k] for k in ("results", "tiles", "wall_s",
                                        "peak_bytes")} for r in runs],
               bitwise=same, spans=len(spans), span_names=names,
               heartbeat=beat,
               influence={"wall_s": wall, "seconds": split,
                          "results": results, "launches": launches,
                          "max_abs": float(np.abs(infl).max())})
    out["seconds"] = sync_clock() - t_start
    print(f"[beam] phase wall time {out['seconds']:.1f} s", flush=True)
    return out


def phase_predict(data, cdata, p0, card: str):
    """The predict path: ``tools/profile_kernel``'s profile (phase 8)."""
    from sagecal_tpu_torch.ops.rime_kernel import (
        fused_predict_bwd_cuda, fused_predict_fwd_cuda,
    )
    from sagecal_tpu_torch.tools.profile_kernel import profile

    fused_predict_fwd_cuda.launches = 0
    fused_predict_bwd_cuda.launches = 0
    out = profile(data, cdata, p0.to(data.device), card)
    out["launches"] = {"fused_predict_fwd": fused_predict_fwd_cuda.launches,
                       "fused_predict_bwd": fused_predict_bwd_cuda.launches}
    print(f"[predict] launches on the predict path: {out['launches']}",
          flush=True)
    for k, n in out["launches"].items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the predict path")
    if not out["lbfgs_cost1"] < out["lbfgs_cost0"]:
        fail("the LBFGS on the composed predict cost did not lower it")
    return out


def bisect_run():
    """The kbisect tool's main path: ``run`` of every variant on the card,
    launch counts set to 0 just before it and read just after.  Returns
    (values, launches)."""
    from sagecal_tpu_torch.kernels.parity import KBISECT_JAX_VALUES
    from sagecal_tpu_torch.ops import rime_kernel as rk
    from sagecal_tpu_torch.tools import kbisect as kb

    counters = {k: getattr(kb, f"probe_{p}_cuda") for k, p in PROBES.items()}
    counters.update({k: getattr(rk, k + "_cuda") for k in KERNELS[:2]})
    for c in counters.values():
        c.launches = 0
    vals = kb.run(BISECT_VARIANTS)
    launches = {k: c.launches for k, c in counters.items()}
    want = {k: 1 for k in PROBES}
    want.update(fused_predict_fwd=2, fused_predict_bwd=1)  # d, e; e
    print(f"[bisect] launches in the tool's run: {launches}", flush=True)
    if launches != want:
        fail(f"kbisect run launched {launches}, want {want}")
    for name, v in vals.items():
        ref = KBISECT_JAX_VALUES[name]
        rel = abs(v["val"] - ref) / abs(ref)
        v["rel_vs_jax"] = rel
        ok = rel <= BISECT_VAL_TOL
        print(f"[bisect] {name}: val={v['val']!r} JAX {ref!r} rel "
              f"{rel:.3e} {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            fail(f"kbisect variant {name} gave {v['val']}, JAX {ref}")
    return vals, launches


def bisect_parity():
    """Each probe against its plain version at both shapes, with station
    indices out of range mixed in for a and f, and probe b refusing
    F = 2.  Returns {kernel: worst max abs error}."""
    from sagecal_tpu_torch.kernels.parity import (
        compare_probe_with_plain, mix_out_of_range, random_probe_inputs,
    )
    from sagecal_tpu_torch.tools.kbisect import probe_b

    worst = {k: 0.0 for k in PROBES}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (k, name), shape in itertools.product(PROBES.items(), BISECT_SHAPES):
        sh = BISECT_SHAPES[shape][name]
        inputs = random_probe_inputs(name, gen, **sh)
        cases = [("", inputs, None)]
        if name in ("a", "f"):
            cases.append((" out-of-range", *mix_out_of_range(name, inputs)))
        for label, args, zero in cases:
            out = compare_probe_with_plain(name, args, zero)
            ok = (out["rel"] <= PROBE_TOL and out["bitwise_repeat"]
                  and out["zeros_exact"])
            print(f"[bisect-parity] {k} {shape}{label} {sh}: rel="
                  f"{out['rel']:.3e} max_abs_err={out['max_abs_err']:.3e} "
                  f"bitwise_repeat={out['bitwise_repeat']} zeros_exact="
                  f"{out['zeros_exact']} {'ok' if ok else 'FAILED'}",
                  flush=True)
            if not ok:
                fail(f"probe {k} parity at {shape}{label}: {out}")
            worst[k] = max(worst[k], out["max_abs_err"])
        del inputs, cases
    try:
        probe_b(torch.zeros((8, 2, 8, 512), device="cuda"))
    except ValueError:
        print("[bisect-parity] kbisect_b with F = 2 raised ValueError ok",
              flush=True)
    else:
        fail("probe b accepted F = 2")
    torch.cuda.empty_cache()
    return worst


def bisect_times():
    """Each probe's kernel, plain-version and (for c and b) library-call
    times at both shapes beside its bound: ({kernel: {shape: {...}}},
    launch floor ms).  The kernel and the library call are timed on the
    device alone (``device_ms``), since at kbisect's shape (and for a and
    f at both) their host work outlasts their kernels; ``host_paced_ms``
    is the kernel's time over back-to-back calls (``cuda_ms``), host
    included.  a and f are also timed in each form of their launch (two
    launches, and each of those alone: reduce, gather; one launch), of
    which the default (``ms``) is one.  The launch floor is ``device_ms``
    of an empty launch (``torch.cuda._sleep(0)``).  The library call must
    agree with the plain version as the kernel does."""
    from sagecal_tpu_torch.kernels.parity import (
        kbisect_work, probe_library_call, random_probe_inputs, roofline,
    )
    from sagecal_tpu_torch.tools import kbisect as kb
    from sagecal_tpu_torch.tools.profile_kernel import cuda_ms, device_ms
    from sagecal_tpu_torch.utils.precision import full_f32

    gen = torch.Generator(device="cuda").manual_seed(1)
    floor_ms = device_ms(lambda: torch.cuda._sleep(0), 200)
    out = {}
    for k, name in PROBES.items():
        out[k] = {}
        kern = getattr(kb, f"probe_{name}_cuda")
        plain = getattr(kb, f"probe_{name}_plain")
        for shape in BISECT_SHAPES:
            sh = BISECT_SHAPES[shape][name]
            args = random_probe_inputs(name, gen, **sh)
            reps = 50 if shape == "north-star" and name in "cb" else 200
            row = {"ms": device_ms(lambda: kern(*args), reps),
                   "host_paced_ms": cuda_ms(lambda: kern(*args), reps)}
            if name in "af":  # each form of the launch, and the parts
                sc = {}
                kern(*args, stages=3, scratch=sc)
                row["forms_device_ms"] = {
                    form: device_ms(lambda st=st: kern(*args, stages=st,
                                                       scratch=sc), reps)
                    for form, st in (("two launches", 3), ("reduce alone", 1),
                                     ("gather alone", 2), ("one launch", 4))}
            with torch.no_grad():
                row["plain_ms"] = cuda_ms(lambda: plain(*args), 20)
                lib = probe_library_call(name, args)
                row["library_ms"] = None
                if lib is not None:
                    with full_f32():
                        want = plain(*args).reshape(-1).double()
                        err = float((lib().reshape(-1).double() - want)
                                    .abs().max()) / float(want.abs().max())
                        if not err <= PROBE_TOL:
                            fail(f"{k}'s library call differs from its plain "
                                 f"version by {err:.3e} at {shape}")
                        row["library_rel"] = err
                        row["library_ms"] = device_ms(lib, 20)
            row.update(roofline(*kbisect_work(name, args)))
            row["shape"] = sh
            out[k][shape] = row
            del args
    torch.cuda.empty_cache()
    return out, floor_ms


def phase_bisect(card: str):
    """The kbisect tool on the card (module doc, phase 9)."""
    t = time.perf_counter()
    vals, launches = bisect_run()
    worst = bisect_parity()
    times, floor_ms = bisect_times()
    print(f"[times] ({card}) launch floor (an empty launch, device only): "
          f"{floor_ms:.4f} ms", flush=True)
    for k, rows in times.items():
        for shape, v in rows.items():
            lib = ("" if v["library_ms"] is None
                   else f", torch.einsum {v['library_ms']:.4f} ms (rel "
                        f"{v['library_rel']:.1e} vs plain)")
            split = ("" if "forms_device_ms" not in v else
                     "; device only: " + ", ".join(
                         f"{form} {ms:.4f} ms"
                         for form, ms in v["forms_device_ms"].items()))
            print(f"[times] ({card}) {k} at {shape} {v['shape']}: "
                  f"{v['ms']:.4f} ms on the device ({v['host_paced_ms']:.4f} "
                  f"ms host-paced), bound {v['bound_ms']:.6f} ms "
                  f"({v['bound_by']}: {v['bytes']} B, {v['flops']} flop, "
                  f"{v['gathers']} gathered words), "
                  f"plain {v['plain_ms']:.4f} ms{lib}{split}, {launches[k]} "
                  f"launch per kbisect run", flush=True)
    secs = time.perf_counter() - t
    print(f"[bisect] phase wall time {secs:.1f} s", flush=True)
    return {"values": vals, "launches": launches, "worst": worst,
            "times": times, "launch_floor_ms": floor_ms, "seconds": secs}


def split_device_ms(launch, parts: dict, whole: int) -> dict:
    """A backward's kernels one at a time and its whole launch, on the
    device alone: ``launch(stages, scratch)`` with one scratch shared by
    every launch; ``parts`` {kernel: stages bit}."""
    from sagecal_tpu_torch.tools.profile_kernel import device_ms

    scratch = {}
    launch(whole, scratch)
    split = {name: device_ms(lambda st=st: launch(st, scratch), 20)
             for name, st in parts.items()}
    return {"split_device_ms": split,
            "device_ms": device_ms(lambda: launch(whole, scratch), 20)}


def print_split(card: str, name: str, v: dict):
    split = v["split_device_ms"]
    print(f"[times] ({card}) {name} per launch, device only: "
          + ", ".join(f"{k} {ms:.4f} ms" for k, ms in split.items())
          + f" (sum {sum(split.values()):.4f}); whole launch "
          f"{v['device_ms']:.4f} ms", flush=True)


def phase_times(nu: float):
    """Kernel and plain-version times at the main path's shapes (nc = 1,
    f32 coherencies; the objective robust as the default mode runs it,
    the predict under a random upstream cotangent).  The backwards run on
    the tile's station plan, built once, and are split into their
    kernels on the device alone."""
    from sagecal_tpu_torch.kernels.parity import (
        fused_cost_work, fused_predict_work, model_cotangent,
        random_cost_problem, roofline,
    )
    from sagecal_tpu_torch.ops.rime_kernel import (
        BwdPlan, _nu_cell, fused_cost_bwd_cuda, fused_cost_fwd_cuda,
        fused_cost_packed_plain, fused_predict_bwd_cuda,
        fused_predict_fwd_cuda, fused_predict_packed_plain,
    )
    from sagecal_tpu_torch.tools.profile_kernel import cuda_ms

    prob = random_cost_problem(NCLUSTERS, NSTATIONS, NCHAN, ROWS, nc=1,
                               seed=2, device="cuda")
    nu_arr = _nu_cell(nu, "cuda")
    args = (prob.tab_re, prob.tab_im, *prob.inputs, nu_arr, True)
    # the solve builds the station plan once per tile
    plan = BwdPlan(prob.ant_p, prob.ant_q, None, 1, prob.tab_re.shape[2])
    model_args = (prob.coh_ri, prob.ant_p, prob.ant_q)
    g = model_cotangent(prob, seed=6)
    out = {
        "fused_predict_fwd": {"ms": cuda_ms(lambda: fused_predict_fwd_cuda(
            prob.tab_re, prob.tab_im, *model_args), 50)},
        "fused_predict_bwd": {"ms": cuda_ms(lambda: fused_predict_bwd_cuda(
            prob.tab_re, prob.tab_im, *model_args, g, plan=plan), 20)},
        "fused_cost_fwd": {"ms": cuda_ms(lambda: fused_cost_fwd_cuda(*args),
                                         50)},
        "fused_cost_bwd": {"ms": cuda_ms(
            lambda: fused_cost_bwd_cuda(*args, plan=plan), 20)},
    }
    out["fused_cost_bwd"].update(split_device_ms(
        lambda st, sc: fused_cost_bwd_cuda(*args, plan=plan, stages=st,
                                           scratch=sc),
        {"cotangent": 1, "gradient": 2, "sum": 4}, 7))
    out["fused_predict_bwd"].update(split_device_ms(
        lambda st, sc: fused_predict_bwd_cuda(
            prob.tab_re, prob.tab_im, *model_args, g, plan=plan, stages=st,
            scratch=sc),
        {"gradient": 2, "sum": 4}, 6))
    with torch.no_grad():
        out["fused_predict_fwd"]["plain_ms"] = cuda_ms(
            lambda: fused_predict_packed_plain(prob.tab_re, prob.tab_im,
                                               *model_args), 10)
        out["fused_cost_fwd"]["plain_ms"] = cuda_ms(
            lambda: fused_cost_packed_plain(prob.tab_re, prob.tab_im,
                                            *prob.inputs, nu_arr), 10)
    a = prob.tab_re.clone().requires_grad_(True)
    b = prob.tab_im.clone().requires_grad_(True)
    model = fused_predict_packed_plain(a, b, *model_args)
    out["fused_predict_bwd"]["plain_ms"] = cuda_ms(
        lambda: torch.autograd.grad(model, (a, b), g, retain_graph=True), 10)
    del model
    cost = fused_cost_packed_plain(a, b, *prob.inputs, nu_arr)
    out["fused_cost_bwd"]["plain_ms"] = cuda_ms(
        lambda: torch.autograd.grad(cost, (a, b), retain_graph=True), 10)
    work = {"fused_cost": fused_cost_work(prob),
            "fused_predict": fused_predict_work(prob)}
    for name in out:
        family, key = name.rsplit("_", 1)
        out[name].update(roofline(*work[family][key]))
    return out


def serve_parity():
    """Batched kernels #5 and #6 against their plain version at the serve
    width (B lanes of SERVE_CLUSTERS clusters at the north-star tile)."""
    from sagecal_tpu_torch.kernels.parity import (
        compare_batch_with_plain, random_cost_problem_batch,
    )

    worst = {"fused_cost_batch_fwd": 0.0, "fused_cost_batch_bwd": 0.0}
    per_lane_nu = torch.linspace(2.0, 12.0, SERVE_B, device="cuda")
    cases = [(nu, dt, None) for nu in (None, per_lane_nu)
             for dt in (torch.float32, torch.bfloat16)]
    cases.append((per_lane_nu, torch.float32, SERVE_RAGGED))
    plan_s = []
    for nu, dt, nvalid in cases:
        prob = random_cost_problem_batch(SERVE_B, SERVE_CLUSTERS, NSTATIONS,
                                         NCHAN, ROWS, coh_dtype=dt, seed=3,
                                         nvalid=nvalid, device="cuda")
        case = (f"{'robust per-lane nu' if nu is not None else 'gaussian'} "
                f"coh={str(dt).split('.')[-1]} valid lanes="
                f"{SERVE_B if nvalid is None else nvalid}/{SERVE_B}")
        plan, secs = timed_plan(prob, "serve-parity", f"{case}, one for the "
                                f"{SERVE_B} lanes")
        plan_s.append(secs)
        out = compare_batch_with_plain(prob, nu, plan)
        del prob, plan
        torch.cuda.empty_cache()
        ok = (out["cost_rel"] <= COST_TOL and out["grad_rel"] <= GRAD_TOL
              and out["bitwise_repeat"] and out["pad_lanes_zero"])
        print(f"[serve-parity] {case}: cost_rel={out['cost_rel']:.3e} "
              f"grad_rel={out['grad_rel']:.3e} "
              f"bitwise_repeat={out['bitwise_repeat']} "
              f"pad_lanes_zero={out['pad_lanes_zero']} "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            fail(f"batched kernel parity {case}: {out}")
        worst["fused_cost_batch_fwd"] = max(worst["fused_cost_batch_fwd"],
                                            out["cost_abs_err"])
        worst["fused_cost_batch_bwd"] = max(worst["fused_cost_batch_bwd"],
                                            out["grad_max_abs_err"])
    return worst, plan_s


def serve_requests(dirname: str):
    """SERVE_B requests as a user builds them: each its own LSM sky of
    SERVE_CLUSTERS point clusters and its own true gains, on the shared
    north-star geometry -> (VisData, ClusterData, p0) per request."""
    from sagecal_tpu_torch.core.types import jones_to_params
    from sagecal_tpu_torch.io.simulate import (
        corrupt_and_observe, make_visdata, random_jones,
    )
    from sagecal_tpu_torch.io.skymodel import load_sky
    from sagecal_tpu_torch.solvers.sage import build_cluster_data

    p0 = jones_to_params(random_jones(SERVE_CLUSTERS, NSTATIONS, seed=9,
                                      amp=0.0))[:, None, :]
    reqs = []
    for b in range(SERVE_B):
        sky, clus = write_sky(dirname, seed=100 + b,
                              nclusters=SERVE_CLUSTERS, name=f"req{b}")
        clusters, cdefs, _ = load_sky(sky, clus, RA0, DEC0)
        data = make_visdata(nstations=NSTATIONS, tilesz=TILESZ, nchan=NCHAN,
                            dec0=DEC0, seed=0)
        truth = random_jones(SERVE_CLUSTERS, NSTATIONS, seed=200 + b,
                             amp=0.2)
        data = corrupt_and_observe(data, clusters, jones=truth,
                                   noise_sigma=1e-3, seed=300 + b,
                                   fdelta=data.deltaf)
        cdata = build_cluster_data(data, clusters, [c.nchunk for c in cdefs])
        reqs.append((data, cdata, p0.clone()))
    return reqs


def _reset_launches():
    from sagecal_tpu_torch.ops import rime_kernel as rk

    for k in KERNELS:
        getattr(rk, k + "_cuda").launches = 0


def _read_launches() -> dict:
    from sagecal_tpu_torch.ops import rime_kernel as rk

    return {k: getattr(rk, k + "_cuda").launches for k in KERNELS}


def serve_config():
    from sagecal_tpu_torch.solvers.sage import SM_OSLM_OSRLM_RLBFGS, SageConfig

    return SageConfig(solver_mode=SM_OSLM_OSRLM_RLBFGS, use_fused_predict=True,
                      max_emiter=SERVE_MAX_EMITER, max_iter=SERVE_MAX_ITER,
                      max_lbfgs=SERVE_MAX_LBFGS)


def serve_solve(reqs, idx, config, valid=None, fused=True):
    """Requests ``idx`` stacked into one bucket and solved by
    ``sagefit_packed_batch`` (lane generators from SEED and the request
    ids) -> (result, wall seconds)."""
    from sagecal_tpu_torch.solvers.batched import (
        derive_lane_generators, sagefit_packed_batch, stack_lanes,
    )

    data, cdata, p0 = stack_lanes([reqs[i] for i in idx])
    t0 = sync_clock()
    res = sagefit_packed_batch(
        data, cdata, data.vis.real, data.vis.imag, cdata.coh.real,
        cdata.coh.imag, p0, config, derive_lane_generators(SEED, idx),
        valid, batched_fused=fused)
    return res, sync_clock() - t0


def phase_serve(dirname: str):
    """The batched serve solve of one bucket (module doc, phase 11)."""
    from sagecal_tpu_torch.serve import bucket_of, pad_indices
    from sagecal_tpu_torch.solvers.batched import (
        choose_batched_path, derive_lane_generators, stack_lanes,
    )
    from sagecal_tpu_torch.solvers.sage import solve_tile

    cfg = serve_config()
    t = time.perf_counter()
    reqs = serve_requests(dirname)
    build_s = sync_clock() - t
    buckets = {bucket_of(*r) for r in reqs}
    if len(buckets) != 1:
        fail(f"serve requests fall in {len(buckets)} buckets: {buckets}")
    bucket = buckets.pop()
    print(f"[serve] bucket {bucket.short()} x {SERVE_B} requests, built in "
          f"{build_s:.3f} s; mode {cfg.solver_mode} emiter {cfg.max_emiter} "
          f"max_iter {cfg.max_iter} max_lbfgs {cfg.max_lbfgs}", flush=True)

    def solve(idx, valid=None, config=cfg, fused=True):
        return serve_solve(reqs, idx, config, valid, fused)

    lanes = list(range(SERVE_B))
    data_b, cdata_b, p0_b = stack_lanes(reqs)
    path, reason = choose_batched_path(data_b, cdata_b, p0_b, cfg)
    del data_b, cdata_b
    print(f"[serve] route: {path} ({reason})", flush=True)
    if path != "fused_batch":
        fail(f"serve bucket routed to {path!r}: {reason}")

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    res, wall = solve(lanes)
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    r0, r1 = res.res_0.double().cpu(), res.res_1.double().cpu()
    print(f"[serve] fused_batch: {wall:.3f} s (EM "
          f"{res.phase_seconds['em']:.3f} s, LBFGS "
          f"{res.phase_seconds['lbfgs']:.3f} s), LBFGS iterations "
          f"{res.lbfgs_iterations}, peak {peak / 2**30:.2f} GiB", flush=True)
    print(f"[serve] res_0 {[f'{x:.4e}' for x in r0.tolist()]}", flush=True)
    print(f"[serve] res_1 {[f'{x:.4e}' for x in r1.tolist()]}", flush=True)
    print(f"[serve] launches in the batched solve: {launches}", flush=True)
    if not (torch.isfinite(r1).all() and (r1 < r0).all()):
        fail("a serve lane did not reduce its residual to a finite value")
    if not torch.isfinite(res.p).all():
        fail("non-finite serve solutions")
    for k in ("fused_cost_batch_fwd", "fused_cost_batch_bwd"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the serve path")
    for k in ("fused_cost_fwd", "fused_cost_bwd"):
        if launches[k] != 0:
            fail(f"solo kernel {k} launched {launches[k]} times in the "
                 f"batched solve")

    gens = derive_lane_generators(SEED, lanes)
    t0 = sync_clock()
    for b in lanes:
        solve_tile(*reqs[b], cfg, gens[b])
    wall_seq = sync_clock() - t0
    res2, wall2 = solve(lanes)
    same = bitwise(res, res2)
    print(f"[serve] solves/s: fused_batch {SERVE_B / wall:.4f} and "
          f"{SERVE_B / wall2:.4f}, sequential solve_tile (fused) "
          f"{SERVE_B / wall_seq:.4f}; batched/sequential "
          f"{wall_seq / wall:.3f} and {wall_seq / wall2:.3f}", flush=True)
    print(f"[serve] two default-mode fused_batch runs bit-identical in p and "
          f"res_1: {same}", flush=True)
    if not same:
        fail("two default-mode fused_batch runs gave different bits")

    res_u, wall_u = solve(lanes, config=cfg.replace(use_fused_predict=False),
                          fused=False)
    idx, valid = pad_indices(SERVE_RAGGED, SERVE_B)
    res_r, wall_r = solve(idx, valid=valid)
    rel_u = rel_max(res.res_1, res_u.res_1)
    print(f"[serve] per-lane torch-op route {wall_u:.3f} s, worst res_1 rel "
          f"diff vs fused_batch {rel_u:.3e} (bar {RES1_TOL})", flush=True)
    if not rel_u <= RES1_TOL:
        fail(f"fused_batch vs torch-op res_1 differ by {rel_u}")
    real = slice(0, SERVE_RAGGED)
    rel_r = rel_max(res_r.res_1[real], res.res_1[real])
    ragged_bits = bool(torch.equal(res_r.res_1[real], res.res_1[real])
                       and torch.equal(res_r.p[real], res.p[real]))
    print(f"[serve] ragged bucket {SERVE_RAGGED} padded to {SERVE_B} "
          f"(lanes {idx}): {wall_r:.3f} s, worst real-lane res_1 rel diff "
          f"vs the full bucket {rel_r:.3e} (bar 1e-5), bit-identical "
          f"{ragged_bits}", flush=True)
    if not rel_r <= 1e-5:
        fail(f"ragged bucket's real lanes differ by {rel_r}")
    return {
        "bucket": bucket.short(), "route": path, "launches": launches,
        "lbfgs_iterations": res.lbfgs_iterations,
        "em_s": [res.phase_seconds["em"], res2.phase_seconds["em"]],
        "lbfgs_s": [res.phase_seconds["lbfgs"], res2.phase_seconds["lbfgs"]],
        "wall_s": [wall, wall2], "sequential_s": wall_seq,
        "bitwise_repeat": same, "torch_op_s": wall_u, "ragged_s": wall_r,
        "peak_bytes": peak, "res_0": r0.tolist(), "res_1": r1.tolist(),
        "res_1_torch_op": res_u.res_1.tolist(), "torch_op_rel": rel_u,
        "ragged_rel": rel_r, "ragged_bitwise": ragged_bits,
        "requests_s": build_s,
    }


def rel_max(a, b) -> float:
    """Worst per-lane |a - b| / |b|."""
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).abs() / b.abs()).max().item()


def service_workload(dirname: str):
    """The service phase's requests (module doc, phase 12): one
    in-memory ``vis.h5`` of SVC_TILES north-star tiles made by the
    port's ``simulate_dataset`` from ``write_sky``'s LSM sky of
    SERVE_CLUSTERS point clusters under true gains, noise 1e-3; tenant A
    asks for SVC_A tiles of it with the sky's cluster file, tenant B for
    SVC_B with a cluster file giving clusters 0 and 1 SVC_HYBRID hybrid
    chunks.  Returns (request manifest, its requests, dataset path)."""
    from sagecal_tpu_torch.io.dataset import simulate_dataset
    from sagecal_tpu_torch.io.memh5 import MemFile
    from sagecal_tpu_torch.io.simulate import random_jones
    from sagecal_tpu_torch.io.skymodel import load_sky
    from sagecal_tpu_torch.serve.request import load_requests

    sky, clus = write_sky(dirname, seed=11, nclusters=SERVE_CLUSTERS,
                          name="svc")
    clus_b = os.path.join(dirname, "svc_hybrid.cluster")
    with open(clus) as src, open(clus_b, "w") as dst:
        for k, line in enumerate(src):
            cid, nchunk, *names = line.split()
            nchunk = SVC_HYBRID if k < 2 else int(nchunk)
            dst.write(f"{cid} {nchunk} {' '.join(names)}\n")
    clusters, _, _ = load_sky(sky, clus, RA0, DEC0, dtype=torch.float64)
    truth = random_jones(SERVE_CLUSTERS, NSTATIONS, seed=5, amp=0.2,
                         dtype=np.complex128)
    path = os.path.join(dirname, "svc.h5")
    simulate_dataset(path, nstations=NSTATIONS, ntime=SVC_TILES * TILESZ,
                     nchan=NCHAN, clusters=clusters, jones=truth,
                     noise_sigma=1e-3, seed=0, dec0=DEC0, open_file=MemFile)
    MemFile(path, "r+").attrs["ra0"] = RA0

    def req(rid, tenant, cfile, t0):
        return {"request_id": rid, "tenant": tenant, "dataset": path,
                "sky_model": sky, "cluster_file": cfile, "t0": t0,
                "tilesz": TILESZ}

    reqs = ([req(f"a{i:02d}", "tenantA", clus, (i % SVC_TILES) * TILESZ)
             for i in range(SVC_A)]
            + [req(f"b{i:02d}", "tenantB", clus_b, i * TILESZ)
               for i in range(SVC_B)])
    manifest = os.path.join(dirname, "requests.json")
    with open(manifest, "w") as fh:
        json.dump({"requests": reqs}, fh, indent=1)
    return manifest, load_requests(manifest), path


class DispatchWatch:
    """The service's batch solves, seen through two public calls:
    ``solvers.batched.stack_lanes``, where a dispatch's packing starts,
    and ``ExecutableCache.get_with_status``, the lookup that ends it and
    hands out the solve.  The callable the lookup returns is wrapped: the
    kernels' counts are set to 0 and the peak memory is reset just before
    the solve, and read just after it, with the solve's seconds.  Pack
    seconds run from the stacking to the lookup, the interval of the
    service's own ``pack_s`` (the service publishes no pack time; the
    reference's goes to the lifecycle spans, ROADMAP.md A11).  Launches
    outside the solves (tile loading, manifests, shadow re-solves) are
    tallied apart.  Route and reason come from the result manifests
    (:func:`service_routes`).  The hybrid dispatch's stacked inputs and
    its result are kept for :func:`service_parity`."""

    def __init__(self):
        self.dispatches = []
        self.outside = {k: 0 for k in KERNELS}
        self.hybrid = None
        self._t_stack = None

    def _tally(self):
        for k, n in _read_launches().items():
            self.outside[k] += n
        _reset_launches()

    def __enter__(self):
        from sagecal_tpu_torch.serve.cache import ExecutableCache
        from sagecal_tpu_torch.solvers import batched

        self._saved = [(batched, "stack_lanes", batched.stack_lanes),
                       (ExecutableCache, "get_with_status",
                        ExecutableCache.get_with_status)]
        stack, lookup = (fn for _, _, fn in self._saved)
        watch = self
        _reset_launches()

        def stack_lanes(*a, **kw):
            watch._t_stack = sync_clock()
            return stack(*a, **kw)

        def get_with_status(cache, bucket, fingerprint, **kw):
            pack_s = sync_clock() - watch._t_stack
            fn, hit = lookup(cache, bucket, fingerprint, **kw)

            def solve(*a, **kw2):
                args = inspect.signature(fn).bind(*a, **kw2).arguments
                watch._tally()
                torch.cuda.reset_peak_memory_stats()
                t = sync_clock()
                out = fn(*a, **kw2)
                solve_s = sync_clock() - t
                valid, lanes = args.get("valid"), args["p0"].shape[0]
                watch.dispatches.append({
                    "bucket": bucket.short(), "cache_hit": hit,
                    "lanes": lanes,
                    "real": lanes if valid is None else int(valid.sum()),
                    "pack_s": pack_s, "solve_s": solve_s,
                    "launches": _read_launches(),
                    "peak_bytes": torch.cuda.max_memory_allocated()})
                _reset_launches()
                if args["p0"].shape[2] > 1:  # hybrid chunks
                    watch.hybrid = (args["data"], args["cdata"], out)
                return out

            return solve, hit

        for (owner, name, _), fn in zip(self._saved,
                                        (stack_lanes, get_with_status)):
            setattr(owner, name, fn)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        self._tally()
        return False


def service_routes(summary, watch) -> None:
    """Each dispatch's route and reason from its requests' result
    manifests (results come in dispatch order, one per real lane);
    printed with the watch's numbers."""
    results, i = summary["results"], 0
    for n, d in enumerate(watch.dispatches, 1):
        mine, i = results[i:i + d["real"]], i + d["real"]
        routes = {(r["kernel_path"], r["kernel_path_reason"], r["bucket"])
                  for r in mine}
        if len(mine) != d["real"] or len(routes) != 1:
            fail(f"service: dispatch {n}'s results disagree: {routes}")
        d["route"], d["reason"], bucket = routes.pop()
        if bucket != d["bucket"]:
            fail(f"service: dispatch {n} solved {d['bucket']}, its results "
                 f"name {bucket}")
        d["requests"] = [r["request_id"] for r in mine]
        print(f"[service] dispatch {n}: bucket {d['bucket']} ({d['real']} "
              f"requests in {d['lanes']} lanes), route {d['route']} "
              f"({d['reason']}), cache {'hit' if d['cache_hit'] else 'miss'},"
              f" pack {d['pack_s']:.4f} s, solve {d['solve_s']:.3f} s, "
              f"launches {d['launches']}, peak "
              f"{d['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    if i != len(results):
        fail(f"service: {len(results)} results from {i} solved lanes")


def service_parity(hybrid) -> dict:
    """Kernels #3/#4 against their plain version on one real lane of
    tenant B's hybrid bucket: the lane's own packed inputs (its chunk
    maps differ from cluster to cluster) through the station plan a
    solve builds from them, at the gains its dispatch returned and at
    those gains under a seeded kick (every chunk's gains then differ, and
    the residual is of the model's size), each at nu None and at the
    lane's mean nu."""
    from sagecal_tpu_torch.kernels.parity import (
        compare_with_plain, plan_of, tile_cost_problem,
    )
    from sagecal_tpu_torch.solvers.sage import lane_of

    data_b, cdata_b, out = hybrid
    data, cdata = lane_of(data_b, 0), lane_of(cdata_b, 0)
    if torch.unique(cdata.chunk_map, dim=0).shape[0] < 2:
        fail("service parity: the lane's clusters share one chunk map")
    p = out.p[0]
    kick = np.random.default_rng(SEED).standard_normal(tuple(p.shape))
    kicked = p + 0.1 * torch.as_tensor(kick, dtype=p.dtype, device=p.device)
    nu = float(out.mean_nu[0])
    worst = {"fused_cost_fwd": 0.0, "fused_cost_bwd": 0.0}
    rows = []
    for label, gains in (("solution", p), ("solution + kick", kicked)):
        prob = tile_cost_problem(data, cdata, gains)
        plan = plan_of(prob)
        for nu_k in (None, nu):
            o = compare_with_plain(prob, nu_k, plan)
            ok = (o["cost_rel"] <= COST_TOL and o["grad_rel"] <= GRAD_TOL
                  and o["bitwise_repeat"])
            print(f"[service] objective parity, tenant B lane 0 at its "
                  f"{label} (nc {prob.nc}), nu={nu_k}: cost_rel="
                  f"{o['cost_rel']:.3e} grad_rel={o['grad_rel']:.3e} "
                  f"bitwise_repeat={o['bitwise_repeat']} "
                  f"{'ok' if ok else 'FAILED'}", flush=True)
            if not ok:
                fail(f"objective kernel parity at tenant B's lane, {label} "
                     f"nu={nu_k}: {o}")
            worst["fused_cost_fwd"] = max(worst["fused_cost_fwd"],
                                          o["cost_abs_err"])
            worst["fused_cost_bwd"] = max(worst["fused_cost_bwd"],
                                          o["grad_max_abs_err"])
            rows.append(dict(o, problem=label, nu=nu_k))
    return {"worst": worst, "cases": rows}


def service_run(manifest: str, reqs, out_dir: str):
    """One ``run_serve`` through the serve CLI's parser and config over
    the in-memory dataset -> (summary, DispatchWatch, wall seconds)."""
    from sagecal_tpu_torch.apps.serve import (
        build_parser, config_from_args, run_serve,
    )
    from sagecal_tpu_torch.io.memh5 import MemFile

    cfg = config_from_args(build_parser().parse_args(
        ["--requests", manifest, "--out-dir", out_dir, *SVC_FLAGS]))
    with DispatchWatch() as watch:
        t = sync_clock()
        summary = run_serve(cfg, requests=reqs, open_file=MemFile,
                            log=lambda m: print(f"[service] {m}",
                                                flush=True))
        wall = sync_clock() - t
    return summary, watch, wall


def service_check(summary, watch) -> None:
    """Run 1's checks (module doc, phase 12)."""
    results = summary["results"]
    if summary["served"] != SVC_A + SVC_B or len(results) != SVC_A + SVC_B:
        fail(f"service: served {summary['served']} of {SVC_A + SVC_B}")
    if summary["buckets"] != {"hits": 1, "misses": 2, "entries": 2}:
        fail(f"service: cache stats {summary['buckets']}")
    routes = [d["route"] for d in watch.dispatches]
    if sorted(routes) != ["fused", "fused_batch", "fused_batch"]:
        fail(f"service: dispatch routes {routes}")
    kernels = {"fused_batch": ("fused_cost_batch_fwd", "fused_cost_batch_bwd"),
               "fused": ("fused_cost_fwd", "fused_cost_bwd")}
    for d in watch.dispatches:
        own = kernels[d["route"]]
        other = kernels["fused" if d["route"] == "fused_batch"
                        else "fused_batch"]
        if any(d["launches"][k] <= 0 for k in own):
            fail(f"service: route {d['route']} launched none of {own}: "
                 f"{d['launches']}")
        if any(d["launches"][k] != 0 for k in other):
            fail(f"service: route {d['route']} launched {other}: "
                 f"{d['launches']}")
    for r in results:
        want = "fused" if r["tenant"] == "tenantB" else "fused_batch"
        if r["kernel_path"] != want:
            fail(f"service: {r['request_id']} solved on {r['kernel_path']}")
        if r["verdict"] == "diverged" or not (
                math.isfinite(r["res_1"]) and r["res_1"] < r["res_0"]):
            fail(f"service: {r['request_id']} {r['verdict']} "
                 f"{r['res_0']} -> {r['res_1']}")
    if any(watch.outside.values()):
        fail(f"service: kernels launched outside the batch solves (tile "
             f"loading, manifests, shadow re-solves): {watch.outside}")


def service_drift(summary, reqs, out_dir: str) -> list:
    """The drift ledger of run 1: valid, one record per sampled id;
    each record printed (reported, not gated on its verdict)."""
    from sagecal_tpu_torch.obs.shadow import (
        drift_path, read_drift, shadow_sampled, validate_drift,
    )

    rows = read_drift(drift_path(out_dir))
    problems = validate_drift(rows)
    if problems:
        fail(f"service: drift ledger malformed: {problems}")
    sampled = sorted(r.request_id for r in reqs
                     if shadow_sampled(r.request_id, SVC_SHADOW_RATE))
    got = sorted(r["request_id"] for r in rows)
    if got != sampled:
        fail(f"service: drift records for {got}, sampled {sampled}")
    for r in rows:
        print(f"[service] drift {r['request_id']} [{r['path_pair']}] "
              f"{r['verdict']}: cost_rel_delta {r['cost_rel_delta']:.3e} "
              f"gain_rel_err_max {r['gain_rel_err_max']:.3e} "
              f"chi2_rel_delta {r.get('chi2_rel_delta', float('nan')):.3e} "
              f"shadow {r['shadow_s']:.3f} s"
              + (f" ({'; '.join(r['reasons'])})" if r["reasons"] else ""),
              flush=True)
    return [{k: r.get(k) for k in ("request_id", "path_pair", "verdict",
                                   "reasons", "cost_rel_delta",
                                   "gain_rel_err_max", "chi2_rel_delta",
                                   "shadow_s")} for r in rows]


def phase_service(dirname: str):
    """The calibration service (module doc, phase 12)."""
    from sagecal_tpu_torch.io.memh5 import remove

    t_start = sync_clock()
    manifest, reqs, path = service_workload(dirname)
    make_s = sync_clock() - t_start
    print(f"[service] {SVC_A} requests of tenant A and {SVC_B} of tenant B "
          f"({SVC_HYBRID} hybrid chunks on 2 of {SERVE_CLUSTERS} clusters) "
          f"over {SVC_TILES} tiles of {ROWS} rows, made in {make_s:.1f} s; "
          f"flags {' '.join(SVC_FLAGS)}", flush=True)
    out1 = os.path.join(dirname, "out1")
    summary, watch, wall = service_run(manifest, reqs, out1)
    verdicts = {}
    for r in summary["results"]:
        verdicts[r["verdict"]] = verdicts.get(r["verdict"], 0) + 1
    service_routes(summary, watch)
    print(f"[service] run 1: {wall:.1f} s, solves/s "
          f"{summary['solves_per_sec']:.4f}, p50 latency "
          f"{summary['p50_latency_s']:.3f} s, cache {summary['buckets']}, "
          f"verdicts {verdicts}, shadow {summary['shadow']}", flush=True)
    service_check(summary, watch)
    drift = service_drift(summary, reqs, out1)
    parity = service_parity(watch.hybrid)
    watch.hybrid = None

    # tenant A's first bucket again, in a new service: the same bits
    again = reqs[:SERVE_B]
    out2 = os.path.join(dirname, "out2")
    summary2, watch2, wall2 = service_run(manifest, again, out2)
    service_routes(summary2, watch2)
    first = {r["request_id"]: r for r in summary["results"]}
    same = summary2["served"] == SERVE_B and all(
        open(r["solutions"], "rb").read()
        == open(first[r["request_id"]]["solutions"], "rb").read()
        and (r["res_0"], r["res_1"]) == (first[r["request_id"]]["res_0"],
                                         first[r["request_id"]]["res_1"])
        for r in summary2["results"])
    print(f"[service] run 2 ({SERVE_B} requests of tenant A): {wall2:.1f} s, "
          f"solutions files and res bit-identical to run 1: {same}",
          flush=True)
    if not same:
        fail("service: serving the same requests again gave other bits")
    remove(path)
    out = {
        "dataset_s": make_s, "wall_s": [wall, wall2],
        "solves_per_sec": summary["solves_per_sec"],
        "p50_latency_s": summary["p50_latency_s"],
        "cache": summary["buckets"], "verdicts": verdicts,
        "shadow": summary["shadow"], "dispatches": watch.dispatches,
        "dispatches_run2": watch2.dispatches, "drift": drift,
        "parity": parity, "launches_outside_solves": watch.outside,
        "results": [{k: r[k] for k in ("request_id", "kernel_path",
                                       "verdict", "res_0", "res_1",
                                       "latency_s")}
                    for r in summary["results"]],
        "bitwise_repeat": same,
    }
    out["seconds"] = sync_clock() - t_start
    print(f"[service] phase wall time {out['seconds']:.1f} s", flush=True)
    return out


def serve_times():
    """Batched kernel and plain-version times at the serve shapes (f32
    coherencies, robust cost with per-lane nu, as mode 3 runs it); #6 on
    the bucket's station plan, built once, and split into its kernels on
    the device alone."""
    from sagecal_tpu_torch.kernels.parity import (
        fused_cost_batch_work, plan_of, random_cost_problem_batch, roofline,
    )
    from sagecal_tpu_torch.ops.rime_kernel import (
        _nu_lanes, fused_cost_batch_bwd_cuda, fused_cost_batch_fwd_cuda,
        fused_cost_packed_batch_plain,
    )
    from sagecal_tpu_torch.tools.profile_kernel import cuda_ms

    prob = random_cost_problem_batch(SERVE_B, SERVE_CLUSTERS, NSTATIONS,
                                     NCHAN, ROWS, seed=4, device="cuda")
    nu = _nu_lanes(torch.linspace(2.0, 12.0, SERVE_B), SERVE_B, "cuda")
    args = (prob.tab_re, prob.tab_im, *prob.inputs, nu, True)
    plan = plan_of(prob)
    out = {
        "fused_cost_batch_fwd": {"ms": cuda_ms(
            lambda: fused_cost_batch_fwd_cuda(*args), 50)},
        "fused_cost_batch_bwd": {"ms": cuda_ms(
            lambda: fused_cost_batch_bwd_cuda(*args, plan=plan), 20)},
    }
    out["fused_cost_batch_bwd"].update(split_device_ms(
        lambda st, sc: fused_cost_batch_bwd_cuda(*args, plan=plan, stages=st,
                                                 scratch=sc),
        {"cotangent": 1, "gradient": 2, "sum": 4}, 7))
    with torch.no_grad():
        out["fused_cost_batch_fwd"]["plain_ms"] = cuda_ms(
            lambda: fused_cost_packed_batch_plain(
                prob.tab_re, prob.tab_im, *prob.inputs, nu), 10)
    a = prob.tab_re.clone().requires_grad_(True)
    b = prob.tab_im.clone().requires_grad_(True)
    costs = fused_cost_packed_batch_plain(a, b, *prob.inputs, nu)
    ones = torch.ones_like(costs)
    out["fused_cost_batch_bwd"]["plain_ms"] = cuda_ms(
        lambda: torch.autograd.grad(costs, (a, b), ones, retain_graph=True),
        10)
    work = fused_cost_batch_work(prob)
    for name, key in (("fused_cost_batch_fwd", "fwd"),
                      ("fused_cost_batch_bwd", "bwd")):
        out[name].update(roofline(*work[key]))
    return out


def dist_datasets(dirname: str):
    """DIST_BANDS in-memory band datasets (``MemFile``) of the north-star
    geometry (TILESZ timeslots x NCHAN channels), at frequencies spread
    over DIST_FREQS, of ``write_sky``'s 100-cluster sky under true gains
    linear in frequency (tests/test_distributed.py's construction), noise
    1e-3.  Returns (glob, sky file, cluster file)."""
    from sagecal_tpu_torch.device import resolve_device
    from sagecal_tpu_torch.io.dataset import simulate_dataset
    from sagecal_tpu_torch.io.memh5 import MemFile
    from sagecal_tpu_torch.io.skymodel import load_sky

    sky, clus = write_sky(dirname, nclusters=NCLUSTERS, name="dist")
    clusters, _, _ = load_sky(sky, clus, RA0, DEC0, dtype=torch.float64)
    rng = np.random.default_rng(13)
    shape = (NCLUSTERS, NSTATIONS, 2, 2)
    c = lambda: rng.standard_normal(shape) + 1j * rng.standard_normal(shape)  # noqa: E731
    Z0 = np.eye(2) + 0.2 * c()
    Z1 = 0.1 * c()
    freqs = np.linspace(*DIST_FREQS, DIST_BANDS)
    for f, freq in enumerate(freqs):
        path = os.path.join(dirname, f"band{f}.h5")
        simulate_dataset(path, nstations=NSTATIONS, ntime=TILESZ,
                         nchan=NCHAN, freq0=float(freq), clusters=clusters,
                         jones=torch.as_tensor(Z0 + (freq - 150e6) / 150e6
                                               * Z1).to(resolve_device()),
                         noise_sigma=1e-3, seed=f, dec0=DEC0,
                         open_file=MemFile)
        MemFile(path, "r+").attrs["ra0"] = RA0
    return os.path.join(dirname, "band*.h5"), sky, clus


def device_event():
    return torch.cuda.Event(enable_timing=True)


class XstepClock:
    """Wraps ``parallel/mesh.py``'s ``admm_sagefit``: each band x-step's
    seconds on the device (a CUDA event recorded at both ends, no
    synchronize) and its res_0/res_1 (kept on the device), read after
    the run by ``calls()`` in call order (round 0: every band; then one
    band a shard a round).  It adds no host read or sync to the run."""

    def __init__(self):
        import sagecal_tpu_torch.parallel.mesh as mesh

        self.mesh, self.real, self.marks = mesh, mesh.admm_sagefit, []

    def __enter__(self):
        def timed(data, *a, **k):
            start = device_event()
            start.record()
            out = self.real(data, *a, **k)
            end = device_event()
            end.record()
            self.marks.append((start, end,
                               torch.stack([out.res_0, out.res_1])))
            return out

        self.mesh.admm_sagefit = timed
        return self

    def __exit__(self, *exc):
        self.mesh.admm_sagefit = self.real

    def calls(self):
        """[(seconds, res_0, res_1)] of every x-step, after the run."""
        torch.cuda.synchronize()
        return [(s.elapsed_time(e) / 1e3, *r.tolist())
                for s, e, r in self.marks]


def _events(path: str, kind: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [r for r in recs if r.get("type") == kind]


def _with_env(env: dict, fn):
    """``fn()`` with the environment variables ``env`` set, restored
    after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_distributed(dirname: str):
    """The multi-band consensus ADMM through the CLI (module doc, phase
    14)."""
    from sagecal_tpu_torch.apps.cli import main as cli_main
    from sagecal_tpu_torch.io.memh5 import MemFile, remove

    t_start = sync_clock()
    pattern, sky, clus = dist_datasets(dirname)
    make_s = sync_clock() - t_start
    print(f"[distributed] {DIST_BANDS} bands of {ROWS} rows ({TILESZ} x "
          f"{NCHAN} channels, {DIST_FREQS[0] / 1e6:.0f}-"
          f"{DIST_FREQS[1] / 1e6:.0f} MHz), {NCLUSTERS} clusters, made in "
          f"{make_s:.1f} s; flags {' '.join(DIST_FLAGS)}", flush=True)
    sol = os.path.join(dirname, "dist.z")
    elog = os.path.join(dirname, "dist_events.jsonl")
    argv = ["-s", sky, "-c", clus, "-f", pattern, "-p", sol, *DIST_FLAGS]
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t = sync_clock()
    with XstepClock() as clock:
        rc = _with_env({"SAGECAL_TELEMETRY": "1", "SAGECAL_EVENT_LOG": elog},
                       lambda: cli_main(argv, open_file=MemFile))
    wall = sync_clock() - t
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        fail(f"distributed: the CLI exited {rc}")
    rounds = _events(elog, "admm_round")
    if len(rounds) != 1:
        fail(f"distributed: {len(rounds)} admm_round events, not 1")
    ev = rounds[0]
    dres, pres = ev["dual_res"], ev["primal_res"]
    rho = np.asarray(ev["rho_trace"])
    nadmm = len(pres)
    # x-steps in call order: round 0 solves every band, then each
    # round one band a shard (one shard a band here)
    calls = clock.calls()
    per_round = [calls[:DIST_BANDS]] + [
        calls[DIST_BANDS * r:DIST_BANDS * (r + 1)] for r in range(1, nadmm)]
    round_s = [sum(c[0] for c in rc_) for rc_ in per_round]
    band_s = [[rc_[b][0] for rc_ in per_round] for b in range(DIST_BANDS)]
    res = [(per_round[0][b][1], per_round[-1][b][2])
           for b in range(DIST_BANDS)]
    print(f"[distributed] run {wall:.1f} s (x-steps {sum(round_s):.1f} s), "
          f"peak device memory {peak / 2**30:.2f} GiB; seconds per round "
          f"{[round(x, 3) for x in round_s]}; per band and round "
          f"{[[round(x, 3) for x in b] for b in band_s]}", flush=True)
    print(f"[distributed] dual residual {dres}; primal residual {pres}",
          flush=True)
    print(f"[distributed] rho per band (mean over clusters) before the BB "
          f"step {rho[0].mean(axis=1).tolist()}, after "
          f"{rho[-1].mean(axis=1).tolist()}; clusters changed "
          f"{int((rho[-1] != rho[0]).sum())} of {rho[0].size}", flush=True)
    health = _events(elog, "consensus_health")
    verdict = health[0]["verdict"] if health else None
    zrows = sum(1 for line in open(sol)
                if not line.startswith("#")) - 1  # the header's numbers
    with_vis = []
    for f in range(DIST_BANDS):
        h = MemFile(os.path.join(dirname, f"band{f}.h5"), "r")
        vis, col = np.asarray(h["vis"]), np.asarray(h["corrected"])
        with_vis.append(float(np.linalg.norm(col) / np.linalg.norm(vis)))
    print(f"[distributed] launches {launches}; global-Z file {zrows} rows "
          f"({2 * 8 * NSTATIONS} expected); consensus watchdog {verdict}",
          flush=True)
    print(f"[distributed] per band res_0 -> res_1 (x-steps) "
          f"{[(round(a, 6), round(b, 6)) for a, b in res]}; residual "
          f"column over data {[round(x, 6) for x in with_vis]}", flush=True)
    if launches["fused_predict_fwd"] != DIST_BANDS:
        fail(f"distributed: kernel #1 launched "
             f"{launches['fused_predict_fwd']} times, not {DIST_BANDS}")
    if any(launches[k] for k in KERNELS[2:]):
        fail(f"distributed: objective kernels launched: {launches}")
    if zrows != 2 * 8 * NSTATIONS:
        fail(f"distributed: the global-Z file holds {zrows} rows")
    if not all(np.isfinite(r1) and r1 < r0 for r0, r1 in res):
        fail(f"distributed: a band's res_1 is not below its res_0: {res}")
    if not (np.all(np.isfinite(pres)) and pres[-1] < pres[1]):
        fail(f"distributed: the final primal residual {pres[-1]} is not "
             f"below round 1's {pres[1]}")
    if not all(x < 1.0 for x in with_vis):
        fail(f"distributed: a residual column is not below its data: "
             f"{with_vis}")
    for f in range(DIST_BANDS):
        remove(os.path.join(dirname, f"band{f}.h5"))
    out = {"dataset_s": make_s, "wall_s": wall, "round_s": round_s,
           "band_round_s": band_s, "dual_res": dres, "primal_res": pres,
           "rho_before": rho[0].tolist(), "rho_after": rho[-1].tolist(),
           "launches": launches, "zrows": zrows, "res": res,
           "residual_over_data": with_vis, "peak_bytes": peak,
           "watchdog": verdict}
    out["seconds"] = sync_clock() - t_start
    print(f"[distributed] phase wall time {out['seconds']:.1f} s", flush=True)
    return out


def phase_minibatch(dirname: str):
    """The minibatch bandpass app in consensus through the CLI (module
    doc, phase 15)."""
    from sagecal_tpu_torch.apps.cli import main as cli_main
    from sagecal_tpu_torch.io.dataset import simulate_dataset
    from sagecal_tpu_torch.io.memh5 import MemFile, remove
    from sagecal_tpu_torch.io.simulate import random_jones
    from sagecal_tpu_torch.io.skymodel import load_sky

    t_start = sync_clock()
    sky, clus = write_sky(dirname, nclusters=NCLUSTERS, name="mb")
    clusters, _, _ = load_sky(sky, clus, RA0, DEC0, dtype=torch.float64)
    path = os.path.join(dirname, "mb.h5")
    simulate_dataset(path, nstations=NSTATIONS, ntime=MB_NTIME,
                     nchan=MB_NCHAN, clusters=clusters,
                     jones=random_jones(NCLUSTERS, NSTATIONS, seed=3, amp=0.2,
                                        dtype=np.complex128),
                     noise_sigma=1e-3, seed=0, dec0=DEC0, open_file=MemFile)
    MemFile(path, "r+").attrs["ra0"] = RA0
    make_s = sync_clock() - t_start
    print(f"[minibatch] one dataset of {MB_NTIME} timeslots x {MB_NCHAN} "
          f"channels ({ROWS} rows a minibatch), {NCLUSTERS} clusters, made "
          f"in {make_s:.1f} s; flags {' '.join(MB_FLAGS)}", flush=True)
    sol = os.path.join(dirname, "mb.sol")
    elog = os.path.join(dirname, "mb_events.jsonl")
    argv = ["-d", path, "-s", sky, "-c", clus, "-p", sol, *MB_FLAGS]
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t = sync_clock()
    rc = _with_env({"SAGECAL_TELEMETRY": "1", "SAGECAL_EVENT_LOG": elog},
                   lambda: cli_main(argv, open_file=MemFile))
    wall = sync_clock() - t
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        fail(f"minibatch: the CLI exited {rc}")
    mb_s = [e["seconds"] for e in _events(elog, "minibatch_done")]
    res = [(e["res0"], e["res1"]) for e in _events(elog, "band_residual")]
    rounds = [e["primal_res"] for e in _events(elog, "admm_round")]
    nbands = len(res)
    print(f"[minibatch] run {wall:.1f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB; seconds per minibatch "
          f"{[round(x, 3) for x in mb_s]}", flush=True)
    print(f"[minibatch] primal residual per band, per round "
          f"{[[round(x, 6) for x in r] for r in rounds]}", flush=True)
    print(f"[minibatch] per band res_0 -> res_1 "
          f"{[(round(a, 4), round(b, 4)) for a, b in res]}; launches "
          f"{launches}", flush=True)
    nmb = len(mb_s)
    if nbands != 4 or nmb != 2:
        fail(f"minibatch: {nbands} bands and {nmb} minibatches")
    if launches["fused_predict_fwd"] != nbands * nmb:
        fail(f"minibatch: kernel #1 launched {launches['fused_predict_fwd']} "
             f"times, not {nbands * nmb}")
    if not all(np.isfinite(r1) and r1 < r0 for r0, r1 in res):
        fail(f"minibatch: a band's res_1 is not below its res_0: {res}")
    remove(path)
    out = {"dataset_s": make_s, "wall_s": wall, "minibatch_s": mb_s,
           "primal_res": rounds, "res": res, "launches": launches,
           "peak_bytes": peak}
    out["seconds"] = sync_clock() - t_start
    print(f"[minibatch] phase wall time {out['seconds']:.1f} s", flush=True)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # 1: cut from 2 when the consensus phases (14, 15) joined, to keep
    # the script near 450 s on an "NVIDIA H100 80GB HBM3, 700.00 W" (the
    # main, warm, extended and telemetry solves run at this depth)
    ap.add_argument("--max-emiter", type=int, default=1)
    # 3: cut from 6 to 4 when the fullbatch phase joined and to 3 when
    # the beam phase did, to keep the script near 400 s on an "NVIDIA
    # H100 80GB HBM3, 700.00 W" (the main, warm, extended and telemetry
    # solves run at this depth)
    ap.add_argument("--max-iter", type=int, default=3)
    ap.add_argument("--max-lbfgs", type=int, default=10)
    ap.add_argument("--json-out", default=None,
                    help="also write every number printed to this file")
    return ap.parse_args(argv)


def print_times(card: str, times: dict, launches: dict, path: str):
    for k, v in times.items():
        print(f"[times] ({card}) {k}: {v['ms']:.4f} ms, bound "
              f"{v['bound_ms']:.4f} ms ({v['bound_by']}: {v['bytes']} B, "
              f"{v['flops']} flop), plain {v['plain_ms']:.4f} ms, "
              f"{launches[k]} launches on {path[k]}", flush=True)


def main():
    args = parse_args()
    t_start = time.perf_counter()

    name, count, card = phase_device()
    phase_build()
    worst, plan_s = phase_parity()
    with tempfile.TemporaryDirectory() as d:
        data, cdata, p0, coh_s = main_tile(d)
        main_out = phase_main(args, d, data, cdata, p0)
    with tempfile.TemporaryDirectory() as d:
        warm_out = phase_warm(args, d)
    with tempfile.TemporaryDirectory() as d:
        ext_out = phase_extended(args, d)
    with tempfile.TemporaryDirectory() as d:
        fb_out = phase_fullbatch(args, d)
    with tempfile.TemporaryDirectory() as d:
        beam_out = phase_beam(d)
    for out in (ext_out, beam_out):
        for k, v in out["parity"]["worst"].items():
            worst[k] = max(worst[k], v)
    pred_out = phase_predict(data, cdata, p0, card)
    del data, cdata
    torch.cuda.empty_cache()
    bisect_out = phase_bisect(card)
    times = phase_times(main_out["nu"])

    em, em_u = main_out["em_s"], main_out["em_s_torch_op"]
    lb, lb_u = main_out["lbfgs_s"], main_out["lbfgs_s_torch_op"]
    print(f"[times] ({card}) coherencies {coh_s:.3f} s, EM {em[0]:.3f} and "
          f"{em[1]:.3f} s (fused runs), {em_u[0]:.3f} and {em_u[1]:.3f} s "
          f"(torch-op runs), joint LBFGS (fused) {lb[0]:.3f} and {lb[1]:.3f} "
          f"s over {main_out['lbfgs_iterations']} iterations, joint LBFGS "
          f"(torch-op) {lb_u[0]:.3f} and {lb_u[1]:.3f} s", flush=True)
    print(f"[times] ({card}) peak device memory of the fused solve "
          f"{main_out['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    print(f"[times] ({card}) beam: coherencies "
          + ", ".join(f"-B {r['code']} {r['seconds']:.3f} s "
                      f"({r['peak_bytes'] / 2**30:.3f} GiB)"
                      for r in beam_out["coherencies"])
          + "; -B 2 app runs " + ", ".join(f"{r['wall_s']:.1f}"
                                           for r in beam_out["runs"])
          + f" s; -i run {beam_out['influence']['wall_s']:.1f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      beam_out["influence"]["seconds"].items())
          + f" s); the phase {beam_out['seconds']:.1f} s", flush=True)
    launches = dict(main_out["launches"])
    launches.update(pred_out["lbfgs_launches"])
    path = {k: f"the predict path's LBFGS ({pred_out['lbfgs_iterations']} "
               f"iterations)" for k in KERNELS[:2]}
    path.update({k: f"the main path ({main_out['lbfgs_iterations']} LBFGS "
                    f"iterations)" for k in KERNELS[2:4]})
    print_times(card, times, launches, path)
    for k in ("fused_cost_bwd", "fused_predict_bwd"):
        print_split(card, k, times[k])

    serve_worst, serve_plan_s = serve_parity()
    worst.update(serve_worst)
    with tempfile.TemporaryDirectory() as d:
        serve_out = phase_serve(d)
    serve_t = serve_times()
    times.update(serve_t)
    print(f"[times] ({card}) serve bucket: EM {serve_out['em_s'][0]:.3f} and "
          f"{serve_out['em_s'][1]:.3f} s, joint LBFGS (fused_batch) "
          f"{serve_out['lbfgs_s'][0]:.3f} and {serve_out['lbfgs_s'][1]:.3f} "
          f"s over "
          f"{serve_out['lbfgs_iterations']} iterations, peak device memory "
          f"{serve_out['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    launches.update({k: serve_out["launches"][k] for k in KERNELS[4:]})
    path.update({k: "the serve path" for k in KERNELS[4:]})
    print_times(card, serve_t, launches, path)
    print_split(card, "fused_cost_batch_bwd", serve_t["fused_cost_batch_bwd"])
    with tempfile.TemporaryDirectory() as d:
        svc_out = phase_service(d)
    with tempfile.TemporaryDirectory() as d:
        dist_out = phase_distributed(d)
    with tempfile.TemporaryDirectory() as d:
        mb_out = phase_minibatch(d)
    for k, v in svc_out["parity"]["worst"].items():
        worst[k] = max(worst[k], v)
    print(f"[times] ({card}) service: run 1 {svc_out['wall_s'][0]:.1f} s "
          f"({SVC_A + SVC_B} requests, {svc_out['solves_per_sec']:.4f} "
          f"solves/s, p50 latency {svc_out['p50_latency_s']:.3f} s), run 2 "
          f"{svc_out['wall_s'][1]:.1f} s; per dispatch "
          + ", ".join(f"{d['route']} pack {d['pack_s']:.4f} s solve "
                      f"{d['solve_s']:.3f} s peak "
                      f"{d['peak_bytes'] / 2**30:.2f} GiB"
                      for d in svc_out["dispatches"]), flush=True)
    print(f"[times] ({card}) BwdPlan build: north-star tile "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in plan_s.items())
          + f"; serve bucket ({SERVE_B} lanes, one plan) "
          + ", ".join(f"{v * 1e3:.3f}" for v in serve_plan_s) + " ms",
          flush=True)

    print(f"[times] ({card}) distributed: run {dist_out['wall_s']:.1f} s, "
          f"x-steps per round {[round(x, 2) for x in dist_out['round_s']]} "
          f"s, peak {dist_out['peak_bytes'] / 2**30:.2f} GiB; minibatch: run "
          f"{mb_out['wall_s']:.1f} s, per minibatch "
          f"{[round(x, 2) for x in mb_out['minibatch_s']]} s, peak "
          f"{mb_out['peak_bytes'] / 2**30:.2f} GiB", flush=True)

    # the probes' entries: their north-star-width times and the kbisect
    # run's launches
    launches.update({k: bisect_out["launches"][k] for k in PROBES})
    worst.update(bisect_out["worst"])
    for k, rows in bisect_out["times"].items():
        times[k] = rows["north-star"]

    kernels = []
    for k in KERNELS + tuple(PROBES):
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCE[k],
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": worst[k], "ms": times[k]["ms"],
            "plain_ms": times[k]["plain_ms"], "bound_ms": times[k]["bound_ms"],
            "bound_by": times[k]["bound_by"],
            "library_ms": times[k].get("library_ms"), "parity": "pass",
        })
    # #1's launches on each path that runs it (the line's count is the
    # predict path's)
    kernels[0]["paths"] = {
        "predict path LBFGS": launches["fused_predict_fwd"],
        "distributed (1 tile, 4 bands)":
            dist_out["launches"]["fused_predict_fwd"],
        "minibatch (4 bands x 2 minibatches)":
            mb_out["launches"]["fused_predict_fwd"]}
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump({"card": card, "main": main_out, "warm": warm_out,
                       "extended": ext_out, "fullbatch": fb_out,
                       "beam": beam_out,
                       "predict": pred_out,
                       "bisect": bisect_out, "serve": serve_out,
                       "service": svc_out, "distributed": dist_out,
                       "minibatch": mb_out, "times": times, "kernels": kernels,
                       "coherencies_s": coh_s, "plan_s": plan_s,
                       "serve_plan_s": serve_plan_s,
                       "seconds": time.perf_counter() - t_start}, fh, indent=1)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
