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
            (``-j 3 -e 1 -g 1 -l 10 -t 60 --f32 --fused``) and
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
            (mode 3, 1 EM pass, max_iter 2, max_lbfgs 10; every lane
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
            config (``--f32 --fused --batch 8 -j 3 -e 1 -g 2 -l 10
            --shadow-rate 0.25``, the reference serve defaults but one EM
            pass) and
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
            with ``-j 3 -e 1 -g 1 -l 10 -t 60 --f32 --fused -B 2
            --element-coeffs hba`` (``-g 6`` until phases 14-15, 3
            until phases 16-17, 2 until the sharded, multihost,
            widefield and refine phases):
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
            --f32 -j 1 -e 1 -g 1 -A 3 -P 2 -Q 2 -r 5 -C 1``, with
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
            band's res_1 is below its res_0;
16. spatial  the consensus ADMM with spatial regularization and the
            diffuse-sky constraint (graded config 5's mode, cut to 4
            sub-bands) through the CLI: phase 14's flags plus ``-X
            1e-3,1e-4,3,20,2 --spatial-diffuse-id 100 -G rho`` over four
            in-memory bands of two north-star tiles each, phase 14's sky
            plus an all-shapelet cluster (a smooth n0 = 6 blob; the data
            hold the point clusters only) and a -G file of nonzero
            alphas, SAGECAL_TELEMETRY=1.  FISTA runs at round 2 of each
            tile (cadence 2, -A 3); tile 2's diffuse coherencies are
            predicted again from tile 1's diffuse model.  Prints each
            x-step's, each FISTA refit's and each re-predict's device
            seconds (CUDA events read after the run), spat_res, peak
            memory.  Fails unless the run exits 0, #1 launched exactly 8
            times (4 bands x 2 tiles) and #2-#6 never, spat_res is
            finite, every tile-2 diffuse prediction differs from the
            sky-only one, #1 on tile 2's re-predicted coherencies (band
            0, its solutions) matches its plain version within 1e-5 and
            repeats bit-identically, every band's res_1 is below its
            res_0 in both tiles, the Z file holds 2 x 2 x 8 x 62 rows and
            ``<solutions>.spatial.ppm`` is a P6 image of 8 x 8 panels of
            64 pixels;
17. federated  federated calibration (``-f`` with ``-N``) through the
            CLI (``-N 1 -M 2 -A 2 -u 5 --f32 -l 10 -t 120 -P 2 -Q 2 -r
            5``, SAGECAL_TELEMETRY=1) over phase 16's bands as one tile
            of 120 timeslots (two minibatches of 113,460 rows), phase
            14's sky.  Prints the seconds per round (the fed.round
            windows), per minibatch round and per average (CUDA events).
            Fails unless the run exits 0, none of #1-#10 launched, each
            round has a ``fed_round`` event with a finite dual residual,
            no band reset, each band's data cost on minibatch 0 fell
            below its cost at the identity, and each band's solution
            file holds one interval of 100 x 62 gains;
then    the ``spatial`` app through the CLI (``spatial -f ... -t 60 -e
            1 -g 1 -l 10 --f32``, SAGECAL_TELEMETRY=1) over phase 16's
            bands and phase 14's sky (the app, as the JAX package's,
            predicts point and extended sources, not shapelets): tile 0
            of each band, ``<out>.json`` and ``<out>.npz`` written,
            k_aic and k_mdl within 1..2, FISTA's fit_rel finite; the
            seconds of each band's solve and of FISTA printed;
sharded     (run after phase 4, on its tile) the rows-sharded joint fit
            (``solvers/sharded.py``, the torch-op joint cost at f32, 10
            LBFGS iterations) unsharded and in 4 row blocks: costs within
            1e-5 relative, p within 1e-4 of its norm; each run's seconds
            and peak device memory above the tile printed;
multihost   (run after phase 14, on its files) phase 14's bands and
            flags through ``-f ... --multihost`` as two ranks on the one
            card over gloo with CUDA tensors (each rank a process that
            rebuilds the bands in its own MemFile registry, LOCAL_RANK 0,
            SAGECAL_DIST_BACKEND=gloo): the Z file and every band's
            solution file bit-identical to phase 14's, #1 twice a rank;
            then one nccl rank on bands 0-1 at -A 3: #1 twice, the Z
            file's rows; each rank's seconds printed;
widefield   the documented run (``widefield -S 10000 --nblobs 40 -k 8 -n
            40 --extent-m 60 --freq0 30e6``) at f64, ``--ntiles 2 -e 1 -g
            2``: every tile's sampled rel_err under the a-priori bound of
            (8, 1.5), 1.06e-4, the watchdog ok; tile 0's hierarchical
            coherencies on the card within 1e-10 relative of the port's
            on the CPU; the plan, hierarchical and exact predict, check
            and solve seconds a tile, peak memory;
refine      dataset mode on a MemFile tile at the north-star width (62
            stations, 100 clusters, cluster 0 of two sources, 2
            channels, 4 timeslots) at f64: ``refine --free-flux 0:0
            --outer-iters 1 --ridge 100 --adjoint-cg-iters 256`` with
            P0's catalog flux 15% off;
            each outer iteration's seconds, the Gauss-Newton and adjoint
            products, peak memory (``--adjoint-cg-iters 256``); the
            app's first gradient (its budgets, from its start) within
            1e-3 of a central difference of the outer cost, and the
            flux closer to the truth than the catalog; the inner
            gradient's ratio after the app's budget at ``--ridge`` 1e-2,
            10 and 100, the adjoint's residual at the default 64
            products; at the default ``--ridge 1e-2`` the implicit
            gradient against its difference (printed) and the unrolled
            route's (within 1e-3);
elastic     (run after phase 7; elastic checkpoints and ``--resume``)
            phase 7's first app run writes a checkpoint after each tile
            (``--checkpoint-every 1``; each write's seconds and bytes
            printed) and its second runs without: the two bit-identical.
            Then phase 7's run in a subprocess that rebuilds its MemFile
            dataset, SIGTERMed as its first checkpoint lands
            (``elastic/faultinject.py::kill_at_checkpoint``), and
            ``--resume`` in another such subprocess: the solutions file
            bit-identical to phase 7's, #3/#4 and #1 launched for tile 1
            only, and tile 1's residual column (the resumed process's;
            tile 0's died with the killed process's MemFile) bit-identical
            to phase 7's; then ``FleetWorker._solve_large`` on phase 7's
            first tile in 4 row blocks, timed, held to the unsharded fit
            (cost 1e-5 relative, gains 1e-4 of their norm);
fleet       (run after phase 12, over its request manifest and flags
            without shadow audits) ``fleet``'s coordinator
            (``apps/fleet.py::run_coordinator``) spawns 2 workers on the
            card (each a process that rebuilds phase 12's dataset in its
            own MemFile registry; lease TTL 5 s; a fresh kernel store),
            and SIGKILLs the worker that built the library into the
            store (whichever took the store's lock first; it prints a
            line when it saves) once the library is saved and that
            worker holds a lease: every request one result manifest,
            every verdict phase 12's, every solution phase 12's bit for
            bit or (another batch composition) within 5e-3 of its max
            abs; requests per second, p50/p95 latency, and each worker's
            claims, steals, kernel builds, store hits and #5/#6, #3/#4
            launches printed; the surviving worker, the second to reach
            the store, builds nothing, and one library is built
            fleet-wide.  The fleet runs with SAGECAL_TELEMETRY=1, so its
            directory holds the event log that phase audit reads (the
            service's solves collect no traces either way);
stream      (run after phase elastic) the stream calibrator through the
            ``stream`` subcommand's parser and config (``-t 20 --hop 10
            --max-windows 3 -e 2 -g 1 -l 10 --warm-emiter 1 --warm-lbfgs
            4 --f32 --checkpoint-every 1 --lease-ttl 5``, mode 3) and
            ``apps.stream.run_stream`` over phase 7's dataset geometry
            (62 stations, 100 clusters, 120 timeslots) in MemFile: one
            uninterrupted run in this process (window 0 cold, 1-2 warm,
            each res_1 < res_0 and a manifest with ``latency_s``, the
            steady-state latency below window 0's, #1-#6 launched 0
            times: the stream solves on the torch-op joint cost); then
            the same run in a process that rebuilds the dataset,
            SIGKILLed once window 0's checkpoint lands, whose live owner
            lease must make ``check_owner_lease`` refuse a foreign owner
            here; after the lease's TTL a ``--resume`` process adopts the
            chain at window 1: its solutions file and the manifests'
            results bit-identical to the uninterrupted run's, no kernel
            launched;
load        (run after phase fleet) the ``load`` subcommand (``--workers
            2 --arrival poisson --rate 1.0 --duration 10 --warmup 10
            --f32 --lease-ttl 5``) at the load generator's own workload
            (the two tenant shapes of ``serve/synthetic.py``), its
            datasets in MemFile, two worker processes on the card that
            rebuild them from the load spec, SAGECAL_TELEMETRY=1: exit
            0 (drained), every scheduled arrival exactly one result
            manifest, the live and after-the-fact queue views
            reconciled, no kernel launched in the workers (the
            torch-op route); requests/s, p50 and p95 latency printed;
audit       (host only) ``obs/audit.py::run_audit`` and
            ``obs/replay.py::replay`` on the fleet and load phases'
            directories: exit 0, no violation, every enqueued request
            served, shed or failed; the fleet's with ``tear_record``
            injected caught as a torn record;
tools       (last) ``tools/restore.py`` renders a sky of two points and
            an n0 = 3 shapelet (its ``.fits.modes`` file beside it) into
            a 96 x 96 FITS image, the shapelet on the card, within 1e-12
            of the CPU's rendering; ``tools/buildsky.py`` extracts the
            two points back within tests/test_tools.py's tolerances
            (fluxes 15%, the brightest within 2 pixels); the native core
            (``tools/_native.py``) is built by g++ into
            ``sagecal_tpu_torch/_build/``, not the scipy path;
            ``tools/uvwriter.py`` rewrites a MemFile dataset's UVW in the
            lunar frame, baseline lengths kept to 1e-12.

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
# the serve defaults' depth: mode 3, max_iter 2, max_lbfgs 10, and one EM
# pass (cut from the defaults' 3 when the sharded, multihost, widefield
# and refine phases joined, to keep the script near 600 s on an "NVIDIA
# H100 80GB HBM3, 700.00 W")
SERVE_MAX_EMITER, SERVE_MAX_ITER, SERVE_MAX_LBFGS = 1, 2, 10
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
# CLI's flags (APP_FLAGS, with -g cut from 6 to 3 when the beam phase
# joined, to 2 when the spatial and federated phases did and to 1 when
# the sharded, multihost, widefield and refine phases did, to keep the
# script near 600 s on an "NVIDIA H100 80GB HBM3, 700.00 W"); telemetry
# off/on in robust RTR
# (the mode with counted host reads) on the warm phase's sky
FB_NTIME = 2 * TILESZ
APP_FLAGS = ("--f32", "--fused", "-j", "3", "-e", "1", "-g", "6", "-l", "10",
             "-t", str(TILESZ))
FB_FLAGS = APP_FLAGS[:6] + ("-g", "1") + APP_FLAGS[8:]
FB_TEL_MODE = 5

# the calibration service: the reference serve defaults (-j 3 -g 2 -l 10
# --batch 8; -e cut to SERVE_MAX_EMITER) with --f32 --fused and a quarter
# of the requests
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

# elastic checkpoints and the fleet: the killed and the resumed phase-7
# runs and the fleet each get a time limit; the fleet's lease TTL (s)
# and its workers; phase 12's flags without the shadow audits
ELASTIC_TIMEOUT, FLEET_TIMEOUT, FLEET_TTL, FLEET_WORKERS = 300, 420, 5.0, 2
FLEET_FLAGS = SVC_FLAGS[:-2]

# the stream calibrator at the north-star width on phase 7's dataset
# geometry (62 stations, 100 clusters, 120 timeslots): three windows of
# 20 timeslots at a hop of 10, a cold window of two EM passes and warm
# windows of one, at f32 in the default mode 3; the chain checkpointed
# every window under an owner lease of STREAM_TTL s
STREAM_TTL = 5.0
STREAM_FLAGS = ("-t", "20", "--hop", "10", "--max-windows", "3", "-e", "2",
                "-g", "1", "-l", "10", "--warm-emiter", "1", "--warm-lbfgs",
                "4", "--f32", "--checkpoint-every", "1", "--lease-ttl",
                str(STREAM_TTL))
STREAM_WINDOWS, STREAM_TIMEOUT = 3, 300
# the load generator at its own workload (the two tenant shapes of
# serve/synthetic.py's SHAPE_CLASSES): a seeded poisson schedule of ~10
# arrivals against 2 worker processes on the card
LOAD_FLAGS = ("--workers", "2", "--arrival", "poisson", "--rate", "1.0",
              "--duration", "10", "--warmup", "10", "--f32", "--lease-ttl",
              "5", "--drain-timeout", "240")
# the offline tools: tests/test_tools.py's two points and a shapelet of
# TOOLS_N0 orders and scale TOOLS_BETA rad (a ~0.4 Jy peak) restored into
# a 96 x 96 FITS image of 3e-3 deg pixels
TOOLS_SKY = ("P1 1 0 0.0 45 0 0.0 2.0 0 0 0 0 0 0 0 0 0 0 150e6\n"
             "P2 1 0 12.0 45 6 0.0 1.0 0 0 0 0 0 0 0 0 0 0 150e6\n"
             "S4 1 0 9.0 44 55 0.0 1.0 0 0 0 0 0 0 0 0 0 0 150e6\n")
TOOLS_N0, TOOLS_BETA, TOOLS_NPIX = 3, 1.5e-4, 96

# the multi-band consensus ADMM (graded config 4: 32 sub-bands of the
# north-star tile, sagecal-mpi -f -A 10 -P 2 -Q 2; cut to DIST_BANDS
# bands and -A 3, the least depth at which -C 1's BB update fires), run
# with SAGECAL_TELEMETRY=1 for the per-band residuals and rho trajectory
# (-g 1: cut from 2 when the refine phase's gradient witness joined, to
# keep the script near 600 s on an "NVIDIA H100 80GB HBM3, 700.00 W";
# phases 14 and 16 and the multihost runs share it)
DIST_BANDS = 4
DIST_FREQS = (130e6, 170e6)
DIST_FLAGS = ("-t", str(TILESZ), "--f32", "-j", "1", "-e", "1", "-g", "1",
              "-A", "3", "-P", "2", "-Q", "2", "-r", "5", "-C", "1")
# the minibatch bandpass app (graded config 2: -N 1, Student's-t, 100
# clusters on one observation): 8 channels in 4 mini-bands in consensus,
# two minibatches of TILESZ timeslots
MB_NCHAN, MB_NTIME = 8, 2 * TILESZ
MB_FLAGS = ("-N", "1", "-M", "2", "-w", "4", "-A", "2", "-j", "2", "--f32",
            "-t", str(TILESZ), "-l", "10")

# the spatial regularization (graded config 5's mode, cut to DIST_BANDS
# bands): phase 14's sky plus an all-shapelet cluster (a smooth blob of
# SPAT_N0 orders and scale SPAT_BETA) with the id SPAT_DIFFUSE_ID, two
# tiles a band; -X lam,mu,n0,fista_maxiter,cadence with the cadence 2 at
# -A 3 (one FISTA refit a tile, at round 2)
SPAT_N0, SPAT_BETA, SPAT_DIFFUSE_ID = 6, 2e-3, NCLUSTERS
SPAT_NTIME = 2 * TILESZ
SPAT_FLAGS = DIST_FLAGS + ("-X", "1e-3,1e-4,3,20,2", "--spatial-diffuse-id",
                           str(SPAT_DIFFUSE_ID))
# federated calibration (-f with -N) over those bands as one tile of two
# minibatches of TILESZ timeslots, and the spatial app over them
FED_FLAGS = ("-N", "1", "-M", "2", "-A", "2", "-u", "5", "--f32", "-l", "10",
             "-t", str(SPAT_NTIME), "-P", "2", "-Q", "2", "-r", "5")
# (-g 1: cut from 2 with phase 14's, for the same reason)
SPAPP_FLAGS = ("-t", str(TILESZ), "-e", "1", "-g", "1", "-l", "10", "--f32")

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
    # run 1 checkpoints after each tile, run 2 does not
    ckpt = ("--checkpoint-every", "1", "--checkpoint-dir",
            os.path.join(dirname, "fb.ckpt"))
    writes = []
    for k in range(2):
        log = TileLog()
        fb.calculate_residuals = spy if k == 0 else real
        torch.cuda.reset_peak_memory_stats()
        t = sync_clock()
        try:
            with timed_checkpoints(writes):
                results = fullbatch_cli(path, sky, clus, sol, log=log,
                                        extra=ckpt if k == 0 else ())
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
    for w in writes:
        print(f"[elastic] checkpoint {os.path.basename(w['path'])}: write "
              f"{w['seconds'] * 1e3:.1f} ms, {w['bytes']} bytes", flush=True)
    if len(writes) != FB_NTIME // TILESZ:
        fail(f"elastic: {len(writes)} checkpoints written in run 1")
    print(f"[fullbatch] second run (no checkpoints) bit-identical to the "
          f"first (res, solutions file, residual column): {same}",
          flush=True)
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
    large = fleet_large(path, sky, clus, dirname)
    remove(path)
    out.update(runs=[{k: r[k] for k in ("results", "tiles", "wall_s",
                                        "peak_bytes")} for r in runs],
               checkpoints=writes, large=large,
               bitwise=same,
               simulation={"seconds": sim_s, "launches": sim_launches,
                           "rel": sim_err},
               telemetry=fullbatch_telemetry(args, dirname))
    out["seconds"] = sync_clock() - t_start
    print(f"[fullbatch] phase wall time {out['seconds']:.1f} s", flush=True)
    return out, {"solutions": a["solutions"], "column": a["column"]}


class timed_checkpoints:
    """Times every checkpoint write (``elastic/checkpoint.py::
    write_checkpoint``, as the manager calls it) into ``writes``: path,
    seconds, bytes."""

    def __init__(self, writes: list):
        self.writes = writes

    def __enter__(self):
        from sagecal_tpu_torch.elastic import checkpoint as ck

        self.real = real = ck.write_checkpoint

        def timed(path, arrays, meta):
            t = time.perf_counter()
            out = real(path, arrays, meta)
            self.writes.append({"path": out,
                                "seconds": time.perf_counter() - t,
                                "bytes": os.path.getsize(out)})
            return out

        ck.write_checkpoint = timed
        return self

    def __exit__(self, *exc):
        from sagecal_tpu_torch.elastic import checkpoint as ck

        ck.write_checkpoint = self.real
        return False


def fleet_large(path: str, sky: str, clus: str, dirname: str) -> dict:
    """The fleet's large placement: ``FleetWorker._solve_large`` on tile
    0 of phase 7's dataset in SHARD_N row blocks (the rows-sharded joint
    fit, as a worker with several devices places a request of
    ``large_stations`` or more), timed, held to the unsharded fit of the
    same inputs (module doc, phase elastic)."""
    from sagecal_tpu_torch.apps.config import FleetConfig
    from sagecal_tpu_torch.core.types import (
        identity_jones, jones_to_params, params_to_jones,
    )
    from sagecal_tpu_torch.fleet.queue import WorkItem
    from sagecal_tpu_torch.fleet.worker import FleetWorker
    from sagecal_tpu_torch.io.dataset import VisDataset
    from sagecal_tpu_torch.io.memh5 import MemFile
    from sagecal_tpu_torch.io.skymodel import load_sky
    from sagecal_tpu_torch.io.solutions import read_solutions
    from sagecal_tpu_torch.solvers import pad_rows_to, sharded_joint_fit
    from sagecal_tpu_torch.solvers.sage import build_cluster_data

    out_dir = os.path.join(dirname, "large")
    cfg = FleetConfig(out_dir=out_dir, large_stations=NSTATIONS,
                      max_lbfgs=SHARD_ITMAX, use_f64=False, timeline=False)
    worker = FleetWorker(cfg, log=lambda m: print(f"[large] {m}"),
                         open_file=MemFile)
    req = {"request_id": "large0", "tenant": "t0", "dataset": path,
           "sky_model": sky, "cluster_file": clus, "t0": 0,
           "tilesz": TILESZ}
    t = sync_clock()
    worker._solve_large(WorkItem(request_id="large0", tenant="t0",
                                 request=req, enqueued_at=time.time(),
                                 large=True), False, None, nshards=SHARD_N)
    sec = sync_clock() - t
    with open(os.path.join(out_dir, "large0.result.json")) as fh:
        doc = json.load(fh)
    # the unsharded fit of the same inputs, on the worker's device
    dev = worker.device
    with VisDataset(path, "r", MemFile) as ds:
        data = ds.load_tile(0, TILESZ, dtype=np.float32, device=dev)
    clusters, cdefs, shapelets = load_sky(sky, clus, RA0, DEC0,
                                          dtype=torch.float32, device=dev)
    cdata = build_cluster_data(data, clusters, [cd.nchunk for cd in cdefs],
                               shapelets=shapelets)
    eye = jones_to_params(identity_jones(NSTATIONS, torch.complex64,
                                         device=dev))
    p0 = eye.expand(len(clusters), 1, 8 * NSTATIONS)
    data, cdata = pad_rows_to(data, cdata, SHARD_N)
    t = sync_clock()
    p1, cost1, _ = sharded_joint_fit(data, cdata, p0, 1, itmax=SHARD_ITMAX)
    sec1 = sync_clock() - t
    cost_rel = abs(doc["res_0"] - float(cost1)) / abs(float(cost1))
    _, jsol = read_solutions(doc["solutions"])
    ref = params_to_jones(p1).reshape(jsol.shape[1:]).cpu().numpy()
    p_rel = float(np.linalg.norm(jsol[0] - ref) / np.linalg.norm(ref))
    print(f"[elastic] large placement: _solve_large in {SHARD_N} row "
          f"blocks {sec:.2f} s ({doc['iterations']} LBFGS iterations, "
          f"placed {doc['placed']}), the unsharded fit {sec1:.2f} s; cost "
          f"rel diff {cost_rel:.3e}, gains rel diff {p_rel:.3e}", flush=True)
    if not (cost_rel <= SHARD_COST_TOL and p_rel <= SHARD_P_TOL):
        fail(f"large placement parts from the unsharded fit (cost "
             f"{cost_rel:.3e}, gains {p_rel:.3e})")
    return {"seconds": sec, "unsharded_s": sec1, "cost_rel": cost_rel,
            "p_rel": p_rel, "iterations": doc["iterations"]}


def elastic_child(dirname: str, argv_json: str) -> None:
    """One process of phase ``elastic``: phase 7's dataset rebuilt in this
    process's MemFile registry under ``dirname``, then phase 7's app with
    the extra flags ``argv``; writes the residual column to
    ``<dirname>/column.npy`` and prints one JSON line of its tiles' kernel
    launches and results."""
    from sagecal_tpu_torch.io.memh5 import MemFile

    path, sky, clus = fullbatch_dataset(dirname, NCLUSTERS, FB_NTIME, "fb")
    log = TileLog()
    t = sync_clock()
    results = fullbatch_cli(path, sky, clus,
                            os.path.join(dirname, "fb.solutions"),
                            extra=json.loads(argv_json), log=log)
    wall = sync_clock() - t
    np.save(os.path.join(dirname, "column.npy"),
            np.asarray(MemFile(path, "r")["corrected"]))
    print("[child] " + json.dumps({"wall_s": wall, "results": results,
                                   "tiles": log.tiles}), flush=True)


def phase_elastic(dirname: str, ref: dict):
    """Kill phase 7's run at its first checkpoint and resume it (module
    doc, phase elastic)."""
    from sagecal_tpu_torch.elastic.faultinject import (
        kill_at_checkpoint, run_subprocess,
    )
    from sagecal_tpu_torch.io.solutions import validate_solutions

    here = os.path.dirname(os.path.abspath(__file__))
    code = "import sys, chip_smoke; chip_smoke.elastic_child(*sys.argv[1:])"
    env = {"PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    ckpt = os.path.join(dirname, "fb.ckpt")
    sol = os.path.join(dirname, "fb.solutions")

    def argv(*extra):
        return [sys.executable, "-c", code, dirname,
                json.dumps(["--checkpoint-dir", ckpt, *extra])]

    t = sync_clock()
    rc, out, err = kill_at_checkpoint(argv("--checkpoint-every", "1"), ckpt,
                                      1, timeout=ELASTIC_TIMEOUT, poll=0.05,
                                      env=env, cwd=here)
    kill_s = sync_clock() - t
    done = validate_solutions(sol)["n_intervals"] if os.path.exists(sol) \
        else 0
    print(f"[elastic] run killed at its first checkpoint: exit {rc} after "
          f"{kill_s:.1f} s with process start, {done} solution interval(s) "
          f"on disk, checkpoints {sorted(os.listdir(ckpt))}", flush=True)
    if rc == 0 or done != 1:
        print((out + err)[-4000:], flush=True)
        fail(f"elastic: the run was not killed after tile 0 (exit {rc}, "
             f"{done} intervals)")
    t = sync_clock()
    rc, out, err = run_subprocess(argv("--resume"), env=env,
                                  timeout=ELASTIC_TIMEOUT, cwd=here)
    resume_s = sync_clock() - t
    got = [json.loads(line[8:]) for line in out.splitlines()
           if line.startswith("[child] ")]
    if rc != 0 or not got:
        print((out + err)[-4000:], flush=True)
        fail(f"elastic: the resumed run exited {rc}")
    run = got[0]
    same_sol = open(sol).read() == ref["solutions"]
    column = np.load(os.path.join(dirname, "column.npy"))
    rows1 = slice(TILESZ, 2 * TILESZ)
    same_col = np.array_equal(column[rows1], ref["column"][rows1])
    launches = [tile["launches"] for tile in run["tiles"]]
    print(f"[elastic] resumed run: {run['wall_s']:.1f} s ({resume_s:.1f} s "
          f"with process start and the dataset), tiles solved "
          f"{len(run['tiles'])}, launches {launches}; solutions file "
          f"bit-identical to phase 7's: {same_sol}; tile 1's residual column "
          f"bit-identical to phase 7's: {same_col} (tile 0's column was in "
          f"the killed process's MemFile)", flush=True)
    if not same_sol:
        fail("elastic: the resumed solutions file differs from phase 7's")
    if not same_col:
        fail("elastic: the resumed tile's residual column differs")
    if len(launches) != 1 or launches[0]["fused_predict_fwd"] != 1 or \
            launches[0]["fused_cost_fwd"] <= 0 or \
            launches[0]["fused_cost_bwd"] <= 0:
        fail(f"elastic: the resumed run's launches {launches}")
    return {"killed_s": kill_s, "resume_s": resume_s,
            "resume_wall_s": run["wall_s"], "launches": launches,
            "bitwise_solutions": same_sol, "bitwise_column_tile1": same_col}


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
# at phase 7's depth (-g 1; -g 6 until the consensus phases joined, 3
# until the spatial ones did, 2 until the sharded, multihost, widefield
# and refine ones did)
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


def service_dataset(dirname: str, sky: str, clus: str) -> str:
    """The service phase's in-memory ``vis.h5`` (module doc, phase 12)
    from its sky files: SVC_TILES north-star tiles of SERVE_CLUSTERS
    point clusters under true gains, noise 1e-3; returns its path."""
    from sagecal_tpu_torch.io.dataset import simulate_dataset
    from sagecal_tpu_torch.io.memh5 import MemFile
    from sagecal_tpu_torch.io.simulate import random_jones
    from sagecal_tpu_torch.io.skymodel import load_sky

    clusters, _, _ = load_sky(sky, clus, RA0, DEC0, dtype=torch.float64)
    truth = random_jones(SERVE_CLUSTERS, NSTATIONS, seed=5, amp=0.2,
                         dtype=np.complex128)
    path = os.path.join(dirname, "svc.h5")
    simulate_dataset(path, nstations=NSTATIONS, ntime=SVC_TILES * TILESZ,
                     nchan=NCHAN, clusters=clusters, jones=truth,
                     noise_sigma=1e-3, seed=0, dec0=DEC0, open_file=MemFile)
    MemFile(path, "r+").attrs["ra0"] = RA0
    return path


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
    path = service_dataset(dirname, sky, clus)

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
    """The calibration service (module doc, phase 12); its dataset stays
    for phase fleet."""
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
                                       "latency_s", "solutions", "batch",
                                       "lane", "bucket")}
                    for r in summary["results"]],
        "manifest": manifest, "dataset": path,
        "bitwise_repeat": same,
    }
    out["seconds"] = sync_clock() - t_start
    print(f"[service] phase wall time {out['seconds']:.1f} s", flush=True)
    return out


def glob_json(dirname: str) -> list:
    """The kernel store's sidecars (one an artifact)."""
    return [n for n in os.listdir(dirname) if n.endswith(".json")]


def fleet_worker(dirname: str, *argv) -> None:
    """One worker process of phase ``fleet``: phase 12's dataset rebuilt
    in this process's MemFile registry from its sky files under
    ``dirname``, then ``apps.fleet.run_worker`` with the fleet's argv on
    the card; its claims (and steals: claims of a lease another worker
    held) counted through the queue's ``claim``; prints one JSON line of
    its summary and kernel launches."""
    from sagecal_tpu_torch.apps.fleet import (
        build_parser, config_from_args, run_worker,
    )
    from sagecal_tpu_torch.fleet.queue import LeaseQueue
    from sagecal_tpu_torch.io.memh5 import MemFile
    from sagecal_tpu_torch.serve.aot_store import AOTArtifactStore

    save = AOTArtifactStore.save

    def announced(self, *a, **k):
        """The store's save, then a line that tells phase fleet which
        worker built the library."""
        lib = save(self, *a, **k)
        print(f"[built] {os.getpid()}", flush=True)
        return lib

    AOTArtifactStore.save = announced
    t = sync_clock()
    service_dataset(dirname, os.path.join(dirname, "svc.txt"),
                    os.path.join(dirname, "svc.txt.cluster"))
    make_s = sync_clock() - t
    claims, steals = [], []
    claim = LeaseQueue.claim

    def counted(self, rid, now=None):
        held = self.read_lease(rid)
        won = claim(self, rid, now=now)
        if won:
            claims.append(rid)
            if held and held.get("worker") not in (None, self.worker):
                steals.append(rid)
        return won

    LeaseQueue.claim = counted
    _reset_launches()
    t = sync_clock()
    summary = run_worker(config_from_args(build_parser().parse_args(argv)),
                         open_file=MemFile)
    wall = sync_clock() - t
    print("[worker] " + json.dumps({
        "worker": summary["worker"], "dataset_s": make_s, "wall_s": wall,
        "claims": claims, "steals": steals, "solved": summary["solved"],
        "cycles": summary["cycles"], "store": summary["store"],
        "builds": summary["builds"], "launches": _read_launches()}),
        flush=True)


def phase_fleet(dirname: str, svc: dict):
    """A coordinator and two workers over phase 12's requests, the one
    that built the library SIGKILLed while it holds a lease (module doc,
    phase fleet)."""
    import signal
    import threading

    from sagecal_tpu_torch.apps.fleet import (
        build_parser, config_from_args, run_coordinator, worker_argv,
    )
    from sagecal_tpu_torch.fleet.queue import LeaseQueue
    from sagecal_tpu_torch.io.memh5 import MemFile, remove
    from sagecal_tpu_torch.io.solutions import read_solutions
    from sagecal_tpu_torch.serve.request import load_requests

    out_dir = os.path.join(dirname, "fleet")
    store = os.path.join(dirname, "fleet-store")
    cfg = config_from_args(build_parser().parse_args(
        ["--requests", svc["manifest"], "--out-dir", out_dir, "--aot-store",
         store, "--workers", str(FLEET_WORKERS), "--lease-ttl",
         str(FLEET_TTL), "--max-idle", "60", "--max-respawns", "0",
         *FLEET_FLAGS]))
    code = "import sys, chip_smoke; chip_smoke.fleet_worker(*sys.argv[1:])"
    outs = {}

    def argv_fn(cfg_, slot):
        return [sys.executable, "-c", code, dirname,
                *worker_argv(cfg_, slot)[3:]]

    pids, killed = [], {}

    def log(msg):
        print(f"[fleet] {msg}", flush=True)
        if "spawned" in msg:
            pids.extend(int(x) for x in
                        msg.split("[")[1].split("]")[0].split(","))

    def builder():
        """The slot of the worker that saved the library into the store
        (it prints ``[built] <pid>``), or None before then.  Either
        worker may take the store's lock first."""
        for slot, pid in enumerate(pids):
            if any(line.startswith("[built] ")
                   for line in list(outs.get(pid, []))):
                return slot
        return None

    def assassin():
        """SIGKILL the worker that built the library once it holds a
        lease, so that the survivor is the one that loads it."""
        q = LeaseQueue(os.path.join(out_dir, "queue"), worker="probe")
        deadline = time.time() + FLEET_TIMEOUT
        while time.time() < deadline and len(pids) < FLEET_WORKERS:
            time.sleep(0.05)
        while time.time() < deadline:
            slot = builder()
            wid = f"w{slot}"
            held = [it.request_id for it in q.items()
                    if (q.read_lease(it.request_id) or {}).get("worker")
                    == wid] if slot is not None else []
            if held:
                os.kill(pids[slot], signal.SIGKILL)
                killed.update(worker=wid, pid=pids[slot], held=held,
                              at=time.time())
                print(f"[fleet] SIGKILL {wid} (pid {pids[slot]}), the "
                      f"worker that built the library, holding {held}",
                      flush=True)
                return
            time.sleep(0.05)

    real_popen = subprocess.Popen
    subprocess.Popen = captured_popen(outs)
    watcher = threading.Thread(target=assassin, daemon=True)
    watcher.start()
    t = sync_clock()
    try:
        # the event log on (the audit phase reads it); the service's
        # solves collect no traces either way
        summary = _with_env({"SAGECAL_TELEMETRY": "1"}, lambda: run_coordinator(
            cfg, requests=load_requests(svc["manifest"]), log=log,
            open_file=MemFile, argv_fn=argv_fn))
    finally:
        subprocess.Popen = real_popen
    wall = sync_clock() - t
    watcher.join(timeout=5)
    workers = []
    for pid in pids:
        lines = [line for line in outs.get(pid, [])
                 if line.startswith("[worker] ")]
        if lines:
            workers.append(json.loads(lines[-1][9:]))
        elif pid != killed.get("pid"):
            print("".join(outs.get(pid, []))[-4000:], flush=True)
            fail(f"fleet: worker pid {pid} printed no summary")
    for w in workers:
        print(f"[fleet] worker {w['worker']}: dataset {w['dataset_s']:.1f} "
              f"s, run {w['wall_s']:.1f} s, {len(w['claims'])} claims, "
              f"{len(w['steals'])} steals, {w['solved']} solved in "
              f"{w['cycles']} cycles, kernel builds {w['builds']}, store "
              f"{w['store']}, launches {w['launches']}", flush=True)
    ref = {r["request_id"]: r for r in svc["results"]}
    docs = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".result.json"):
            with open(os.path.join(out_dir, name)) as fh:
                doc = json.load(fh)
            docs[doc["request_id"]] = doc
    bitwise, close, worst = 0, 0, 0.0
    for rid, r in ref.items():
        doc = docs.get(rid)
        if doc is None or doc["verdict"] != r["verdict"]:
            fail(f"fleet: request {rid}: {doc and doc['verdict']} against "
                 f"phase 12's {r['verdict']}")
        a, b = (read_solutions(x)[1] for x in (r["solutions"],
                                                doc["solutions"]))
        if np.array_equal(a, b):
            bitwise += 1
        else:
            rel = float(np.abs(a - b).max() / np.abs(a).max())
            worst = max(worst, rel)
            close += rel <= 5e-3
    builds = sum(w["builds"] for w in workers)
    alive_builds = [w["builds"] for w in workers]
    print(f"[fleet] {summary['done']}/{summary['requests']} done in "
          f"{wall:.1f} s with process start: {summary['solves_per_sec']:.4f} "
          f"requests/s, p50 latency {summary['p50_latency_s']:.3f} s, p95 "
          f"{summary['p95_latency_s']:.3f} s; manifests {len(docs)} for "
          f"{len(ref)} requests; solutions bit-identical to phase 12's "
          f"{bitwise}, others within 5e-3 {close} (worst {worst:.2e}); "
          f"kernel builds of the reporting workers {alive_builds}, store "
          f"artifacts {len(glob_json(store))}", flush=True)
    if not killed:
        fail("fleet: the worker that built the library held no lease "
             "after it saved it")
    if not summary["drained"] or sorted(docs) != sorted(ref):
        fail(f"fleet: {len(docs)} manifests for {len(ref)} requests, "
             f"drained {summary['drained']}")
    if bitwise + close != len(ref):
        fail(f"fleet: solutions off phase 12's by {worst:.2e}")
    if builds > 1 or alive_builds != [0] or \
            workers[0]["store"]["aot_hits"] < 1:
        fail(f"fleet: kernel builds per reporting worker {alive_builds}, "
             f"store {[w['store'] for w in workers]}")
    remove(svc["dataset"])
    return {"out_dir": out_dir, "wall_s": wall, "summary": summary,
            "workers": workers,
            "killed": killed, "bitwise": bitwise, "close": close,
            "worst_rel": worst}


def stream_argv(path: str, sky: str, clus: str, out_dir: str, extra=()):
    """The ``stream`` subcommand's arguments over phase 7's dataset."""
    return ["-d", path, "-s", sky, "-c", clus, "--out-dir", out_dir,
            *STREAM_FLAGS, *extra]


def stream_run(argv, log):
    """``apps.stream``'s parser and config over ``argv``, then
    ``run_stream`` on the card over the in-memory dataset; returns the
    summary and the launches of #1-#6 in the run (counts set to 0 just
    before it)."""
    from sagecal_tpu_torch.apps.stream import (
        build_parser, config_from_args, run_stream,
    )
    from sagecal_tpu_torch.io.memh5 import MemFile

    cfg = config_from_args(build_parser().parse_args(argv))
    _reset_launches()
    summary = run_stream(cfg, log=log, open_file=MemFile)
    return summary, _read_launches()


def stream_child(dirname: str, out_dir: str, extra_json: str) -> None:
    """One process of phase ``stream``: phase 7's dataset rebuilt in this
    process's MemFile registry under ``dirname``, then the stream into
    ``out_dir`` with the extra flags; prints one JSON line of its summary
    and launches."""
    path, sky, clus = fullbatch_dataset(dirname, NCLUSTERS, FB_NTIME, "st")
    summary, launches = stream_run(
        stream_argv(path, sky, clus, out_dir, json.loads(extra_json)),
        log=lambda m: print(f"[stream child] {m}", flush=True))
    print("[child] " + json.dumps({"summary": summary,
                                   "launches": launches}), flush=True)


def result_docs(out_dir: str) -> list:
    """The result manifests in ``out_dir``, in file-name order (a
    stream's in window order)."""
    docs = []
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".result.json"):
            with open(os.path.join(out_dir, name)) as fh:
                docs.append(json.load(fh))
    return docs


def phase_stream(dirname: str):
    """The stream calibrator: uninterrupted, killed, adopted (module
    doc, phase stream)."""
    import signal

    from sagecal_tpu_torch.elastic.checkpoint import (
        ResumeRefused, check_owner_lease, find_latest_checkpoint,
        list_checkpoints,
    )

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t_start = sync_clock()
    path, sky, clus = fullbatch_dataset(dirname, NCLUSTERS, FB_NTIME, "st")
    make_s = sync_clock() - t_start
    ref_dir = os.path.join(dirname, "stream-ref")
    t = sync_clock()
    ref, launches = stream_run(
        stream_argv(path, sky, clus, ref_dir),
        log=lambda m: print(f"[stream] {m}", flush=True))
    ref_s = sync_clock() - t
    docs = result_docs(ref_dir)
    print(f"[stream] uninterrupted run {ref_s:.1f} s (dataset "
          f"{make_s:.1f} s): windows {ref['solved']}/{ref['windows']}, "
          f"warm {[d['warm'] for d in docs]}, res_0 -> res_1 "
          + ", ".join(f"{d['res0']:.6e} -> {d['res1']:.6e}" for d in docs)
          + f", latencies {[round(x, 3) for x in ref['latencies_s']]} s, "
          f"steady-state {ref['latency_to_first_solution_s']:.3f} s, first "
          f"{ref['first_window_latency_s']:.3f} s; owner lease fenced "
          f"(a window outlasted the TTL) {ref['lease_fenced']}; launches "
          f"of #1-#6 {launches}", flush=True)
    if ref["solved"] != STREAM_WINDOWS or len(docs) != STREAM_WINDOWS:
        fail(f"stream: {ref['solved']} windows solved, {len(docs)} "
             f"manifests")
    if [d["warm"] for d in docs] != [False] + [True] * (STREAM_WINDOWS - 1):
        fail(f"stream: warm flags {[d['warm'] for d in docs]}")
    for d in docs:
        if not (np.isfinite(d["res1"]) and d["res1"] < d["res0"]):
            fail(f"stream window {d['window']}: res_1 {d['res1']} not below "
                 f"res_0 {d['res0']}")
        if not d.get("latency_s", 0.0) > 0.0:
            fail(f"stream window {d['window']}: no latency_s")
    if not ref["latency_to_first_solution_s"] < ref["first_window_latency_s"]:
        fail("stream: the steady-state latency is not below window 0's")
    if any(launches.values()):
        fail(f"stream: kernels launched on the torch-op route: {launches}")
    with open(ref["solutions"]) as fh:
        ref_sol = fh.read()

    # a second process, SIGKILLed once window 0's checkpoint lands
    out = os.path.join(dirname, "stream-kill")
    ckpt = os.path.join(out, "stream.ckpt")
    code = "import sys, chip_smoke; chip_smoke.stream_child(*sys.argv[1:])"
    t = sync_clock()
    proc = subprocess.Popen([sys.executable, "-c", code, dirname, out, "[]"],
                            cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + STREAM_TIMEOUT
    while proc.poll() is None and time.time() < deadline and \
            not list_checkpoints(ckpt):
        time.sleep(0.05)
    if proc.poll() is not None or not list_checkpoints(ckpt):
        proc.kill()
        print(proc.communicate()[0][-4000:], flush=True)
        fail("stream: the run to kill wrote no checkpoint")
    os.kill(proc.pid, signal.SIGKILL)
    proc.communicate(timeout=60)
    kill_s = sync_clock() - t
    meta, _, cpath = find_latest_checkpoint(ckpt)
    try:
        check_owner_lease(meta, "chip-smoke-foreign")
        refused = ""
    except ResumeRefused as e:
        refused = str(e)
    left = float(meta["lease_expires_at"]) - time.time()
    with open(os.path.join(out, os.path.basename(ref["solutions"]))) as fh:
        killed_sol = fh.read()
    print(f"[stream] run SIGKILLed after window 0's checkpoint "
          f"({os.path.basename(cpath)}, windows_done {meta['windows_done']}, "
          f"owner {meta['owner']}) {kill_s:.1f} s after its start, exit "
          f"{proc.returncode}; a foreign owner with {left:.2f} s of the lease "
          f"left: {'refused' if refused else 'ADOPTED'} ({refused})",
          flush=True)
    if proc.returncode != -signal.SIGKILL or meta["windows_done"] != 1:
        fail(f"stream: the killed run exited {proc.returncode} at "
             f"windows_done {meta['windows_done']}")
    if not refused or left <= 0.0:
        fail("stream: a live foreign lease did not refuse the chain")
    if not ref_sol.startswith(killed_sol) or killed_sol == ref_sol:
        fail("stream: the killed run's solutions file is not a prefix of the "
             "uninterrupted run's")

    # after the TTL, another process adopts the chain
    time.sleep(max(float(meta["lease_expires_at"]) - time.time(), 0.0) + 0.2)
    t = sync_clock()
    r = subprocess.run([sys.executable, "-c", code, dirname, out,
                        json.dumps(["--resume"])], cwd=here, env=env,
                       capture_output=True, text=True, timeout=STREAM_TIMEOUT)
    adopt_s = sync_clock() - t
    got = [json.loads(line[8:]) for line in r.stdout.splitlines()
           if line.startswith("[child] ")]
    if r.returncode != 0 or not got:
        print((r.stdout + r.stderr)[-4000:], flush=True)
        fail(f"stream: the adopting run exited {r.returncode}")
    adopted = got[0]["summary"]
    with open(adopted["solutions"]) as fh:
        same_sol = fh.read() == ref_sol
    keys = ("request_id", "window", "t0", "warm", "verdict", "res0", "res1")
    same_docs = [{k: d[k] for k in keys} for d in result_docs(out)] == \
        [{k: d[k] for k in keys} for d in docs]
    print(f"[stream] adopting run {adopt_s:.1f} s with process start and the "
          f"dataset: resumed from window {adopted['resumed_from']}, solved "
          f"{adopted['solved']}/{adopted['windows']}, latencies "
          f"{[round(x, 3) for x in adopted['latencies_s']]} s, launches "
          f"{got[0]['launches']}; solutions file bit-identical to the "
          f"uninterrupted run's: {same_sol}; window manifests' results "
          f"bit-identical: {same_docs}", flush=True)
    if adopted["resumed_from"] != 1 or adopted["solved"] != STREAM_WINDOWS:
        fail(f"stream: the adopter resumed from {adopted['resumed_from']}")
    if not (same_sol and same_docs):
        fail("stream: the adopted chain differs from the uninterrupted run")
    if any(got[0]["launches"].values()):
        fail(f"stream: the adopter launched kernels: {got[0]['launches']}")
    from sagecal_tpu_torch.io.memh5 import remove

    remove(path)
    out_doc = {"dataset_s": make_s, "ref_s": ref_s, "summary": ref,
               "launches": launches, "killed_s": kill_s, "adopt_s": adopt_s,
               "adopted": adopted, "lease_left_s": left,
               "seconds": sync_clock() - t_start}
    print(f"[stream] phase wall time {out_doc['seconds']:.1f} s", flush=True)
    return out_doc


def captured_popen(outs: dict):
    """A ``subprocess.Popen`` whose processes start from this script's
    directory and whose output is kept in ``outs[pid]``, read by a
    thread (the fleet and load phases' workers)."""
    import threading

    here = os.path.dirname(os.path.abspath(__file__))

    class Piped(subprocess.Popen):
        def __init__(self, args, **kw):
            super().__init__(args, cwd=here, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, **kw)
            buf = outs[self.pid] = []
            threading.Thread(target=lambda: buf.extend(self.stdout),
                             daemon=True).start()

    return Piped


def load_worker(workdir: str, spec_json: str, *argv) -> None:
    """One worker process of phase ``load``: the tenants' datasets
    rebuilt in this process's MemFile registry from the load spec
    (``fleet/loadgen.py::tenant_datasets``), then
    ``apps.fleet.run_worker`` with the fleet's argv on the card; prints
    one JSON line of its kernel launches (also when the coordinator's
    SIGTERM ends it)."""
    from sagecal_tpu_torch.apps.fleet import (
        build_parser, config_from_args, run_worker,
    )
    from sagecal_tpu_torch.fleet.loadgen import LoadSpec, tenant_datasets
    from sagecal_tpu_torch.io.memh5 import MemFile

    doc = json.loads(spec_json)
    spec = LoadSpec(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in doc.items()})
    tenant_datasets(workdir, spec, open_file=MemFile)
    _reset_launches()
    try:
        run_worker(config_from_args(build_parser().parse_args(argv)),
                   open_file=MemFile)
    finally:
        print("[worker] " + json.dumps({"launches": _read_launches()}),
              flush=True)


def phase_load(dirname: str):
    """The load generator against a live fleet on the card (module doc,
    phase load)."""
    import dataclasses

    from sagecal_tpu_torch.apps.fleet import worker_argv
    from sagecal_tpu_torch.apps.load import (
        build_parser, main as load_main, spec_from_args,
    )
    from sagecal_tpu_torch.io.memh5 import MemFile

    out = os.path.join(dirname, "load")
    argv = ["--out-dir", out, *LOAD_FLAGS]
    spec = spec_from_args(build_parser().parse_args(argv))
    workdir = os.path.join(out, "workload")
    code = "import sys, chip_smoke; chip_smoke.load_worker(*sys.argv[1:])"

    def argv_fn(cfg_, slot):
        return [sys.executable, "-c", code, workdir,
                json.dumps(dataclasses.asdict(spec)),
                *worker_argv(cfg_, slot)[3:]]

    outs = {}
    real_popen = subprocess.Popen
    subprocess.Popen = captured_popen(outs)
    t = sync_clock()
    try:
        rc = _with_env({"SAGECAL_TELEMETRY": "1"}, lambda: load_main(
            argv, open_file=MemFile, argv_fn=argv_fn,
            log=lambda m: print(f"[load] {m}", flush=True)))
    finally:
        subprocess.Popen = real_popen
    wall = sync_clock() - t
    with open(os.path.join(out, "load_report.json")) as fh:
        report = json.load(fh)
    with open(os.path.join(out, "load_steps.json")) as fh:
        steps = json.load(fh)
    submitted = [a["request_id"] for a in steps["submitted"]]
    docs = result_docs(out)
    ids = [d["request_id"] for d in docs]
    served = [d for d in docs if d.get("verdict") not in ("shed", "error")]
    lat = sorted(d["latency_s"] for d in served)
    p50 = float(np.percentile(lat, 50)) if lat else float("nan")
    p95 = float(np.percentile(lat, 95)) if lat else float("nan")
    rps = len(served) / report["wall_s"] if report["wall_s"] > 0 else 0.0
    workers = []
    for lines in outs.values():
        rows = [json.loads(x[9:]) for x in lines if x.startswith("[worker] ")]
        workers.extend(rows[-1:])
    print(f"[load] exit {rc} in {wall:.1f} s with process start: "
          f"{len(submitted)} arrivals, {len(docs)} result manifests "
          f"({report['served']} served, {report['shed']} shed, "
          f"{report['errors']} errors); {rps:.4f} requests/s over the "
          f"schedule and the drain ({report['wall_s']:.1f} s), p50 latency "
          f"{p50:.3f} s, p95 {p95:.3f} s; saturation throughput "
          f"{report['saturation_throughput_solves_per_sec']} solves/s; "
          f"Little's law ok {report['littles_law']['ok']}, live vs "
          f"after-the-fact depth reconciled {report['reconcile']['ok']}; "
          f"workers {workers}", flush=True)
    if rc != 0 or not report["drained"]:
        fail(f"load: exit {rc}, drained {report['drained']}")
    if not submitted or sorted(ids) != sorted(submitted):
        fail(f"load: {len(docs)} manifests for {len(submitted)} arrivals")
    if not report["reconcile"]["ok"]:
        fail(f"load: the live and after-the-fact views disagree: "
             f"{report['reconcile']}")
    if len(workers) != 2 or any(any(w["launches"].values()) for w in workers):
        fail(f"load: worker launches {workers}")
    return {"out_dir": out, "wall_s": wall, "rc": rc, "report": report,
            "requests_per_s": rps, "p50_latency_s": p50,
            "p95_latency_s": p95, "arrivals": len(submitted),
            "workers": workers}


def phase_audit(dirs: dict):
    """``run_audit`` and ``replay`` of the fleet and load phases' run
    directories, and one injection caught (module doc, phase audit)."""
    from sagecal_tpu_torch.obs.audit import format_audit, run_audit
    from sagecal_tpu_torch.obs.replay import format_replay, load_run, replay

    out = {}
    t0 = time.perf_counter()
    for name, d in dirs.items():
        t = time.perf_counter()
        rep = run_audit(d, inject="")
        state = replay(load_run(d))
        secs = time.perf_counter() - t
        text = format_audit(rep)
        print("\n".join(f"[audit] {name}: {line}" for line in
                        (format_replay(state).splitlines()[:2]
                         + text.splitlines()[-12:])), flush=True)
        c = state.counts
        out[name] = {"exit": rep.exit_code(), "violations": len(rep.violations),
                     "counts": c, "seconds": secs}
        if rep.exit_code() != 0 or rep.violations:
            fail(f"audit {name}: exit {rep.exit_code()}, violations "
                 f"{[v.render() for v in rep.violations]}")
        if c["enqueued"] != c["served"] + c["shed"] + c["failed"] or \
                c["pending"]:
            fail(f"audit {name}: replayed counts {c}")
    name, d = next(iter(dirs.items()))
    rep = run_audit(d, inject="tear_record")
    print(f"[audit] {name} with tear_record injected: exit "
          f"{rep.exit_code()}, kinds {rep.kinds()}", flush=True)
    if rep.exit_code() != 1 or "torn_record" not in rep.kinds():
        fail("audit: the injected torn record was not caught")
    out["seconds"] = time.perf_counter() - t0
    return out


def tools_sky(dirname: str) -> str:
    """TOOLS_SKY and its shapelet's ``S4.fits.modes`` (a seeded mode
    vector) in ``dirname``."""
    sky = os.path.join(dirname, "tools.sky")
    with open(sky, "w") as fh:
        fh.write(TOOLS_SKY)
    modes = 3e-5 * np.random.default_rng(5).standard_normal(TOOLS_N0 ** 2)
    modes[0] = 8e-5
    with open(os.path.join(dirname, "S4.fits.modes"), "w") as fh:
        fh.write(f"# ra dec\n1 0 9.0 44 55 0\n{TOOLS_N0} {TOOLS_BETA}\n")
        fh.writelines(f"{k} {float(v)!r}\n" for k, v in enumerate(modes))
    return sky


def phase_tools(dirname: str):
    """The offline tools (module doc, phase tools)."""
    from sagecal_tpu_torch.io.dataset import simulate_dataset
    from sagecal_tpu_torch.io.fits import FitsWCS, write_fits_image
    from sagecal_tpu_torch.io.memh5 import MemFile, remove
    from sagecal_tpu_torch.tools import _native
    from sagecal_tpu_torch.tools.buildsky import buildsky
    from sagecal_tpu_torch.tools.restore import restore
    from sagecal_tpu_torch.tools.uvwriter import rewrite_uvw

    t_start = time.perf_counter()
    n = TOOLS_NPIX
    wcs = FitsWCS(crval1=15.0, crval2=45.0, crpix1=n / 2, crpix2=n / 2,
                  cdelt1=-3e-3, cdelt2=3e-3)
    blank = os.path.join(dirname, "blank.fits")
    write_fits_image(blank, (0.005 * np.random.default_rng(8).standard_normal(
        (n, n))).astype(np.float32), wcs, extra={"CRVAL3": 150e6})
    sky = tools_sky(dirname)
    t = sync_clock()
    img = restore(sky, blank, os.path.join(dirname, "card.fits"))
    restore_s = sync_clock() - t
    cpu = restore(sky, blank, os.path.join(dirname, "cpu.fits"), device="cpu")
    rel = float(np.abs(img - cpu).max() / np.abs(cpu).max())
    t = time.perf_counter()
    srcs = buildsky(os.path.join(dirname, "card.fits"),
                    os.path.join(dirname, "rec.sky.txt"), threshold_sigma=5.0,
                    maxP=2, log=lambda *a: None)
    buildsky_s = time.perf_counter() - t
    fluxes = sorted((s["flux"] for s in srcs), reverse=True)
    bright = max(srcs, key=lambda s: s["flux"])
    ra0, dec0 = math.radians(wcs.crval1), math.radians(wcs.crval2)
    pix = 2 * math.radians(3e-3)
    off = (abs((bright["ra"] - ra0) * math.cos(dec0)), abs(bright["dec"] - dec0))
    backend, lib = _native.backend(), _native.library_path()
    print(f"[tools] restore: {n} x {n} pixels, point, point and an n0 "
          f"{TOOLS_N0} shapelet rendered on the card in {restore_s:.3f} s, "
          f"{rel:.2e} of the CPU's image; buildsky: {len(srcs)} sources in "
          f"{buildsky_s:.3f} s, fluxes {[round(f, 4) for f in fluxes]}, the "
          f"brightest {off[0] / pix * 2:.2f}, {off[1] / pix * 2:.2f} pixels "
          f"off the centre; native core: {backend} "
          f"({os.path.relpath(lib, os.path.dirname(_native._PKG))}, g++ runs "
          f"in this process {_native.builds})",
          flush=True)
    if not rel <= 1e-12:
        fail(f"tools: the card's restore is {rel} off the CPU's")
    if len(fluxes) < 2 or abs(fluxes[0] - 2.0) > 0.3 or \
            abs(fluxes[1] - 1.0) > 0.15 or max(off) >= pix:
        fail(f"tools: buildsky recovered {srcs}")
    if backend != "native" or not os.path.exists(lib) or \
            os.path.dirname(lib) != _native.BUILD_DIR:
        fail(f"tools: the native core is not built ({backend}, {lib})")
    path = os.path.join(dirname, "uvw.h5")
    simulate_dataset(path, nstations=NSTATIONS, ntime=4, nchan=1,
                     open_file=MemFile)
    before = {k: np.asarray(MemFile(path, "r")[k]) for k in "uvw"}
    xyz = np.random.default_rng(0).standard_normal((NSTATIONS, 3)) * 500.0
    pos = os.path.join(dirname, "pos.txt")
    np.savetxt(pos, xyz)
    t = time.perf_counter()
    rewrite_uvw(path, pos, "moon", log=lambda *a: None, open_file=MemFile)
    uvw_s = time.perf_counter() - t
    f = MemFile(path, "r")
    after = np.stack([np.asarray(f[k]) for k in "uvw"], -1)
    ap, aq = np.asarray(f["ant_p"]), np.asarray(f["ant_q"])
    length = np.linalg.norm(xyz[ap] - xyz[aq], axis=1)
    len_rel = float(np.abs(np.linalg.norm(after, axis=-1) - length).max()
                    / length.max())
    moved = float(np.abs(after[..., 0] - before["u"]).max())
    remove(path)
    print(f"[tools] uvwriter: {after.shape[0]} x {after.shape[1]} baselines "
          f"rewritten in the lunar frame through MemFile in {uvw_s:.3f} s, "
          f"baseline lengths kept to {len_rel:.1e}, u moved by {moved:.1f} m",
          flush=True)
    if not (len_rel <= 1e-12 and moved > 1.0):
        fail(f"tools: uvwriter lengths {len_rel}, moved {moved}")
    return {"restore_s": restore_s, "restore_rel_cpu": rel,
            "buildsky_s": buildsky_s, "sources": len(srcs),
            "fluxes": fluxes, "native": backend,
            "native_builds": _native.builds, "uvwriter_s": uvw_s,
            "seconds": time.perf_counter() - t_start}


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


def dist_datasets(dirname: str, ntime: int = TILESZ, name: str = "dist"):
    """DIST_BANDS in-memory band datasets (``MemFile``) of the north-star
    geometry (``ntime`` timeslots x NCHAN channels), at frequencies spread
    over DIST_FREQS, of ``write_sky``'s 100-cluster sky under true gains
    linear in frequency (tests/test_distributed.py's construction), noise
    1e-3.  Returns (glob, sky file, cluster file)."""
    from sagecal_tpu_torch.device import resolve_device
    from sagecal_tpu_torch.io.dataset import simulate_dataset
    from sagecal_tpu_torch.io.memh5 import MemFile
    from sagecal_tpu_torch.io.skymodel import load_sky

    sky, clus = write_sky(dirname, nclusters=NCLUSTERS, name=name)
    clusters, _, _ = load_sky(sky, clus, RA0, DEC0, dtype=torch.float64)
    rng = np.random.default_rng(13)
    shape = (NCLUSTERS, NSTATIONS, 2, 2)
    c = lambda: rng.standard_normal(shape) + 1j * rng.standard_normal(shape)  # noqa: E731
    Z0 = np.eye(2) + 0.2 * c()
    Z1 = 0.1 * c()
    freqs = np.linspace(*DIST_FREQS, DIST_BANDS)
    for f, freq in enumerate(freqs):
        path = os.path.join(dirname, f"band{f}.h5")
        simulate_dataset(path, nstations=NSTATIONS, ntime=ntime,
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


def _launchers() -> dict:
    """Every kernel's launcher (#1-#6 and the probes #7-#10), by name."""
    from sagecal_tpu_torch.ops import rime_kernel as rk
    from sagecal_tpu_torch.tools import kbisect as kb

    out = {k: getattr(rk, k + "_cuda") for k in KERNELS}
    out.update({k: getattr(kb, f"probe_{p}_cuda") for k, p in PROBES.items()})
    return out


class EventClock:
    """Wraps ``module.name`` for a ``with`` block: each call's device
    seconds from CUDA events recorded at both ends (no synchronize), and
    ``keep(args, out)``'s value, read after the run by ``calls()``."""

    def __init__(self, module, name: str, keep=None):
        self.module, self.name = module, name
        self.real, self.keep, self.marks = getattr(module, name), keep, []

    def __enter__(self):
        def timed(*a, **k):
            start = device_event()
            start.record()
            out = self.real(*a, **k)
            end = device_event()
            end.record()
            self.marks.append((start, end, self.keep and self.keep(a, out)))
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)

    def calls(self):
        """[(seconds, kept)] of every call, after the run."""
        torch.cuda.synchronize()
        return [(s.elapsed_time(e) / 1e3, kept) for s, e, kept in self.marks]


def spatial_sky(dirname: str, sky: str, clus: str):
    """Phase 14's sky and cluster files plus the all-shapelet diffuse
    cluster SPAT_DIFFUSE_ID (one source near the phase centre, a smooth
    blob: a dominant zeroth mode over SPAT_N0 x SPAT_N0), its
    ``.fits.modes`` file, and a -G file of rho 5 and nonzero alphas.
    Returns (sky, cluster file, -G file)."""
    rng = np.random.default_rng(17)
    out = os.path.join(dirname, "spat.txt")
    with open(sky) as f:
        text = f.read()
    hrs, deg = math.degrees(RA0) / 15.0, math.degrees(DEC0) + 0.3
    h, rem = int(hrs), (hrs - int(hrs)) * 60.0
    d, drem = int(deg), (deg - int(deg)) * 60.0
    with open(out, "w") as f:
        f.write(text + f"SDIF {h} {int(rem)} {(rem - int(rem)) * 60.0:.6f} "
                f"{d} {int(drem)} {(drem - int(drem)) * 60.0:.6f} 5.0 0 0 "
                f"0 0 0 1 1 0 150e6\n")
    with open(clus) as f:
        ctext = f.read()
    with open(out + ".cluster", "w") as f:
        f.write(ctext + f"{SPAT_DIFFUSE_ID} 1 SDIF\n")
    modes = 0.05 * rng.standard_normal(SPAT_N0 * SPAT_N0)
    modes[0] = 1.0
    with open(os.path.join(dirname, "SDIF.fits.modes"), "w") as f:
        f.write(f"# ra dec\n0 0 0 51 0 0\n{SPAT_N0} {SPAT_BETA}\n")
        f.writelines(f"{i} {m:.8f}\n" for i, m in enumerate(modes))
    rho = os.path.join(dirname, "spat.rho")
    with open(rho, "w") as f:
        f.writelines(f"{k} 1 5.0 {2.0 + 0.02 * k:.3f}\n"
                     for k in range(NCLUSTERS + 1))
    return out, out + ".cluster", rho


def phase_spatial(dirname: str):
    """Spatial regularization with the diffuse constraint through the CLI
    (module doc, phase 16).  Returns the phase's numbers and the band
    datasets with their point sky (glob, sky, cluster file) for phase 17
    and the spatial app."""
    import sagecal_tpu_torch.apps.distributed as dist
    import sagecal_tpu_torch.parallel.mesh as mesh
    from sagecal_tpu_torch.apps.cli import main as cli_main
    from sagecal_tpu_torch.io.memh5 import MemFile
    from sagecal_tpu_torch.kernels.parity import compare_predict_on_tile

    t_start = sync_clock()
    pattern, sky, clus = dist_datasets(dirname, SPAT_NTIME, "spatsky")
    ssky, sclus, rho = spatial_sky(dirname, sky, clus)
    make_s = sync_clock() - t_start
    print(f"[spatial] {DIST_BANDS} bands of {SPAT_NTIME // TILESZ} tiles of "
          f"{ROWS} rows, {NCLUSTERS} point clusters and a shapelet cluster "
          f"(n0 {SPAT_N0}), made in {make_s:.1f} s; flags "
          f"{' '.join(SPAT_FLAGS)} -G", flush=True)
    sol = os.path.join(dirname, "spat.z")
    elog = os.path.join(dirname, "spat_events.jsonl")
    argv = ["-s", ssky, "-c", sclus, "-f", pattern, "-p", sol, "-G", rho,
            *SPAT_FLAGS]
    # the tile-2 residual step's inputs of band 0; each ADMM window's
    # spat_res; each re-predict's largest change of the diffuse cluster
    seen, sres = [], []
    real_res, real_fn = dist.calculate_residuals, dist.make_admm_mesh_fn

    def res_spy(data, cdata, p, **kw):
        seen.append((data, cdata, p) if len(seen) == DIST_BANDS else None)
        return real_res(data, cdata, p, **kw)

    def fn_spy(*a, **k):
        fn = real_fn(*a, **k)

        def run(*args):
            out = fn(*args)
            sres.append(out.spat_res)
            return out
        return run

    def change(a, out):
        cid = a[2]
        return ((out.coh[cid] - a[1].coh[cid]).abs().max()
                / a[1].coh[cid].abs().max())

    for k in KERNELS + tuple(PROBES):
        _launchers()[k].launches = 0
    torch.cuda.reset_peak_memory_stats()
    dist.calculate_residuals, dist.make_admm_mesh_fn = res_spy, fn_spy
    t = sync_clock()
    try:
        with XstepClock() as xclock, \
                EventClock(mesh, "update_spatialreg_fista") as fclock, \
                EventClock(dist, "recalculate_diffuse_coherencies",
                           change) as rclock:
            rc = _with_env({"SAGECAL_TELEMETRY": "1",
                            "SAGECAL_EVENT_LOG": elog},
                           lambda: cli_main(argv, open_file=MemFile))
    finally:
        dist.calculate_residuals, dist.make_admm_mesh_fn = real_res, real_fn
    wall = sync_clock() - t
    launches = {k: c.launches for k, c in _launchers().items()}
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        fail(f"spatial: the CLI exited {rc}")
    xcalls, fcalls = xclock.calls(), fclock.calls()
    rcalls = [(sec, float(c)) for sec, c in rclock.calls()]
    ntile = SPAT_NTIME // TILESZ
    per_tile = len(xcalls) // ntile
    res = [[(xcalls[t * per_tile + b][1], xcalls[(t + 1) * per_tile
                                                 - DIST_BANDS + b][2])
            for b in range(DIST_BANDS)] for t in range(ntile)]
    spat_res = [x.cpu().tolist() for x in sres]
    # #1 on tile 2's re-predicted coherencies (band 0's residual step)
    data, cdata, p = seen[DIST_BANDS]
    par = compare_predict_on_tile(data, cdata, p)
    del seen
    zrows = sum(1 for line in open(sol) if not line.startswith("#")) - 1
    with open(sol + ".spatial.ppm", "rb") as f:
        ppm = f.read()
    # a near-square grid of 64-pixel panels, one a station
    grid = math.ceil(math.sqrt(NSTATIONS))
    side = max(grid, -(-NSTATIONS // grid)) * 64
    head = f"P6\n{side} {side} 255\n".encode()
    print(f"[spatial] run {wall:.1f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB; x-step seconds per tile "
          f"{[round(sum(c[0] for c in xcalls[t * per_tile:(t + 1) * per_tile]), 2) for t in range(ntile)]}; "
          f"FISTA refits {[round(c[0], 4) for c in fcalls]} s; re-predicts "
          f"{[round(c[0], 4) for c in rcalls]} s (diffuse cluster changed "
          f"by {[round(c[1], 4) for c in rcalls]} of the sky-only "
          f"prediction's max)", flush=True)
    print(f"[spatial] spat_res per tile {spat_res}; launches {launches}; "
          f"global-Z file {zrows} rows; plot {len(ppm)} bytes", flush=True)
    print(f"[spatial] per tile, band res_0 -> res_1 "
          f"{[[(round(a, 6), round(b, 6)) for a, b in r] for r in res]}; "
          f"#1 on the re-predicted tile: model_rel {par['model_rel']:.3e}, "
          f"max abs error {par['model_max_abs_err']:.3e}, bitwise repeat "
          f"{par['bitwise_repeat']}", flush=True)
    if launches["fused_predict_fwd"] != DIST_BANDS * ntile:
        fail(f"spatial: kernel #1 launched {launches['fused_predict_fwd']} "
             f"times, not {DIST_BANDS * ntile}")
    if any(launches[k] for k in KERNELS[1:] + tuple(PROBES)):
        fail(f"spatial: other kernels launched: {launches}")
    if len(spat_res) != ntile or not np.all(np.isfinite(spat_res)):
        fail(f"spatial: spat_res {spat_res}")
    if len(fcalls) != ntile or len(rcalls) != DIST_BANDS:
        fail(f"spatial: {len(fcalls)} FISTA refits and {len(rcalls)} "
             f"re-predicts, not {ntile} and {DIST_BANDS}")
    if not all(c[1] > 0.0 for c in rcalls):
        fail("spatial: a re-predict left the diffuse cluster unchanged")
    if not (par["model_rel"] <= MODEL_TOL and par["bitwise_repeat"]):
        fail(f"spatial: #1 on the re-predicted coherencies: {par}")
    if not all(np.isfinite(b) and b < a for r in res for a, b in r):
        fail(f"spatial: a band's res_1 is not below its res_0: {res}")
    if zrows != ntile * 2 * 8 * NSTATIONS:
        fail(f"spatial: the global-Z file holds {zrows} rows")
    if not (ppm.startswith(head) and len(ppm) == len(head) + side * side * 3):
        fail(f"spatial: the plot is {len(ppm)} bytes, header {ppm[:16]!r}")
    out = {"dataset_s": make_s, "wall_s": wall, "peak_bytes": peak,
           "xstep_s": [c[0] for c in xcalls],
           "fista_s": [c[0] for c in fcalls],
           "repredict_s": [c[0] for c in rcalls],
           "repredict_change": [c[1] for c in rcalls], "spat_res": spat_res,
           "launches": launches, "res": res, "zrows": zrows,
           "parity": par}
    out["seconds"] = sync_clock() - t_start
    print(f"[spatial] phase wall time {out['seconds']:.1f} s", flush=True)
    return out, (pattern, sky, clus)


def phase_federated(dirname: str, pattern: str, sky: str, clus: str):
    """Federated calibration through the CLI (module doc, phase 17)."""
    import sagecal_tpu_torch.apps.federated as fed
    from sagecal_tpu_torch.apps.cli import main as cli_main
    from sagecal_tpu_torch.io import solutions as solio
    from sagecal_tpu_torch.io.memh5 import MemFile
    from sagecal_tpu_torch.solvers.batchmode import _data_cost

    t_start = sync_clock()
    print(f"[federated] {DIST_BANDS} bands of one {SPAT_NTIME}-timeslot "
          f"tile, {NCLUSTERS} clusters; flags {' '.join(FED_FLAGS)}",
          flush=True)
    sol = os.path.join(dirname, "fed.sol")
    elog = os.path.join(dirname, "fed_events.jsonl")
    argv = ["-s", sky, "-c", clus, "-f", pattern, "-p", sol, *FED_FLAGS]
    # each minibatch round's (data, cdata, input state, costs) and each
    # average, timed on the device
    real_step, real_avg = fed.make_federated_minibatch_fn, fed.make_fed_avg_fn
    step_clock, avg_clock = [], []

    def clocked(make, marks, keep):
        def build(*a, **k):
            fn = make(*a, **k)

            def run(*args):
                start = device_event()
                start.record()
                out = fn(*args)
                end = device_event()
                end.record()
                marks.append((start, end, keep(args, out)))
                return out
            return run
        return build

    step_keep = lambda a, out: (a[0], a[1], out[2])  # noqa: E731
    for k in KERNELS + tuple(PROBES):
        _launchers()[k].launches = 0
    torch.cuda.reset_peak_memory_stats()
    fed.make_federated_minibatch_fn = clocked(real_step, step_clock,
                                              step_keep)
    fed.make_fed_avg_fn = clocked(real_avg, avg_clock, lambda a, out: None)
    t = sync_clock()
    try:
        rc = _with_env({"SAGECAL_TELEMETRY": "1", "SAGECAL_EVENT_LOG": elog},
                       lambda: cli_main(argv, open_file=MemFile))
    finally:
        fed.make_federated_minibatch_fn = real_step
        fed.make_fed_avg_fn = real_avg
    wall = sync_clock() - t
    launches = {k: c.launches for k, c in _launchers().items()}
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        fail(f"federated: the CLI exited {rc}")
    torch.cuda.synchronize()
    step_s = [s.elapsed_time(e) / 1e3 for s, e, _ in step_clock]
    avg_s = [s.elapsed_time(e) / 1e3 for s, e, _ in avg_clock]
    rounds = _events(elog, "fed_round")
    resets = _events(elog, "band_reset")
    round_s = [sum(step_s[r * 2:(r + 1) * 2]) + avg_s[r]
               for r in range(len(avg_s))]
    # each band's data cost on minibatch 0: at the identity, and after
    # its last round
    dst, cst, _ = step_clock[0][2]
    last = step_clock[-2][2][2].tolist()  # the last round's minibatch 0
    from sagecal_tpu_torch.core.types import identity_jones, jones_to_params
    from sagecal_tpu_torch.solvers.sage import lane_of

    from sagecal_tpu_torch.utils.precision import full_f32

    eye = jones_to_params(identity_jones(NSTATIONS, torch.complex64))
    p_id = eye.expand(NCLUSTERS, 1, 8 * NSTATIONS).reshape(-1)
    with torch.no_grad(), full_f32():
        first = [float(_data_cost(p_id, lane_of(dst, b), lane_of(cst, b),
                                  (NCLUSTERS, 1, 8 * NSTATIONS), None))
                 for b in range(DIST_BANDS)]
    del step_clock
    shapes = []
    for b in range(DIST_BANDS):
        _, jsol = solio.read_solutions(f"{sol}.band{b}")
        shapes.append(tuple(jsol.shape))
    dres = [r["dual_res"] for r in rounds]
    print(f"[federated] run {wall:.1f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB; seconds per round "
          f"{[round(x, 3) for x in round_s]}, per minibatch round "
          f"{[round(x, 3) for x in step_s]}, per average "
          f"{[round(x, 4) for x in avg_s]}", flush=True)
    print(f"[federated] dual residual per round {dres}; resets "
          f"{len(resets)}; data cost on minibatch 0 at the identity -> "
          f"last round {[(round(a, 3), round(b, 3)) for a, b in zip(first, last)]}; "
          f"launches {launches}; solution files {shapes}", flush=True)
    if any(launches.values()):
        fail(f"federated: kernels launched: {launches}")
    if len(rounds) != 2 or not all(d is not None and np.isfinite(d)
                                   for d in dres):
        fail(f"federated: fed_round events {rounds}")
    if resets:
        fail(f"federated: bands reset: {resets}")
    if not all(np.isfinite(b) and b < a for a, b in zip(first, last)):
        fail(f"federated: a band's data cost did not fall: {first} {last}")
    if shapes != [(1, NCLUSTERS, NSTATIONS, 2, 2)] * DIST_BANDS:
        fail(f"federated: solution files {shapes}")
    out = {"wall_s": wall, "peak_bytes": peak, "round_s": round_s,
           "minibatch_s": step_s, "avg_s": avg_s, "dual_res": dres,
           "cost_identity": first, "cost_last": last, "launches": launches}
    out["seconds"] = sync_clock() - t_start
    print(f"[federated] phase wall time {out['seconds']:.1f} s", flush=True)
    return out


def phase_spatial_app(dirname: str, pattern: str, sky: str, clus: str):
    """The ``spatial`` app through the CLI (module doc, after phase 17)."""
    from sagecal_tpu_torch.apps.cli import main as cli_main
    from sagecal_tpu_torch.io.memh5 import MemFile

    t_start = sync_clock()
    prefix = os.path.join(dirname, "spapp")
    elog = os.path.join(dirname, "spapp_events.jsonl")
    argv = ["spatial", "-f", pattern, "-s", sky, "-c", clus, "-o", prefix,
            *SPAPP_FLAGS]
    for k in KERNELS + tuple(PROBES):
        _launchers()[k].launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = sync_clock()
    rc = _with_env({"SAGECAL_TELEMETRY": "1", "SAGECAL_EVENT_LOG": elog},
                   lambda: cli_main(argv, open_file=MemFile))
    wall = sync_clock() - t
    launches = {k: c.launches for k, c in _launchers().items()}
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        fail(f"spatial app: the CLI exited {rc}")
    band_s = [e["seconds"] for e in _events(elog, "band_solved")]
    fista = _events(elog, "spatial_fista")
    summary = json.load(open(prefix + ".json"))
    npz = np.load(prefix + ".npz")
    print(f"[spatial app] run {wall:.1f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB; seconds per band solve "
          f"{[round(x, 2) for x in band_s]}, FISTA "
          f"{fista[0]['seconds'] if fista else None} s; k_aic "
          f"{summary['k_aic']} k_mdl {summary['k_mdl']}, fit_rel "
          f"{summary['fista_fit_rel']:.4e}, nnz {summary['fista_nnz']}; "
          f"npz {sorted(npz.files)}; launches {launches}", flush=True)
    if not (1 <= summary["k_aic"] <= 2 and 1 <= summary["k_mdl"] <= 2):
        fail(f"spatial app: orders {summary['k_aic']} {summary['k_mdl']}")
    if not np.isfinite(summary["fista_fit_rel"]):
        fail(f"spatial app: fit_rel {summary['fista_fit_rel']}")
    if len(band_s) != DIST_BANDS or set(npz.files) != {
            "J", "Z", "Zs", "Z_spatial", "aic", "mdl", "freqs"}:
        fail(f"spatial app: {len(band_s)} band solves, npz {npz.files}")
    out = {"wall_s": wall, "peak_bytes": peak, "band_s": band_s,
           "fista_s": fista[0]["seconds"] if fista else None,
           "summary": summary, "launches": launches}
    out["seconds"] = sync_clock() - t_start
    print(f"[spatial app] phase wall time {out['seconds']:.1f} s", flush=True)
    return out


# the rows-sharded joint fit: the main tile's torch-op joint cost at f32,
# unsharded and in SHARD_N row blocks, SHARD_ITMAX LBFGS iterations each
SHARD_N, SHARD_ITMAX = 4, 10
SHARD_COST_TOL, SHARD_P_TOL = 1e-5, 1e-4
# --multihost: phase 14's bands and flags as MH_RANKS ranks on the one
# card (gloo with CUDA tensors; NCCL takes one rank a GPU), then one nccl
# rank on MH_NCCL_BANDS of the bands
MH_RANKS, MH_NCCL_BANDS, MH_TIMEOUT = 2, 2, 420
# the widefield app: the documented run (USER_MANUAL.md, "widefield -S
# 10000 --nblobs 40 -k 8 -n 40 --extent-m 60 --freq0 30e6") at f64, two
# tiles, -e 1 -g 2; tile 0's coherencies on the card against the CPU's
WF_FLAGS = ("-S", "10000", "--nblobs", "40", "-k", "8", "-n", "40",
            "--extent-m", "60", "--freq0", "30e6", "--ntiles", "2", "-e",
            "1", "-g", "2")
WF_CPU_TOL = 1e-10
# sky-model refinement in dataset mode: a MemFile tile at the north-star
# width (62 stations, 100 clusters, NCHAN channels) at f64, REFINE_NTIME
# timeslots (the depth; cut to keep the phase near a minute and a half),
# observed through gains REFINE_GAIN_AMP from the identity; the catalog's
# first flux (in a cluster of two sources) off by REFINE_PERTURB and
# free, two outer iterations at --ridge REFINE_RIDGE and
# --adjoint-cg-iters REFINE_ADJOINT.  Then the app's first gradient (its
# budgets, from its own start: the catalog flux, identity gains) against
# a central difference of the outer cost with the same budgets (the JAX
# package's 1e-3 pin).  The implicit gradient is exact only at the inner
# fixed point with the adjoint solved: at the default --ridge 1e-2 the
# app's 12 Gauss-Newton steps of 32 CG products do not reach the fixed
# point at this width and the adjoint CG does not converge; at
# REFINE_RIDGE the inner solve does, and the adjoint needs more than the
# default 64 products (its residual 3e-2 there).  The phase shows
# both: the inner gradient's ratio after the app's inner budget at each
# of REFINE_RIDGES, the adjoint's residual and gradient at 64 products,
# the implicit gradient against its difference at the default ridge
# (printed), and there the unrolled route, exact for what the solver
# ran, against its own difference (checked; at REFINE_WITNESS
# Gauss-Newton steps and CG products, since its graph grows with the
# products: ~0.3 GiB each at this width)
REFINE_NTIME, REFINE_EPS, REFINE_FD_TOL = 4, 1e-2, 1e-3
REFINE_GAIN_AMP, REFINE_PERTURB = 0.05, 1.15
REFINE_RIDGE, REFINE_ADJOINT = 100.0, 256
REFINE_RIDGES = (1e-2, 10.0, 100.0)
REFINE_FLAGS = ("--free-flux", "0:0", "--outer-iters", "1", "--ridge",
                str(REFINE_RIDGE), "--adjoint-cg-iters", str(REFINE_ADJOINT))
REFINE_WITNESS = (4, 8)


def phase_sharded(data, cdata, p0):
    """The rows-sharded joint fit on the main tile (module doc)."""
    from sagecal_tpu_torch.solvers import pad_rows_to, sharded_joint_fit

    data, cdata = pad_rows_to(data, cdata, SHARD_N)
    runs = {}
    base = torch.cuda.memory_allocated()
    for k in (1, SHARD_N):
        torch.cuda.reset_peak_memory_stats()
        t = sync_clock()
        p, cost, it = sharded_joint_fit(data, cdata, p0, k, itmax=SHARD_ITMAX)
        sec = sync_clock() - t
        peak = torch.cuda.max_memory_allocated()
        runs[k] = dict(p=p, cost=float(cost), iterations=int(it), seconds=sec,
                       peak_bytes=peak, transient_bytes=peak - base)
        print(f"[sharded] nshards {k}: cost {float(cost):.8e} after {it} "
              f"LBFGS iterations, {sec:.2f} s, peak device memory "
              f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB "
              f"above the tile)", flush=True)
    a, b = runs[1], runs[SHARD_N]
    cost_rel = abs(b["cost"] - a["cost"]) / abs(a["cost"])
    p_rel = float((b["p"] - a["p"]).norm() / a["p"].norm())
    print(f"[sharded] cost rel diff {cost_rel:.3e} (tol {SHARD_COST_TOL}), "
          f"p rel diff {p_rel:.3e} of its norm (tol {SHARD_P_TOL}); "
          f"transient memory ratio "
          f"{b['transient_bytes'] / max(a['transient_bytes'], 1):.3f}",
          flush=True)
    if not (cost_rel <= SHARD_COST_TOL and p_rel <= SHARD_P_TOL):
        fail(f"sharded: nshards {SHARD_N} parts from the unsharded fit "
             f"(cost {cost_rel:.3e}, p {p_rel:.3e})")
    if not (np.isfinite(a["cost"]) and a["iterations"] > 0):
        fail(f"sharded: the unsharded fit did not run: {a}")
    return {k: {kk: v for kk, v in r.items() if kk != "p"}
            for k, r in runs.items()} | {"cost_rel": cost_rel, "p_rel": p_rel}


def multihost_rank(dirname: str, argv_json: str) -> None:
    """One rank of phase ``multihost``: phase 14's bands rebuilt in this
    process's ``MemFile`` registry under ``dirname``, then the CLI with
    ``argv`` (the rank environment set by the parent); prints one JSON
    line with its seconds and #1 launches."""
    from sagecal_tpu_torch.apps.cli import main as cli_main
    from sagecal_tpu_torch.io.memh5 import MemFile

    t = sync_clock()
    pattern, sky, clus = dist_datasets(dirname)
    make_s = sync_clock() - t
    some = pattern.replace("*", "[" + "".join(
        str(b) for b in range(MH_NCCL_BANDS)) + "]")
    argv = [a.format(pattern=pattern, some=some, sky=sky, clus=clus)
            for a in json.loads(argv_json)]
    _reset_launches()
    t = sync_clock()
    rc = cli_main(argv, open_file=MemFile)
    wall = sync_clock() - t
    print("[rank] " + json.dumps({
        "rank": int(os.environ["RANK"]), "rc": rc, "dataset_s": make_s,
        "wall_s": wall, "launches": _read_launches()}), flush=True)


def _spawn_ranks(dirname: str, argv: list, env: dict, nranks: int):
    """Run ``nranks`` processes of :func:`multihost_rank` with ``env``
    and the rank variables; returns their parsed rank lines.  Every
    process is waited for, and killed at the time limit."""
    import socket

    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for r in range(nranks):
        rdir = os.path.join(dirname, f"rank{r}")
        os.makedirs(rdir, exist_ok=True)
        code = "import sys, chip_smoke; chip_smoke.multihost_rank(*sys.argv[1:])"
        penv = dict(os.environ, **env, RANK=str(r), WORLD_SIZE=str(nranks),
                    LOCAL_RANK="0", MASTER_ADDR="localhost",
                    MASTER_PORT=str(port),
                    PYTHONPATH=here + os.pathsep + os.environ.get(
                        "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, rdir, json.dumps(argv)], env=penv, cwd=here, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs, lines = [], []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=MH_TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        got = [json.loads(line[7:]) for line in out.splitlines()
               if line.startswith("[rank] ")]
        if p.returncode != 0 or not got or got[0]["rc"] != 0:
            print(out[-4000:], flush=True)
            fail(f"multihost: rank {r} exited {p.returncode}")
        lines.append(got[0])
    return lines


def phase_multihost(dirname: str):
    """``-f ... --multihost`` over ranks on the one card (module doc)."""
    sol = os.path.join(dirname, "mh.z")
    elog = os.path.join(dirname, "mh_events.jsonl")
    base = ["-s", "{sky}", "-c", "{clus}", "-f", "{pattern}", *DIST_FLAGS]
    env = {"SAGECAL_TELEMETRY": "1", "SAGECAL_EVENT_LOG": elog,
           "SAGECAL_DIST_BACKEND": "gloo"}
    t = sync_clock()
    ranks = _spawn_ranks(dirname, base + ["-p", sol, "--multihost"], env,
                         MH_RANKS)
    wall = sync_clock() - t
    for r in ranks:
        print(f"[multihost] gloo rank {r['rank']}: datasets "
              f"{r['dataset_s']:.1f} s, run {r['wall_s']:.1f} s, #1 "
              f"launches {r['launches']['fused_predict_fwd']}", flush=True)
    # the one-process run of phase 14: dist.z and its band files
    ref = os.path.join(dirname, "dist.z")
    same = {}
    for suffix in [""] + [f".band{b}" for b in range(DIST_BANDS)]:
        with open(ref + suffix, "rb") as fa, open(sol + suffix, "rb") as fb:
            same[suffix or "Z"] = fa.read() == fb.read()
    print(f"[multihost] {MH_RANKS} gloo ranks with CUDA tensors, "
          f"{DIST_BANDS} shards: {wall:.1f} s with process start; files "
          f"bit-identical to phase 14's one-process run: {same}", flush=True)
    if not all(same.values()):
        fail(f"multihost: files differ from the one-process run: {same}")
    per_rank = [r["launches"]["fused_predict_fwd"] for r in ranks]
    if per_rank != [DIST_BANDS // MH_RANKS] * MH_RANKS:
        fail(f"multihost: #1 launches per rank {per_rank}")
    # one nccl rank (the production backend) on two of the bands
    nsol = os.path.join(dirname, "nccl.z")
    nargv = ["-s", "{sky}", "-c", "{clus}", "-f", "{some}", *DIST_FLAGS,
             "-p", nsol, "--multihost"]
    t = sync_clock()
    (nccl,) = _spawn_ranks(os.path.join(dirname, "nccl"), nargv,
                           {"SAGECAL_DIST_BACKEND": "nccl"}, 1)
    nwall = sync_clock() - t
    zrows = sum(1 for line in open(nsol) if not line.startswith("#")) - 1
    print(f"[multihost] one nccl rank on {MH_NCCL_BANDS} bands: run "
          f"{nccl['wall_s']:.1f} s ({nwall:.1f} s with process start), #1 "
          f"launches {nccl['launches']['fused_predict_fwd']}, Z file "
          f"{zrows} rows", flush=True)
    if nccl["launches"]["fused_predict_fwd"] != MH_NCCL_BANDS:
        fail(f"multihost: the nccl rank launched #1 "
             f"{nccl['launches']['fused_predict_fwd']} times")
    if zrows != 2 * 8 * NSTATIONS:
        fail(f"multihost: the nccl run's Z file holds {zrows} rows")
    return {"gloo_ranks": ranks, "gloo_wall_s": wall, "same": same,
            "nccl": nccl, "nccl_wall_s": nwall,
            "launches_per_rank": per_rank}


def phase_widefield(dirname: str):
    """The widefield app and its hierarchical predict (module doc)."""
    from sagecal_tpu_torch.apps import widefield as wf
    from sagecal_tpu_torch.apps.cli import main as cli_main
    from sagecal_tpu_torch.data.simsky import make_sky
    from sagecal_tpu_torch.sky.farfield import apriori_rel_bound
    from sagecal_tpu_torch.sky import predict as hier_predict
    from sagecal_tpu_torch.sky.predict import gather_sources
    from sagecal_tpu_torch.sky.tree import build_source_tree, partition_by_tree

    out_dir = os.path.join(dirname, "wf")
    torch.cuda.reset_peak_memory_stats()
    t = sync_clock()
    rc = cli_main(["widefield", *WF_FLAGS, "--out-dir", out_dir])
    wall = sync_clock() - t
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        fail(f"widefield: the CLI exited {rc}")
    with open(os.path.join(out_dir, "widefield.json")) as fh:
        summary = json.load(fh)
    bound = apriori_rel_bound(8, 1.5)
    for i, tile in enumerate(summary["tiles"]):
        print(f"[widefield] tile {i}: res {tile['res_0']:.6e} -> "
              f"{tile['res_1']:.6e}, sampled rel_err {tile['rel_err']:.3e} "
              f"(a-priori bound {bound:.3e}), plan {tile['plan_s']:.3f} s, "
              f"hierarchical predict {tile['predict_s']:.3f} s, check "
              f"{tile['check_s']:.3f} s, solve {tile['solve_s']:.2f} s",
              flush=True)
    if not all(t_["rel_err"] is not None and t_["rel_err"] < bound
               for t_ in summary["tiles"]):
        fail(f"widefield: a sampled error is not under {bound:.3e}")
    if not summary["hier_watchdog_ok"]:
        fail("widefield: the hier predict watchdog degraded")
    # tile 0's coherencies, on the card and on the CPU, and the exact
    # predict's time per tile on the card
    cfg = wf.config_from_args(wf.build_parser().parse_args(
        [*WF_FLAGS, "--out-dir", out_dir]))
    cohs, exact_s, hier_s = {}, [], []
    parts = {k: [] for k in ("node_moments", "far_field_tiles",
                             "near_field_tiles")}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = sync_clock()
            out = fn(*a, **kw)
            parts[name][-1] += sync_clock() - t0
            return out
        return run

    for dev in (None, "cpu"):  # None: the card
        sky = make_sky(nstations=cfg.nstations, tilesz=cfg.ntiles * cfg.tilesz,
                       nchan=cfg.nchan, nclusters=cfg.nblobs, freq0=cfg.freq0,
                       gain_amp=cfg.gain_amp, noise_sigma=cfg.noise_sigma,
                       seed=cfg.seed, dtype=np.float64, wide_field=True,
                       nsources=cfg.nsources, fov=cfg.fov,
                       cluster_scale=cfg.cluster_scale,
                       extent_m=cfg.extent_m, device=dev)
        merged = wf._merge_sources(sky.clusters)
        tree = build_source_tree(merged.ll.cpu().numpy(),
                                 merged.mm.cpu().numpy(),
                                 merged.nn.cpu().numpy(),
                                 leaf_size=cfg.leaf_size)
        eff = [gather_sources(merged, g)
               for g in partition_by_tree(tree, cfg.nclusters)]
        tiles = range(cfg.ntiles) if dev is None else (0,)
        for ti in tiles:
            data_t = wf._slice_tile(sky.data, ti, cfg.tilesz)
            timing = {}
            if dev is None:
                # the hierarchical predict's parts, each ended by a sync
                saved = {k: getattr(hier_predict, k) for k in parts}
                for k in parts:
                    parts[k].append(0.0)
                    setattr(hier_predict, k, timed(k, saved[k]))
            try:
                coh = wf._tile_coherencies(cfg, data_t, eff, timing)
            finally:
                if dev is None:
                    for k in parts:
                        setattr(hier_predict, k, saved[k])
            if ti == 0:
                cohs[dev or "cuda"] = coh.cpu()
            if dev is None:
                hier_s.append(timing["plan_s"] + timing["predict_s"])
                timing = {}
                ex_cfg = wf.WidefieldConfig(**{**cfg.__dict__, "exact": True})
                wf._tile_coherencies(ex_cfg, data_t, eff, timing)
                exact_s.append(timing["predict_s"])
    err = float((cohs["cuda"] - cohs["cpu"]).abs().max()
                / cohs["cpu"].abs().max())
    rows = cohs["cpu"].shape[-1]
    print(f"[widefield] {cfg.nsources} sources -> {summary['nclusters_eff']} "
          f"clusters {summary['cluster_sizes']}, {rows} rows a tile; tile "
          f"0 coherencies card vs CPU {err:.3e} of the max abs (tol "
          f"{WF_CPU_TOL}); per tile on the card: hierarchical (plan + "
          f"predict) {[round(x, 3) for x in hier_s]} s ("
          + ", ".join(f"{k} {[round(x, 4) for x in v]}"
                      for k, v in parts.items())
          + f" s), exact {[round(x, 3) for x in exact_s]} s; app run "
          f"{wall:.1f} s, peak device memory {peak / 2**30:.3f} GiB",
          flush=True)
    if not err <= WF_CPU_TOL:
        fail(f"widefield: the card's coherencies part from the CPU's by "
             f"{err:.3e}")
    return {"summary": summary, "wall_s": wall, "peak_bytes": peak,
            "card_vs_cpu": err, "hier_s": hier_s, "exact_s": exact_s,
            "hier_parts_s": parts}


def refine_sky(dirname: str):
    """``write_sky``'s 100 point clusters with a second source in
    cluster 0 (P0's position moved by 0.3 degrees in declination, flux
    3): a lone source's flux is absorbed by its cluster's gains, a
    cluster of two keeps the flux ratio.  Returns (true sky file,
    cluster file, catalog file with P0's flux off by REFINE_PERTURB,
    P0's true flux)."""
    true_sky, clus = write_sky(dirname, nclusters=NCLUSTERS, name="refine")
    with open(true_sky) as fh:
        lines = fh.readlines()
    p0 = next(line.split() for line in lines if line.startswith("P0 "))
    dm = int(p0[5]) + 18  # 0.3 degrees in arcminutes (P0 sits above 0.9 rad)
    extra = p0[:5] + [str(dm % 60), p0[6], "3.0"] + p0[8:]
    extra[0], extra[4] = "Q0", str(int(p0[4]) + dm // 60)
    with open(true_sky, "a") as fh:
        fh.write(" ".join(extra) + "\n")
    with open(clus) as fh:
        clines = fh.readlines()
    clines[0] = clines[0].rstrip("\n") + " Q0\n"
    with open(clus, "w") as fh:
        fh.writelines(clines)
    true_flux = float(p0[7])
    sky = os.path.join(dirname, "refine_catalog.txt")
    with open(true_sky) as fin, open(sky, "w") as fout:
        for line in fin:
            f = line.split()
            if f and f[0] == "P0":
                f[7] = f"{true_flux * REFINE_PERTURB:.6f}"
                line = " ".join(f) + "\n"
            fout.write(line)
    return true_sky, clus, sky, true_flux


def refine_fd(problem, theta, p0, gradient="implicit", **budget) -> dict:
    """The outer gradient in P0's flux of ``gradient``'s route at
    ``budget`` against a central difference of the outer cost with the
    same inner budget."""
    from sagecal_tpu_torch.refine import make_outer_value_and_grad

    _, vg, cost = make_outer_value_and_grad(problem, gradient=gradient,
                                            **budget)
    _, g = vg(theta, p0)
    e = torch.zeros_like(theta)
    e[0] = REFINE_EPS
    fd = (float(cost(theta + e, p0)) - float(cost(theta - e, p0))) / (
        2 * REFINE_EPS)
    return {"grad": float(g[0]), "fd": fd,
            "rel": abs(float(g[0]) - fd) / abs(fd)}


def refine_product_ms(problem, theta, p, reps: int = 10) -> dict:
    """Milliseconds of one Gauss-Newton product (``"jtj"``, the inner
    CG's) and one exact Hessian-vector product (``"hvp"``, the
    adjoint's) at ``p``, each the mean of ``reps`` after a warm-up."""
    from sagecal_tpu_torch.refine.implicit import _hessian_matvec
    from sagecal_tpu_torch.refine.objective import cluster_data_from_theta

    cdata = cluster_data_from_theta(problem, theta)
    v = torch.randn(p.shape, dtype=p.dtype, device=p.device,
                    generator=torch.Generator(p.device).manual_seed(0))
    out = {}
    for kind in ("jtj", "hvp"):
        _hessian_matvec(problem, p, theta, v, kind, cdata=cdata)
        t = sync_clock()
        for _ in range(reps):
            _hessian_matvec(problem, p, theta, v, kind, cdata=cdata)
        out[kind] = (sync_clock() - t) / reps * 1e3
    return out


def refine_adjoint(problem, theta, pstar, iters: int) -> dict:
    """The implicit route's gradient in P0's flux at the inner solution
    ``pstar`` with ``iters`` adjoint CG products (the exact Hessian, as
    ``refine/implicit.py``'s backward), and the adjoint's relative
    residual ``|H v - pbar| / |pbar|``."""
    from sagecal_tpu_torch.refine.implicit import (
        _hessian_matvec, _inner_grad, cg_solve,
    )
    from sagecal_tpu_torch.refine.objective import (
        cluster_data_from_theta, outer_cost,
    )

    cdata = cluster_data_from_theta(problem, theta)
    with torch.enable_grad():
        pp = pstar.detach().requires_grad_(True)
        (pbar,) = torch.autograd.grad(outer_cost(problem, pp, theta, cdata),
                                      pp)
        th = theta.detach().requires_grad_(True)
        (direct,) = torch.autograd.grad(outer_cost(problem, pstar, th), th)

    def hv(u):
        return _hessian_matvec(problem, pstar, theta, u, "hvp", cdata=cdata)

    v = cg_solve(hv, pbar, iters)
    resid = float((pbar - hv(v)).norm() / pbar.norm())
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        g = _inner_grad(problem, pstar, th, create_graph=True)
        (mixed,) = torch.autograd.grad(torch.dot(g, v), th)
    return {"grad": float(direct[0] - mixed[0]), "resid": resid}


def refine_ridge_witness(problem, theta, p0, app_budget: dict,
                         check: dict) -> dict:
    """Why the app runs at REFINE_RIDGE and REFINE_ADJOINT (module doc):
    after the app's inner budget at each ridge, the inner gradient's
    ratio to its start and the implicit gradient with the default 64
    adjoint products (its residual); at the default ridge that gradient
    against its difference (printed) and the unrolled route against its
    own (checked).  ``check``: the app's gradient check at REFINE_RIDGE,
    whose difference the 64-product gradient there is read against."""
    import dataclasses

    from sagecal_tpu_torch.refine.implicit import (
        _inner_grad, gauss_newton_solve,
    )

    t0 = sync_clock()
    out = {"inner_ratio": {}, "adjoint64": {}}
    for ridge in REFINE_RIDGES:
        prob = dataclasses.replace(problem, ridge=ridge)
        ps = gauss_newton_solve(prob, theta, p0, iters=app_budget["iters"],
                                cg_iters=app_budget["cg_iters"],
                                damping=app_budget["damping"])
        out["inner_ratio"][ridge] = float(
            _inner_grad(prob, ps, theta).norm()
            / _inner_grad(prob, p0, theta).norm())
        if ridge in (REFINE_RIDGES[0], REFINE_RIDGE):
            out["adjoint64"][ridge] = refine_adjoint(prob, theta, ps, 64)
    default = dataclasses.replace(problem, ridge=REFINE_RIDGES[0])
    budget = dict(app_budget, adjoint_cg_iters=64)
    out["implicit"] = refine_fd(default, theta, p0, **budget)
    iters, cg = REFINE_WITNESS
    torch.cuda.reset_peak_memory_stats()
    out["unrolled"] = refine_fd(default, theta, p0, gradient="unrolled",
                                iters=iters, cg_iters=cg,
                                damping=app_budget["damping"])
    out["unrolled"]["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = sync_clock() - t0
    imp, unr = out["implicit"], out["unrolled"]
    a_hi = out["adjoint64"][REFINE_RIDGE]
    a_lo = out["adjoint64"][REFINE_RIDGES[0]]
    print(f"[refine] after the app's inner budget, the inner gradient's "
          f"ratio to its start: "
          + ", ".join(f"--ridge {k:g} {v:.3e}"
                      for k, v in out["inner_ratio"].items())
          + f"; with 64 adjoint products at --ridge {REFINE_RIDGE:g}: "
          f"residual {a_hi['resid']:.3e}, gradient {a_hi['grad']:.8e}, rel "
          f"{abs(a_hi['grad'] - check['fd']) / abs(check['fd']):.3e} to "
          f"the check's difference; at --ridge {REFINE_RIDGES[0]:g}: "
          f"residual {a_lo['resid']:.3e}, the implicit gradient "
          f"{imp['grad']:.8e} vs central difference {imp['fd']:.8e}, rel "
          f"{imp['rel']:.3e} (not checked), the unrolled route ({iters} x "
          f"{cg}) {unr['grad']:.8e} vs {unr['fd']:.8e}, rel "
          f"{unr['rel']:.3e} (tol {REFINE_FD_TOL}), peak "
          f"{unr['peak_bytes'] / 2**30:.2f} GiB; {out['seconds']:.1f} s",
          flush=True)
    if not unr["rel"] <= REFINE_FD_TOL:
        fail(f"refine: at --ridge {REFINE_RIDGES[0]:g} the unrolled gradient "
             f"parts from its finite difference by {unr['rel']:.3e}")
    return out


def phase_refine(dirname: str):
    """Sky-model refinement in dataset mode (module doc)."""
    from sagecal_tpu_torch.apps import refine as rf
    from sagecal_tpu_torch.apps.cli import main as cli_main
    from sagecal_tpu_torch.device import resolve_device
    from sagecal_tpu_torch.io.memh5 import MemFile, remove
    from sagecal_tpu_torch.refine import SkySpec
    from sagecal_tpu_torch.refine.implicit import MATVEC_COUNTS

    from sagecal_tpu_torch.io.dataset import simulate_dataset
    from sagecal_tpu_torch.io.simulate import random_jones
    from sagecal_tpu_torch.io.skymodel import load_sky

    t0 = sync_clock()
    true_sky, clus, sky, true_flux = refine_sky(dirname)
    clusters, _, _ = load_sky(true_sky, clus, RA0, DEC0, dtype=torch.float64)
    path = os.path.join(dirname, "refine.h5")
    simulate_dataset(path, nstations=NSTATIONS, ntime=REFINE_NTIME,
                     nchan=NCHAN, clusters=clusters,
                     jones=random_jones(NCLUSTERS, NSTATIONS, seed=3,
                                        amp=REFINE_GAIN_AMP,
                                        dtype=np.complex128),
                     noise_sigma=1e-3, seed=0, dec0=DEC0, open_file=MemFile)
    MemFile(path, "r+").attrs["ra0"] = RA0
    prefix = os.path.join(dirname, "rf")
    argv = ["refine", "-d", path, "-s", sky, "-c", clus, "-t",
            str(REFINE_NTIME), *REFINE_FLAGS, "-o", prefix]
    for k in MATVEC_COUNTS:
        MATVEC_COUNTS[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t = sync_clock()
    rc = cli_main(argv, open_file=MemFile)
    wall = sync_clock() - t
    peak = torch.cuda.max_memory_allocated()
    counts = dict(MATVEC_COUNTS)
    if rc != 0:
        fail(f"refine: the CLI exited {rc}")
    trace = [json.loads(line) for line in open(prefix + ".trace.jsonl")]
    for e in trace:
        print(f"[refine] outer {e['iter']}: cost {e['cost']:.8e}, gradnorm "
              f"{e['gradnorm']:.4e}, flux {e['theta'][0]:.6f} (true "
              f"{true_flux:.6f}, catalog {true_flux * REFINE_PERTURB:.6f}), "
              f"{e['seconds']:.2f} s", flush=True)
    # the app's first gradient: its budgets, its start (the catalog
    # flux, identity gains)
    args = rf.build_parser().parse_args(argv[1:])
    cfg = rf.config_from_args(args)
    problem, _ = rf._build_problem(cfg, SkySpec(flux=[(0, 0)]), print,
                                   resolve_device(), MemFile)
    app_budget = dict(iters=cfg.inner_iters, cg_iters=cfg.cg_iters,
                      damping=cfg.damping,
                      adjoint_cg_iters=cfg.adjoint_cg_iters,
                      adjoint_matvec=cfg.adjoint_matvec)
    th = problem.spec.theta0(problem.clusters, problem.tables).to(
        problem.data.device)
    p0 = problem.identity_gains()
    t = sync_clock()
    check = refine_fd(problem, th, p0, **app_budget)
    check["seconds"] = sync_clock() - t
    print(f"[refine] {NSTATIONS} stations, {NCLUSTERS} clusters, "
          f"{REFINE_NTIME} timeslots x {NCHAN} channels at f64: run "
          f"{wall:.1f} s, Gauss-Newton matvecs {counts['inner']}, adjoint "
          f"Hessian-vector products {counts['adjoint']}, peak device "
          f"memory {peak / 2**30:.3f} GiB; the app's first gradient "
          f"(--ridge {cfg.ridge:g}, {cfg.inner_iters} x {cfg.cg_iters} "
          f"inner, {cfg.adjoint_cg_iters} adjoint) {check['grad']:.8e} vs "
          f"central difference {check['fd']:.8e}: rel {check['rel']:.3e} "
          f"(tol {REFINE_FD_TOL}; {check['seconds']:.1f} s)", flush=True)
    if not check["rel"] <= REFINE_FD_TOL:
        fail(f"refine: the app's gradient parts from its finite difference "
             f"by {check['rel']:.3e}")
    product_ms = refine_product_ms(problem, th, p0)
    print(f"[refine] one product at this width: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in product_ms.items()),
          flush=True)
    witness = refine_ridge_witness(problem, th, p0, app_budget, check)
    remove(path)
    outer = int(REFINE_FLAGS[REFINE_FLAGS.index("--outer-iters") + 1])
    if not (len(trace) == outer
            and all(np.isfinite(x["cost"]) for x in trace)):
        fail(f"refine: the trace is {trace}")
    flux_err = [abs(x["theta"][0] - true_flux) / true_flux for x in trace]
    if not flux_err[-1] < REFINE_PERTURB - 1.0:
        fail(f"refine: the flux did not move toward the truth: {flux_err}")
    out = {"wall_s": wall, "iter_s": [x["seconds"] for x in trace],
           "matvecs": counts, "peak_bytes": peak, "check": check,
           "witness": witness, "product_ms": product_ms,
           "flux_err": flux_err,
           "cost": [x["cost"] for x in trace]}
    out["seconds"] = sync_clock() - t0
    print(f"[refine] phase wall time {out['seconds']:.1f} s", flush=True)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # 1: cut from 2 when the consensus phases (14, 15) joined, to keep
    # the script near 450 s on an "NVIDIA H100 80GB HBM3, 700.00 W" (the
    # main, warm, extended and telemetry solves run at this depth)
    ap.add_argument("--max-emiter", type=int, default=1)
    # 1: cut from 6 to 4 when the fullbatch phase joined, to 3 when the
    # beam phase did, to 2 when the spatial and federated phases did and
    # to 1 when the sharded, multihost, widefield and refine phases did,
    # to keep the script near 600 s on an "NVIDIA H100 80GB HBM3, 700.00
    # W" (the main, warm, extended and telemetry solves run at this
    # depth)
    ap.add_argument("--max-iter", type=int, default=1)
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
    shard_out = phase_sharded(data, cdata, p0)
    with tempfile.TemporaryDirectory() as d:
        warm_out = phase_warm(args, d)
    with tempfile.TemporaryDirectory() as d:
        ext_out = phase_extended(args, d)
    with tempfile.TemporaryDirectory() as d:
        fb_out, fb_ref = phase_fullbatch(args, d)
    with tempfile.TemporaryDirectory() as d:
        elastic_out = phase_elastic(d, fb_ref)
    del fb_ref
    with tempfile.TemporaryDirectory() as d:
        stream_out = phase_stream(d)
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
        fleet_out = phase_fleet(d, svc_out)
        load_out = phase_load(d)
        audit_out = phase_audit({"fleet": fleet_out["out_dir"],
                                 "load": load_out["out_dir"]})
    with tempfile.TemporaryDirectory() as d:
        dist_out = phase_distributed(d)
        mh_out = phase_multihost(d)
    with tempfile.TemporaryDirectory() as d:
        mb_out = phase_minibatch(d)
    with tempfile.TemporaryDirectory() as d:
        from sagecal_tpu_torch.io.memh5 import remove

        spat_out, (pattern, psky, pclus) = phase_spatial(d)
        fed_out = phase_federated(d, pattern, psky, pclus)
        spapp_out = phase_spatial_app(d, pattern, psky, pclus)
        for f in range(DIST_BANDS):
            remove(os.path.join(d, f"band{f}.h5"))
    with tempfile.TemporaryDirectory() as d:
        wf_out = phase_widefield(d)
    with tempfile.TemporaryDirectory() as d:
        rf_out = phase_refine(d)
    with tempfile.TemporaryDirectory() as d:
        tools_out = phase_tools(d)
    worst["fused_predict_fwd"] = max(worst["fused_predict_fwd"],
                                     spat_out["parity"]["model_max_abs_err"])
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
    print(f"[times] ({card}) spatial: run {spat_out['wall_s']:.1f} s, FISTA "
          f"{[round(x, 4) for x in spat_out['fista_s']]} s, re-predicts "
          f"{[round(x, 4) for x in spat_out['repredict_s']]} s, peak "
          f"{spat_out['peak_bytes'] / 2**30:.2f} GiB; federated: run "
          f"{fed_out['wall_s']:.1f} s, per round "
          f"{[round(x, 2) for x in fed_out['round_s']]} s, per minibatch "
          f"round {[round(x, 2) for x in fed_out['minibatch_s']]} s, per "
          f"average {[round(x, 4) for x in fed_out['avg_s']]} s, peak "
          f"{fed_out['peak_bytes'] / 2**30:.2f} GiB; spatial app: run "
          f"{spapp_out['wall_s']:.1f} s, per band "
          f"{[round(x, 2) for x in spapp_out['band_s']]} s, FISTA "
          f"{spapp_out['fista_s']} s", flush=True)
    print(f"[times] ({card}) sharded fit: unsharded "
          f"{shard_out[1]['seconds']:.2f} s peak "
          f"{shard_out[1]['peak_bytes'] / 2**30:.3f} GiB, {SHARD_N} blocks "
          f"{shard_out[SHARD_N]['seconds']:.2f} s peak "
          f"{shard_out[SHARD_N]['peak_bytes'] / 2**30:.3f} GiB; multihost: "
          f"{MH_RANKS} gloo ranks "
          f"{[round(r['wall_s'], 1) for r in mh_out['gloo_ranks']]} s, one "
          f"nccl rank {mh_out['nccl']['wall_s']:.1f} s; widefield: app "
          f"{wf_out['wall_s']:.1f} s, peak {wf_out['peak_bytes'] / 2**30:.3f}"
          f" GiB; refine: run {rf_out['wall_s']:.1f} s, per outer iteration "
          f"{[round(x, 2) for x in rf_out['iter_s']]} s, peak "
          f"{rf_out['peak_bytes'] / 2**30:.3f} GiB", flush=True)
    fs = fleet_out["summary"]
    print(f"[times] ({card}) elastic: checkpoint writes "
          + ", ".join(f"{w['seconds'] * 1e3:.1f} ms ({w['bytes']} B)"
                      for w in fb_out["checkpoints"])
          + f", phase 7 {fb_out['seconds']:.1f} s; killed run "
          f"{elastic_out['killed_s']:.1f} s, resumed run "
          f"{elastic_out['resume_wall_s']:.1f} s "
          f"({elastic_out['resume_s']:.1f} s with process start); large "
          f"placement {fb_out['large']['seconds']:.2f} s ({SHARD_N} row "
          f"blocks), unsharded {fb_out['large']['unsharded_s']:.2f} s; "
          f"fleet: {fleet_out['wall_s']:.1f} s, {fs['solves_per_sec']:.4f} "
          f"requests/s, p50 {fs['p50_latency_s']:.3f} s, p95 "
          f"{fs['p95_latency_s']:.3f} s", flush=True)
    ss = stream_out["summary"]
    print(f"[times] ({card}) stream: uninterrupted run "
          f"{stream_out['ref_s']:.1f} s, window latencies "
          f"{[round(x, 3) for x in ss['latencies_s']]} s (steady-state "
          f"{ss['latency_to_first_solution_s']:.3f} s), killed run "
          f"{stream_out['killed_s']:.1f} s, adopting run "
          f"{stream_out['adopt_s']:.1f} s with process start, phase "
          f"{stream_out['seconds']:.1f} s; load: {load_out['wall_s']:.1f} s, "
          f"{load_out['arrivals']} arrivals, "
          f"{load_out['requests_per_s']:.4f} requests/s, p50 "
          f"{load_out['p50_latency_s']:.3f} s, p95 "
          f"{load_out['p95_latency_s']:.3f} s; audit "
          f"{audit_out['seconds']:.2f} s (host); tools "
          f"{tools_out['seconds']:.2f} s (restore on the card "
          f"{tools_out['restore_s']:.3f} s)", flush=True)

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
            mb_out["launches"]["fused_predict_fwd"],
        "spatial (2 tiles, 4 bands)":
            spat_out["launches"]["fused_predict_fwd"],
        "multihost (1 tile, 4 bands, per gloo rank)":
            mh_out["launches_per_rank"],
        "multihost (1 tile, 2 bands, one nccl rank)":
            mh_out["nccl"]["launches"]["fused_predict_fwd"]}
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump({"card": card, "main": main_out, "warm": warm_out,
                       "extended": ext_out, "fullbatch": fb_out,
                       "beam": beam_out,
                       "predict": pred_out,
                       "bisect": bisect_out, "serve": serve_out,
                       "service": svc_out, "distributed": dist_out,
                       "minibatch": mb_out, "spatial": spat_out,
                       "federated": fed_out, "spatial_app": spapp_out,
                       "sharded": shard_out, "multihost": mh_out,
                       "widefield": wf_out, "refine": rf_out,
                       "elastic": elastic_out, "fleet": fleet_out,
                       "stream": stream_out, "load": load_out,
                       "audit": audit_out, "tools": tools_out,
                       "times": times, "kernels": kernels,
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
