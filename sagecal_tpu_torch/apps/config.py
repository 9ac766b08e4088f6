"""Run configuration of the fullbatch app (counterpart of
``sagecal_tpu/apps/config.py::RunConfig``): the same fields and defaults
as the reference, ``use_f64=True`` and ``use_fused_predict=False``
included.  Field names follow the reference's single-letter flags (see
``cli.py``).  Fields whose feature the port has not reached yet are
kept, and ``apps/fullbatch.py`` refuses them by name.  :class:`ServeConfig`
is the reference's too, for ``apps/serve.py``, :class:`SpatialConfig`
for ``apps/spatial.py``, :class:`WidefieldConfig` for
``apps/widefield.py``, :class:`RefineConfig` for ``apps/refine.py`` and
:class:`FleetConfig` for ``apps/fleet.py`` and ``apps/load.py``, and
:class:`StreamConfig` for ``apps/stream.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from sagecal_tpu_torch.solvers.sage import SM_OSLM_OSRLM_RLBFGS


@dataclasses.dataclass
class RunConfig:
    # data / sky
    dataset: str = ""  # -d
    sky_model: str = ""  # -s
    cluster_file: str = ""  # -F is format in ref; here explicit path
    out_solutions: str = "solutions.txt"  # -p
    init_solutions: Optional[str] = None  # -q warm start
    tilesz: int = 120  # -t
    # solver (defaults per user_manual.rst:32-58 / data.cpp)
    max_emiter: int = 3  # -e
    max_iter: int = 2  # -g
    max_lbfgs: int = 10  # -l
    lbfgs_m: int = 7  # -m
    solver_mode: int = SM_OSLM_OSRLM_RLBFGS  # -j
    nulow: float = 2.0
    nuhigh: float = 30.0
    randomize: bool = True  # -R
    min_uvcut: float = 0.0  # -x
    max_uvcut: float = 1e20  # -y
    whiten: bool = False  # -W
    # simulation (-a) / correction (-E)
    simulation_mode: int = 0  # 0 calibrate; 1/2/3 = SIMUL_ONLY/ADD/SUB
    ignore_clusters_file: Optional[str] = None  # -z
    ccid: Optional[int] = None  # -E cluster id to correct residuals by
    correction_rho: float = 1e-9
    phase_only_correction: bool = False
    # stochastic modes
    epochs: int = 0  # -N  (>0 selects minibatch mode)
    minibatches: int = 1  # -M
    in_column: str = "vis"  # -I input column (data.h DataField)
    out_column: str = "corrected"  # --out-column (ref -O OutField)
    sky_format: int = -1  # -F: -1 auto, 0 LSM, 1 three-term spectra
    bands: int = 1  # -w mini-bands
    admm_iters: int = 0  # -A (>0 with bands>1 selects consensus)
    npoly: int = 2  # -P
    poly_type: int = 2  # -Q (POLY_* in parallel.consensus)
    admm_rho: float = 5.0  # -r
    # consensus-layer scaling knobs (parallel/consensus.ConsensusConfig
    # on the mesh path; parallel/async_consensus on the host minibatch
    # loop — see USER_MANUAL "Scaling ADMM"):
    # zstep "reduced" = transpose-reduced Z-step (basis-sized Gram
    # collectives instead of full-solution psums, arXiv:1504.02147)
    consensus_zstep: str = "grouped"
    # >1 splits each x-step below band granularity into this many
    # cluster factor-node groups (arXiv:1603.02526)
    consensus_cluster_groups: int = 1
    # >0 allows bands to contribute Gram terms up to this many rounds
    # stale (rho-discounted by consensus_staleness_discount per round);
    # 0 = fully synchronous rounds
    consensus_staleness: int = 0
    consensus_staleness_discount: float = 1.0
    # beam (-B: 0 none, 1 array, 2 array+element, 3 element, 4/5/6 the
    # same per-channel/wideband — main.cpp DOBEAM_* codes)
    beam_mode: int = 0
    element_coeffs: Optional[str] = None  # element-coefficient table file
    # per-channel re-fit after the averaged solve (-b, doChan;
    # fullbatch_mode.cpp:453-499)
    per_channel: bool = False
    # joint-LBFGS cost through the fused-objective CUDA kernels (f32 only)
    use_fused_predict: bool = False
    # coherency-stack storage dtype on the fused path: "f32" (default)
    # or "bf16" (halved HBM stream, f32 accumulation — ~3 significant
    # digits of coherency precision; the quality watchdog validates the
    # solves it produces and its events carry the active coh_dtype)
    coh_dtype: str = "f32"
    # per-cluster ADMM rho / spatial alpha file (-G, read_arho_fromfile)
    rho_file: Optional[str] = None
    # partial reruns: skip first K tiles, process at most T tiles
    # (-K/-T, MPI/main.cpp:133-139)
    skip_tiles: int = 0
    max_tiles: int = 0  # 0 = no limit
    # divergence guard (fullbatch_mode.cpp:250,618-632)
    res_ratio: float = 5.0
    # quality watchdog escalation: report-only by default; True makes a
    # diverged solve (non-finite gains/chi^2, residual-ratio blowup,
    # ADMM consensus runaway) terminate the run with a structured
    # run_aborted event (obs/quality.py DivergenceAbort)
    abort_on_divergence: bool = False
    # influence-function diagnostics in place of residuals (-i,
    # diagnostics.c / fullbatch_mode.cpp:526-534)
    influence: bool = False
    # elastic execution (sagecal_tpu/elastic/): checkpoint_every > 0
    # writes an atomic solver-state checkpoint every that many tile
    # boundaries; resume restarts from the newest valid checkpoint
    # (deriving the effective skip count, truncating any torn trailing
    # solution interval, warm-starting the gains).  checkpoint_dir
    # defaults to "<out_solutions>.ckpt".
    resume: bool = False
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    # precision
    use_f64: bool = True
    verbose: bool = False  # -V


@dataclasses.dataclass
class SpatialConfig:
    """The ``spatial`` app: per-band calibration solves -> consensus
    polynomial -> FISTA elastic-net fit of Z onto the spatial basis
    (``parallel/spatial.py``) and the AIC/MDL consensus-order scan."""

    band_pattern: str = ""  # glob of per-band vis.h5; empty = synthetic
    sky_model: str = ""
    cluster_file: str = ""
    out_prefix: str = "spatial-out"  # <prefix>.json / .npz
    tilesz: int = 2
    # per-band solver (RunConfig semantics)
    max_emiter: int = 3
    max_iter: int = 2
    max_lbfgs: int = 10
    lbfgs_m: int = 7
    solver_mode: int = SM_OSLM_OSRLM_RLBFGS
    # consensus + spatial
    admm_rho: float = 5.0
    npoly: int = 2
    poly_type: int = 2
    spatial_n0: int = 2
    spatial_beta: float = 0.0  # <=0: master's auto scale
    spatial_basis: str = "shapelet"
    spatial_mu: float = 1e-3
    fista_maxiter: int = 60
    mdl_kmax: int = 0  # 0: max(npoly, 2)
    # synthetic mode: make_multiband_skies bands
    synthetic: int = 0  # >0: number of synthetic bands
    nstations: int = 7
    noise_sigma: float = 0.0
    seed: int = 5
    # elastic (checkpoint after each solved band)
    resume: bool = False
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    use_f64: bool = True
    verbose: bool = False


@dataclasses.dataclass
class ServeConfig:
    """The calibration service (``serve/``): the reference's fields and
    defaults.  Solver fields are SERVICE-WIDE defaults; a request
    manifest entry may override any of the per-request knobs
    (``serve/request.py`` SOLVER_KNOBS)."""

    requests: str = ""          # request manifest (JSON) path
    out_dir: str = "serve-out"  # solutions + result manifests
    batch: int = 8              # lanes per bucketed batch solve
    # solver defaults (same semantics as RunConfig)
    max_emiter: int = 3
    max_iter: int = 2
    max_lbfgs: int = 10
    lbfgs_m: int = 7
    solver_mode: int = SM_OSLM_OSRLM_RLBFGS
    nulow: float = 2.0
    nuhigh: float = 30.0
    randomize: bool = True
    res_ratio: float = 5.0
    abort_on_divergence: bool = False
    # elastic (per-tenant checkpoints)
    resume: bool = False
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    use_f64: bool = True
    # the solves' joint LBFGS on the fused-objective CUDA kernels: the
    # batched kernels (one launch per bucket) when the bucket passes
    # solvers/batched.choose_batched_path, the solo kernels lane by lane
    # or the torch-op cost otherwise.  f32 only: under use_f64 the fused
    # request is ignored (the fullbatch precedent)
    use_fused_predict: bool = False
    # coherency-stack dtype on the fused paths ("f32" | "bf16")
    coh_dtype: str = "f32"
    verbose: bool = False
    # per-tenant SLO specs (obs/slo.py): path to a slo.json; empty falls
    # back to any "slos" key inside the request manifest
    slo: str = ""
    # cross-worker kernel store (serve/aot_store.py)
    aot_store: str = ""
    # cap on concurrently open TilePrefetcher streams (one per (tenant,
    # dataset, tilesz, column)); 0 = unbounded.  Above the cap the least
    # recently used stream is closed and reopened from its remaining
    # tiles on next touch (serve_prefetch_evictions_total)
    max_streams: int = 0
    # shadow-solve auditing (obs/shadow.py): re-solve this fraction of
    # requests on the reference path (torch-op cost, f32 coherencies,
    # single lane) after each result manifest is written, appending a
    # drift record to <out_dir>/drift.jsonl; sampling is a pure function
    # of (shadow_seed, request_id); 0 builds no auditor at all
    shadow_rate: float = 0.0
    shadow_seed: int = 0
    # per-process wall-clock budget for shadow re-solves; sampled
    # requests past it are skipped and counted
    shadow_budget_s: float = 120.0
    # escalate a drift-tolerance breach (obs/shadow.DRIFT_TOLERANCES)
    # from report-only to a run abort (exit 3) after the drain
    abort_on_drift: bool = False


@dataclasses.dataclass
class RefineConfig:
    """The ``refine`` app: differentiable sky-model refinement
    (``refine/``).  An outer LBFGS over the free sky parameters wraps
    the inner gain solve; gradients flow through the inner fixed point
    (implicit function theorem by default, truncated unrolling as the
    fallback).  The torch-op predict only: the hand kernels have no
    coherency cotangent (``refine/objective.py::require_xla_predict``)."""

    dataset: str = ""  # vis.h5 (one tile); empty with synthetic>0
    sky_model: str = ""
    cluster_file: str = ""
    out_prefix: str = "refine-out"  # <prefix>.json / .npz / .trace.jsonl
    tilesz: int = 2
    # which parameters are free: "c:s" entries (cluster:source index),
    # comma-separated; modes entries are "c:m" (cluster:flat mode idx)
    free_flux: str = "0:0"
    free_spec: str = ""
    free_pos: str = ""
    free_modes: str = ""
    # outer loop
    outer_iters: int = 10
    lbfgs_m: int = 7
    gradient: str = "implicit"  # or "unrolled"
    tol: float = 0.0
    # inner solve / adjoint
    inner_iters: int = 12
    cg_iters: int = 32
    damping: float = 1e-6
    adjoint_cg_iters: int = 64
    adjoint_matvec: str = "hvp"  # or "jtj" (Gauss-Newton)
    ridge: float = 1e-2  # inner gain prior (degeneracy breaker)
    # synthetic mode: simulate a make_sky fixture, perturb one flux by
    # this factor, refine it back
    synthetic: int = 0  # >0: nstations of the synthetic sky
    perturb: float = 1.15
    noise_sigma: float = 0.0
    seed: int = 3
    # elastic (outer-state checkpoints)
    resume: bool = False
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    use_f64: bool = True
    verbose: bool = False


@dataclasses.dataclass
class WidefieldConfig:
    """The ``widefield`` app: 10k+-source wide-field calibration through
    the hierarchical sky predict (``sky/``).  A synthetic compact-array
    observation (``data/simsky.py::make_sky(wide_field=True)``) is
    collapsed into ``nclusters`` tree-partitioned effective directions,
    and each tile's cluster coherencies come from
    ``predict_coherencies_hier`` (checked a-posteriori by the quality
    watchdog) before the SAGE solve."""

    out_dir: str = "widefield-out"
    # synthetic wide-field sky (data/simsky.py wide_field branch)
    nstations: int = 24
    ntiles: int = 4             # solve tiles (total obs = ntiles*tilesz)
    tilesz: int = 2             # time samples per solve tile
    nchan: int = 1
    nsources: int = 2000        # total point sources across the field
    nblobs: int = 12            # spatial blobs the sky generator draws
    fov: float = 1.1            # field diameter, direction cosines
    cluster_scale: float = 0.004
    freq0: float = 30e6         # low-frequency all-sky regime
    extent_m: float = 80.0      # compact-array station layout radius
    gain_amp: float = 0.1
    noise_sigma: float = 0.0
    seed: int = 11
    # hierarchical predict knobs (sky/predict.py)
    nclusters: int = 4          # tree-collapsed effective directions
    order: int = 8              # multipole/Taylor truncation order p
    theta: float = 1.5          # well-separation phase budget (rad)
    leaf_size: int = 32
    tile_rows: int = 128
    source_chunk: int = 32
    exact: bool = False         # route through the exact predict instead
    # a-posteriori verification: rows sampled per tile; the verdict
    # degrades when the sampled error exceeds max_rel_err (<= 0: the
    # a-priori bound of (order, theta))
    hier_nsample: int = 32
    hier_max_rel_err: float = 1e-3
    # solver (RunConfig semantics)
    max_emiter: int = 3
    max_iter: int = 2
    max_lbfgs: int = 10
    lbfgs_m: int = 7
    solver_mode: int = SM_OSLM_OSRLM_RLBFGS
    nulow: float = 2.0
    nuhigh: float = 30.0
    randomize: bool = True
    res_ratio: float = 5.0
    abort_on_divergence: bool = False
    # elastic (checkpoints at tile boundaries)
    resume: bool = False
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    use_f64: bool = True
    verbose: bool = False


@dataclasses.dataclass
class FleetConfig:
    """``fleet``: coordinator + N worker processes sharing
    a filesystem work queue with atomic lease files (``fleet/``).
    Workers claim requests by bucket affinity, leases expire so a
    killed worker's requests requeue, and admission control consumes
    obs/slo.py burn rates (shed-or-degrade on overload)."""

    requests: str = ""          # request manifest (JSON) path
    out_dir: str = "fleet-out"  # solutions + result manifests
    queue_dir: str = ""         # shared queue; default <out_dir>/queue
    aot_store: str = ""         # shared kernel store (serve/aot_store.py);
    #                             default <out_dir>/aot-store
    workers: int = 2            # worker processes the coordinator spawns
    role: str = "coordinator"   # "coordinator" | "worker"
    worker_id: str = ""         # set by the coordinator for workers
    batch: int = 4              # lanes per bucketed batch solve
    # lease protocol: claims expire after ttl; holders renew at
    # renew_s (0 = ttl/3); an expired lease may be stolen by any worker
    lease_ttl_s: float = 30.0
    lease_renew_s: float = 0.0
    poll_s: float = 0.2         # queue poll period when idle
    max_idle_s: float = 10.0    # worker exits after this long idle
    # placement: requests with nstations >= large_stations (and >1
    # local device) solve via solvers/sharded.sharded_joint_fit instead
    # of riding a batch lane; 0 disables the large path
    large_stations: int = 0
    # admission control on SLO burn (obs/slo.py): what to do when a
    # tenant's shed_burn threshold trips — "shed" refuses the request
    # (manifest verdict "shed", no solve), "degrade" solves with
    # reduced iteration budgets (quality watchdog still verdicts the
    # result), "off" restores the report-only behavior
    overload_policy: str = "degrade"
    degrade_emiter: int = 1
    degrade_lbfgs: int = 4
    # solver defaults (ServeConfig semantics; per-request overrides win)
    max_emiter: int = 3
    max_iter: int = 2
    max_lbfgs: int = 10
    lbfgs_m: int = 7
    solver_mode: int = SM_OSLM_OSRLM_RLBFGS
    nulow: float = 2.0
    nuhigh: float = 30.0
    randomize: bool = True
    res_ratio: float = 5.0
    abort_on_divergence: bool = False
    resume: bool = False
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    use_f64: bool = True
    # fused-kernel routing for the workers' batch solves (ServeConfig
    # semantics: batched fused kernel when capability checks pass,
    # ignored under use_f64)
    use_fused_predict: bool = False
    coh_dtype: str = "f32"
    verbose: bool = False
    slo: str = ""
    max_streams: int = 8
    # live observability (obs/timeline.py): the coordinator appends one
    # timeline.jsonl row per watch poll and feeds the report-only
    # autoscale recommender (obs/capacity.py) — pure observation unless
    # elastic_workers is set
    timeline: bool = True
    # bounded respawn of CRASHED workers (nonzero exit with work left):
    # per-slot replacement budget; clean exits never respawn
    max_respawns: int = 2
    # opt-in: act on the recommender (spawn/retire one worker per
    # recommendation change, clamped to [min_workers, max_workers];
    # retire = SIGTERM -> the worker's existing lease-release path).
    # Off (default) the recommender provably changes no solve output.
    elastic_workers: bool = False
    min_workers: int = 1
    max_workers: int = 0        # 0 = max(workers, min_workers)
    # open-loop submission (the load harness): arrivals keep landing
    # AFTER workers start, so "every item submitted so far is done" is
    # not an exit signal — workers hold on until max_idle_s or SIGTERM
    open_loop: bool = False
    # shadow-solve differential auditing (ServeConfig semantics): each
    # worker audits its own claimed requests against the torch-op/f32
    # reference, appending to the SHARED <out_dir>/drift.jsonl (the
    # O_APPEND single-write contract keeps concurrent workers from
    # interleaving); the budget is per worker
    shadow_rate: float = 0.0
    shadow_seed: int = 0
    shadow_budget_s: float = 120.0
    abort_on_drift: bool = False


@dataclasses.dataclass
class StreamConfig:
    """The ``stream`` app's configuration: streaming/online calibration.  The
    dataset is consumed as a time stream; each sliding window of
    ``window`` time samples (advanced by ``hop``) is solved with a
    warm start from the previous window's gains via the elastic
    warm-start chain, minimizing latency-to-first-solution."""

    dataset: str = ""           # vis.h5 consumed as a time stream
    sky_model: str = ""
    cluster_file: str = ""
    out_dir: str = "stream-out"
    window: int = 2             # time samples per sliding window
    hop: int = 1                # samples the window advances per solve
    max_windows: int = 0        # 0 = run to the end of the stream
    warm_start: bool = True     # p0 <- previous window's solution
    # iteration budget for warm-started windows (the chain means a
    # near-converged start; full budgets only for the cold window 0)
    warm_emiter: int = 1
    warm_lbfgs: int = 0         # 0 = inherit max_lbfgs
    in_column: str = "vis"
    # solver (RunConfig semantics)
    max_emiter: int = 3
    max_iter: int = 2
    max_lbfgs: int = 10
    lbfgs_m: int = 7
    solver_mode: int = SM_OSLM_OSRLM_RLBFGS
    nulow: float = 2.0
    nuhigh: float = 30.0
    randomize: bool = True
    res_ratio: float = 5.0
    # elastic: lease-aware stream checkpoints — the checkpoint carries
    # an owner lease so a second stream process refuses to adopt a
    # LIVE peer's chain and only resumes one whose lease expired
    resume: bool = False
    checkpoint_every: int = 1
    checkpoint_dir: Optional[str] = None
    lease_ttl_s: float = 30.0
    use_f64: bool = True
    verbose: bool = False
    # synthetic mode (tests/bench): simulate a make_sky fixture stream
    synthetic: int = 0          # >0: nstations of the synthetic array
    ntime: int = 6
    nchan: int = 2
    noise_sigma: float = 0.0
    seed: int = 7
