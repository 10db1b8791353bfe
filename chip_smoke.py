"""End-to-end check of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Runs from the repository root and needs one CUDA card.  It

1. builds the hand-written kernels (``pgmpy_tpu_torch/csrc/bincount.cu``,
   ``csrc/jt_calibrate.cu``, ``csrc/table_gather.cu``, ``csrc/ancestral.cu``,
   ``csrc/gibbs.cu``, ``csrc/einsum_plan.cu``, ``csrc/hmc.cu`` and
   ``csrc/loopy_bp.cu``, one ``nvcc`` each, started together, each build's time and what ptxas says
   of each kernel logged), and holds both count entry points
   against their plain PyTorch versions on the card: ``weighted_bincount``
   on index vectors, ``table_counts`` on MUNIN's 1041 (node, parents) tables
   over the 50,000-row code matrix;
2. drives the port's main path at full width: load MUNIN (1041 variables),
   draw 50,000 rows with a seeded numpy ancestral sampler, fit every CPD with
   the BDeu Bayesian estimator (one table-count launch for all 1041 tables),
   calibrate the junction tree on the hand-written calibration kernels
   (``pgmpy_tpu_torch/csrc/jt_calibrate.cu``, K2: one ``clique_potentials``
   launch, then ``sepset_wave`` and ``absorb_wave`` per wave of independent
   messages), then run ``query`` and ``query_batch`` (2048 rows).  Every K2
   kernel must launch on the path; the profiler's device operations per
   calibration must equal the kernels' launches; each kernel is held against
   its plain version on the card (MUNIN, both operations, at the float32
   rounding the schedule allows; a float64 ALARM; ALARM's Markov model with
   normalised messages), two successive MUNIN calibrations are held equal to
   the bit, and each kernel is timed beside it and its bound, the wave
   kernels wave by wave (the five slowest waves logged).  MUNIN's junction
   tree follows the string hash seed: the script runs itself again under
   ``PYTHONHASHSEED=0`` when the variable is unset, so that every run times
   the same tree.  The fit no longer calls ``weighted_bincount``, so that entry point
   is driven, counted, checked and timed on its own: one direct call that
   tabulates the evidence variable's observed states over the 50,000 rows;
3. checks the fit against host ``np.bincount`` counts, the calibration
   against the junction-tree identities and the port's own CPU run, and the
   queries against the CPU run;
4. drives simulate -> fit -> predict at the same width: ``model.simulate``
   draws 52,048 rows of the true MUNIN on the card in ONE launch of the
   ancestral sweep kernel (K5, ``csrc/ancestral.cu``; state frequencies
   against the exact marginals of a calibrated junction tree; the same seed
   twice gives equal codes; ``forward`` and ``likelihood_weighted`` one launch
   each; the kernel against its plain version on explicit noise at 4,096 rows,
   codes and log weights equal to the bit, and timed beside the parent
   commit's kernel where it is unpacked), a fresh network is fitted on the first 50,000 (one
   table-count launch), ``predict`` and ``predict_probability`` fill three
   dropped columns of the last 2,048 rows (against a numpy float64 oracle
   computed from the fitted CPD tables, and against the CPU run), one
   sparse-evidence ``VariableElimination`` query runs if its planned
   contraction stays under a memory guard (against BeliefPropagation), and
   ``ApproxInference`` answers one query from 50,000 draws; every exact
   query's contraction runs on K3 (``csrc/einsum_plan.cu``: one
   ``plan_block`` launch where every step's union fits a block, else one
   cooperative ``plan_grid`` launch over the grid), and ``phase_k3`` holds
   both schedules against the plain version on the contractions of a MUNIN
   VE query, a BP query, a 2,048-row ``query_batch``, a do-query's and a
   float64 plan, checks that each of them makes exactly one launch of the
   schedule its plan chooses, counts K3's launches per ``predict`` /
   ``predict_probability`` call, times both schedules on each of those
   contractions, and times the chosen one beside the plain version, the
   bound (``plan_block``'s also its dependency bound: its levels, each a
   barrier and a dependent shared-memory read), one ``torch.einsum`` and,
   where it is unpacked, the parent commit's kernel;
5. drives the MCMC lane (``phase_mcmc``): Gibbs on MUNIN (4,096 chains started
   from ancestral samples, 5 sweeps over all 1041 variables, each sweep one
   launch of the Gibbs sweep kernel, K6, ``csrc/gibbs.cu``: the local
   conditionals against a numpy float64 oracle and the CPU run, every state
   still possible after every sweep, the same seed twice, a run checkpointed
   after 2 sweeps and resumed; the kernel against its plain version on
   explicit noise, MUNIN and ALARM's Markov model at 4,096 chains and
   HEPAR2 at 10,000 and 2,500, codes equal to the bit, and timed at MUNIN's
   and HEPAR2's shapes), Gibbs on HEPAR2 (10,000 chains x 120 sweeps
   against the exact marginals of a calibrated junction tree), and on the
   46-dimensional linear-Gaussian network ecoli70 ``VectorizedNUTS`` with
   1,024 chains (20 + 120 transitions, each ONE launch of K8's ``nuts_step``,
   ``csrc/hmc.cu``, no ``torch.func`` call, one host read) and
   ``HamiltonianMCDA`` with 64 (one ``hmc_step`` launch per warm-up step and
   one for the 150 draws): moments against the closed-form joint, the
   batched leapfrog against the CPU run, both kernels against their plain
   versions on explicit noise (float32 and float64) and timed, ``nuts_step``
   at 1,024 chains and at a shard's 256.  Where ``tools/parent_kernels.py
   unpack`` left an earlier commit's kernels in the tree
   (``.chip_scratch/parent``), those of ``PARENT_WRAPPERS`` are built beside
   the others and timed in turns with this tree's at the shapes the smoke
   times them (the rows' ``parent_ms``; "not timed" without them): K5 and
   K9 (``ancestral.cu``), K3's two schedules and K10 (``einsum_plan.cu``)
   and K11 and K13 (``table_gather.cu``), and K6 and K8 where it names
   ``gibbs.cu`` and ``hmc.cu``;
6. drives the temporal lane (``phase_temporal``): the particle filter on the
   rain/umbrella 2-TBN (16,384 particles, 200 slices) and on ALARM unrolled
   as a 2-TBN with 6 persistent root nodes (262,144 particles, 50 slices,
   three leaves observed in every slice), each slice one launch of the sweep
   kernel reading the previous slice (K9, ``csrc/ancestral.cu``; held to
   its plain version on explicit noise at one ALARM slice, codes and log
   weights equal to the bit, and timed beside the slice's library calls) and
   its weighted marginals one launch of ``table_counts``; the filtered
   marginals against
   ``DBNInference.forward_scan`` on the card, ``forward_scan`` (K10: one
   ``filter_scan`` launch a call, the profiler's kernels of a 50-slice call
   equal to a 2-slice call's) against its plain version on the card and the
   CPU run, and timed on ALARM's 49 transition slices and rain's 199 beside
   the parent commit's kernel where it is unpacked, with its bytes,
   operations and dependency bounds; ``DynamicBayesianNetwork.simulate`` and ``fit`` (one
   launch per pair of slices);
7. drives score-based structure search (``phase_structure``):
   ``HillClimbSearch`` with BIC on 2,000 simulated ALARM rows (one launch per
   iteration with uncached specs, the DAG against the CPU run, the first
   iteration's 1,369 scores against numpy) and a Chow-Liu ``TreeSearch`` over
   MUNIN's 50,000 rows x 1041 columns (541,320 pair tables in one launch,
   held whole against the plain version; 200 tables and their mutual
   information against numpy);
8. drives constraint-based structure learning and the log-likelihood metric
   (``phase_constraint``): PC on 50,000 ALARM rows simulated on the card
   (chi-square, significance 0.01, up to 5 conditioning variables; one
   launch per non-empty level; skeleton, separating sets and PDAG against
   the CPU run, 200 triples of levels 1 and 2 against scipy's
   ``chi2_contingency`` per slice), the bench's skeleton on 2,000 rows, GES
   with BIC on 2,000 ALARM rows and MMHC on 2,000 SACHS rows (both against
   the CPU run), and ``log_likelihood_score`` of the fitted MUNIN on its
   50,000 rows (one launch of K13's ``row_sums`` kernel, ``csrc/table_gather.cu``,
   on int8 codes; against a numpy float64 gather-sum and, at rtol 1e-5, the
   plain version, and timed beside the parent commit's kernel where it is
   unpacked), with ``DAG.validate``;
9. drives the latent-variable lane (``phase_latent``): ``NaiveBayes`` on
   MUNIN's 50,000 rows with DIFFN_PATHO (5 states) as the class (one launch,
   every table against ``np.bincount``; ``predict_probability`` of 2,048
   rows against a numpy float64 log-space oracle), ``ExpectationMaximization``
   with DIFFN_PATHO latent (one E-step launch per iteration, K11's ``e_step``
   kernel over the 50,000 observed rows and 5 latent states, held at atol
   1e-6 against its plain version and timed beside the parent commit's
   kernel where it is unpacked; one
   iteration against numpy float64, the
   observed-data log-likelihood along 1, 3 and 10 iterations, the same seed
   twice), ``MirrorDescentEstimator`` on ALARM's junction tree fitted to
   50,000 simulated rows (100 iterations with the line search, against the
   CPU run), ``ExpertInLoop`` on 2,000 SACHS rows with an oracle answering
   from the true DAG (against the CPU run), and ``is_imap`` on ASIA's joint
   as a JPD beside a noisy-OR query;
10. drives loopy and LP inference (``phase_loopy``): flooding BP on a
   128 x 128 binary grid (16,384 variables, 32,512 factors) with a noisy
   image as virtual evidence (against the CPU run, rounds at most one
   apart; the query ONE launch of K7's ``flood``, ``csrc/loopy_bp.cu``, and
   no K3 launch; the flood held against its plain version on the grid, the
   star, the 8 x 8 grid and a mixed graph in float32 and float64, and timed;
   the plain round's contractions held on both K3 schedules), the 8 x 8
   grid against the junction tree, a star of 600 leaves against its exact
   beliefs, and ``Mplp.map_query`` on the v4 golden's grid and a 12 x 12 grid
   with diagonals (against the CPU run);
11. drives the causal and SEM lane (``phase_causal``): do-queries on MUNIN
   through ``BeliefPropagation`` (R_APB_EFFMUS := OTHER, 49 combinations in
   one ``query_batch``; R_LNLW_APB_MUSIZE's 100 combinations, NaN in the
   reference semantics) and on ALARM through ``VariableElimination``
   (CATECHOL := HIGH, 54 combinations), each against the per-combination
   loop on the card, the truncated factorisation and the CPU run;
   ``Adjustment`` / ``Frontdoor`` on the twelve teaching DAGs, minimal
   adjustment sets of 20 seeded MUNIN pairs and a MAG on ALARM against the
   CPU run; ``SEMEstimator.fit`` (ML, Adam, run to its stopping rule) of
   Bollen's political-democracy model and of ecoli70 as a path SEM on 50,000
   rows (against the CPU run of the same steps, Bollen also against the
   parameters its rows were drawn from and ecoli70 against OLS), ``IVEstimator`` on
   500,000 rows against numpy 2SLS and ``estimate_ate`` against
   ``LinearEstimator``;
12. drives the functional lane (``phase_functional``) on ecoli70 (46 nodes,
   70 edges): 50,000 rows of the linear-Gaussian network, a
   ``FunctionalBayesianNetwork`` of 162 learnable parameters fitted by SVI
   (against numpy least squares and, over its first 50 steps, the CPU run),
   ``simulate`` at the fit (against the closed-form joint, a ``do`` against
   its closed form, the same seed twice), ``log_likelihood`` against numpy
   float64, the MCMC fit of a conjugate model, the point fit against least
   squares, and a ``trace`` of one SVI step;
13. drives the file formats (``phase_readwrite``) on MUNIN: save and load
   through XMLBIF, NET, UAI, XDSL and XBN (every table back exactly; UAI by
   canonical index), the junction tree of the read-back model calibrated
   against the original's, the read-back model fitted on the main path's
   rows (one table-count launch, CPDs equal to the main path's), the files
   the reference pgmpy wrote, a PomdpX round trip and ``KernelTimer`` around
   a calibration against CUDA events;
14. drives the multi-device lane (``phase_parallel``) on 4 shards of one card
   (and on every card when there are more): MUNIN's junction tree calibrated
   in 4 connected parts against the single-device program (every clique and
   sepset, at a tolerance derived from float32 rounding over the schedule;
   both timed), ``sharded_sample_marginals`` of MUNIN (262,144 forward draws
   against the exact marginals, the same seed twice; likelihood-weighted
   draws with one leaf observed against ``BeliefPropagation.query`` at the
   effective sample size; one ``table_counts`` launch per shard),
   ``sharded_query_batch`` of the 2,048 prediction rows over 4, 1 and 3 shards
   against ``query_batch``, ``sharded_gibbs_marginals`` on HEPAR2 and
   ``sharded_nuts_moments`` on ecoli70 (1,024 chains, 30 kept steps, one
   ``nuts_step`` launch per shard and transition) against their exact
   answers, K1 at the shape of one shard's moments, and a run of
   two processes joined by gloo on one card (NCCL, one card per rank, when
   there are two);
15. prints the card, the timings, one JSON line describing each kernel (its
   time beside the plain version's, the card's bound for the same bytes and,
   where one PyTorch call computes the same function, that call's time; K5's,
   K11's, K13's, K3's, K10's, K8's and K7's launches counted on the path that
   drives each: simulate -> fit -> predict, the latent lane, constraint-based
   learning, the main path, the temporal lane, the MCMC lane, loopy
   inference), and, as the
   last line, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the exit code is not 0 and no result line is
printed.  Without a CUDA device it exits with code 1 before doing anything.
"""

import contextlib
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pandas as pd
import torch

N_ROWS = 50_000
BATCH_ROWS = 2048
SEED = 0
# the sparse VariableElimination query runs only if the largest tensor its
# planned contraction builds stays under this many elements (1 GiB of float32)
VE_GUARD_ELEMENTS = 2**28
# published peaks of one H100 SXM: device memory rate, and f32 operations
# outside the tensor cores (the integer multiply-adds and atomic adds of a
# count are charged at that rate)
HBM_BYTES_PER_S = 3.35e12
PLAIN_OPS_PER_S = 67e12
# cycles per second of torch.cuda._sleep's spin on an H100 (its SM clock)
SLEEP_CYCLES_PER_S = 2e9
# K10's dependency bound: SM cycles of one __syncthreads() of a 512-thread
# block and one dependent shared-memory read (tools/stamp_kernels.py k10's
# dependency probe on an NVIDIA H100 80GB HBM3 at 700 W: 62.56 a round, the
# read alone 32.1), counted at the card's highest SM clock (SM_MAX_MHZ, read
# from nvidia-smi at the start)
K10_LEVEL_CYCLES = 62.56
SM_MAX_MHZ = [1980.0]


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


@contextlib.contextmanager
def on_device(name):
    from pgmpy_tpu_torch.config import config

    previous = config.DEVICE
    config.set_device(name)
    try:
        yield
    finally:
        config.set_device(previous)


def cuda_median_ms(fn, reps=20, warmup=2, device_only=False, with_enqueue=False):
    """Median of ``reps`` single-call timings taken with CUDA events.

    With ``device_only`` each call is queued behind a device sleep of about
    four times the host's enqueue of one call (and at least ~1 ms), so that
    the host has queued the whole call before the device reaches the start
    event: the events then time the call's device work and not the host's
    Python between its launches.  That is checked: the start event must still
    be pending when ``fn`` returns.  A call that was not covered is dropped
    and the sleep doubled, and a fourth such call fails (a call that waits
    for the device, as a read-back does, cannot be covered: time it without
    ``device_only``).  With ``with_enqueue`` the result is (ms, the host's
    enqueue of one call in seconds)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_s = None
    if device_only or with_enqueue:
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    cycles = int(max(2e6, 4 * (host_s or 0.0) * SLEEP_CYCLES_PER_S))
    times, misses = [], 0
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        covered = not (device_only and start.query())
        end.synchronize()
        if covered:
            times.append(start.elapsed_time(end))
            continue
        misses += 1
        check(misses <= 3, f"cuda_median_ms: {misses} calls were not queued whole behind a "
              f"device sleep of up to {cycles:.3g} cycles (the host's enqueue "
              f"{host_s * 1e3:.3f} ms)")
        cycles *= 2
    ms = float(np.median(times))
    return (ms, host_s) if with_enqueue else ms


def reset_launches():
    """Zero the launch counters of every kernel source (K1, K2, K5 with K9,
    K6, K11, K13, K3 with K10, K8, K7)."""
    from pgmpy_tpu_torch.ops import bincount as bc
    from pgmpy_tpu_torch.ops import jt

    bc.reset_launches()
    jt.reset_launches()
    reset_gather_launches()


# path -> launches of each K2 kernel in that path's counted run
JT_PATH_LAUNCHES = {}
# K5, K9, K6, K11, K13, K3, K10, K8 and K7: kernel row name -> (source, the
# JAX function it replaces, the path that drives it)
GATHER_KERNELS = {
    "ancestral/sweep": ("pgmpy_tpu_torch/csrc/ancestral.cu", "pgmpy_tpu/sampling/core.py:173",
                        "simulate_fit_predict"),
    "ancestral/particle_sweep": ("pgmpy_tpu_torch/csrc/ancestral.cu",
                                 "pgmpy_tpu/sampling/smc.py:101", "temporal"),
    "gibbs/sweep": ("pgmpy_tpu_torch/csrc/gibbs.cu", "pgmpy_tpu/sampling/gibbs.py:148", "mcmc"),
    "table_gather/row_sums": ("pgmpy_tpu_torch/csrc/table_gather.cu",
                              "pgmpy_tpu/metrics/bn_inference.py:24", "constraint"),
    "table_gather/e_step": ("pgmpy_tpu_torch/csrc/table_gather.cu",
                            "pgmpy_tpu/estimators/em.py:186", "latent"),
    "einsum_plan/plan_block": ("pgmpy_tpu_torch/csrc/einsum_plan.cu",
                               "pgmpy_tpu/ops/einsum.py:73", "simulate_fit_predict"),
    "einsum_plan/plan_grid": ("pgmpy_tpu_torch/csrc/einsum_plan.cu",
                              "pgmpy_tpu/ops/einsum.py:73", "main"),
    "einsum_plan/filter_scan": ("pgmpy_tpu_torch/csrc/einsum_plan.cu",
                                "pgmpy_tpu/inference/dbn.py:131", "temporal"),
    "hmc/nuts_step": ("pgmpy_tpu_torch/csrc/hmc.cu", "pgmpy_tpu/sampling/nuts_jax.py:185",
                      "mcmc"),
    "hmc/hmc_step": ("pgmpy_tpu_torch/csrc/hmc.cu", "pgmpy_tpu/sampling/hmc.py:135", "mcmc"),
    "loopy_bp/flood": ("pgmpy_tpu_torch/csrc/loopy_bp.cu", "pgmpy_tpu/inference/fg_bp.py:188",
                       "loopy"),
}
# path -> launches of each K5 / K9 / K6 / K11 / K13 / K3 / K10 / K8 / K7
# kernel in that path's counted run
GATHER_PATH_LAUNCHES = {}
# kernel row name -> its check against the plain version and its timings
GATHER_ROWS = {}


def gather_launches():
    """The launch counters of the K5, K9, K6, K11, K13, K3, K10, K8 and K7
    kernels, by row name."""
    from pgmpy_tpu_torch.ops import ancestral, einsum, gibbs, hmc, loopy, table_gather

    return {"ancestral/sweep": ancestral.LAUNCHES,
            "ancestral/particle_sweep": ancestral.PARTICLE_LAUNCHES,
            "gibbs/sweep": gibbs.LAUNCHES,
            "table_gather/row_sums": table_gather.LAUNCHES["row_sums"],
            "table_gather/e_step": table_gather.LAUNCHES["e_step"],
            "einsum_plan/plan_block": einsum.LAUNCHES["plan_block"],
            "einsum_plan/plan_grid": einsum.LAUNCHES["plan_grid"],
            "einsum_plan/filter_scan": einsum.SCAN_LAUNCHES,
            "hmc/nuts_step": hmc.LAUNCHES["nuts_step"],
            "hmc/hmc_step": hmc.LAUNCHES["hmc_step"],
            "loopy_bp/flood": loopy.LAUNCHES}


def reset_gather_launches():
    from pgmpy_tpu_torch.ops import ancestral, einsum, gibbs, hmc, loopy, table_gather

    ancestral.reset_launches()
    loopy.reset_launches()
    hmc.reset_launches()
    gibbs.reset_launches()
    table_gather.reset_launches()
    einsum.reset_launches()


def record_jt(path):
    """Keep the K2 kernels' launch counts of ``path``'s counted run (read
    where the path's K1 counts are read), and the K5 / K9 / K6 / K11 / K13 /
    K3 / K10 / K8 / K7 kernels'."""
    from pgmpy_tpu_torch.ops import jt

    JT_PATH_LAUNCHES[path] = dict(jt.LAUNCHES)
    GATHER_PATH_LAUNCHES[path] = gather_launches()


def bound(nbytes, operations):
    """(bound_ms, bound_by): the least time the card could take to move
    ``nbytes`` once or to do ``operations``, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = operations / PLAIN_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# profiling sessions in this run, and those that kept fewer device records
# than the fullest session of their call
PROFILE_SESSIONS = {"sessions": 0, "short": 0}


@contextlib.contextmanager
def profile_session(device_only=False):
    """A ``torch.profiler`` session of the card (and the host, unless
    ``device_only``) that ends after the block's device work has ended."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] if device_only else [ProfilerActivity.CPU,
                                                               ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        yield prof
        torch.cuda.synchronize()


def count_sessions(counts):
    """Add one call's per-session record counts to ``PROFILE_SESSIONS``."""
    PROFILE_SESSIONS["sessions"] += len(counts)
    PROFILE_SESSIONS["short"] += sum(n < max(counts) for n in counts)


def profiled(fn, reps=1, sessions=3):
    """(kernels per call, device ms per call) of ``fn`` from ``torch.profiler``:
    the device operations it starts and the sum of their times.

    A profiling session can come back without some of its device records (in
    one process the same call of K13 read 5, 33, 5, 33, 5 kernels in five
    sessions, 33 being what it launches), so each count is a lower bound: this
    takes the session with the most records of ``sessions``.  Late in this
    script's process whole sessions keep too few (see :func:`fresh_profile`).
    A session of tens of thousands of kernels takes the host about a minute
    to read."""
    best, counts = (0, 0.0), []
    for _ in range(sessions):
        with profile_session() as prof:
            for _ in range(reps):
                fn()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        counts.append(len(kernels))
        best = max(best, (len(kernels), sum(e.time_range.elapsed_us() for e in kernels)))
    count_sessions(counts)
    return best[0] / reps, best[1] / 1e3 / reps


def kernels_by_name(fn):
    """{device operation name: (count, microseconds)} of one call of ``fn``,
    largest first (``torch.profiler``; of three sessions, the one with the
    most records, as in :func:`profiled`)."""
    best, counts = {}, []
    for _ in range(3):
        with profile_session() as prof:
            fn()
        out = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                count, total = out.get(e.name, (0, 0.0))
                out[e.name] = (count + 1, total + e.time_range.elapsed_us())
        counts.append(sum(c for c, _ in out.values()))
        if counts[-1] > sum(c for c, _ in best.values()):
            best = out
    count_sessions(counts)
    return dict(sorted(best.items(), key=lambda kv: -kv[1][1]))


FRESH_PROFILE = {}


def fresh_profile():
    """The profiler's readings of three calls, taken once in a process of its
    own (``python3 chip_smoke.py --fresh-profile``, the same tree, seed and
    card; cached): ``nuts_names``, :func:`kernels_by_name` of one
    ``VectorizedNUTS`` transition of ecoli70's ``NUTS_CHAINS`` chains;
    ``scan`` / ``scan_2``, :func:`profiled` of ALARM's ``forward_scan`` as in
    :func:`phase_temporal` over ``ALARM_SLICES`` and over 2 slices; and
    ``loopy_names``, :func:`kernels_by_name` of one warm loopy BP query of
    a ``LOOPY_PROFILE_SIDE`` grid built as :func:`phase_loopy`'s, and
    ``loopy_query_s``, its host-clock median of 3.

    Late in this script's process whole sessions keep too few device records,
    the same call in every session (a NUTS transition kept 3 of its 6 in nine
    sessions; the 2-slice ``forward_scan`` 29 of its 33 in nine, while the
    50-slice one kept 33), and a pad of host sleep around the call did not
    help.  A process of its own keeps every record in every session."""
    if not FRESH_PROFILE:
        t0 = time.time()
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--fresh-profile"],
                             capture_output=True, text=True, timeout=300)
        check(out.returncode == 0, f"the fresh profiling process failed: {out.stderr[-2000:]}")
        FRESH_PROFILE.update(json.loads(out.stdout.strip().splitlines()[-1]))
        log(f"fresh_profile_s {time.time() - t0:.1f} (a process of its own)")
    return FRESH_PROFILE


def fresh_profile_main():
    """The child of :func:`fresh_profile`: prints its readings as one JSON line."""
    from pgmpy_tpu_torch.config import as_tensor
    from pgmpy_tpu_torch.inference import DBNInference
    from pgmpy_tpu_torch.sampling import VectorizedNUTS
    from pgmpy_tpu_torch.utils import get_example_model
    from pgmpy_tpu_torch.utils.mathext import seeded_generator

    ecoli = get_example_model("ecoli70")
    _, mu, _ = ecoli.joint_gaussian()
    nuts = VectorizedNUTS(ecoli, max_depth=6)
    draws = nuts.sample(mu.copy(), num_samples=5, num_adapt=5, stepsize=0.17,
                        n_chains=NUTS_CHAINS, seed=SEED)
    positions, gen = as_tensor(draws[-1]), seeded_generator(SEED)
    names = kernels_by_name(lambda: nuts._nuts_step(gen, positions, nuts.final_stepsize))

    alarm = get_example_model("alarm")
    dbn, persistent, _ = alarm_2tbn(alarm, ALARM_PERSISTENT)
    leaves = sorted((v for v in alarm.nodes() if not alarm.get_children(v)),
                    key=str)[:ALARM_EVIDENCE_LEAVES]
    truth = dbn_trajectory(dbn, ALARM_SLICES, SEED)
    evidence = {(v, t): truth[(v, t)] for v in leaves for t in range(ALARM_SLICES)}
    infer = DBNInference(dbn)
    scans = {}
    for key, slices in (("scan", ALARM_SLICES), ("scan_2", 2)):
        infer.forward_scan(persistent, evidence, n_time_slices=slices)  # plans
        scans[key] = profiled(lambda: infer.forward_scan(persistent, evidence,
                                                         n_time_slices=slices))
    from pgmpy_tpu_torch.inference import BeliefPropagationWithMessagePassing
    from pgmpy_tpu_torch.utils.interop import factor_graph_from_numpy

    scopes, cards, tables, variables, messages = loopy_grid(LOOPY_PROFILE_SIDE)
    bp = BeliefPropagationWithMessagePassing(factor_graph_from_numpy(scopes, cards, tables))
    virtual = virtual_factors(variables, messages)
    query = lambda: bp.query(variables, virtual_evidence=virtual)  # noqa: E731
    query()  # the program, its tables, the kernel
    loopy_names = kernels_by_name(query)
    print(json.dumps({"nuts_names": names, **scans, "loopy_names": loopy_names,
                      "loopy_query_s": host_median_s(query)}))


def host_median_s(fn, reps=3):
    """Median host-clock seconds of ``fn``, each run ending in a device
    synchronisation."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    return float(np.median(times))


def ancestral_sample(model, n_rows, seed):
    """``n_rows`` ancestral samples as categorical columns whose categories
    are the model's full state lists (inverse-CDF draws from one numpy
    stream, nodes in topological order)."""
    import networkx as nx

    rng = np.random.default_rng(seed)
    codes, columns = {}, {}
    for node in nx.lexicographical_topological_sort(model, key=str):
        cpd = model.get_cpds(node)
        values = cpd.get_values().astype(np.float64)
        col = np.zeros(n_rows, dtype=np.int64)
        for parent in cpd.variables[1:]:  # last evidence variable fastest
            col = col * len(cpd.state_names[parent]) + codes[parent]
        cdf = np.cumsum(values[:, col].T, axis=1)
        draw = np.minimum((rng.random(n_rows)[:, None] >= cdf).sum(axis=1), values.shape[0] - 1)
        codes[node] = draw
        columns[node] = pd.Categorical.from_codes(draw, categories=cpd.state_names[node])
    return pd.DataFrame(columns), codes


# --------------------------------------------------------------------------- #
# K1, first entry point: weighted bincount of an index vector
# --------------------------------------------------------------------------- #
def bincount_case(name, idx, w, length, weighted, library=False):
    """Hold ``weighted_bincount``'s kernel against its plain version on one
    index vector, then time it, the plain version and (``library``: every index
    lies in [0, length), where both compute the same function)
    ``torch.bincount`` beside the card's bound for the same bytes."""
    from pgmpy_tpu_torch.ops import bincount as bc

    n = idx.numel()
    got = bc.weighted_bincount_cuda(idx, w, length)
    ref = bc.weighted_bincount_reference(idx, w, length)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max()) if length else 0.0
    if weighted:
        check(torch.allclose(got, ref, rtol=1e-5, atol=0), f"k1 {name}: max_abs_err {err}")
    else:
        check(torch.equal(got, ref), f"k1 {name}: unweighted counts differ ({err})")
    nbytes = n * (idx.element_size() + w.element_size()) + length * w.element_size()
    bound_ms, bound_by = bound(nbytes, n)
    out = {
        "err": err,
        "ms": cuda_median_ms(lambda: bc.weighted_bincount_cuda(idx, w, length),
                             device_only=True),
        # the plain version's mask and torch.bincount read a size back (a host
        # sync), so neither can be queued behind a device sleep: CUDA events
        # around the whole call, the read-back included
        "plain_ms": cuda_median_ms(lambda: bc.weighted_bincount_reference(idx, w, length)),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }
    if library:
        lib = torch.bincount(idx, weights=w, minlength=length)
        check(torch.equal(lib.to(got.dtype), got), f"k1 {name}: torch.bincount differs")
        out["library_ms"] = cuda_median_ms(
            lambda: torch.bincount(idx, weights=w, minlength=length))
    log(f"k1 {name} n={n} length={length} {idx.dtype} {w.dtype} max_abs_err={err:.3e} "
        f"kernel_ms={out['ms']:.5f} plain_ms={out['plain_ms']:.5f} "
        f"bound_ms={bound_ms:.6f} ({bound_by}) torch_bincount_ms={out['library_ms']} "
        f"(medians of 20; the kernel's device time, the others with their read-back)")
    return out


def phase_bincount():
    from pgmpy_tpu_torch.ops import bincount as bc

    t0 = time.time()
    bc._library()
    log(f"k1 build_s {time.time() - t0:.3f}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def case(name, n, length, weighted, itype=torch.int32, dtype=torch.float32, library=False):
        # indices in [0, length]: idx == length is the padding convention.  The
        # cases timed against torch.bincount keep to [0, length).
        idx = torch.randint(0, length + (0 if library else 1), (n,), generator=gen,
                            device="cuda", dtype=itype)
        w = (torch.rand(n, generator=gen, device="cuda", dtype=dtype) if weighted
             else torch.ones(n, device="cuda", dtype=dtype))
        return bincount_case(name, idx, w, length, weighted, library)

    results = {
        "munin_table": case("munin_table", N_ROWS, 600, False, library=True),
        "munin_table_w": case("munin_table_weighted", N_ROWS, 600, True),
        "1M_600": case("shared", 1_000_003, 600, False, library=True),
        "1M_600_w": case("shared_weighted", 1_000_003, 600, True),
        "1M_200k": case("global", 1_000_003, 200_000, False, itype=torch.int64),
        "1M_200k_w": case("global_weighted", 1_000_003, 200_000, True),
        "f64_global": case("f64_global", 100_000, 20_000, True, dtype=torch.float64),
        # the longest histogram that is still built in shared memory
        "budget_edge": case("shared_memory_budget_edge", 1_000_003,
                            bc.SHARED_BUDGET_BYTES // 4, False),
        "len1": case("length1", 5000, 1, False),
        "f64": case("f64_weighted", 1537, 300, True, dtype=torch.float64),
        "f64_i64": case("f64_int64", 5000, 300, True, itype=torch.int64, dtype=torch.float64),
    }
    # empty bins and padding only: every index is 5 or length
    idx = torch.tensor([5, 5, 8, 5], device="cuda", dtype=torch.int32)
    got = bc.weighted_bincount_cuda(idx, torch.ones(4, device="cuda"), 8)
    expect = torch.zeros(8, device="cuda")
    expect[5] = 3
    check(torch.equal(got, expect), f"k1 empty bins / padding: {got.tolist()}")
    log("k1 empty_bins_and_padding ok")
    return results


# --------------------------------------------------------------------------- #
# K1, second entry point: every count table of a spec list in one launch
# --------------------------------------------------------------------------- #
def munin_count_inputs(model, codes):
    """The fit's count problem as the table-count op sees it: the column-major
    code matrix on the card, the row count, and each node's (node, parents)
    columns and cardinalities."""
    from pgmpy_tpu_torch.ops import bincount as bc

    variables = sorted(model.nodes(), key=str)
    index = {v: j for j, v in enumerate(variables)}
    cards = [len(model.states[v]) for v in variables]
    host = np.stack([codes[v] for v in variables], axis=1).astype(np.int32)
    cm = bc.column_major_codes(torch.from_numpy(host).cuda(), max(cards))
    col_lists = [[index[u] for u in [v] + sorted(model.get_parents(v), key=str)]
                 for v in variables]
    card_lists = [[cards[c] for c in cols] for cols in col_lists]
    return host, cm, cards, col_lists, card_lists


def library_index(cm, n, specs, chunk=1024):
    """Every spec's flat table entry per row, offset into one index space: the
    input of one ``torch.bincount`` that computes all of ``specs``'s tables
    (built in chunks of specs, outside any timed window)."""
    idx = torch.empty((len(specs), n), dtype=torch.int64, device=cm.device)
    for width in np.unique(specs.n_cols):
        rows = np.flatnonzero(specs.n_cols == width)
        for start in range(0, rows.size, chunk):
            part = rows[start:start + chunk]
            cols = torch.as_tensor(specs.cols[part, :width].reshape(-1), device=cm.device)
            strides = torch.as_tensor(specs.strides[part, :width], device=cm.device)
            g = cm.index_select(0, cols)[:, :n].view(len(part), width, n).long()
            idx[torch.as_tensor(part, device=cm.device)] = (g * strides[:, :, None]).sum(dim=1) \
                + torch.as_tensor(specs.offsets[part], device=cm.device)[:, None]
            del g
    return idx.view(-1)


def library_bincount(name, cm, n, specs, ref, weights=None):
    """(max_abs_err, ms) of one ``torch.bincount`` over every spec's flat index
    (weights repeated per spec) against the plain version's tables ``ref``:
    equal without weights; with them within 1e-3, as ``torch.bincount`` adds
    float32 weights with one global atomic per row.  Median of 5 device-time
    runs."""
    flat_idx = library_index(cm, n, specs)
    flat_w = None if weights is None else weights.repeat(len(specs))
    lib = torch.bincount(flat_idx, weights=flat_w, minlength=specs.total)
    err = float((lib.double() - ref.double()).abs().max())
    if weights is None:
        check(lib.numel() == specs.total and torch.equal(lib, ref.to(lib.dtype)),
              f"k1 {name}: torch.bincount differs from the plain version by {err}")
    else:
        check(lib.numel() == specs.total and torch.allclose(lib.double(), ref.double(),
                                                              rtol=1e-3, atol=1e-3),
              f"k1 {name}: torch.bincount differs from the plain version by {err}")
    # torch.bincount reads its input's maximum back: CUDA events around the
    # whole call, the read-back included
    ms = cuda_median_ms(lambda: torch.bincount(flat_idx, weights=flat_w, minlength=specs.total),
                        reps=5, warmup=1)
    log(f"k1t {name} library torch_bincount_ms={ms:.5f} (one call over the {len(specs)} specs "
        f"offset into one index space of {flat_idx.numel()} int64 entries, "
        f"{flat_idx.numel() * 8 / 1e9:.2f} GB, built outside the timing; median of 5; "
        f"max_abs_err {err:.3e})")
    del flat_idx, flat_w, lib
    torch.cuda.empty_cache()
    return err, ms


def phase_table_counts(model, codes):
    """The table-count kernel against its plain version on MUNIN's code
    matrix (50,000 rows x 1041 columns) and its 1041 (node, parents) specs."""
    from pgmpy_tpu_torch.ops import bincount as bc

    host, cm, cards, col_lists, card_lists = munin_count_inputs(model, codes)
    n_rows = host.shape[0]
    specs = bc.table_specs(col_lists, card_lists)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    w32 = torch.rand(n_rows, generator=gen, device="cuda")
    worst = 0.0

    def exact(name, cm_, specs_):
        before = bc.TABLE_LAUNCHES
        got = bc.table_counts_cuda(cm_, n_rows, specs_)
        torch.cuda.synchronize()
        ref = bc.table_counts_reference(cm_, n_rows, specs_)
        torch.cuda.synchronize()
        check(bc.TABLE_LAUNCHES == before + (1 if len(specs_) else 0), f"k1t {name}: launch count")
        check(got.dtype == torch.int32 and torch.equal(got, ref), f"k1t {name}: counts differ")
        log(f"k1t {name} specs={len(specs_)} entries={specs_.total} exact")
        return got

    def close(name, w):
        # The oracle is the plain version on f64 copies of the same weights:
        # float atomics add in a run-dependent order in the kernel AND in
        # index_add_, so two f32 sums of 25,000 rows may each be off by
        # several 1e-6 relative; against f64 only the kernel's rounding counts.
        nonlocal worst
        got = bc.table_counts_cuda(cm, n_rows, specs, w)
        torch.cuda.synchronize()
        ref = bc.table_counts_reference(cm, n_rows, specs, w.double())
        torch.cuda.synchronize()
        err = float((got.double() - ref).abs().max())
        check(got.dtype == w.dtype and torch.allclose(got.double(), ref, rtol=1e-5, atol=0),
              f"k1t {name}: max_abs_err {err}")
        worst = max(worst, err)
        log(f"k1t {name} specs={len(specs)} max_abs_err={err:.3e} (rtol 1e-5 against the f64 plain version)")

    full = exact("munin_unweighted", cm, specs)
    check(int(full.sum()) == n_rows * len(specs), "k1t munin_unweighted: a row was dropped")
    close("munin_weighted_f32", w32)
    close("munin_weighted_f64", w32.double())

    missing = torch.from_numpy(host).cuda()
    holes = torch.rand(missing.shape, generator=gen, device="cuda") < 0.1
    holes[:, ::3] = False  # two columns in three have missing values
    missing[holes] = -1
    got = exact("missing_values", bc.column_major_codes(missing, max(cards)), specs)
    check(int(got.sum()) < n_rows * len(specs), "k1t missing_values: no row was skipped")

    exact("one_spec", cm, bc.table_specs(col_lists[:1], card_lists[:1]))
    empty = exact("no_spec", cm, bc.table_specs([], []))
    check(empty.numel() == 0, "k1t no_spec: output not empty")

    # a table that cannot fit the shared-memory budget goes to global atomics
    wide = [int(c) for c in np.argsort(cards)[-4:]]
    big = bc.table_specs([wide] + col_lists[:3], [[cards[c] for c in wide]] + card_lists[:3])
    check(big.sizes[0] * 4 > bc.SHARED_BUDGET_BYTES, f"k1t large table has {big.sizes[0]} entries")
    exact("table_beyond_shared_memory", cm, big)

    used = np.unique(np.concatenate(col_lists)).size
    nbytes = (used * n_rows * cm.element_size() + specs.total * 4
              + 8 * len(specs) * (6 + 2 * specs.cols.shape[1]))
    operations = 2 * int(specs.n_cols.sum()) * n_rows
    bound_ms, bound_by = bound(nbytes, operations)
    wbound_ms, _ = bound(nbytes + n_rows * 4, operations)
    ms = cuda_median_ms(lambda: bc.table_counts_cuda(cm, n_rows, specs), device_only=True)
    ms_w = cuda_median_ms(lambda: bc.table_counts_cuda(cm, n_rows, specs, w32), device_only=True)
    # The plain version launches ~12 eager kernels per spec; its time is the
    # host's enqueue of them, which no device sleep can hide.
    plain_ms = cuda_median_ms(lambda: bc.table_counts_reference(cm, n_rows, specs),
                              reps=3, warmup=1)
    log(f"k1t munin specs={len(specs)} rows={n_rows} codes={cm.dtype} columns_read="
        f"{int(specs.n_cols.sum())} kernel_ms={ms:.5f} weighted_kernel_ms={ms_w:.5f} "
        f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.6f} ({bound_by}) "
        f"weighted_bound_ms={wbound_ms:.6f} (kernel: device time, median of 20; plain: 3 runs)")
    _, library_ms = library_bincount("munin", cm, n_rows, specs, full)
    return {"err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# --------------------------------------------------------------------------- #
# the main path on MUNIN
# --------------------------------------------------------------------------- #
def fit_check(fitted, codes, states, ess=5.0):
    """Every fitted CPD against host np.bincount counts with the BDeu prior."""
    worst = 0.0
    for node in fitted.nodes():
        cpd = fitted.get_cpds(node)
        parents = sorted(fitted.get_parents(node), key=str)
        check(cpd.variables[1:] == parents, f"fit {node}: parent order {cpd.variables[1:]}")
        card = len(states[node])
        n_cols = int(np.prod([len(states[p]) for p in parents])) if parents else 1
        flat = codes[node] * n_cols
        stride = 1
        for p in reversed(parents):
            flat = flat + codes[p] * stride
            stride *= len(states[p])
        counts = np.bincount(flat, minlength=card * n_cols).reshape(card, n_cols)
        post = counts + ess / (card * n_cols)
        post = post / post.sum(axis=0, keepdims=True)
        err = float(np.abs(cpd.get_values().astype(np.float64) - post).max())
        worst = max(worst, err)
        check(err <= 1e-6, f"fit {node}: max_abs_err {err}")
    return worst


def calibration_check(bp):
    cliques = bp.get_clique_beliefs()
    for clique, phi in cliques.items():
        total = float(phi.values.double().sum())
        check(abs(total - 1.0) <= 1e-4, f"clique {clique[:3]}... sums to {total}")
    worst = 0.0
    for edge, sep in bp.get_sepset_beliefs().items():
        for clique in edge:
            phi = cliques[clique]
            drop = [v for v in phi.variables if v not in sep.variables]
            marg = phi.marginalize(drop, inplace=False)
            check(marg.variables == sep.variables, "sepset axis order")
            err = float((marg.values - sep.values).abs().max())
            worst = max(worst, err)
            check(err <= 1e-5, f"sepset of {clique[:3]}...: max_abs_err {err}")
    return worst


# --------------------------------------------------------------------------- #
# K2: the junction-tree calibration kernels
# --------------------------------------------------------------------------- #
JT_SOURCE = "pgmpy_tpu_torch/csrc/jt_calibrate.cu"
JT_REPLACES = "pgmpy_tpu/inference/bp.py:396"


def jt_case(name, program, arrays, operation, rtol, atol=0.0):
    """One calibration on the kernels and one with the plain version, on the
    card, held entry by entry to ``|a - b| <= atol + rtol |b|``, or, where
    ``rtol`` is None, equal to the bit.  Logs the magnitudes of the plain
    version's entries beside the tolerance.  Returns the max abs errors of
    (beliefs, sepsets)."""
    from pgmpy_tpu_torch.ops import jt

    plan = program.wave_plan()
    normalize = program.normalize_messages
    got = jt.calibrate_waves_cuda(plan, arrays, operation, normalize)
    want = jt.calibrate_waves_reference(plan, arrays, operation, normalize)
    torch.cuda.synchronize()
    errs = []
    held = "equal to the bit" if rtol is None else f"rtol {rtol:.3e}, atol {atol:g}"
    for a, b, what in zip(got, want, ("beliefs", "sepsets")):
        check(a.dtype == b.dtype == arrays[0].dtype and a.is_cuda, f"k2 {name}: {what} type")
        check(bool(torch.isfinite(a).all()), f"k2 {name}: non-finite {what}")
        diff = (a - b).abs()
        same = torch.equal(a, b) if rtol is None else bool((diff <= atol + rtol * b.abs()).all())
        check(same, f"k2 {name} {operation}: {what} differ by {float(diff.max())} ({held})")
        errs.append(float(diff.max()))
        mags = b.abs()
        nonzero = mags[mags > 0]
        log(f"k2 {name} {operation} {what} |b| largest {float(mags.max()):.3e} median "
            f"{float(mags.median()):.3e} zero {mags.numel() - nonzero.numel()} of {mags.numel()} "
            f"smallest nonzero {float(nonzero.min()) if nonzero.numel() else 0.0:.3e} worst "
            f"relative gap {float((diff[mags > 0] / nonzero).max()) if nonzero.numel() else 0.0:.3e}")
    log(f"k2 {name} {operation} dtype {str(arrays[0].dtype)[6:]} normalize_messages {normalize} "
        f"cliques {len(program.cliques)} messages {len(program.messages)} waves {plan.n_waves} "
        f"max_abs_err beliefs {errs[0]:.3e} sepsets {errs[1]:.3e} against the plain version on "
        f"the card ({held})")
    return errs


def kernel_name(signature):
    """``sepset_wave_kernel<float, false, 16>`` of a profiler's kernel signature."""
    import re

    found = re.search(r"(\w+)(<[^()]*>)?\(", signature)
    return found.group(1) + (found.group(2) or "") if found else signature


def jt_wave_bytes(plan, elem, w):
    """(sepset_wave's, absorb_wave's) data bytes of wave ``w``: each of its
    sources read once (a downward wave's messages from one parent share it),
    per message its ratio and sepset written and the previous sepset read;
    every destination read and written once and its ratios read."""
    sizes = plan.cliques[:, 1]
    lo, hi = plan.wave_message_start[w:w + 2]
    rows = plan.messages[plan.wave_messages[lo:hi]]
    sep = rows[:, 4]
    sepset = int(sizes[np.unique(rows[:, 0])].sum() + 2 * sep.sum() + (sep * (1 - rows[:, 3])).sum())
    dsts = np.unique(rows[:, 1])
    return elem * sepset, elem * int(2 * sizes[dsts].sum() + sep.sum())


def jt_bounds(plan, elem):
    """{kernel: (bytes, operations)} one calibration must move and do: every
    clique written once in stage 0 and every factor read once; the waves'
    data bytes (:func:`jt_wave_bytes`); the descriptor tables each kernel
    reads (stage 0: its potential rows and block prefix, its factor rows and
    the factor pointers).  Operations count a product per factor after the
    first of each clique entry, and every message's own walk of its source."""
    sizes = plan.cliques[:, 1]
    rows = plan.messages
    src = sizes[rows[:, 0]]
    sep = rows[:, 4]
    stale = sep * (1 - rows[:, 3])
    n_factors = np.array([len(specs) for specs in plan.potential_specs])
    wave_bytes = np.array([jt_wave_bytes(plan, elem, w) for w in range(plan.n_waves)])
    absorb_ops = int(sum(int(sizes[row[0]]) * int(row[2] - row[1]) for row in plan.groups))
    return {
        "clique_potentials": (
            elem * (plan.total + sum(plan.factor_sizes))
            + 8 * (plan.potentials.size + plan.potential_starts.size
                   + plan.potential_factors.size + len(plan.factor_sizes)),
            int((sizes * np.maximum(n_factors - 1, 0)).sum())),
        "sepset_wave": (
            int(wave_bytes[:, 0].sum()) + 8 * (rows.size + plan.message_blocks.size),
            int(src.sum() + sep.sum() + stale.sum())),
        "absorb_wave": (
            int(wave_bytes[:, 1].sum())
            + 8 * (plan.groups.size + plan.group_blocks.size + plan.absorb_rows.size),
            absorb_ops),
    }


def log_slowest_waves(plan, wave_ms, elem):
    """The five slowest waves of each wave kernel: device ms beside the
    wave's bound, its messages, largest source and that message's sepset,
    data bytes and blocks."""
    sizes = plan.cliques[:, 1]
    for k, (name, times) in enumerate(wave_ms.items()):
        parts = []
        for w in sorted(range(plan.n_waves), key=lambda w: -times[w])[:5]:
            lo, hi = plan.wave_message_start[w:w + 2]
            rows = plan.messages[plan.wave_messages[lo:hi]]
            big = int(np.argmax(sizes[rows[:, 0]]))
            nbytes = jt_wave_bytes(plan, elem, w)[k]
            blocks = (plan.sepset_blocks if k == 0 else plan.absorb_blocks)[w]
            parts.append(f"wave {w}{' (down)' if w >= plan.n_up_waves else ''} {times[w]:.5f} ms "
                         f"(bound {bound(nbytes, 0)[0]:.5f}) messages {hi - lo} largest source "
                         f"{int(sizes[rows[big, 0]])} onto sepset {int(rows[big, 4])} bytes "
                         f"{nbytes} blocks {int(blocks)}")
        log(f"k2 {name} slowest waves (device ms, each launch alone behind a device sleep, "
            f"median of 5): " + "; ".join(parts))


def phase_jt_kernels(bp):
    """K2 on the main path's calibrated MUNIN: launches and the profiler's
    kernels per calibration, every kernel against the plain version (both
    operations on MUNIN, a float64 ALARM, ALARM's Markov model with its
    messages normalised), and each kernel's time beside its plain version and
    its bound.  Returns per kernel the numbers of its JSON row."""
    from pgmpy_tpu_torch.inference import BeliefPropagation
    from pgmpy_tpu_torch.ops import jt
    from pgmpy_tpu_torch.utils import get_example_model

    program = bp._program
    plan = program.wave_plan()
    arrays = [f.values.contiguous() for f in bp._input_factors]
    waves = plan.n_waves
    split = plan.messages[:, jt.MSG_CHUNKS] > 1
    log(f"k2 tree PYTHONHASHSEED={os.environ.get('PYTHONHASHSEED')} cliques "
        f"{len(program.cliques)} messages {len(program.messages)} waves {waves} (upward "
        f"{plan.n_up_waves}) messages cut into chunks {int(split.sum())} sepset_wave blocks "
        f"{int(plan.sepset_blocks.sum())} absorb_wave blocks {int(plan.absorb_blocks.sum())} "
        f"largest block walk {int(jt.block_walks(plan.messages).max())} source entries (limit "
        f"{jt.MAX_BLOCK_WALK})")
    check(jt.block_walks(plan.messages).max() <= jt.MAX_BLOCK_WALK,
          "k2: a sepset_wave block reads past the limit")

    # ---- launches and device operations per calibration
    jt.reset_launches()
    bp._calibrate_junction_tree("marginalize")
    torch.cuda.synchronize()
    per_cal, by_kernel = jt.JT_LAUNCHES, dict(jt.LAUNCHES)
    check(by_kernel == {"clique_potentials": 1, "sepset_wave": waves, "absorb_wave": waves},
          f"k2 launches per calibration {by_kernel} for {waves} waves")
    # the wrapper's own copies (the descriptor tables once per card, the
    # factor-pointer table when an address changes) are none in steady state;
    # a profiling session can lose device records, so up to three tries
    for _ in range(3):
        kernels, device_ms = profiled(lambda: bp._calibrate_junction_tree("marginalize"))
        if kernels >= per_cal:
            break
    check(kernels == per_cal, f"k2: the profiler saw {kernels} device operations per "
          f"calibration, the kernels launched {per_cal}")
    names = kernels_by_name(lambda: bp._calibrate_junction_tree("marginalize"))
    dev_ms, host_s = cuda_median_ms(lambda: bp._calibrate_junction_tree("marginalize"),
                                    reps=15, device_only=True, with_enqueue=True)
    log(f"k2 calibration waves {waves} (upward {plan.n_up_waves}) jt_launches_per_calibration "
        f"{per_cal} profiler_kernels_per_calibration {kernels:.0f} device_ms {device_ms:.4f} "
        f"(profiler) device_only_ms {dev_ms:.4f} (CUDA events behind a covering device sleep, "
        f"median of 15; host enqueue {host_s * 1e3:.3f} ms) by_name " + "; ".join(f"{kernel_name(k)} x{c} {us / 1e3:.4f} ms"
                                   for k, (c, us) in names.items()))

    # ---- every kernel against the plain version
    rtol = schedule_rtol(program)
    errs = {"sepset_wave": 0.0, "absorb_wave": 0.0}

    def keep(e):
        errs["absorb_wave"] = max(errs["absorb_wave"], e[0])
        errs["sepset_wave"] = max(errs["sepset_wave"], e[1])

    # the sums differ by rounding only (the kernel sums in double), so every
    # entry is held relative to itself, with no absolute slack: most beliefs
    # lie far below 1e-6.  Max is exact and both multiply in schedule order,
    # so maximize is equal to the bit
    keep(jt_case("munin", program, arrays, "marginalize", rtol))
    keep(jt_case("munin", program, arrays, "maximize", None))
    # the partials of a message cut into chunks combine in a fixed order:
    # two calibrations are equal to the bit
    for operation in ("marginalize", "maximize"):
        first = jt.calibrate_waves_cuda(plan, arrays, operation)
        again = jt.calibrate_waves_cuda(plan, arrays, operation)
        torch.cuda.synchronize()
        check(torch.equal(first[0], again[0]) and torch.equal(first[1], again[1]),
              f"k2 munin {operation}: two calibrations differ")
        log(f"k2 munin {operation} two successive calibrations equal to the bit")
    del first, again
    stage0 = torch.empty(plan.total, dtype=arrays[0].dtype, device="cuda")
    jt.clique_potentials_cuda(plan, arrays, stage0)
    ref0 = torch.empty_like(stage0)
    jt.clique_potentials_reference(plan, arrays, jt.arena_views(
        plan, ref0, torch.empty(plan.sepset_total, dtype=ref0.dtype, device="cuda"))[0])
    torch.cuda.synchronize()
    errs["clique_potentials"] = float((stage0 - ref0).abs().max())
    check(bool(torch.equal(stage0, ref0)),
          f"k2 clique_potentials differs from the plain version by {errs['clique_potentials']} "
          f"(both multiply the factors in potential_specs order: equal to the bit)")
    log("k2 munin clique_potentials equal to the plain version to the bit")
    alarm = get_example_model("alarm")
    bp64 = BeliefPropagation(alarm)
    arrays64 = [f.values.double().contiguous() for f in bp64._input_factors]
    for operation in ("marginalize", "maximize"):
        keep(jt_case("alarm", bp64._program, arrays64, operation,
                     schedule_rtol(bp64._program, u=2.0 ** -53), 1e-14))
    markov = BeliefPropagation(alarm.to_markov_model())
    check(markov._program.normalize_messages, "ALARM's Markov model does not normalise")
    rng = np.random.default_rng(SEED)
    scaled = [(f.values * float(rng.uniform(0.25, 4.0))).contiguous()
              for f in markov._input_factors]
    for operation in ("marginalize", "maximize"):
        keep(jt_case("alarm_markov", markov._program, scaled, operation,
                     schedule_rtol(markov._program, normalized=True), 1e-6))

    # ---- times: each kernel launch alone behind a device sleep (device
    # time), summed over a calibration; the plain version's pieces with CUDA
    # events around their eager ops (its time is the host's enqueue)
    arena, sepsets = jt.calibrate_waves_cuda(plan, arrays)
    scratch, partial = jt.wave_scratch(plan, arena)
    work, sep_work = arena.clone(), sepsets.clone()
    wave_ms = {
        "sepset_wave": [cuda_median_ms(
            lambda w=w: jt.sepset_wave_cuda(plan, w, arena, sep_work, scratch, partial), reps=5,
            warmup=1, device_only=True) for w in range(waves)],
        "absorb_wave": [cuda_median_ms(
            lambda w=w: jt.absorb_wave_cuda(plan, w, work, scratch), reps=5, warmup=1,
            device_only=True) for w in range(waves)],
    }
    ms = {
        "clique_potentials": cuda_median_ms(
            lambda: jt.clique_potentials_cuda(plan, arrays, work), reps=10, warmup=1,
            device_only=True),
        **{name: sum(times) for name, times in wave_ms.items()},
    }
    # the card's write rate for stage 0's bytes: a yardstick of stores, not a
    # call that computes clique potentials (library_ms stays null)
    fill_ms = cuda_median_ms(lambda: work.fill_(1.0), reps=10, warmup=1, device_only=True)
    factorless = int(plan.potentials[:plan.fill_rows, jt.POT_SIZE].sum())
    log(f"k2 clique_potentials munin kernel_ms {ms['clique_potentials']:.5f} arena entries "
        f"{plan.total} factorless {factorless} factored {plan.total - factorless} (rows "
        f"{len(plan.potentials)}, {plan.fill_rows} runs of ones; blocks {plan.potential_blocks} "
        f"of up to {jt.ENTRIES_PER_BLOCK} entries, {jt.potential_shared(plan)} shared bytes) "
        f"arena_fill_ms {fill_ms:.5f} (one arena.fill_(1.0) over the whole arena, "
        f"{plan.total * arena.element_size()} bytes: the card's measured store rate "
        f"{plan.total * arena.element_size() / fill_ms / 1e6:.1f} GB/s, a yardstick of stores "
        f"and no library call for the function)")
    log_slowest_waves(plan, wave_ms, arena.element_size())
    p_arena, p_sepsets = torch.empty_like(arena), torch.empty_like(sepsets)
    beliefs, mu = jt.arena_views(plan, p_arena, p_sepsets)
    jt.clique_potentials_reference(plan, arrays, beliefs)
    ratios = []
    for w in range(waves):
        ratios.append(jt.sepset_wave_reference(plan, w, beliefs, mu))
        jt.absorb_wave_reference(plan, w, beliefs, ratios[-1])
    plain = {
        "clique_potentials": cuda_median_ms(
            lambda: jt.clique_potentials_reference(plan, arrays, beliefs), reps=3, warmup=1),
        "sepset_wave": cuda_median_ms(
            lambda: [jt.sepset_wave_reference(plan, w, beliefs, mu) for w in range(waves)],
            reps=3, warmup=1),
        "absorb_wave": cuda_median_ms(
            lambda: [jt.absorb_wave_reference(plan, w, beliefs, ratios[w]) for w in range(waves)],
            reps=3, warmup=1),
    }
    plain_cal = cuda_median_ms(lambda: jt.calibrate_waves_reference(plan, arrays), reps=5,
                               warmup=1)
    out = {}
    total_bound = 0.0
    for name, (nbytes, ops) in jt_bounds(plan, arena.element_size()).items():
        bound_ms, bound_by = bound(nbytes, ops)
        total_bound += bound_ms
        out[name] = {"err": errs[name], "ms": ms[name], "plain_ms": plain[name],
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        log(f"k2 {name} munin launches_per_calibration {by_kernel[name]} kernel_ms "
            f"{ms[name]:.5f} (device time, the launches of one calibration each alone behind "
            f"a device sleep, medians summed) plain_ms {plain[name]:.3f} (CUDA events around "
            f"the plain version's eager ops) bound_ms {bound_ms:.6f} ({bound_by}: {nbytes} "
            f"bytes, {ops} operations) max_abs_err {errs[name]:.3e}")
    log(f"k2 calibration munin kernels_sum_ms {sum(ms.values()):.5f} plain_calibration_ms "
        f"{plain_cal:.3f} bound_ms {total_bound:.6f}; library_ms null: no single PyTorch call "
        f"computes a calibration, a wave of messages or a clique potential table")
    return {"waves": waves, "per_calibration": per_cal, "device_ms": device_ms,
            "plain_calibration_ms": plain_cal, "kernels": out, "wave_ms": wave_ms}


def load_and_sample():
    from pgmpy_tpu_torch.utils import get_example_model

    t0 = time.time()
    model = get_example_model("munin")
    log(f"munin load_s {time.time() - t0:.3f} nodes={len(model.nodes())}")
    t0 = time.time()
    df, codes = ancestral_sample(model, N_ROWS, SEED)
    log(f"sample_s {time.time() - t0:.3f} rows={N_ROWS}")
    return model, df, codes


def phase_slice(model, df, codes, bincount_results, table_result):
    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.estimators import BayesianEstimator
    from pgmpy_tpu_torch.inference import BeliefPropagation
    from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
    from pgmpy_tpu_torch.ops import bincount as bc
    from pgmpy_tpu_torch.ops import jt, weighted_bincount
    from pgmpy_tpu_torch.utils.interop import bn_from_numpy

    states = model.states
    fitted = DiscreteBayesianNetwork()
    fitted.add_nodes_from(model.nodes())
    fitted.add_edges_from(model.edges())
    nodes = sorted(model.nodes(), key=str)
    q_var, e_var = nodes[0], nodes[len(nodes) // 2]
    e_states = states[e_var]
    batch_ev = {e_var: [e_states[i % len(e_states)] for i in range(BATCH_ROWS)]}

    # ---- the main path, counted: fit -> calibrate -> query -> query_batch
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    fitted.fit(df, estimator=BayesianEstimator, state_names=states,
               prior_type="BDeu", equivalent_sample_size=5)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    fit_launches = (bc.TABLE_LAUNCHES, bc.LAUNCHES)
    fit_jt_launches = jt.JT_LAUNCHES
    t0 = time.time()
    bp = BeliefPropagation(fitted)
    build_s = time.time() - t0
    t0 = time.time()
    bp.calibrate()
    torch.cuda.synchronize()
    first_cal_s = time.time() - t0
    t0 = time.time()
    single = bp.query([q_var], evidence={e_var: e_states[0]})
    batch, _ = bp.query_batch([q_var], batch_ev)
    torch.cuda.synchronize()
    first_query_s = time.time() - t0
    table_launches, path_bincount_launches = bc.TABLE_LAUNCHES, bc.LAUNCHES
    record_jt("main")
    log(f"main_path jt_launches {jt.JT_LAUNCHES} by kernel {JT_PATH_LAUNCHES['main']} (the "
        f"calibration and the query program's own calibration of its pruned tree) waves "
        f"{bp._program.wave_plan().n_waves} (upward {bp._program.wave_plan().n_up_waves}) "
        f"fit_jt_launches {fit_jt_launches}")
    check(fit_jt_launches == 0, "fit launched a junction-tree kernel")
    for name, n in JT_PATH_LAUNCHES["main"].items():
        check(n > 0, f"the main path did not launch the junction-tree kernel {name}")
    log(f"main_path fit_s {fit_s:.4f} jt_build_s {build_s:.3f} first_calibrate_s "
        f"{first_cal_s:.4f} first_queries_s {first_query_s:.3f} fit_table_count_launches "
        f"{fit_launches[0]} fit_bincount_launches {fit_launches[1]} "
        f"table_count_launches {table_launches} bincount_launches {path_bincount_launches}")
    check(fit_launches[0] >= 1, "fit did not launch the table-count kernel")
    check(sum(fit_launches) <= 2, f"fit made {sum(fit_launches)} count launches for {len(nodes)} tables")

    # ---- the public bincount op, counted on its own.  No module of the port
    # calls it any more (the fit builds its tables with table_counts), so its
    # path is a user's direct call: how often each state of the evidence
    # variable was observed.  The same call is held against the plain version
    # and timed, so every number of the kernel's line belongs to this shape.
    idx = torch.as_tensor(codes[e_var], dtype=torch.int32, device="cuda")
    ones = torch.ones(N_ROWS, device="cuda")
    reset_launches()
    observed = weighted_bincount(idx, ones, len(e_states))
    launches = bc.LAUNCHES
    check(launches == 1 and bc.TABLE_LAUNCHES == 0,
          "the direct bincount call did not launch its kernel once")
    check(np.array_equal(observed.cpu().numpy(),
                         np.bincount(codes[e_var], minlength=len(e_states))),
          "observed evidence frequencies differ from np.bincount")
    direct = bincount_case("evidence_frequencies", idx, ones, len(e_states), False, library=True)
    log(f"direct_call weighted_bincount rows={N_ROWS} bins={len(e_states)} launches {launches} "
        f"(launches of weighted_bincount inside fit -> calibrate -> query: {path_bincount_launches})")
    check(fitted.check_model(), "fitted model invalid")
    program = bp._program
    log(f"junction_tree cliques={len(program.cliques)} messages={len(program.messages)} "
        f"max_clique={max(int(np.prod(s)) for s in program.clique_shapes)} "
        f"clique_entries={sum(int(np.prod(s)) for s in program.clique_shapes)}")

    # ---- timings
    cal_ms = cuda_median_ms(lambda: bp._calibrate_junction_tree("marginalize"), reps=15, warmup=1)
    log(f"calibrate_median_ms {cal_ms:.4f} (15 runs, CUDA events; the K2 kernels, the host's "
        f"enqueue included)")
    k2 = phase_jt_kernels(bp)
    qb = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.time()
        bp.query_batch([q_var], batch_ev)
        torch.cuda.synchronize()
        qb.append(time.time() - t0)
    qb_s = float(np.median(qb))
    log(f"query_batch rows={BATCH_ROWS} median_s {qb_s:.5f} rows_per_s {BATCH_ROWS / qb_s:.1f}")

    # ---- checks
    fit_err = fit_check(fitted, codes, states)
    log(f"fit_check ok max_abs_err {fit_err:.3e} (limit 1e-6)")
    bp.calibrate()
    sep_err = calibration_check(bp)
    log(f"calibration_check ok sepset max_abs_err {sep_err:.3e} (limit 1e-5)")

    cpds = [(c.variable, c.variable_card, c.get_values(), c.variables[1:],
             [int(x) for x in c.cardinality[1:]], c.state_names) for c in fitted.get_cpds()]
    with on_device("cpu"):
        cpu_model = bn_from_numpy(list(fitted.edges()), cpds, nodes=list(fitted.nodes()))
        cpu_bp = BeliefPropagation(cpu_model)
        cpu_bp.calibrate()
        cpu_single = cpu_bp.query([q_var], evidence={e_var: e_states[0]})
        cpu_batch, _ = cpu_bp.query_batch([q_var], batch_ev)
        cpu_cliques = cpu_bp.get_clique_beliefs()
    gpu_cliques = bp.get_clique_beliefs()
    check(set(gpu_cliques) == set(cpu_cliques), "GPU and CPU junction trees differ")
    worst = 0.0
    for clique, phi in gpu_cliques.items():
        a, b = phi.values.cpu(), cpu_cliques[clique].values
        worst = max(worst, float((a - b).abs().max()))
        check(torch.allclose(a, b, rtol=1e-3, atol=1e-6), f"belief of {clique[:3]}... differs")
    log(f"cpu_parity beliefs ok max_abs_err {worst:.3e} (rtol 1e-3, atol 1e-6)")
    q_err = float((single.values.cpu() - cpu_single.values).abs().max())
    b_err = float((batch.cpu() - cpu_batch).abs().max())
    check(q_err <= 1e-5 and b_err <= 1e-5, f"query parity: {q_err} {b_err}")
    check(tuple(batch.shape) == (BATCH_ROWS, len(states[q_var])), f"batch shape {batch.shape}")
    check(bool(torch.isfinite(batch).all()), "non-finite query_batch output")
    log(f"cpu_parity query max_abs_err {q_err:.3e} query_batch max_abs_err {b_err:.3e} (limit 1e-5)")
    check(config.DEVICE.type == "cuda", "device left on the CPU")

    source = "pgmpy_tpu_torch/csrc/bincount.cu"
    context = {"fitted": fitted, "q_var": q_var, "e_var": e_var, "bp_single": single, "k2": k2,
               "batch_ev": batch_ev}
    return context, [
        {
            "name": "weighted_bincount",
            "route": "cuda",
            "source": source,
            "replaces": "pgmpy_tpu/ops/pallas_kernels.py:35",
            "launches": launches,
            "max_abs_err": max([direct["err"]] + [r["err"] for r in bincount_results.values()]),
            **{key: direct[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        },
        {
            # no single PyTorch call computes many tables from a code matrix;
            # the error is the weighted f32 case, the unweighted tables of the
            # main path compare torch.equal
            "name": "table_counts",
            "route": "cuda",
            "source": source,
            "replaces": "pgmpy_tpu/estimators/base.py:120",
            "launches": table_launches,
            "max_abs_err": table_result["err"],
            **{key: table_result[key]
               for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        },
    ]


# --------------------------------------------------------------------------- #
# simulate -> fit -> predict on MUNIN
# --------------------------------------------------------------------------- #
def independent_targets(model, count=3):
    """``count`` inner nodes (parents and children) of ``model``, in name
    order, none of which lies in another's Markov blanket: with every other
    variable observed they are conditionally independent, and each one's
    posterior is a function of its own blanket alone."""
    targets = []
    for node in sorted(model.nodes(), key=str):
        if not model.get_parents(node) or not model.get_children(node):
            continue
        blanket = set(model.get_markov_blanket(node))
        if not blanket & set(targets):
            targets.append(node)
        if len(targets) == count:
            return targets
    raise AssertionError(f"found only {len(targets)} independent inner nodes")


def blanket_posterior(fitted, target, codes):
    """P(target | every other variable) per row, with numpy in float64 straight
    from the fitted CPD tables: ``P(t | pa(t)) * prod over children c of
    P(c | pa(c))``, normalised.  ``codes`` maps each observed variable to its
    integer states per row."""
    card = fitted.get_cardinality(target)
    n_rows = len(next(iter(codes.values())))
    post = np.ones((n_rows, card))
    for node in [target] + list(fitted.get_children(target)):
        cpd = fitted.get_cpds(node)
        table = cpd.values.double().cpu().numpy()
        index = tuple(np.arange(card)[None, :] if v == target else codes[v][:, None]
                      for v in cpd.variables)
        post = post * table[index]
    return post / post.sum(axis=1, keepdims=True)


def exact_marginals(bp):
    """{variable: exact marginal as a float64 array} from a calibrated
    BeliefPropagation."""
    out = {}
    for clique, phi in bp.get_clique_beliefs().items():
        for var in clique:
            if var not in out:
                drop = [v for v in phi.variables if v != var]
                values = phi.marginalize(drop, inplace=False).values.double().cpu().numpy()
                out[var] = values / values.sum()
    return out


def within_mc_error(freq, p, n):
    return np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-4


def phase_simulate_predict(model, context):
    import networkx as nx

    from pgmpy_tpu_torch.estimators import BayesianEstimator
    from pgmpy_tpu_torch.inference import ApproxInference, BeliefPropagation, VariableElimination
    from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
    from pgmpy_tpu_torch.ops import ancestral
    from pgmpy_tpu_torch.ops import bincount as bc
    from pgmpy_tpu_torch.sampling import BayesianModelSampling
    from pgmpy_tpu_torch.utils.interop import bn_from_numpy

    states = model.states
    nodes = sorted(model.nodes(), key=str)
    n_sim = N_ROWS + BATCH_ROWS

    # ---- 1. simulate on the card.  K5's launches are counted over the whole
    # path, from here; K1's and K2's from the fit, as before
    reset_gather_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    df = model.simulate(n_samples=n_sim, seed=SEED, show_progress=False)
    torch.cuda.synchronize()
    simulate_first_s = time.time() - t0
    check(ancestral.LAUNCHES == 1, f"simulate made {ancestral.LAUNCHES} sweep launches")
    simulate_s = host_median_s(
        lambda: model.simulate(n_samples=n_sim, seed=SEED, show_progress=False))
    sampler = BayesianModelSampling(model).sampler  # the one simulate compiled
    before = ancestral.LAUNCHES
    device_codes = sampler.forward(n_sim, seed=SEED)
    check(ancestral.LAUNCHES == before + 1,
          f"forward made {ancestral.LAUNCHES - before} sweep launches")
    leaf = sampler.variables[-1]
    before = ancestral.LAUNCHES
    lw_codes, lw_logw = sampler.likelihood_weighted(BATCH_ROWS, {leaf: 0}, seed=SEED)
    check(ancestral.LAUNCHES == before + 1 and lw_codes.is_cuda
          and bool((lw_codes[:, -1] == 0).all()) and bool(torch.isfinite(lw_logw).all()),
          f"likelihood_weighted made {ancestral.LAUNCHES - before} sweep launches")
    check(device_codes.is_cuda and tuple(device_codes.shape) == (n_sim, len(nodes)),
          f"simulate codes on {device_codes.device}, shape {tuple(device_codes.shape)}")
    check(device_codes.dtype == torch.int8, f"simulate codes are {device_codes.dtype}")
    check(torch.equal(device_codes, sampler.forward(n_sim, seed=SEED)),
          "the same seed gave different codes")
    check(not torch.equal(device_codes, sampler.forward(n_sim, seed=SEED + 1)),
          "another seed gave the same codes")
    host_codes = device_codes.cpu().numpy()
    codes = {v: host_codes[:, sampler.var_index[v]].astype(np.int64) for v in nodes}
    for v in nodes[:: max(len(nodes) // 50, 1)]:
        check(list(df[v].cat.categories) == list(states[v])
              and np.array_equal(df[v].cat.codes.to_numpy(), codes[v]),
              f"simulate frame and sampler codes differ in {v}")
    sweep_s = host_median_s(lambda: sampler.forward(n_sim, seed=SEED))
    sim_kernels, sim_device_ms = profiled(lambda: sampler.forward(n_sim, seed=SEED))
    log(f"simulate rows={n_sim} simulate_s {simulate_s:.4f} (median of 3; first call "
        f"{simulate_first_s:.4f}) sampler_sweep_s {sweep_s:.4f} kernels_per_call "
        f"{sim_kernels:.0f} device_ms {sim_device_ms:.3f} "
        f"idle_share_of_sweep {1 - sim_device_ms / (sweep_s * 1e3):.3f}")

    true_bp = BeliefPropagation(model)
    true_bp.calibrate()
    marginals = exact_marginals(true_bp)
    worst = 0.0
    for v in nodes:
        freq = np.bincount(codes[v], minlength=len(states[v])) / n_sim
        check(bool(within_mc_error(freq, marginals[v], n_sim).all()),
              f"simulate: frequencies of {v} {freq} against exact {marginals[v]}")
        worst = max(worst, float(np.abs(freq - marginals[v]).max()))
    log(f"simulate_check ok variables={len(nodes)} max_abs_freq_err {worst:.3e} "
        f"(limit 5*sqrt(p(1-p)/n)+1e-4 per state)")

    # ---- 2. fit a fresh network on the first 50,000 simulated rows
    train = df.iloc[:N_ROWS]
    fitted = DiscreteBayesianNetwork()
    fitted.add_nodes_from(model.nodes())
    fitted.add_edges_from(model.edges())
    carried = gather_launches()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    fitted.fit(train, estimator=BayesianEstimator, state_names=states,
               prior_type="BDeu", equivalent_sample_size=5)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    table_launches, bincount_launches = bc.TABLE_LAUNCHES, bc.LAUNCHES
    record_jt("simulate_fit_predict")
    check(table_launches == 1 and bincount_launches == 0,
          f"fit on the simulated frame: {table_launches} table-count and "
          f"{bincount_launches} bincount launches")
    fit_err = fit_check(fitted, {v: c[:N_ROWS] for v, c in codes.items()}, states)
    log(f"simulated_fit fit_s {fit_s:.4f} table_count_launches {table_launches} "
        f"bincount_launches {bincount_launches} fit_check max_abs_err {fit_err:.3e} (limit 1e-6)")

    # ---- 3. predict three dropped columns of the held-out rows
    targets = independent_targets(fitted)
    out_card = int(np.prod([len(states[t]) for t in targets]))
    check(BATCH_ROWS * out_card <= 2**31, f"joint of {targets} has {out_card} states")
    test = df.iloc[N_ROWS:].drop(columns=targets)
    held_out = {v: c[N_ROWS:] for v, c in codes.items()}
    torch.cuda.synchronize()
    t0 = time.time()
    predicted = fitted.predict(test)
    torch.cuda.synchronize()
    predict_first_s = time.time() - t0
    predict_s = host_median_s(lambda: fitted.predict(test))
    plan_s = predict_first_s - predict_s
    t0 = time.time()
    probabilities = fitted.predict_probability(test)
    torch.cuda.synchronize()
    probability_first_s = time.time() - t0
    probability_s = host_median_s(lambda: fitted.predict_probability(test))
    pred_kernels, pred_device_ms = profiled(lambda: fitted.predict(test))
    prob_kernels, prob_device_ms = profiled(lambda: fitted.predict_probability(test))
    log(f"predict rows={BATCH_ROWS} missing={targets} joint_states={out_card} "
        f"predict_s {predict_s:.4f} (median of 3; first call {predict_first_s:.4f}, plan_s "
        f"{plan_s:.4f}) predict_rows_per_s {BATCH_ROWS / predict_s:.1f} kernels_per_call "
        f"{pred_kernels:.0f} device_ms {pred_device_ms:.4f}")
    log(f"predict_probability predict_probability_s {probability_s:.4f} (median of 3; first "
        f"call {probability_first_s:.4f}) rows_per_s {BATCH_ROWS / probability_s:.1f} "
        f"kernels_per_call {prob_kernels:.0f} device_ms {prob_device_ms:.4f}")

    check(list(predicted.columns) == targets and len(predicted) == BATCH_ROWS,
          f"predict returned {list(predicted.columns)} x {len(predicted)}")
    prob_err, undecided, hits = 0.0, 0, 0
    oracle = {}
    for t in targets:
        oracle[t] = blanket_posterior(fitted, t, held_out)
        got = probabilities[[f"{t}_{s}" for s in states[t]]].to_numpy()
        check(bool(np.isfinite(got).all()), f"predict_probability of {t} is not finite")
        prob_err = max(prob_err, float(np.abs(got - oracle[t]).max()))
        top2 = np.sort(oracle[t], axis=1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 1e-4
        undecided += int((~decided).sum())
        want = np.asarray(states[t], dtype=object)[oracle[t].argmax(axis=1)]
        check(bool((predicted[t].to_numpy(dtype=object)[decided] == want[decided]).all()),
              f"predict: MAP state of {t} differs from the oracle's argmax")
        hits += int((predicted[t].to_numpy(dtype=object)
                     == np.asarray(states[t], dtype=object)[held_out[t]]).sum())
    check(prob_err <= 1e-5, f"predict_probability against the oracle: max_abs_err {prob_err}")
    context["predict_rows"] = (fitted, targets, test)
    log(f"predict_check ok oracle max_abs_err {prob_err:.3e} (limit 1e-5) undecided_rows "
        f"{undecided} accuracy_on_held_out {hits / (len(targets) * BATCH_ROWS):.4f}")

    cpds = [(c.variable, c.variable_card, c.get_values(), c.variables[1:],
             [int(x) for x in c.cardinality[1:]], c.state_names) for c in fitted.get_cpds()]
    with on_device("cpu"):
        cpu_model = bn_from_numpy(list(fitted.edges()), cpds, nodes=list(fitted.nodes()))
        cpu_probabilities = cpu_model.predict_probability(test)
        cpu_predicted = cpu_model.predict(test)
    cpu_err = float(np.abs(probabilities.to_numpy() - cpu_probabilities.to_numpy()).max())
    check(list(probabilities.columns) == list(cpu_probabilities.columns) and cpu_err <= 1e-5,
          f"predict_probability against the CPU run: max_abs_err {cpu_err}")
    joint = np.ones((BATCH_ROWS, 1))
    for t in targets:
        joint = (joint[:, :, None] * oracle[t][:, None, :]).reshape(BATCH_ROWS, -1)
    top2 = np.sort(joint, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 1e-4
    check(predicted[decided].equals(cpu_predicted[decided]), "predict differs from the CPU run")
    log(f"cpu_parity predict_probability max_abs_err {cpu_err:.3e} (limit 1e-5) predict equal "
        f"on {int(decided.sum())} decided rows")

    # ---- 4. one sparse-evidence VariableElimination query, under a guard
    # read from the planned contraction before anything is launched
    q_var, e_var = context["q_var"], context["e_var"]
    ve = VariableElimination(context["fitted"])
    t0 = time.time()
    program = ve._get_compiled_query([q_var], [e_var])
    largest = program.largest_intermediate()
    ve_plan_s = time.time() - t0
    if largest <= VE_GUARD_ELEMENTS:
        evidence = {e_var: states[e_var][0]}
        answer = ve.query([q_var], evidence=evidence)
        ve_err = float((answer.values - context["bp_single"].values).abs().max())
        check(answer.values.is_cuda and ve_err <= 1e-5,
              f"sparse VE query against BeliefPropagation: max_abs_err {ve_err}")
        ve_s = host_median_s(lambda: ve.query([q_var], evidence=evidence))
        ve_kernels, ve_device_ms = profiled(lambda: ve.query([q_var], evidence=evidence))
        log(f"sparse_ve_query operands={len(program._arrays)} largest_intermediate {largest} "
            f"plan_s {ve_plan_s:.4f} query_s {ve_s:.5f} kernels_per_call {ve_kernels:.0f} "
            f"device_ms {ve_device_ms:.4f} max_abs_err_against_bp {ve_err:.3e} (limit 1e-5)")
    else:
        log(f"sparse_ve_query not run: operands={len(program._arrays)} largest_intermediate "
            f"{largest} elements exceeds the guard of {VE_GUARD_ELEMENTS}")

    # ---- 5. ApproxInference with one root observed: the query is q_var, or
    # its first child where q_var is itself a root (roots are independent of
    # each other, so evidence on another root would say nothing about it)
    a_var = q_var if model.get_parents(q_var) else sorted(model.get_children(q_var), key=str)[0]
    root = sorted((v for v in nx.ancestors(model, a_var) if not model.get_parents(v)), key=str)[0]
    root_state = states[root][int(np.argmax(marginals[root]))]
    t0 = time.time()
    approx = ApproxInference(model).query([a_var], n_samples=N_ROWS, evidence={root: root_state},
                                          seed=SEED, show_progress=False)
    approx_s = time.time() - t0
    exact = true_bp.query([a_var], evidence={root: root_state}).values.double().cpu().numpy()
    got = approx.values.double().cpu().numpy()
    check(bool(within_mc_error(got, exact, N_ROWS).all()),
          f"ApproxInference {got} against exact {exact}")
    log(f"approx_inference query={a_var} evidence={root}={root_state} samples={N_ROWS} "
        f"approx_s {approx_s:.4f} max_abs_err {float(np.abs(got - exact).max()):.3e} "
        f"(limit 5*sqrt(p(1-p)/n)+1e-4)")
    GATHER_PATH_LAUNCHES["simulate_fit_predict"] = {
        name: carried[name] + count for name, count in gather_launches().items()}
    log(f"simulate_path sweep_launches {GATHER_PATH_LAUNCHES['simulate_fit_predict']} (simulate "
        f"and forward: one each; likelihood_weighted: one)")
    GATHER_ROWS["ancestral/sweep"] = k5_kernel_row(sampler, n_sim)
    return table_launches, bincount_launches


# --------------------------------------------------------------------------- #
# K3: the planned contraction's two schedules against the plain version
# --------------------------------------------------------------------------- #
# the block-schedule check is skipped for plans whose unions sum past this
# (one block would walk them alone for seconds)
K3_BLOCK_CHECK_UNIONS = 2**27


def capture_contractions(fn, modules):
    """Run ``fn`` with each module's ``sum_product_planned`` / ``sum_product``
    (and ``sum_product_reference``, which loopy BP's plain round calls)
    recording its (operand labels, output labels, operands) before it runs:
    the contractions the path hands K3."""
    from pgmpy_tpu_torch.ops import einsum

    calls = []

    def planned(axes, out, arrays, optimize="greedy"):
        calls.append((tuple(map(tuple, axes)), tuple(out), list(arrays)))
        return einsum.sum_product_planned(axes, out, arrays, optimize)

    def product(axes, out, *arrays, optimize="greedy"):
        calls.append((tuple(map(tuple, axes)), tuple(out), list(arrays)))
        return einsum.sum_product(axes, out, *arrays, optimize=optimize)

    def reference(axes, out, arrays, optimize="greedy"):
        calls.append((tuple(map(tuple, axes)), tuple(out), list(arrays)))
        return einsum.sum_product_reference(axes, out, arrays, optimize)

    saved = []
    for module in modules:
        for name, fake in (("sum_product_planned", planned), ("sum_product", product),
                           ("sum_product_reference", reference)):
            if hasattr(module, name):
                saved.append((module, name, getattr(module, name)))
                setattr(module, name, fake)
    try:
        fn()
    finally:
        for module, name, original in saved:
            setattr(module, name, original)
    check(bool(calls), f"no contraction captured from {[m.__name__ for m in modules]}")
    return calls


def k3_table(call, schedule=None):
    from pgmpy_tpu_torch.ops import einsum

    axes, out, arrays = call
    shapes = tuple(tuple(a.shape) for a in arrays)
    strides = tuple(tuple(a.stride()) for a in arrays)
    plan = einsum.contraction_plan(axes, out, shapes)
    return einsum.PlanTable(axes, out, shapes, strides, arrays[0].element_size(), plan,
                            schedule=schedule)


def k3_case(name, call):
    """Both schedules of one captured contraction against the plain version
    on the card: float32 at rtol 1e-5 with atol 1e-6 of the plan's largest
    entry (the kernel sums in float64, the plain version's steps in float32),
    float64 at rtol 1e-12.  Returns the largest absolute error."""
    from pgmpy_tpu_torch.ops import einsum

    axes, out, arrays = call
    want = einsum.sum_product_reference(axes, out, arrays)
    table = k3_table(call)
    f64 = want.dtype == torch.float64
    atol = 0.0 if f64 else 1e-6 * float(want.abs().max())
    rtol = 1e-12 if f64 else 1e-5
    errs = {}
    for schedule in ("plan_block", "plan_grid"):
        if schedule == "plan_block" and int(table.unions.sum()) > K3_BLOCK_CHECK_UNIONS:
            errs[schedule] = None
            continue
        got = einsum.launch_plan(k3_table(call, schedule), arrays)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"k3 {name} {schedule}: {tuple(got.shape)} {got.dtype}")
        check(torch.allclose(got, want, rtol=rtol, atol=atol),
              f"k3 {name} {schedule}: max_abs_err {float((got - want).abs().max())}")
        errs[schedule] = float((got - want).abs().max())
    log(f"k3_check {name} operands={len(arrays)} steps={len(table.steps)} schedule="
        f"{table.schedule} max_union={int(table.unions.max())} unions={int(table.unions.sum())} "
        f"arena={table.arena} ({'shared' if table.shared else 'global'}) dtype={want.dtype} "
        f"max_abs_err plan_block={errs['plan_block']} plan_grid={errs['plan_grid']} (rtol "
        f"{rtol:g}, atol {atol:.3e})")
    return max(e for e in errs.values() if e is not None)


def phase_k3(context):
    """K3 held against its plain version on the card: the contractions of a
    MUNIN VariableElimination query, a MUNIN BeliefPropagation query, a
    2,048-row ``query_batch`` and a do-query on MUNIN (the causal lane's
    batched query), each with both schedules, and the VE query's in float64
    (loopy BP's round is held in ``phase_loopy``), and the synthetic
    contractions of ``k3_probe_contractions``; exactly one launch, of the
    plan's schedule, for each of them; both schedules timed on each, and
    how often the dispatch chose the faster; K3's
    launches per ``predict`` and ``predict_probability`` call; the chosen
    schedules timed beside the plain version, the bound, ``torch.einsum``
    and the parent's kernel."""
    from pgmpy_tpu_torch.inference import BeliefPropagation, CausalInference, VariableElimination
    from pgmpy_tpu_torch.inference import bp, ve
    from pgmpy_tpu_torch.ops import einsum

    fitted, q_var, e_var = context["fitted"], context["q_var"], context["e_var"]
    evidence = {e_var: fitted.states[e_var][0]}
    engine = VariableElimination(fitted)
    ve_calls = capture_contractions(lambda: engine.query([q_var], evidence=evidence), [ve])
    tree = BeliefPropagation(fitted)
    tree.calibrate()
    bp_calls = capture_contractions(lambda: tree.query([q_var], evidence=evidence), [bp])
    batch_calls = capture_contractions(lambda: tree.query_batch([q_var], context["batch_ev"]),
                                       [bp])
    child = sorted(fitted.get_children(CAUSAL_DO[0]))[0]
    do_calls = capture_contractions(
        lambda: CausalInference(fitted).query([child], do=dict([CAUSAL_DO]),
                                              inference_algo="bp"), [bp, ve])
    worst = 0.0
    captured = (("munin_ve_query", ve_calls), ("munin_bp_query", bp_calls),
                ("munin_query_batch_2048", batch_calls), ("munin_do_query", do_calls))
    for name, calls in captured:
        for k, call in enumerate(calls):
            worst = max(worst, k3_case(f"{name}[{k}]", call))
    axes, out, arrays = ve_calls[-1]
    k3_case("munin_ve_query_float64", (axes, out, [a.double() for a in arrays]))
    check(k3_table(ve_calls[-1]).schedule == "plan_block", "the VE plan is not under the limit")
    check(k3_table(batch_calls[-1]).schedule == "plan_grid",
          "the query_batch plan is not past the block limit")
    probes = k3_probe_contractions(ve_calls[-1][2][0].device)
    for name, call in probes:
        worst = max(worst, k3_case(name, call))
    # each distinct contraction: one launch of its schedule, both schedules
    # timed, and whether the dispatch chose the faster one
    seen, picks = set(), []
    for name, calls in list(captured) + [(name, [call]) for name, call in probes]:
        for k, call in enumerate(calls):
            signature = (call[0], call[1], tuple(tuple(a.shape) for a in call[2]))
            if signature not in seen:
                seen.add(signature)
                picks.append((f"{name}[{k}]", k3_schedules(f"{name}[{k}]", call)[1]))
    log(f"k3_schedule_choice faster on {sum(ok for _, ok in picks)} of {len(picks)} "
        f"contractions (slower: {[name for name, ok in picks if not ok] or 'none'})")
    fitted_p, _, test = context["predict_rows"]
    per_call = {}
    for name, fn in (("predict", lambda: fitted_p.predict(test)),
                     ("predict_probability", lambda: fitted_p.predict_probability(test))):
        einsum.reset_launches()
        fn()
        per_call[name] = dict(einsum.LAUNCHES)
    log(f"k3_launches_per_call predict {per_call['predict']} predict_probability "
        f"{per_call['predict_probability']} (their profiler kernels per call are logged with "
        f"predict_rows_per_s)")
    GATHER_ROWS["einsum_plan/plan_block"] = k3_kernel_row("munin_ve_query", ve_calls[-1],
                                                          parent=True)
    GATHER_ROWS["einsum_plan/plan_grid"] = k3_kernel_row("munin_query_batch_2048",
                                                         batch_calls[-1], parent=True)
    log(f"k3_checks ok: every captured contraction within its limits under both schedules, "
        f"one launch each (largest float32 error {worst:.3e})")
    einsum.reset_launches()


def turns_ms(calls):
    """Device times (median of 20 behind a device sleep) of ``calls`` in
    turns: in order, then in reverse order.  Returns {key: (the smaller of
    its two medians, both medians)}."""
    runs = {}
    for key in list(calls) + list(reversed(calls)):
        runs.setdefault(key, []).append(cuda_median_ms(calls[key], device_only=True))
    return {key: (min(v), v) for key, v in runs.items()}


def k3_library_args(call):
    """``torch.einsum``'s sublist arguments for the whole contraction, labels
    renumbered from 0, or None past its 52 labels."""
    axes, out, arrays = call
    dense, args = {}, []
    for a, ax in zip(arrays, axes):
        args += [a, [dense.setdefault(label, len(dense)) for label in ax]]
    args.append([dense[label] for label in out])
    return args if len(dense) <= 52 else None


def k3_kernel_row(name, call, parent=False):
    """The dispatch's schedule on one captured contraction: its device time
    and one ``torch.einsum``'s over the whole contraction on opt_einsum's
    path (labels renumbered; only where they are at most 52), with
    ``parent`` the parent commit's kernel too (where it is unpacked), in
    turns (parent, kernel, library, library, kernel, parent; each the
    smaller median of 20 behind a device sleep), the plain version's (one
    ``torch.einsum`` per step, eager) and the bound (the operands and the
    output moved once at 3.35 TB/s, or two operations per union entry per
    step at 67e12/s)."""
    from pgmpy_tpu_torch.ops import einsum

    axes, out, arrays = call
    table = k3_table(call)
    want = einsum.sum_product_reference(axes, out, arrays)
    got = einsum.launch_plan(table, arrays)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    calls = {"kernel": lambda: einsum.launch_plan(table, arrays)}
    old = PARENT.get("modules", {}).get("einsum") if parent else None
    if old is not None:
        shapes = tuple(tuple(a.shape) for a in arrays)
        old_table = old.PlanTable(axes, out, shapes, tuple(tuple(a.stride()) for a in arrays),
                                  arrays[0].element_size(), old.contraction_plan(axes, out, shapes))
        old_got = old.launch_plan(old_table, arrays)
        torch.cuda.synchronize()
        check(torch.allclose(old_got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max())),
              f"k3 {name}: the parent's {old_table.schedule} differs from the plain version")
        calls = {"parent": lambda: old.launch_plan(old_table, arrays), **calls}
    args = k3_library_args(call)
    if args is not None:
        lib = torch.einsum(*args)
        check(torch.allclose(lib, want, rtol=1e-5, atol=1e-6 * float(want.abs().max())),
              f"k3 {name}: torch.einsum differs from the plain version")
        calls["library"] = lambda: torch.einsum(*args)
    times = turns_ms(calls)
    ms = times["kernel"][0]
    parent_ms = times["parent"][0] if "parent" in times else None
    library_ms = times["library"][0] if "library" in times else None
    plain_ms = cuda_median_ms(lambda: einsum.sum_product_reference(axes, out, arrays))
    nbytes = sum(a.numel() * a.element_size() for a in arrays) + got.numel() * got.element_size()
    bound_ms, bound_by = bound(nbytes, 2 * int(table.unions.sum()))
    # plan_block: its chain of levels, a barrier and a dependent shared read
    # each (K10's dependency bound at one slice)
    dependency_ms = (k10_dependency_ms(table.n_levels, 1) if table.schedule == "plan_block"
                     else None)
    log(f"k3 {table.schedule} {name} operands={len(arrays)} steps={len(table.steps)} "
        f"unions={int(table.unions.sum())} kernel_ms={ms:.5f} parent_ms="
        f"{'not timed' if parent_ms is None else f'{parent_ms:.5f} ({old_table.schedule})'} "
        f"torch_einsum_ms={'none' if library_ms is None else f'{library_ms:.5f}'} (device time, "
        f"each the smaller median of 20 of two turns: "
        + " ".join(f"{k} " + "/".join(f"{t:.5f}" for t in v[1]) for k, v in times.items())
        + f") plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f} ({bound_by}) "
        + ("" if dependency_ms is None else
           f"dependency_bound_ms={dependency_ms:.6f} ({table.n_levels} levels x "
           f"{K10_LEVEL_CYCLES} cycles at {SM_MAX_MHZ[0]:.0f} MHz; level_sizes="
           f"{np.bincount(table.levels).tolist()}, tables "
           f"{'staged' if table.staged else 'global'}, shared_bytes={table.shared_bytes}) ")
        + f"max_abs_err={err:.3e}")
    row = {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    if parent:
        row["parent_ms"] = parent_ms
    if dependency_ms is not None:
        row["dependency_bound_ms"] = dependency_ms
    return row


def k3_probe_contractions(device, seed=0):
    """(name, call) of synthetic contractions on which the schedule choice
    is hard: scalar and four-output reductions of 2^12 to 2^16 entries (one
    step; one warp of the block walks them), chains of mat-vec products (16
    steps of 64 x 64, 28 of 32 x 32) and 16 independent mat-vec products
    with their product (64 and 256 wide); float32 in [0.1, 1.1]."""
    gen = torch.Generator().manual_seed(seed)

    def t(*shape):
        return (torch.rand(shape, generator=gen) + 0.1).to(device)

    calls = [(f"scalar_{n}", ([(0,), (0,)], (), [t(n), t(n)])) for n in (4096, 16384, 65536)]
    calls += [(f"out4_red{n}", ([(0, 1), (1,)], (0,), [t(4, n), t(n)])) for n in (4096, 16384)]
    for steps, w in ((16, 64), (28, 32)):
        calls.append((f"chain{steps}_{w}", ([(0,)] + [(i, i + 1) for i in range(steps)], (steps,),
                                            [t(w)] + [t(w, w) for _ in range(steps)])))
    for w in (64, 256):
        axes = [ax for i in range(16) for ax in ((i,), (i, 100))]
        calls.append((f"fan16_{w}", (axes, (100,), [t(w) if k % 2 == 0 else t(w, w)
                                                    for k in range(32)])))
    return [(name, (tuple(map(tuple, axes)), out, arrays)) for name, (axes, out, arrays) in calls]


def k3_schedules(name, call):
    """Both schedules' device time on one contraction (median of 20 behind
    a device sleep; ``plan_block`` only where one block walks its unions in
    reasonable time), beside the plan's numbers and the modelled times the
    choice reads (``tools/k3_schedules.py`` fits the models to such times).
    Also checks that the dispatch makes exactly one launch, of the schedule
    the plan chooses.  Returns (the times, whether the chosen schedule was
    the faster)."""
    from pgmpy_tpu_torch.ops import einsum

    axes, out, arrays = call
    table = k3_table(call)
    einsum.reset_launches()
    einsum.sum_product_planned(axes, out, arrays)
    check(einsum.LAUNCHES == {**{k: 0 for k in einsum.LAUNCHES}, table.schedule: 1},
          f"k3 {name}: the contraction made {einsum.LAUNCHES}, not one {table.schedule} launch")
    times = {}
    for schedule in ("plan_block", "plan_grid"):
        forced = k3_table(call, schedule)
        if schedule == "plan_block" and int(forced.unions.sum()) > K3_BLOCK_CHECK_UNIONS:
            times[schedule] = None
            continue
        times[schedule] = cuda_median_ms(lambda: einsum.launch_plan(forced, arrays),
                                         device_only=True)
    fmt = {k: "not timed" if v is None else f"{v:.5f}" for k, v in times.items()}
    timed = {k: v for k, v in times.items() if v is not None}
    faster = min(timed, key=timed.get)
    model = {k: "none" if v is None else f"{v / 1e3:.5f}"
             for k, v in (("plan_block", table.block_us), ("plan_grid", table.grid_us))}
    log(f"k3_schedules {name} steps={len(table.steps)} max_union={int(table.unions.max())} "
        f"unions={int(table.unions.sum())} chosen={table.schedule} (BLOCK_UNION "
        f"{einsum.BLOCK_UNION}; modelled ms plan_block={model['plan_block']} plan_grid="
        f"{model['plan_grid']}) plan_block_ms={fmt['plan_block']} plan_grid_ms="
        f"{fmt['plan_grid']} (device time, median of 20) faster={faster} launches=1")
    return times, faster == table.schedule


# --------------------------------------------------------------------------- #
# the MCMC lane: Gibbs on MUNIN and HEPAR2, NUTS and HMC on ecoli70
# --------------------------------------------------------------------------- #
GIBBS_CHAINS = 4096
GIBBS_SWEEPS = 5
HEPAR_CHAINS = 10_000
HEPAR_SWEEPS = 120
HEPAR_BURN_IN = 20
NUTS_CHAINS = 1024
NUTS_SAMPLES = 120
NUTS_ADAPT = 20
HMC_CHAINS = 64


def blanket_logits(model, var, codes):
    """log P(var = k | every other variable) up to a constant per row, with
    numpy in float64 straight from the CPD tables (zeros clamped at 1e-38, as
    the samplers clamp them): ``codes`` maps each variable to its states per
    row."""
    card = model.get_cardinality(var)
    total = np.zeros((len(codes[var]), card))
    for node in [var] + list(model.get_children(var)):
        cpd = model.get_cpds(node)
        table = np.log(np.maximum(cpd.values.double().cpu().numpy(), 1e-38))
        index = tuple(np.arange(card)[None, :] if v == var else codes[v][:, None]
                      for v in cpd.variables)
        total = total + table[index]
    return total


def possible(model, variables, codes):
    """Per chain, whether its state has positive joint probability: every
    CPD entry it selects is > 0.  ``codes``: (..., d) host integers, columns
    in ``variables`` order."""
    column = {v: codes[..., j].astype(np.int64) for j, v in enumerate(variables)}
    ok = np.ones(codes.shape[:-1], dtype=bool)
    for cpd in model.get_cpds():
        table = cpd.values.cpu().numpy()
        ok &= table[tuple(column[v] for v in cpd.variables)] > 0
    return ok


def moment_check(name, samples, mean, cov, n_effective):
    """Pooled mean and standard deviations of ``samples`` (draws, dim) against
    the joint's, six standard errors at ``n_effective`` independent draws:
    |mean error| <= 6 sd / sqrt(n) and |sd ratio - 1| <= 6 / sqrt(2 n)."""
    check(bool(np.isfinite(samples).all()), f"{name}: non-finite samples")
    return moments_check(name, samples.mean(axis=0), samples.std(axis=0), mean, cov, n_effective)


def moments_check(name, got_mean, got_sd, mean, cov, n_effective):
    """:func:`moment_check` on the pooled means and standard deviations."""
    sd = np.sqrt(np.diag(cov))
    check(bool(np.isfinite(got_mean).all() and np.isfinite(got_sd).all()),
          f"{name}: non-finite moments")
    mean_err = float(np.abs((got_mean - mean) / sd).max())
    sd_err = float(np.abs(got_sd / sd - 1).max())
    mean_limit, sd_limit = 6 / np.sqrt(n_effective), 6 / np.sqrt(2 * n_effective)
    check(mean_err <= mean_limit, f"{name}: pooled mean off by {mean_err} sd (limit {mean_limit})")
    check(sd_err <= sd_limit, f"{name}: pooled sd off by {sd_err} (limit {sd_limit})")
    return (f"max_mean_err_in_sd {mean_err:.4f} (limit {mean_limit:.4f}) max_rel_sd_err "
            f"{sd_err:.4f} (limit {sd_limit:.4f}; 6 standard errors at {n_effective:.0f} "
            f"effective draws)")


def phase_gibbs_munin(model):
    """Gibbs on MUNIN; returns the sampler and its 4,096 start states."""
    from pgmpy_tpu_torch.ops import gibbs as gibbs_ops
    from pgmpy_tpu_torch.sampling import (BayesianModelSampling, GibbsSampling,
                                          load_sampler_state, save_sampler_state)
    from pgmpy_tpu_torch.utils.interop import bn_from_numpy
    from pgmpy_tpu_torch.utils.mathext import seeded_generator

    t0 = time.time()
    gibbs = GibbsSampling(model)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    compiled = gibbs._compiled
    variables = gibbs.variables
    pairs = sum(len(specs) for specs in compiled._var_specs)
    entries = sum(int(t.numel()) for specs in compiled._var_specs for t, _, _ in specs)
    check(pairs == sum(len(c.variables) for c in model.get_cpds()),
          f"gibbs: {pairs} (variable, blanket factor) pairs")
    zeros = sum(int((c.values == 0).sum()) for c in model.get_cpds())
    log(f"gibbs_munin variables={len(variables)} pairs={pairs} table_entries={entries} "
        f"largest_card={max(compiled.cards)} zero_cpd_entries={zeros} build_s {build_s:.3f}")

    # start where the joint is positive: MUNIN's CPDs hold zeros
    sampler = BayesianModelSampling(model).sampler
    check(sampler.variables == variables, "sampler and Gibbs order the variables differently")
    init = sampler.forward(GIBBS_CHAINS, seed=SEED)
    init_host = init.cpu().numpy()
    check(bool(possible(model, variables, init_host).all()), "an ancestral sample is impossible")

    # ---- the local conditionals: numpy float64 oracle, and the CPU run
    states = init.to(torch.int64).T.contiguous()
    by_factors = sorted(range(len(variables)), key=lambda i: -len(compiled._var_specs[i]))[:10]
    spread = range(0, len(variables), max(len(variables) // 22, 1))
    picked = by_factors + [i for i in spread if i not in by_factors][:22]
    codes = {v: init_host[:, j].astype(np.int64) for j, v in enumerate(variables)}
    cpds = [(c.variable, c.variable_card, c.get_values(), c.variables[1:],
             [int(x) for x in c.cardinality[1:]], c.state_names) for c in model.get_cpds()]
    with on_device("cpu"):
        cpu_model = bn_from_numpy(list(model.edges()), cpds, nodes=list(model.nodes()))
        cpu_gibbs = GibbsSampling(cpu_model)
        check(cpu_gibbs.variables == variables, "CPU and GPU Gibbs order the variables differently")
        cpu_states = states.cpu()
        cpu_logits = {i: cpu_gibbs._compiled._conditional_logits(cpu_states, i) for i in picked}
    # A float32 sum of k log entries, none below log(1e-38) = -87.5: each of
    # the k additions rounds a partial sum of at most 87.5 k by half an ulp,
    # so the sum lies within 87.5 k^2 2^-24 of the float64 oracle.  The CPU
    # run adds the same float32 numbers in the same order.
    oracle_err = cpu_err = oracle_margin = 0.0
    for i in picked:
        got = compiled._conditional_logits(states, i)
        check(got.is_cuda and tuple(got.shape) == (GIBBS_CHAINS, compiled.cards[i]),
              f"gibbs logits of {variables[i]}: {got.device} {tuple(got.shape)}")
        err = float(np.abs(got.double().cpu().numpy()
                           - blanket_logits(model, variables[i], codes)).max())
        limit = 87.5 * len(compiled._var_specs[i]) ** 2 * 2.0**-24 + 1e-5
        check(err <= limit, f"gibbs logits of {variables[i]} against the oracle: {err} > {limit}")
        oracle_err, oracle_margin = max(oracle_err, err), max(oracle_margin, err / limit)
        cpu_err = max(cpu_err, float((got.cpu() - cpu_logits[i]).abs().max()))
    check(cpu_err <= 1e-5, f"gibbs conditional logits against the CPU run: {cpu_err}")
    log(f"gibbs_munin conditional_logits variables={len(picked)} most_blanket_factors="
        f"{len(compiled._var_specs[by_factors[0]])} oracle max_abs_err {oracle_err:.3e} (numpy "
        f"float64; limit 87.5 k^2 2^-24 + 1e-5 for k blanket factors, largest share of it used "
        f"{oracle_margin:.3f}) cpu_run max_abs_err {cpu_err:.3e} (limit 1e-5)")

    # ---- the run, and what must hold of it
    torch.cuda.synchronize()
    launches = gibbs_ops.LAUNCHES
    t0 = time.time()
    traj = compiled._run_chains(seeded_generator(SEED), GIBBS_SWEEPS, init)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    check(gibbs_ops.LAUNCHES - launches == GIBBS_SWEEPS,
          f"gibbs: {gibbs_ops.LAUNCHES - launches} sweep launches for {GIBBS_SWEEPS} sweeps")
    check(traj.is_cuda and traj.dtype == torch.int8
          and tuple(traj.shape) == (GIBBS_SWEEPS, GIBBS_CHAINS, len(variables)),
          f"gibbs trajectory {traj.dtype} {tuple(traj.shape)} on {traj.device}")
    cards = torch.as_tensor(compiled.cards, dtype=torch.int8, device=traj.device)
    check(bool(((traj >= 0) & (traj < cards)).all()), "gibbs: a code is out of range")
    host = traj.cpu().numpy()
    alive = possible(model, variables, host)
    check(bool(alive.all()), f"gibbs: {int((~alive).sum())} chain states of probability 0, the "
                             f"first after sweep {int(np.argmin(alive.all(axis=1))) + 1}")
    moved = float((host[-1] != init_host).mean())
    check(moved > 0.01, f"gibbs: only {moved:.4f} of the codes changed in {GIBBS_SWEEPS} sweeps")
    check(torch.equal(traj, compiled._run_chains(seeded_generator(SEED), GIBBS_SWEEPS, init)),
          "gibbs: the same seed gave another trajectory")
    check(not torch.equal(traj, compiled._run_chains(seeded_generator(SEED + 1), GIBBS_SWEEPS, init)),
          "gibbs: another seed gave the same trajectory")

    # ---- checkpoint after 2 sweeps, resume for 3
    gen = seeded_generator(SEED)
    head = compiled._run_chains(gen, 2, init)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gibbs_state.npz")
        save_sampler_state(path, {"codes": head[-1]}, gen, step=2)
        saved, key, step, _ = load_sampler_state(path, treedef_like={"codes": None})
    resumed = seeded_generator(0)
    resumed.set_state(key)
    tail = compiled._run_chains(resumed, GIBBS_SWEEPS - step, saved["codes"])
    check(step == 2 and saved["codes"].is_cuda and torch.equal(tail, traj[2:]),
          "gibbs: the resumed run differs from the uninterrupted one")
    log(f"gibbs_munin_check ok trajectory {tuple(traj.shape)} {traj.dtype} codes in range, "
        f"every state possible after each of {GIBBS_SWEEPS} sweeps, share_of_codes_changed "
        f"{moved:.4f}, same seed equal, resumed after 2 sweeps equal")

    # ---- timings of one sweep
    gen = seeded_generator(SEED)
    out = torch.empty_like(init)
    sweep_s = host_median_s(lambda: compiled._sweep(init, gen, out=out))
    kernels, device_ms = profiled(lambda: compiled._sweep(init, gen, out=out))
    log(f"gibbs_munin chains={GIBBS_CHAINS} sweeps={GIBBS_SWEEPS} run_s {run_s:.4f} "
        f"sweep_s {sweep_s:.4f} (median of 3) gibbs_chain_sweeps_per_s "
        f"{GIBBS_CHAINS / sweep_s:.1f} kernels_per_sweep {kernels:.0f} (the key's draw and the "
        f"sweep kernel; 13,714 eager kernels before K6) device_ms {device_ms:.3f} "
        f"idle_share_of_sweep {1 - device_ms / (sweep_s * 1e3):.3f} levels "
        f"{compiled._tables.n_levels} groups {compiled._tables.groups}")
    return gibbs, init


def phase_gibbs_hepar2():
    from pgmpy_tpu_torch.inference import BeliefPropagation
    from pgmpy_tpu_torch.ops import gibbs as gibbs_ops
    from pgmpy_tpu_torch.sampling import GibbsSampling
    from pgmpy_tpu_torch.utils import get_example_model

    model = get_example_model("hepar2")
    smallest = min(float(c.values.min()) for c in model.get_cpds())
    check(smallest > 0, "hepar2 has a zero CPD entry: the Gibbs chain may be reducible")
    gibbs = GibbsSampling(model)
    torch.cuda.synchronize()
    launches = gibbs_ops.LAUNCHES
    t0 = time.time()
    traj = gibbs.sample_chains(HEPAR_CHAINS, HEPAR_SWEEPS, seed=SEED)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    check(gibbs_ops.LAUNCHES - launches == HEPAR_SWEEPS,
          f"hepar2 gibbs: {gibbs_ops.LAUNCHES - launches} sweep launches for {HEPAR_SWEEPS}")
    check(traj.is_cuda and tuple(traj.shape) == (HEPAR_SWEEPS, HEPAR_CHAINS, len(gibbs.variables)),
          f"hepar2 trajectory {tuple(traj.shape)} on {traj.device}")
    bp = BeliefPropagation(model)
    bp.calibrate()
    marginals = exact_marginals(bp)
    kept = traj[HEPAR_BURN_IN:].reshape(-1, traj.shape[-1])
    worst, worst_var = 0.0, None
    for j, v in enumerate(gibbs.variables):
        freq = torch.bincount(kept[:, j].to(torch.int64), minlength=len(marginals[v]))
        err = float(np.abs(freq.cpu().numpy() / kept.shape[0] - marginals[v]).max())
        if err > worst:
            worst, worst_var = err, v
    check(worst <= 0.02, f"hepar2 Gibbs marginal of {worst_var} off by {worst}")
    log(f"gibbs_hepar2 variables={len(gibbs.variables)} smallest_cpd_entry {smallest:.2e} "
        f"chains={HEPAR_CHAINS} sweeps={HEPAR_SWEEPS} burn_in={HEPAR_BURN_IN} run_s {run_s:.4f} "
        f"gibbs_chain_sweeps_per_s {HEPAR_CHAINS * HEPAR_SWEEPS / run_s:.1f} "
        f"max_abs_marginal_err {worst:.4e} at {worst_var} (limit 0.02)")


@contextlib.contextmanager
def counting_calls(cls, names):
    """Count the calls of the methods ``names`` of ``cls`` (through any
    instance) while the block runs: yields a dict whose "calls" grows."""
    counts = {"calls": 0}
    saved = {name: getattr(cls, name) for name in names}

    def counted(method):
        def call(*args, **kwargs):
            counts["calls"] += 1
            return method(*args, **kwargs)
        return call

    for name, method in saved.items():
        setattr(cls, name, counted(method))
    try:
        yield counts
    finally:
        for name, method in saved.items():
            setattr(cls, name, method)


def phase_nuts_ecoli70():
    """NUTS and HMC on ecoli70; returns what the K8 rows need: the joint,
    the NUTS sampler, its final positions."""
    from pgmpy_tpu_torch.config import as_tensor
    from pgmpy_tpu_torch.ops import hmc as hmc_ops
    from pgmpy_tpu_torch.sampling import HamiltonianMCDA, VectorizedNUTS
    from pgmpy_tpu_torch.sampling.hmc import _Density
    from pgmpy_tpu_torch.utils import get_example_model
    from pgmpy_tpu_torch.utils.mathext import seeded_generator

    ecoli = get_example_model("ecoli70")
    variables, mu, cov = ecoli.joint_gaussian()
    dim = len(variables)
    nuts = VectorizedNUTS(ecoli, max_depth=6)
    check(isinstance(nuts.log_pdf, hmc_ops.GaussianTarget) and nuts.log_pdf.device.type == "cuda",
          "ecoli70's density is not a GaussianTarget on the card: NUTS would not take K8")

    # ---- the batched leapfrog on the card against the CPU run
    rng = np.random.default_rng(SEED)
    z = mu + rng.normal(size=(NUTS_CHAINS, dim)) * np.sqrt(np.diag(cov))
    r = rng.normal(size=(NUTS_CHAINS, dim))
    got = nuts._leapfrog(as_tensor(z), as_tensor(r), nuts._grad(as_tensor(z)), 0.17)
    with on_device("cpu"):
        cpu_nuts = VectorizedNUTS(ecoli, max_depth=6)
        want = cpu_nuts._leapfrog(as_tensor(z), as_tensor(r), cpu_nuts._grad(as_tensor(z)), 0.17)
    leap_err = 0.0
    for a, b in zip(got, want):
        check(a.is_cuda and tuple(a.shape) == (NUTS_CHAINS, dim), f"leapfrog output on {a.device}")
        leap_err = max(leap_err, float(((a.cpu() - b).abs() / b.abs().max()).max()))
    check(leap_err <= 1e-5, f"nuts leapfrog against the CPU run: {leap_err}")

    # ---- the same seed twice, on a short run
    short = dict(num_samples=6, num_adapt=4, stepsize=0.17, n_chains=NUTS_CHAINS)
    first = nuts.sample(mu.copy(), seed=SEED + 1, **short)
    check(np.array_equal(first, nuts.sample(mu.copy(), seed=SEED + 1, **short)),
          "nuts: the same seed gave other samples")
    check(not np.array_equal(first, nuts.sample(mu.copy(), seed=SEED + 2, **short)),
          "nuts: another seed gave the same samples")

    # ---- the run: one nuts_step launch and one host read per transition,
    # and no torch.func density evaluated
    steps = NUTS_SAMPLES + NUTS_ADAPT
    launches = hmc_ops.LAUNCHES["nuts_step"]
    torch.cuda.synchronize()
    t0 = time.time()
    with counting_calls(_Density, ("__init__", "value", "grad", "grad_and_value")) as density:
        samples = nuts.sample(mu.copy(), num_samples=NUTS_SAMPLES, num_adapt=NUTS_ADAPT,
                              stepsize=0.17, n_chains=NUTS_CHAINS, seed=SEED)
    run_s = time.time() - t0
    launches = hmc_ops.LAUNCHES["nuts_step"] - launches
    check(launches == steps, f"nuts: {launches} nuts_step launches for {steps} transitions")
    check(density["calls"] == 0, f"nuts: {density['calls']} torch.func density calls")
    check(nuts.host_reads == steps, f"nuts: {nuts.host_reads} host reads for {steps} transitions")
    check(samples.shape == (NUTS_SAMPLES, NUTS_CHAINS, dim), f"nuts samples {samples.shape}")
    check(0.6 < nuts.acceptance_rate <= 1.0, f"nuts acceptance rate {nuts.acceptance_rate}")
    # an autocorrelation time of 10 transitions is allowed for
    pooled = samples.reshape(-1, dim).astype(np.float64)
    moments = moment_check("nuts", pooled, mu, cov, pooled.shape[0] / 10)
    positions = as_tensor(samples[-1])
    gen = seeded_generator(SEED)
    # the profiler names the device operations of one transition (in a
    # process of its own: see fresh_profile); their time comes from CUDA
    # events (median of 20 behind a device sleep)
    names = fresh_profile()["nuts_names"]
    kernels = sum(count for count, _ in names.values())
    device_ms = cuda_median_ms(lambda: nuts._nuts_step(gen, positions, nuts.final_stepsize),
                               device_only=True)
    step_s = run_s / steps
    log(f"nuts_ecoli70 dim={dim} chains={NUTS_CHAINS} samples={NUTS_SAMPLES} adapt={NUTS_ADAPT} "
        f"max_depth=6 run_s {run_s:.3f} nuts_samples_per_s "
        f"{NUTS_SAMPLES * NUTS_CHAINS / run_s:.1f} acceptance_rate {nuts.acceptance_rate:.4f} "
        f"final_stepsize {nuts.final_stepsize:.4f} leapfrogs_per_chain_and_step "
        f"{nuts.leaf_iterations:.2f} nuts_step_launches {launches} (one per transition) "
        f"host_reads_per_step {nuts.host_reads / steps:.2f} step_s {step_s:.5f} kernels_per_step "
        f"{kernels} (the profiler's, in a process of its own: " + ", ".join(f"{name[:40]} x{count}" for name, (count, _)
                                                  in names.items())
        + f") device_ms_per_step {device_ms:.4f} (CUDA events, median of 20) idle_share "
        f"{1 - device_ms / (step_s * 1e3):.3f} torch_func_density_calls {density['calls']} "
        f"(the eager schedule before this kernel, on an H100: 4,465 kernels, 74.9 host reads, "
        f"0.165 s a step, idle 0.96)")
    log(f"nuts_ecoli70_check ok {moments} leapfrog_vs_cpu max_rel_err {leap_err:.3e} "
        f"(limit 1e-5) same seed equal on a run of {short['num_adapt'] + short['num_samples']} steps")

    # ---- HMC with dual averaging, 64 chains.  A fixed trajectory length can
    # freeze a direction of a Gaussian whose period it matches, so each chain
    # is counted as one independent draw.  One hmc_step launch per warm-up
    # step, one for the 150 draws.
    launches = hmc_ops.LAUNCHES["hmc_step"]
    t0 = time.time()
    with counting_calls(_Density, ("__init__", "value", "grad", "grad_and_value")) as density:
        hmc = HamiltonianMCDA(ecoli)
        samples = hmc.sample(mu.copy(), num_adapt=50, num_samples=150, trajectory_length=3.0,
                             stepsize=0.17, n_chains=HMC_CHAINS, seed=SEED, return_type="array")
    run_s = time.time() - t0
    launches = hmc_ops.LAUNCHES["hmc_step"] - launches
    check(launches == 50 + 1, f"hmcda: {launches} hmc_step launches for 50 warm-up steps + 1")
    check(density["calls"] == 0, f"hmcda: {density['calls']} torch.func density calls")
    check(samples.shape == (150, HMC_CHAINS, dim), f"hmc samples {samples.shape}")
    check(0.3 < hmc.acceptance_rate <= 1.0, f"hmc acceptance rate {hmc.acceptance_rate}")
    moments = moment_check("hmcda", samples[30:].reshape(-1, dim).astype(np.float64), mu, cov,
                           HMC_CHAINS)
    log(f"hmcda_ecoli70 chains={HMC_CHAINS} adapt=50 samples=150 trajectory_length=3.0 "
        f"run_s {run_s:.3f} samples_per_s {150 * HMC_CHAINS / run_s:.1f} acceptance_rate "
        f"{hmc.acceptance_rate:.4f} hmc_step_launches {launches} {moments}")
    return {"mean": mu, "cov": cov, "nuts": nuts, "positions": positions}


# K8's checks against the plain versions: float32 positions within 1e-4 of
# each chain's scale where the leapfrog counts (or accept flags) agree, at
# most 1 chain in 256 taking another; float64 all equal, within 1e-9
K8_F32_LIMIT, K8_F64_LIMIT = 1e-4, 1e-9
K8_PAST_STABLE = 0.3  # ecoli70's leapfrog is stable below 0.294
HMC_TIMED = (64, 150, 17)  # the HMC path's draw launch: chains, transitions, steps (3.0 / 0.17)
# nuts_step's timed shapes: the MCMC path's chains, and one of the multi-device
# path's 4 shards
K8_NUTS_SHAPES = (NUTS_CHAINS, NUTS_CHAINS // 4)


def k8_case(name, got, want, same, dtype, n):
    """Hold one K8 kernel result to its plain version; returns the max abs
    error of the positions where ``same``."""
    differ = int((~same).sum())
    scale = want.abs().amax(dim=-1, keepdim=True).clamp_min(1.0)
    rel = float(((got - want).abs() / scale)[..., same, :].max())
    err = float((got - want).abs()[..., same, :].max())
    limit = K8_F64_LIMIT if dtype == torch.float64 else K8_F32_LIMIT
    most = 0 if dtype == torch.float64 else n // 256
    check(differ <= most and rel <= limit,
          f"k8 {name} {dtype}: {differ} chains differ (most {most}), positions max rel err "
          f"{rel:.3e} (limit {limit})")
    return err, rel, differ


def k8_kernel_rows(context):
    """K8 on ecoli70: both kernels against their plain versions on explicit
    noise (float32 and float64; NUTS at 1,024 chains at the run's step size
    and past stability, HMC at 64 chains, 3 transitions of 17 steps), each
    timed at the paths' shapes (``nuts_step`` at 1,024 chains and a shard's
    256, ``hmc_step`` at the draws' launch; single calls behind a device
    sleep, median of 20, in turns with the parent commit's kernel where it
    was unpacked; the plain versions' median of 5) beside its bound."""
    from pgmpy_tpu_torch.ops import hmc as hmc_ops
    from pgmpy_tpu_torch.utils.mathext import seeded_generator

    nuts, positions = context["nuts"], context["positions"]
    md, eps = nuts.max_depth, nuts.final_stepsize
    n, dim = positions.shape
    errs = {}
    for dtype in (torch.float32, torch.float64):
        target = hmc_ops.GaussianTarget(context["mean"], np.linalg.inv(context["cov"]),
                                                        dtype=dtype)
        z = positions.to(dtype)
        for step in (eps, K8_PAST_STABLE):
            noise = hmc_ops.nuts_noise(n, dim, md, seeded_generator(SEED), dtype)
            got = hmc_ops.nuts_step_cuda(target, z, step, md, noise)
            want = hmc_ops.nuts_step_reference(target, z, step, md, noise)
            same = ((got.leapfrogs == want.leapfrogs) & (got.turned == want.turned)
                    & (got.diverged == want.diverged))
            err, rel, differ = k8_case("nuts_step", got.z, want.z, same, dtype, n)
            acc = float((got.accept - want.accept).abs()[same].max())
            check(acc <= (K8_F64_LIMIT if dtype == torch.float64 else K8_F32_LIMIT),
                  f"k8 nuts_step {dtype}: acceptance statistics off by {acc}")
            errs[("nuts", dtype, step)] = err
            log(f"k8 nuts_step check {dtype} eps {step:.4f}: chains with another leapfrog count "
                f"or flag {differ} of {n}; positions max_abs_err {err:.3e} max_rel_err {rel:.3e}; "
                f"acceptance max_abs_err {acc:.3e}; diverged {int(want.diverged.sum())} turned "
                f"{int(want.turned.sum())} mean_leapfrogs {float(want.leapfrogs.float().mean()):.2f}")
        chains, _, steps = HMC_TIMED
        gen = seeded_generator(SEED)
        noise = hmc_ops.HmcNoise(
            torch.randn((3, chains, dim), generator=gen, dtype=dtype, device=z.device),
            torch.rand((3, chains), generator=gen, dtype=dtype, device=z.device))
        got = hmc_ops.hmc_step_cuda(target, z[:chains], 0.17, steps, noise, transitions=3)
        want = hmc_ops.hmc_step_reference(target, z[:chains], 0.17, steps, noise, transitions=3)
        same = (got.accepted == want.accepted).all(dim=0)
        err, rel, differ = k8_case("hmc_step", got.z, want.z, same, dtype, chains)
        errs[("hmc", dtype)] = err
        log(f"k8 hmc_step check {dtype}: chains accepted otherwise {differ} of {chains}; "
            f"positions max_abs_err {err:.3e} max_rel_err {rel:.3e}; accepted "
            f"{float(want.accepted.float().mean()):.3f}")

    target = nuts.log_pdf
    parent_hmc = PARENT.get("modules", {}).get("hmc")
    parent_target = None if parent_hmc is None else parent_hmc.GaussianTarget(
        target.mean.cpu().numpy(), target.precision.cpu().double().numpy(), dtype=target.dtype,
        device=target.device)
    gen = seeded_generator(SEED)
    shapes = []
    for chains in K8_NUTS_SHAPES:
        start = positions[:chains].contiguous()
        leapfrogs = hmc_ops.nuts_step_cuda(target, start, eps, md, gen=gen).leapfrogs
        parent = None if parent_hmc is None else (
            lambda start=start: parent_hmc.nuts_step_cuda(parent_target, start, eps, md, gen=gen))
        ms, parent_ms, runs = paired_ms(
            lambda start=start: hmc_ops.nuts_step_cuda(target, start, eps, md, gen=gen), parent)
        plain_ms = cuda_median_ms(lambda start=start: hmc_ops.nuts_step_reference(
            target, start, eps, md, gen=gen), reps=5, warmup=1)
        bound_ms, bound_by = hmc_ops.nuts_bound_ms(target, leapfrogs)
        total = int(leapfrogs.sum())
        log(f"k8 nuts_step chains={chains} dim={dim} max_depth={md} eps={eps:.4f} "
            f"leapfrogs={total} (mean {total / chains:.2f}, most {int(leapfrogs.max())}) "
            f"register_form={hmc_ops.plan('nuts_step', dim, target.dtype, md)[3]} "
            f"kernel_ms={ms:.5f} parent_ms="
            f"{'not timed' if parent_ms is None else f'{parent_ms:.5f}'} (device time, Philox, "
            f"each the smaller median of 20 of two turns: " + "/".join(f"{t:.5f}" for t in runs)
            + f") plain_ms={plain_ms:.3f} (median of 5) bound_ms={bound_ms:.6f} ({bound_by}; "
            f"2 dim^2 + 12 dim per leapfrog and start gradient at 67e12/s) library: none")
        shapes.append({"name": f"ecoli70_{chains}", "chains": chains, "ms": ms,
                       "parent_ms": parent_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by})
    rows = {"hmc/nuts_step": {"err": errs[("nuts", torch.float32, eps)],
                              **{key: shapes[0][key] for key in ("ms", "parent_ms", "plain_ms",
                                                                 "bound_ms", "bound_by")},
                              "library_ms": None, "shapes": shapes}}

    chains, transitions, steps = HMC_TIMED
    start = positions[:chains].contiguous()
    parent = None if parent_hmc is None else (lambda: parent_hmc.hmc_step_cuda(
        parent_target, start, 0.17, steps, gen=gen, transitions=transitions))
    ms, parent_ms, runs = paired_ms(lambda: hmc_ops.hmc_step_cuda(
        target, start, 0.17, steps, gen=gen, transitions=transitions), parent)
    plain_ms = cuda_median_ms(lambda: hmc_ops.hmc_step_reference(
        target, start, 0.17, steps, gen=gen, transitions=transitions), reps=5, warmup=1)
    bound_ms, bound_by = hmc_ops.hmc_bound_ms(target, chains, steps, transitions)
    log(f"k8 hmc_step chains={chains} dim={dim} transitions={transitions} n_steps={steps} "
        f"kernel_ms={ms:.5f} parent_ms={'not timed' if parent_ms is None else f'{parent_ms:.5f}'} "
        f"(device time, Philox, each the smaller median of 20 of two turns: "
        + "/".join(f"{t:.5f}" for t in runs) + f") plain_ms={plain_ms:.3f} (median of 5) "
        f"bound_ms={bound_ms:.6f} ({bound_by}) library: none")
    rows["hmc/hmc_step"] = {"err": errs[("hmc", torch.float32)], "ms": ms, "parent_ms": parent_ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": None}
    return rows


def phase_mcmc(model):
    """The MCMC lane; returns the (table-count, bincount) launches it made."""
    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.ops import bincount as bc

    reset_launches()
    gibbs, init = phase_gibbs_munin(model)
    phase_gibbs_hepar2()
    nuts_context = phase_nuts_ecoli70()
    check(config.DEVICE.type == "cuda", "device left on the CPU")
    launches = bc.TABLE_LAUNCHES, bc.LAUNCHES
    record_jt("mcmc")
    counts = GATHER_PATH_LAUNCHES["mcmc"]
    log(f"mcmc_path table_count_launches {launches[0]} bincount_launches {launches[1]} "
        f"(no module of the lane counts) gibbs_sweep_launches {counts['gibbs/sweep']} (one per "
        f"sweep) nuts_step_launches {counts['hmc/nuts_step']} (one per transition) "
        f"hmc_step_launches {counts['hmc/hmc_step']} (one per warm-up step, one per sample call)")
    GATHER_ROWS["gibbs/sweep"] = k6_kernel_row(gibbs, init)
    GATHER_ROWS.update(k8_kernel_rows(nuts_context))
    return launches


# --------------------------------------------------------------------------- #
# the temporal lane: DynamicBayesianNetwork, DBNInference, the particle filter
# --------------------------------------------------------------------------- #
PF_PARTICLES = 16_384
PF_SLICES = 200
ALARM_PARTICLES = 262_144
ALARM_SLICES = 50
ALARM_PERSISTENT = 6
ALARM_EVIDENCE_LEAVES = 3
DBN_SIM_ROWS = 2000
DBN_SIM_SLICES = 4


def rain_umbrella_dbn():
    from pgmpy_tpu_torch.factors import TabularCPD
    from pgmpy_tpu_torch.models import DynamicBayesianNetwork

    dbn = DynamicBayesianNetwork()
    dbn.add_edges_from([(("rain", 0), ("umbrella", 0)), (("rain", 0), ("rain", 1))])
    dbn.add_cpds(
        TabularCPD(("rain", 0), 2, [[0.5], [0.5]]),
        TabularCPD(("umbrella", 0), 2, [[0.8, 0.1], [0.2, 0.9]],
                   evidence=[("rain", 0)], evidence_card=[2]),
        TabularCPD(("rain", 1), 2, [[0.7, 0.3], [0.3, 0.7]],
                   evidence=[("rain", 0)], evidence_card=[2]),
        TabularCPD(("umbrella", 1), 2, [[0.8, 0.1], [0.2, 0.9]],
                   evidence=[("rain", 1)], evidence_card=[2]),
    )
    return dbn


def alarm_2tbn(alarm, n_persistent):
    """A 2-TBN of ALARM's width: ALARM's edges and CPDs inside each slice, and
    for the first ``n_persistent`` root nodes (in sorted order) an edge
    ``(v, 0) -> (v, 1)`` whose CPD is ``0.9 I + 0.1 prior(v)``.  Returns the
    network, the persistent nodes and their transition tables."""
    from pgmpy_tpu_torch.factors import TabularCPD
    from pgmpy_tpu_torch.models import DynamicBayesianNetwork

    roots = sorted((v for v in alarm.nodes() if not alarm.get_parents(v)), key=str)
    persistent = roots[:n_persistent]
    dbn = DynamicBayesianNetwork()
    dbn.add_nodes_from(sorted(alarm.nodes(), key=str))
    dbn.add_edges_from(((u, 0), (v, 0)) for u, v in alarm.edges())
    dbn.add_edges_from(((v, 0), (v, 1)) for v in persistent)
    cpds, transitions = [], {}
    for t in (0, 1):
        for cpd in alarm.get_cpds():
            var = cpd.variable
            values = cpd.get_values().astype(np.float64)
            evidence = [(p, t) for p in cpd.variables[1:]]
            evidence_card = [int(c) for c in cpd.cardinality[1:]]
            names = {(v, t): cpd.state_names[v] for v in cpd.variables}
            if t == 1 and var in persistent:
                card = cpd.variable_card
                values = 0.9 * np.eye(card) + 0.1 * values.reshape(card, 1)
                transitions[var] = values
                evidence, evidence_card = [(var, 0)], [card]
                names[(var, 0)] = cpd.state_names[var]
            cpds.append(TabularCPD((var, t), cpd.variable_card, values, evidence=evidence or None,
                                   evidence_card=evidence_card or None, state_names=names))
    dbn.add_cpds(*cpds)
    return dbn, persistent, transitions


def dbn_trajectory(dbn, n_slices, seed):
    """One trajectory {(name, t): state index} of a 2-TBN, drawn with numpy:
    slice 0 from the slice-0 CPDs, every later slice from the slice-1 CPDs."""
    import networkx as nx

    rng = np.random.default_rng(seed)
    order = {t: [n for n in nx.topological_sort(dbn) if n[1] == t] for t in (0, 1)}
    out = {}
    for t in range(n_slices):
        local = 0 if t == 0 else 1
        for node in order[local]:
            cpd = dbn.get_cpds(node)
            col = 0
            for parent in cpd.variables[1:]:
                state = out[(parent[0], t - (local - parent[1]))]
                col = col * len(cpd.state_names[parent]) + state
            column = cpd.get_values()[:, col].astype(np.float64)
            out[(node[0], t)] = int(rng.choice(cpd.variable_card, p=column / column.sum()))
    return out


def filter_check(name, marginals, ess, exact, variables, n_slices, n_particles, lineage=False):
    """Filtered marginals against the exact filter: 5 standard errors at the
    slice's effective sample size, plus 1e-4.  With ``lineage`` the sample
    size of a slice is the smallest one up to it: a variable that persists
    from slice to slice is inherited through every resampling, so after a
    slice that left few effective particles the ones read later overstate how
    many independent histories the population still holds."""
    check(ess.shape == (n_slices,) and bool(((ess > 0) & (ess <= n_particles * (1 + 1e-5))).all()),
          f"{name}: effective sample sizes outside (0, n]: {ess.min()} .. {ess.max()}")
    if lineage:
        ess = np.minimum.accumulate(ess)
    worst = 0.0
    for v in variables:
        for t in range(n_slices):
            got, want = marginals[(v, t)].astype(np.float64), exact[(v, t)].astype(np.float64)
            check(bool(np.isfinite(got).all()), f"{name}: marginal of {(v, t)} is not finite")
            limit = 5 * np.sqrt(want * (1 - want) / ess[t]) + 1e-4
            check(bool((np.abs(got - want) <= limit).all()),
                  f"{name}: marginal of {(v, t)} {got} against exact {want} (ess {ess[t]})")
            worst = max(worst, float((np.abs(got - want) / limit).max()))
    return worst


def phase_temporal():
    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.inference import DBNInference
    from pgmpy_tpu_torch.models import DynamicBayesianNetwork
    from pgmpy_tpu_torch.ops import ancestral, einsum
    from pgmpy_tpu_torch.ops import bincount as bc
    from pgmpy_tpu_torch.sampling.smc import ParticleFilter
    from pgmpy_tpu_torch.utils import get_example_model

    # ---- build: the repo's own filter configuration, and ALARM as a 2-TBN
    rain = rain_umbrella_dbn()
    rain_ev = {("umbrella", t): t % 2 for t in range(0, PF_SLICES, 3)}
    rain_pf = ParticleFilter(rain, n_particles=PF_PARTICLES)
    alarm = get_example_model("alarm")
    t0 = time.time()
    dbn, persistent, transitions = alarm_2tbn(alarm, ALARM_PERSISTENT)
    leaves = sorted((v for v in alarm.nodes() if not alarm.get_children(v)),
                    key=str)[:ALARM_EVIDENCE_LEAVES]
    truth = dbn_trajectory(dbn, ALARM_SLICES, SEED)
    alarm_ev = {(v, t): truth[(v, t)] for v in leaves for t in range(ALARM_SLICES)}
    alarm_pf = ParticleFilter(dbn, n_particles=ALARM_PARTICLES)
    alarm_infer = DBNInference(dbn)
    torch.cuda.synchronize()
    log(f"alarm_2tbn variables={len(alarm.nodes())} persistent={persistent} evidence_on={leaves} "
        f"build_s {time.time() - t0:.3f}")

    # ---- the main path, counted: filter twice, simulate, fit
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    rain_marg, rain_particles, rain_ess = rain_pf.filter(rain_ev, n_time_slices=PF_SLICES, seed=SEED)
    rain_first_s = time.time() - t0
    check(bc.TABLE_LAUNCHES == PF_SLICES, f"rain filter made {bc.TABLE_LAUNCHES} count launches")
    t0 = time.time()
    alarm_marg, alarm_particles, alarm_ess = alarm_pf.filter(
        alarm_ev, n_time_slices=ALARM_SLICES, seed=SEED)
    alarm_first_s = time.time() - t0
    check(bc.TABLE_LAUNCHES == PF_SLICES + ALARM_SLICES,
          f"alarm filter made {bc.TABLE_LAUNCHES - PF_SLICES} count launches")
    check(ancestral.PARTICLE_LAUNCHES == PF_SLICES + ALARM_SLICES,
          f"the filters made {ancestral.PARTICLE_LAUNCHES} slice sweeps for "
          f"{PF_SLICES + ALARM_SLICES} slices")
    t0 = time.time()
    frame = dbn.simulate(n_samples=DBN_SIM_ROWS, n_time_slices=DBN_SIM_SLICES, seed=SEED,
                         show_progress=False)
    torch.cuda.synchronize()
    dbn_simulate_s = time.time() - t0
    learned = DynamicBayesianNetwork()
    learned.add_nodes_from(sorted(alarm.nodes(), key=str))
    learned.add_edges_from(dbn.edges())
    before = bc.TABLE_LAUNCHES
    t0 = time.time()
    # every slice pair after the first replaces the CPDs of the one before,
    # and the network says so once per CPD
    port_logger = logging.getLogger("pgmpy_tpu_torch")
    level = port_logger.level
    port_logger.setLevel(logging.ERROR)
    try:
        learned.fit(frame)
    finally:
        port_logger.setLevel(level)
    torch.cuda.synchronize()
    dbn_fit_s = time.time() - t0
    fit_launches = bc.TABLE_LAUNCHES - before
    # the exact filters: one filter_scan launch per forward_scan call (K10)
    rain_infer = DBNInference(rain)
    exact = rain_infer.forward_scan(["rain"], rain_ev, n_time_slices=PF_SLICES)
    check(einsum.SCAN_LAUNCHES == 1, f"rain's forward_scan made {einsum.SCAN_LAUNCHES} "
          f"filter_scan launches")
    warm = alarm_infer.forward_scan(persistent, alarm_ev, n_time_slices=2)  # plans
    check(len(warm) == 2 * len(persistent), "forward_scan of two slices")
    torch.cuda.synchronize()
    t0 = time.time()
    alarm_exact = alarm_infer.forward_scan(persistent, alarm_ev, n_time_slices=ALARM_SLICES)
    scan_s = time.time() - t0
    check(einsum.SCAN_LAUNCHES == 3, f"three forward_scan calls made {einsum.SCAN_LAUNCHES} "
          f"filter_scan launches")
    table_launches, bincount_launches = bc.TABLE_LAUNCHES, bc.LAUNCHES
    record_jt("temporal")
    check(fit_launches == DBN_SIM_SLICES - 1,
          f"DynamicBayesianNetwork.fit made {fit_launches} count launches for "
          f"{DBN_SIM_SLICES - 1} slice pairs")
    log(f"temporal_path table_count_launches {table_launches} (rain filter {PF_SLICES}, alarm "
        f"filter {ALARM_SLICES}, dbn fit {fit_launches}) bincount_launches {bincount_launches} "
        f"slice_sweep_launches {GATHER_PATH_LAUNCHES['temporal']['ancestral/particle_sweep']} "
        f"(one per slice)")

    # ---- rain / umbrella: against the exact filter, the same seed, the CPU run
    with on_device("cpu"):
        cpu_exact = DBNInference(rain_umbrella_dbn()).forward_scan(
            ["rain"], rain_ev, n_time_slices=PF_SLICES)
    scan_err = max(float(np.abs(exact[k] - cpu_exact[k]).max()) for k in exact)
    check(scan_err <= 1e-5, f"forward_scan against the CPU run: {scan_err}")
    plain = rain_infer._forward_scan(["rain"], rain_ev, PF_SLICES, kernel=False)
    rain_plain_err = max(float(np.abs(exact[k] - plain[k]).max()) for k in exact)
    check(set(plain) == set(exact) and rain_plain_err <= 1e-5,
          f"rain forward_scan against the plain version on the card: {rain_plain_err}")
    check(rain_particles.shape == (PF_PARTICLES, 2), f"final particles {rain_particles.shape}")
    margin = filter_check("rain", rain_marg, rain_ess, exact, ["rain"], PF_SLICES, PF_PARTICLES)
    again = rain_pf.filter(rain_ev, n_time_slices=PF_SLICES, seed=SEED)
    # the particles and the effective sample sizes are equal bit for bit; the
    # marginals are float sums that the count kernel adds with atomics, in an
    # order that differs from run to run
    check(np.array_equal(rain_particles, again[1]) and np.array_equal(rain_ess, again[2]),
          "particle filter: the same seed gave other particles or sample sizes")
    drift = max(float(np.abs(rain_marg[k] - again[0][k]).max()) for k in rain_marg)
    check(drift <= 1e-5, f"particle filter: the same seed moved a marginal by {drift}")
    other = rain_pf.filter(rain_ev, n_time_slices=PF_SLICES, seed=SEED + 1)
    check(not np.array_equal(rain_particles, other[1]), "particle filter: another seed, same result")
    rain_s = host_median_s(lambda: rain_pf.filter(rain_ev, n_time_slices=PF_SLICES, seed=SEED))
    # one profiling session for each of this phase's long runs (a lower bound
    # on their kernels): three took minutes of host time
    kernels, device_ms = profiled(
        lambda: rain_pf.filter(rain_ev, n_time_slices=PF_SLICES, seed=SEED), sessions=1)
    log(f"particle_filter_rain particles={PF_PARTICLES} slices={PF_SLICES} filter_s {rain_s:.4f} "
        f"(median of 3; first call {rain_first_s:.4f}) particle_steps_per_s "
        f"{PF_PARTICLES * PF_SLICES / rain_s:.1f} kernels_per_slice {kernels / PF_SLICES:.1f} "
        f"device_ms_per_slice {device_ms / PF_SLICES:.4f} idle_share "
        f"{1 - device_ms / (rain_s * 1e3):.3f} min_ess {rain_ess.min():.1f}")
    log(f"particle_filter_rain_check ok 200 filtered marginals of rain within 5 standard errors at "
        f"the slice's effective sample size + 1e-4 of forward_scan (largest share of the limit "
        f"{margin:.3f}), same seed: particles and sample sizes equal, marginals within "
        f"{drift:.3e} (float atomics; limit 1e-5), forward_scan_vs_cpu max_abs_err "
        f"{scan_err:.3e} (limit 1e-5), forward_scan_vs_plain_on_card max_abs_err "
        f"{rain_plain_err:.3e} (limit 1e-5)")

    # ---- ALARM 2-TBN: the exact filter, then the particle filter against it
    exact = alarm_exact
    plain = alarm_infer._forward_scan(persistent, alarm_ev, ALARM_SLICES, kernel=False)
    alarm_plain_err = max(float(np.abs(exact[k] - plain[k]).max()) for k in exact)
    check(set(plain) == set(exact) and alarm_plain_err <= 1e-5,
          f"ALARM forward_scan against the plain version on the card: {alarm_plain_err}")
    # the kernels of a whole call do not grow with the slices: both counts
    # from a process of its own (see fresh_profile), with this process's
    # (lower bounds) beside them
    (scan_kernels, scan_device_ms), (warm_kernels, _) = (fresh_profile()[key]
                                                         for key in ("scan", "scan_2"))
    here = [profiled(lambda: alarm_infer.forward_scan(persistent, alarm_ev,
                                                      n_time_slices=slices))[0]
            for slices in (ALARM_SLICES, 2)]
    check(scan_kernels == warm_kernels, f"forward_scan: {scan_kernels} kernels for "
          f"{ALARM_SLICES} slices, {warm_kernels} for 2")
    log(f"forward_scan_alarm slices={ALARM_SLICES} queries={len(persistent)} scan_s {scan_s:.4f} "
        f"forward_scan_slices_per_s {(ALARM_SLICES - 1) / scan_s:.1f} kernels_per_slice "
        f"{scan_kernels / (ALARM_SLICES - 1):.1f} device_ms_per_slice "
        f"{scan_device_ms / (ALARM_SLICES - 1):.4f} idle_share "
        f"{1 - scan_device_ms / (scan_s * 1e3):.3f} kernels_per_call {scan_kernels:.0f} (the "
        f"2-slice call: {warm_kernels:.0f}; one filter_scan launch a call; in this process "
        f"{here[0]:.0f} and {here[1]:.0f}) "
        f"forward_scan_vs_plain_on_card max_abs_err {alarm_plain_err:.3e} (limit 1e-5)")
    check(alarm_particles.shape == (ALARM_PARTICLES, len(alarm.nodes())),
          f"final particles {alarm_particles.shape}")
    margin = filter_check("alarm", alarm_marg, alarm_ess, exact, persistent, ALARM_SLICES,
                          ALARM_PARTICLES, lineage=True)
    for (v, t), code in alarm_ev.items():
        check(abs(float(alarm_marg[(v, t)][code]) - 1) <= 1e-3,
              f"alarm: the marginal of observed {(v, t)} is {alarm_marg[(v, t)]}")
    alarm_s = host_median_s(
        lambda: alarm_pf.filter(alarm_ev, n_time_slices=ALARM_SLICES, seed=SEED), reps=2)
    kernels, device_ms = profiled(
        lambda: alarm_pf.filter(alarm_ev, n_time_slices=ALARM_SLICES, seed=SEED), sessions=1)
    log(f"particle_filter_alarm particles={ALARM_PARTICLES} slices={ALARM_SLICES} filter_s "
        f"{alarm_s:.4f} (median of 2; first call {alarm_first_s:.4f}) particle_steps_per_s "
        f"{ALARM_PARTICLES * ALARM_SLICES / alarm_s:.1f} kernels_per_slice "
        f"{kernels / ALARM_SLICES:.1f} device_ms_per_slice {device_ms / ALARM_SLICES:.4f} "
        f"idle_share {1 - device_ms / (alarm_s * 1e3):.3f} "
        f"min_ess {alarm_ess.min():.1f} resampled_slices "
        f"{int((alarm_ess < alarm_pf.ess_threshold * ALARM_PARTICLES).sum())}")
    log(f"particle_filter_alarm_check ok {len(persistent) * ALARM_SLICES} filtered marginals of "
        f"the persistent nodes within 5 standard errors (at the smallest effective sample size "
        f"so far) + 1e-4 of forward_scan (largest share of the limit {margin:.3f}), ess in "
        f"(0, n], observed leaves at their evidence")

    # ---- K1 at the filter's shape: the weighted marginals of one slice
    n, specs = ALARM_PARTICLES, alarm_pf._marginal_specs
    cm = bc.column_major_codes(torch.as_tensor(alarm_particles, device="cuda"),
                               max(alarm_pf.cards.values()))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    w = torch.softmax(torch.randn(n, generator=gen, device="cuda", dtype=config.DTYPE), dim=0)
    got = bc.table_counts_cuda(cm, n, specs, w)
    ref = bc.table_counts_reference(cm, n, specs, w.double())
    torch.cuda.synchronize()
    err = float((got.double() - ref).abs().max())
    check(got.dtype == w.dtype and torch.allclose(got.double(), ref, rtol=1e-5, atol=0),
          f"k1t particle marginals: max_abs_err {err}")
    nbytes = cm.shape[0] * n * cm.element_size() + n * w.element_size() + specs.total * 4 \
        + 8 * len(specs) * (6 + 2 * specs.cols.shape[1])
    bound_ms, bound_by = bound(nbytes, 2 * int(specs.n_cols.sum()) * n)
    # the library call: one torch.bincount over every spec's column offset
    # into one index space, the weights repeated once per spec (the index is
    # built outside the timed window)
    check(bool((specs.n_cols == 1).all()), "particle marginals: a spec of several columns")
    cols = torch.as_tensor(specs.cols[:, 0], device="cuda")
    offsets = torch.as_tensor(specs.offsets, device="cuda")
    flat_idx = (cm[cols, :n].long() + offsets[:, None]).reshape(-1)
    flat_w = w.repeat(len(specs))
    lib = torch.bincount(flat_idx, weights=flat_w, minlength=specs.total)
    check(lib.numel() == specs.total and torch.allclose(lib.double(), ref, rtol=1e-5, atol=0),
          "particle marginals: torch.bincount differs from the plain version")
    weighted = {
        "err": err,
        "ms": cuda_median_ms(lambda: bc.table_counts_cuda(cm, n, specs, w), device_only=True),
        "plain_ms": cuda_median_ms(lambda: bc.table_counts_reference(cm, n, specs, w),
                                   reps=5, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        # torch.bincount reads its input's maximum back: no device sleep
        "library_ms": cuda_median_ms(
            lambda: torch.bincount(flat_idx, weights=flat_w, minlength=specs.total)),
    }
    host_us = []
    for _ in range(20):
        t0 = time.perf_counter()
        bc.table_counts_cuda(cm, n, specs, w)
        host_us.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    log(f"k1t particle_marginals specs={len(specs)} rows={n} codes={cm.dtype} weights={w.dtype} "
        f"max_abs_err={err:.3e} (rtol 1e-5 against the f64 plain version) kernel_ms="
        f"{weighted['ms']:.5f} plain_ms={weighted['plain_ms']:.4f} bound_ms={bound_ms:.6f} "
        f"({bound_by}) torch_bincount_ms={weighted['library_ms']:.5f} (one call over the "
        f"{len(specs)} columns offset into one index space, weights repeated) "
        f"wrapper_host_us_median {float(np.median(host_us)):.1f} (descriptor uploaded once)")
    GATHER_ROWS["ancestral/particle_sweep"] = k9_kernel_row(alarm_pf, alarm_particles, alarm_ev)
    GATHER_ROWS["einsum_plan/filter_scan"] = k10_kernel_row(alarm_infer, persistent, alarm_ev,
                                                            rain_infer, rain_ev)

    # ---- simulate and fit of the 2-TBN
    check(set(frame.columns) == {(v, t) for v in alarm.nodes() for t in range(DBN_SIM_SLICES)}
          and len(frame) == DBN_SIM_ROWS, f"dbn simulate frame {frame.shape}")
    check(learned.check_model(), "fitted 2-TBN invalid")
    worst = 0.0
    for v in persistent:
        cpd = learned.get_cpds((v, 1))
        check([tuple(p) for p in cpd.variables[1:]] == [(v, 0)], f"fitted parents of {(v, 1)}")
        names = cpd.state_names[(v, 1)]
        order = [alarm.states[v].index(s) for s in names]
        true = transitions[v][np.ix_(order, order)]
        true = true / true.sum(axis=0, keepdims=True)
        seen = np.zeros(len(names))
        for t in range(DBN_SIM_SLICES - 1):
            seen += np.array([(frame[(v, t)] == s).sum() for s in names])
        got = cpd.get_values().astype(np.float64)
        limit = 5 * np.sqrt(true * (1 - true) / seen[None, :]) + 1e-3
        check(bool((np.abs(got - true) <= limit).all()),
              f"fitted transition CPD of {v} {got} against {true} (parent counts {seen})")
        worst = max(worst, float((np.abs(got - true) / limit).max()))
    log(f"dbn_simulate_fit rows={DBN_SIM_ROWS} slices={DBN_SIM_SLICES} dbn_simulate_s "
        f"{dbn_simulate_s:.4f} dbn_fit_s {dbn_fit_s:.4f} table_count_launches {fit_launches} "
        f"transition CPDs of {len(persistent)} persistent nodes within 5 standard errors + 1e-3 "
        f"of the true ones (largest share of the limit {worst:.3f})")
    check(config.DEVICE.type == "cuda", "device left on the CPU")
    return (table_launches, bincount_launches), weighted, ALARM_SLICES


# --------------------------------------------------------------------------- #
# score-based structure search: HillClimbSearch on ALARM, Chow-Liu on MUNIN
# --------------------------------------------------------------------------- #
HILLCLIMB_ROWS = 2000
TREE_CHECKED_PAIRS = 200


def bic_from_codes(codes, cards, variable, parents):
    """The BIC local score from numpy counts, in float64."""
    n_cols = int(np.prod([cards[p] for p in parents])) if parents else 1
    flat = codes[variable] * n_cols
    stride = 1
    for p in reversed(parents):
        flat = flat + codes[p] * stride
        stride *= cards[p]
    counts = np.bincount(flat, minlength=cards[variable] * n_cols).reshape(cards[variable], n_cols)
    counts = counts.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        ll = np.where(counts > 0, counts * np.log(counts / counts.sum(axis=0, keepdims=True)), 0.0)
    return float(ll.sum() - 0.5 * np.log(counts.sum()) * n_cols * (cards[variable] - 1))


def cuda_profiled_ms(fn):
    """Device ms of ``fn`` from ``torch.profiler`` tracing the card alone (no
    host events: ``fn`` is a long Python loop); of three sessions, the one
    with the most records (see :func:`profiled`)."""
    best, counts = (0, 0.0), []
    for _ in range(3):
        with profile_session(device_only=True) as prof:
            fn()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        counts.append(len(kernels))
        best = max(best, (len(kernels), sum(e.time_range.elapsed_us() for e in kernels)))
    count_sessions(counts)
    return best[1] / 1e3


def phase_structure(munin_df):
    import networkx as nx

    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.estimators import BIC, HillClimbSearch, ScoreCache, TreeSearch
    from pgmpy_tpu_torch.estimators.tree_search import pairwise_mutual_info
    from pgmpy_tpu_torch.ops import bincount as bc
    from pgmpy_tpu_torch.utils import get_example_model

    alarm = get_example_model("alarm")
    frame = alarm.simulate(n_samples=HILLCLIMB_ROWS, seed=3, show_progress=False)
    torch.cuda.synchronize()

    # iterations whose dry run found a spec the cache did not hold
    primed = []
    real_prime = ScoreCache.prime

    def counting_prime(self, specs):
        keys = {(v, tuple(sorted(ps, key=str))) for v, ps in specs}
        primed.append(len(keys - set(self._cache.keys())))
        real_prime(self, specs)

    # ---- the main path, counted: one hill climb, one Chow-Liu tree
    reset_launches()
    scorer = BIC(frame)
    ScoreCache.prime = counting_prime
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        dag = HillClimbSearch(frame).estimate(scoring_method=scorer, show_progress=False)
        torch.cuda.synchronize()
        hillclimb_s = time.time() - t0
    finally:
        ScoreCache.prime = real_prime
    dispatches, hill_launches = scorer._coded.n_dispatches, bc.TABLE_LAUNCHES
    uncached_iterations = sum(1 for n in primed if n)
    check(dispatches == uncached_iterations,
          f"hill climb: {dispatches} dispatches in {uncached_iterations} iterations with uncached "
          f"specs")
    check(hill_launches == dispatches, f"hill climb: {hill_launches} launches, {dispatches} dispatches")
    t0 = time.time()
    search = TreeSearch(munin_df)
    torch.cuda.synchronize()
    tree_coding_s = time.time() - t0
    t0 = time.time()
    tree = search.estimate(estimator_type="chow-liu", show_progress=False)
    treesearch_s = time.time() - t0
    timings = dict(search.timings)
    check(bc.TABLE_LAUNCHES == hill_launches + 1 and search._coded.n_dispatches == 1,
          f"Chow-Liu made {bc.TABLE_LAUNCHES - hill_launches} count launches")
    table_launches, bincount_launches = bc.TABLE_LAUNCHES, bc.LAUNCHES
    record_jt("structure")
    log(f"structure_path table_count_launches {table_launches} (hill climb {hill_launches}, "
        f"Chow-Liu 1) bincount_launches {bincount_launches}")

    # ---- hill climb: against the CPU run and numpy scores
    with on_device("cpu"):
        cpu_dag = HillClimbSearch(frame).estimate(scoring_method="bic-d", show_progress=False)
    check(sorted(dag.edges()) == sorted(cpu_dag.edges()),
          "hill climb: the card and the CPU learned different DAGs")
    check(nx.is_directed_acyclic_graph(dag) and set(dag.nodes()) == set(alarm.nodes()),
          "hill climb: not a DAG over ALARM's variables")
    variables = list(frame.columns)
    first = [(v, []) for v in variables] + [(v, [u]) for v in variables for u in variables if u != v]
    check(primed[0] == len(first), f"the first iteration primed {primed[0]} specs, not {len(first)}")
    codes = {v: np.unique(frame[v].astype(str), return_inverse=True)[1] for v in variables}
    cards = {v: int(codes[v].max()) + 1 for v in variables}
    got = np.array(scorer.local_scores_batch(first))
    want = np.array([bic_from_codes(codes, cards, v, ps) for v, ps in first])
    score_err = float((np.abs(got - want) / np.abs(want)).max())
    check(score_err <= 1e-9, f"first-iteration scores against numpy counts: {score_err}")
    true_skeleton = {frozenset(e) for e in alarm.edges()}
    found = {frozenset(e) for e in dag.edges()}
    device_ms = cuda_profiled_ms(
        lambda: HillClimbSearch(frame).estimate(scoring_method=BIC(frame), show_progress=False))
    log(f"hillclimb_alarm rows={HILLCLIMB_ROWS} hillclimb_s {hillclimb_s:.3f} iterations "
        f"{len(primed)} dispatches {dispatches} specs_first_launch {primed[0]} specs_per_launch "
        f"{sum(primed) / max(dispatches, 1):.1f} edges {len(dag.edges())} true_edges_found "
        f"{len(found & true_skeleton)}/{len(true_skeleton)} device_ms {device_ms:.3f} host_share "
        f"{1 - device_ms / (hillclimb_s * 1e3):.5f}")
    log(f"hillclimb_check ok DAG equal to the CPU run's, one launch per iteration with uncached "
        f"specs, {len(first)} first-iteration scores within {score_err:.3e} of numpy (limit 1e-9 "
        f"relative)")

    # ---- Chow-Liu: tables and mutual information against numpy, the tree
    n_vars = len(search.variables)
    check(len(tree.edges()) == n_vars - 1 and nx.is_tree(tree.to_undirected()),
          f"Chow-Liu: {len(tree.edges())} edges over {n_vars} variables, or not a tree")
    flat, table, pair_i, pair_j = search._pair_tables(list(search.variables))  # one more launch
    torch.cuda.synchronize()
    n_pairs = len(table)
    check(n_pairs == n_vars * (n_vars - 1) // 2, f"{n_pairs} pair tables")
    coded = search._coded
    host_codes = coded.codes.cpu().numpy()
    pair_cards = np.array([coded.cards[v] for v in search.variables])
    mi = pairwise_mutual_info(flat.cpu().numpy().astype(np.float64), pair_cards[pair_i],
                              pair_cards[pair_j])
    rng = np.random.default_rng(SEED)
    mi_err = 0.0
    for s in rng.choice(n_pairs, TREE_CHECKED_PAIRS, replace=False):
        a, b = int(pair_i[s]), int(pair_j[s])
        ca, cb = int(table.sizes[s]) // coded.cards[search.variables[b]], coded.cards[search.variables[b]]
        want = np.bincount(host_codes[:, a].astype(np.int64) * cb + host_codes[:, b],
                           minlength=ca * cb)
        part = flat[int(table.offsets[s]): int(table.offsets[s] + table.sizes[s])]
        check(torch.equal(part.cpu(), torch.from_numpy(want).to(torch.int32)),
              f"pair table {s} differs from numpy")
        pxy = want.reshape(ca, cb) / want.sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            terms = np.where(pxy > 0, pxy * np.log(pxy / (pxy.sum(1, keepdims=True)
                                                           * pxy.sum(0, keepdims=True))), 0.0)
        mi_err = max(mi_err, abs(float(terms.sum()) - mi[s]))
    check(mi_err <= 1e-9, f"mutual information against numpy: {mi_err}")

    # ---- K1 at this shape: the whole launch against the plain version
    cm = coded._column_codes()
    t0 = time.time()
    ref = bc.table_counts_reference(cm, coded.n, table)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    check(flat.dtype == torch.int32 and torch.equal(flat, ref),
          "pair tables differ from the plain version")
    check(int(flat.sum()) == coded.n * n_pairs, "pair tables: a row was dropped")
    del ref
    ms = cuda_median_ms(lambda: bc.table_counts_cuda(cm, coded.n, table), reps=5, warmup=1,
                        device_only=True)
    desc_bytes = 8 * n_pairs * (6 + 2 * table.cols.shape[1])
    nbytes = cm.shape[0] * coded.n * cm.element_size() + table.total * 4 + desc_bytes
    bound_ms, bound_by = bound(nbytes, 2 * int(table.n_cols.sum()) * coded.n)
    per_spec_bytes = int(table.n_cols.sum()) * coded.n * cm.element_size() + table.total * 4
    pairs = {"err": 0.0, "ms": ms, "plain_ms": plain_s * 1e3, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None}
    log(f"k1t pair_tables specs={n_pairs} rows={coded.n} codes={cm.dtype} entries={table.total} "
        f"descriptor_bytes={desc_bytes} equal to the plain version, kernel_ms={ms:.4f} (device "
        f"time, median of 5) plain_ms={plain_s * 1e3:.1f} (one run) bound_ms={bound_ms:.5f} "
        f"({bound_by}) bytes_if_each_spec_reads_its_columns {per_spec_bytes} at 3.35 TB/s "
        f"{per_spec_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms library_ms null (one torch.bincount "
        f"would take an index of {n_pairs * coded.n} int64 entries, "
        f"{n_pairs * coded.n * 8 / 1e9:.0f} GB, beyond the card's 80 GB)")
    log(f"treesearch_munin rows={coded.n} columns={n_vars} pairs={n_pairs} treesearch_s "
        f"{treesearch_s:.3f} specs_s {timings['specs_s']:.3f} launch_s {timings['launch_s']:.3f} "
        f"readback_s {timings['readback_s']:.3f} mutual_info_s {timings['mutual_info_s']:.3f} "
        f"spanning_tree_s {timings['spanning_tree_s']:.3f} coding_s {tree_coding_s:.3f} "
        f"(TreeSearch(df), before estimate)")
    log(f"treesearch_check ok one launch, {TREE_CHECKED_PAIRS} pair tables equal to numpy counts, "
        f"their mutual information within {mi_err:.3e} of numpy float64 (limit 1e-9), "
        f"{len(tree.edges())} edges, a tree")
    check(config.DEVICE.type == "cuda", "device left on the CPU")
    return (table_launches, bincount_launches), pairs


# --------------------------------------------------------------------------- #
# constraint-based structure learning (PC, GES, MMHC) and the log-likelihood
# metric (K13)
# --------------------------------------------------------------------------- #
PC_ROWS = 50_000
PC_MAX_COND_VARS = 5
PC_BENCH_ROWS = 2000
PC_CHECKED_TRIPLES = 200
GES_ROWS = 2000
MMHC_ROWS = 2000


def chi_square_oracle(host, x, y, z):
    """(stat, dof) of the chi-square test of ``x`` and ``y`` given ``z`` from
    numpy counts and scipy: ``chi2_contingency`` (Yates where scipy applies it)
    per Z slice over its observed rows and columns, summed."""
    from scipy.stats import chi2_contingency

    cx, cy = int(host[x].max()) + 1, int(host[y].max()) + 1
    zi = np.zeros(len(host[x]), dtype=np.int64)
    nz = 1
    for v in z:
        card = int(host[v].max()) + 1
        zi, nz = zi * card + host[v], nz * card
    table = np.bincount((zi * cx + host[x]) * cy + host[y], minlength=nz * cx * cy)
    stat, dof = 0.0, 0
    for part in table.reshape(nz, cx, cy):
        part = part[part.sum(axis=1) > 0][:, part.sum(axis=0) > 0]
        if part.shape[0] >= 2 and part.shape[1] >= 2:
            s, _, d, _ = chi2_contingency(part)
            stat, dof = stat + s, dof + int(d)
    return stat, dof


def numpy_log_probability(model, frame):
    """log P(row) in float64 by numpy from the frame's categorical codes: per
    node the CPD entry at the row's state and parent states, log-clamped at
    1e-38 as the sampler's tables are, summed over nodes."""
    total = np.zeros(len(frame))
    for cpd in model.get_cpds():
        codes = {}
        for v in cpd.variables:
            check(list(frame[v].cat.categories) == list(cpd.state_names[v]),
                  f"k13 oracle: {v}'s categories are not its state names")
            codes[v] = frame[v].cat.codes.to_numpy().astype(np.int64)
        values = cpd.get_values().astype(np.float64)
        col = np.zeros(len(frame), dtype=np.int64)
        for parent in cpd.variables[1:]:
            col = col * len(cpd.state_names[parent]) + codes[parent]
        total += np.log(np.maximum(values[codes[cpd.variable], col], 1e-38))
    return total


def phase_constraint(fitted_munin, munin_df):
    import networkx as nx
    from scipy import stats

    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.estimators import BIC, GES, PC, MmhcEstimator, ScoreCache, citests
    from pgmpy_tpu_torch.metrics import BayesianModelProbability, log_likelihood_score
    from pgmpy_tpu_torch.ops import bincount as bc
    from pgmpy_tpu_torch.ops import table_gather
    from pgmpy_tpu_torch.utils import get_example_model

    alarm = get_example_model("alarm")
    frame = alarm.simulate(n_samples=PC_ROWS, seed=3, show_progress=False)
    bench_frame = alarm.simulate(n_samples=PC_BENCH_ROWS, seed=3, show_progress=False)
    sachs_frame = get_example_model("sachs").simulate(n_samples=MMHC_ROWS, seed=3,
                                                      show_progress=False)
    torch.cuda.synchronize()

    # every batch of CI tests handed to the count kernel, with its results
    batches = []
    real_batch = citests.power_divergence_batch

    def recording_batch(triples, *args, **kwargs):
        out = real_batch(triples, *args, **kwargs)
        batches.append((list(triples), out))
        return out

    # the skeleton and separating sets inside PC.estimate, and the skeleton
    # inside MmhcEstimator.estimate (with its time and launches)
    skeletons, mmpc_runs = [], []
    real_build, real_mmpc = PC.build_skeleton, MmhcEstimator.mmpc

    def recording_build(self, *args, **kwargs):
        out = real_build(self, *args, **kwargs)
        skeletons.append(out)
        return out

    def recording_mmpc(self, *args, **kwargs):
        launches, t0 = bc.TABLE_LAUNCHES, time.time()
        out = real_mmpc(self, *args, **kwargs)
        torch.cuda.synchronize()
        mmpc_runs.append((out, time.time() - t0, bc.TABLE_LAUNCHES - launches))
        return out

    PC.build_skeleton, MmhcEstimator.mmpc = recording_build, recording_mmpc
    primed = []
    real_prime = ScoreCache.prime

    def counting_prime(self, specs):
        keys = {(v, tuple(sorted(ps, key=str))) for v, ps in specs}
        primed.append(len(keys - set(self._cache.keys())))
        real_prime(self, specs)

    pc_kwargs = dict(ci_test="chi_square", significance_level=0.01,
                     max_cond_vars=PC_MAX_COND_VARS, show_progress=False)
    # ---- the main path, counted: PC, the bench's skeleton, GES, MMHC, K13
    reset_launches()
    citests.power_divergence_batch = recording_batch
    try:
        est = PC(frame)
        torch.cuda.synchronize()
        t0 = time.time()
        pdag = est.estimate(return_type="pdag", **pc_kwargs)
        torch.cuda.synchronize()
        pc_s = time.time() - t0
        pc_batches = list(batches)
        pc_launches = bc.TABLE_LAUNCHES
        dag = pdag.to_dag()
        bench_est = PC(bench_frame)
        torch.cuda.synchronize()
        t0 = time.time()
        bench_skel, bench_seps = bench_est.build_skeleton(
            ci_test="chi_square", max_cond_vars=2, significance_level=0.01, show_progress=False)
        torch.cuda.synchronize()
        pc_skeleton_s = time.time() - t0
        bench_launches = bc.TABLE_LAUNCHES - pc_launches
    finally:
        citests.power_divergence_batch = real_batch
    before = bc.TABLE_LAUNCHES
    scorer = BIC(bench_frame)
    ScoreCache.prime = counting_prime
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        ges_dag = GES(bench_frame).estimate(scoring_method=scorer)
        torch.cuda.synchronize()
        ges_s = time.time() - t0
    finally:
        ScoreCache.prime = real_prime
    ges_launches = bc.TABLE_LAUNCHES - before
    before = bc.TABLE_LAUNCHES
    t0 = time.time()
    mmhc_dag = MmhcEstimator(sachs_frame).estimate(significance_level=0.01)
    torch.cuda.synchronize()
    mmhc_s = time.time() - t0
    mmhc_launches = bc.TABLE_LAUNCHES - before
    mmhc_skel, mmpc_s, mmpc_launches = mmpc_runs[-1]
    t0 = time.time()
    before = table_gather.LAUNCHES["row_sums"]
    loglik = log_likelihood_score(fitted_munin, munin_df)
    loglik_first_s = time.time() - t0
    check(table_gather.LAUNCHES["row_sums"] == before + 1,
          f"log_likelihood_score made {table_gather.LAUNCHES['row_sums'] - before} K13 launches")
    table_launches, bincount_launches = bc.TABLE_LAUNCHES, bc.LAUNCHES
    record_jt("constraint")
    log(f"constraint_path table_count_launches {table_launches} (PC {pc_launches}, PC skeleton "
        f"{bench_launches}, GES {ges_launches}, MMHC {mmhc_launches} of which mmpc "
        f"{mmpc_launches}, K13 0) bincount_launches {bincount_launches}")

    # ---- PC: one launch per non-empty level, the CPU run, numpy/scipy
    levels = [(triples, out) for triples, out in pc_batches if triples]
    check(pc_launches == len(levels) == est._coded.n_dispatches,
          f"PC: {pc_launches} launches, {len(levels)} non-empty levels, "
          f"{est._coded.n_dispatches} dispatches")
    per_level = [(len(t), len({(x, (y,) + tuple(z)) for x, y, z in t}),
                  len(t[0][2])) for t, _ in levels]
    with on_device("cpu"):
        cpu_pdag = PC(frame).estimate(return_type="pdag", **pc_kwargs)
        cpu_bench = PC(bench_frame).build_skeleton(
            ci_test="chi_square", max_cond_vars=2, significance_level=0.01, show_progress=False)
        cpu_ges = GES(bench_frame).estimate(scoring_method="bic-d")
        cpu_dag = MmhcEstimator(sachs_frame).estimate(significance_level=0.01)
    PC.build_skeleton, MmhcEstimator.mmpc = real_build, real_mmpc
    (skel, seps), (cpu_skel, cpu_seps) = skeletons[0], skeletons[-2]
    cpu_mmhc_skel = mmpc_runs[-1][0]
    check(len(skeletons) == 4 and len(mmpc_runs) == 2, "the recorders missed a run")
    check({frozenset(e) for e in skel.edges()} == {frozenset(e) for e in cpu_skel.edges()}
          and seps == cpu_seps, "PC: skeleton or separating sets differ from the CPU run's")
    check(pdag == cpu_pdag, "PC: the PDAG differs from the CPU run's")
    check({frozenset(e) for e in bench_skel.edges()} == {frozenset(e) for e in cpu_bench[0].edges()}
          and bench_seps == cpu_bench[1], "PC skeleton (bench configuration) differs from the CPU run's")
    check(nx.is_directed_acyclic_graph(dag) and set(dag.nodes()) == set(alarm.nodes()),
          "PC: to_dag is not a DAG over ALARM's variables")
    host = {v: np.unique(frame[v].astype(str), return_inverse=True)[1] for v in frame.columns}
    rng = np.random.default_rng(SEED)
    worst_stat = worst_p = 0.0
    checked = 0
    for want_level in (1, 2):
        triples, out = next((t, o) for t, o in levels if len(t[0][2]) == want_level)
        for k in rng.choice(len(triples), min(PC_CHECKED_TRIPLES, len(triples)), replace=False):
            (x, y, z), (stat, p, dof) = triples[k], out[k]
            want_stat, want_dof = chi_square_oracle(host, x, y, z)
            check(dof == want_dof, f"PC triple {triples[k]}: dof {dof}, scipy {want_dof}")
            if dof == 0:
                check(stat == 0.0 and np.isnan(p), f"PC triple {triples[k]}: degenerate")
                continue
            want_p = float(stats.chi2.sf(want_stat, want_dof))
            rel = abs(stat - want_stat) / max(abs(want_stat), 1e-300)
            check(rel <= 1e-9 and abs(p - want_p) <= 1e-9,
                  f"PC triple {triples[k]}: ({stat}, {p}) against scipy ({want_stat}, {want_p})")
            worst_stat, worst_p = max(worst_stat, rel), max(worst_p, abs(p - want_p))
            checked += 1
    pc_device_ms = cuda_profiled_ms(lambda: PC(frame).estimate(return_type="pdag", **pc_kwargs))
    true_skeleton = {frozenset(e) for e in alarm.edges()}
    found = {frozenset(e) for e in skel.edges()}
    log(f"pc_alarm rows={PC_ROWS} max_cond_vars={PC_MAX_COND_VARS} pc_s {pc_s:.3f} launches "
        f"{pc_launches} triples_per_level {[n for n, _, _ in per_level]} unique_specs_per_level "
        f"{[u for _, u, _ in per_level]} pdag_arcs {len(pdag.edges())} (directed "
        f"{len(pdag.directed_edges)}, undirected {len(pdag.undirected_edges)}) true_edges_found "
        f"{len(found & true_skeleton)}/{len(true_skeleton)} extra {len(found - true_skeleton)} "
        f"device_ms {pc_device_ms:.3f} host_share {1 - pc_device_ms / (pc_s * 1e3):.5f}")
    log(f"pc_check ok one launch per non-empty level, skeleton, separating sets and PDAG equal "
        f"to the CPU run's, {checked} triples of levels 1 and 2 within {worst_stat:.3e} (stat, "
        f"relative) and {worst_p:.3e} (p) of scipy chi2_contingency per slice (limits 1e-9), "
        f"dof equal")
    log(f"pc_skeleton_alarm rows={PC_BENCH_ROWS} max_cond_vars=2 pc_skeleton_s {pc_skeleton_s:.3f} "
        f"launches {bench_launches} edges {len(bench_skel.edges())}; equal to the CPU run's")

    # ---- K1 at the new shape: the level-1 spec list of the PC run
    coded = est._coded
    triples = next(t for t, _ in levels if len(t[0][2]) == 1)
    uniq = list(dict.fromkeys((x, (y,) + tuple(z)) for x, y, z in triples))
    col_lists = [[coded.var_index[x]] + [coded.var_index[v] for v in rest] for x, rest in uniq]
    table = bc.table_specs(col_lists, [[coded.cards[coded.variables[c]] for c in cols]
                                       for cols in col_lists])
    cm = coded._column_codes()
    got = bc.table_counts_cuda(cm, coded.n, table)
    ref = bc.table_counts_reference(cm, coded.n, table)
    torch.cuda.synchronize()
    check(got.dtype == torch.int32 and torch.equal(got, ref),
          "PC level 1: the kernel differs from the plain version")
    ms = cuda_median_ms(lambda: bc.table_counts_cuda(cm, coded.n, table), device_only=True)
    plain_ms = cuda_median_ms(lambda: bc.table_counts_reference(cm, coded.n, table),
                              reps=5, warmup=1)
    used = np.unique(np.concatenate(col_lists)).size
    desc_bytes = 8 * len(table) * (6 + 2 * table.cols.shape[1])
    nbytes = used * coded.n * cm.element_size() + table.total * 4 + desc_bytes
    bound_ms, bound_by = bound(nbytes, 2 * int(table.n_cols.sum()) * coded.n)
    per_spec_bytes = int(table.n_cols.sum()) * coded.n * cm.element_size() + table.total * 4
    _, library_ms = library_bincount("pc_level1", cm, coded.n, table, ref)
    level1 = {"err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": library_ms}
    log(f"k1t pc_level1 specs={len(table)} rows={coded.n} codes={cm.dtype} entries={table.total} "
        f"descriptor_bytes={desc_bytes} equal to the plain version, kernel_ms={ms:.5f} (device "
        f"time, median of 20) plain_ms={plain_ms:.3f} (median of 5) bound_ms={bound_ms:.6f} "
        f"({bound_by}) bytes_if_each_spec_reads_its_columns {per_spec_bytes} at 3.35 TB/s "
        f"{per_spec_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms library_ms {library_ms:.5f}")
    t0 = time.perf_counter()
    results = real_batch(triples, lambda_="pearson", coded=coded)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    check([r[2] for r in results] == [r[2] for r in next(o for t, o in levels if t is triples)],
          "PC level 1: a second batch disagrees")
    log(f"pc_level1_batch triples={len(triples)} batch_s {batch_s:.4f} (one launch and the host "
        f"statistic of every triple)")

    # ---- GES: one launch per iteration with uncached specs, the CPU run
    uncached = sum(1 for n in primed if n)
    check(ges_launches == scorer._coded.n_dispatches == uncached,
          f"GES: {ges_launches} launches, {scorer._coded.n_dispatches} dispatches, {uncached} "
          f"iterations with uncached specs")
    check(sorted(ges_dag.edges()) == sorted(cpu_ges.edges()), "GES: the DAG differs from the CPU run's")
    log(f"ges_alarm rows={GES_ROWS} ges_s {ges_s:.3f} iterations {len(primed)} launches "
        f"{ges_launches} specs_per_launch {sum(primed) / max(ges_launches, 1):.1f} edges "
        f"{len(ges_dag.edges())}; DAG equal to the CPU run's")

    # ---- MMHC on SACHS: the CPU run
    check({frozenset(e) for e in mmhc_skel.edges()} == {frozenset(e) for e in cpu_mmhc_skel.edges()},
          "MMHC: the mmpc skeleton differs from the CPU run's")
    check(sorted(mmhc_dag.edges()) == sorted(cpu_dag.edges()), "MMHC: the DAG differs from the CPU run's")
    log(f"mmhc_sachs rows={MMHC_ROWS} mmhc_s {mmhc_s:.3f} (estimate, its mmpc included) "
        f"mmpc_s {mmpc_s:.3f} launches {mmhc_launches} (mmpc {mmpc_launches}) skeleton_edges "
        f"{len(mmhc_skel.edges())} dag_edges {len(mmhc_dag.edges())}; skeleton and DAG equal to "
        f"the CPU run's")

    # ---- K13 on MUNIN: per row and in total against numpy float64
    prob = BayesianModelProbability(fitted_munin)
    before = table_gather.LAUNCHES["row_sums"]
    rows = prob.log_probability(munin_df)
    check(table_gather.LAUNCHES["row_sums"] == before + 1,
          f"log_probability made {table_gather.LAUNCHES['row_sums'] - before} K13 launches")
    want = numpy_log_probability(fitted_munin, munin_df)
    row_err = float((np.abs(rows - want) / np.abs(want)).max())
    total_err = abs(loglik - want.sum()) / abs(want.sum())
    check(np.all(np.isfinite(rows)) and row_err <= 1e-5, f"k13: per-row error {row_err}")
    check(total_err <= 1e-6, f"k13: total {loglik} against numpy {want.sum()} ({total_err})")
    codes = prob._encode(munin_df)
    check(codes.dtype == torch.int8, f"k13: the frame was coded as {codes.dtype}")
    torch.cuda.synchronize()
    encode_s = host_median_s(lambda: prob._encode(munin_df))
    logp_s = host_median_s(lambda: prob._logp(codes))
    call_s = host_median_s(lambda: prob.log_probability(munin_df))
    kernels, device_ms = profiled(lambda: prob._logp(codes))
    log(f"k13_munin rows={len(munin_df)} columns={munin_df.shape[1]} loglik_rows_per_s "
        f"{len(munin_df) / call_s:.1f} log_probability_s {call_s:.4f} (median of 3; first "
        f"log_likelihood_score {loglik_first_s:.4f}) encode_s {encode_s:.4f} device_sum_s "
        f"{logp_s:.5f} kernels_per_call {kernels:.0f} device_ms {device_ms:.4f} idle_share "
        f"{1 - device_ms / (call_s * 1e3):.4f}")
    log(f"k13_check ok {len(rows)} rows within {row_err:.3e} (limit 1e-5 relative) and the total "
        f"{loglik:.6f} within {total_err:.3e} (limit 1e-6) of a numpy float64 gather-sum")
    report = fitted_munin.validate(munin_df, metrics=("log-likelihood", "bic"))
    values = dict(zip(report["metric"], report["value"]))
    check(all(isinstance(v, float) and np.isfinite(v) for v in values.values())
          and abs(values["log-likelihood"] - loglik) <= 1e-6 * abs(loglik),
          f"DAG.validate: {values}")
    log(f"validate_munin ok log-likelihood {values['log-likelihood']:.6f} bic {values['bic']:.6f}")
    GATHER_ROWS["table_gather/row_sums"] = k13_kernel_row(prob, codes)
    check(config.DEVICE.type == "cuda", "device left on the CPU")
    return (table_launches, bincount_launches), level1


# --------------------------------------------------------------------------- #
# the latent-variable lane: NaiveBayes, EM, mirror descent, ExpertInLoop, JPD
# --------------------------------------------------------------------------- #
LATENT = "DIFFN_PATHO"
LATENT_CARD = 5
NB_PREDICT_ROWS = 2048
MD_ROWS = 50_000
MD_ITERATIONS = 100
EXPERT_ROWS = 2000


def k1_shape_row(name, cm, n, specs, weights=None):
    """K1 at one shape of the latent lane: the kernel against its plain version
    (equal without weights; with them within rtol 1e-4 and atol 1e-4 of the
    float64 plain version: a float32 cell sums up to a quarter million
    weights), its device time, the plain version's, the card's bound, and one
    ``torch.bincount`` over every spec's flat index offset into one index
    space, weights repeated (the index built outside the timed window)."""
    from pgmpy_tpu_torch.ops import bincount as bc

    got = bc.table_counts_cuda(cm, n, specs, weights)
    if weights is None:
        ref = bc.table_counts_reference(cm, n, specs)
        err = float((got - ref).abs().max())
        check(got.dtype == torch.int32 and torch.equal(got, ref),
              f"k1 {name}: the kernel differs from the plain version")
    else:
        ref = bc.table_counts_reference(cm, n, specs, weights.double())
        err = float((got.double() - ref).abs().max())
        check(got.dtype == weights.dtype
              and torch.allclose(got.double(), ref, rtol=1e-4, atol=1e-4),
              f"k1 {name}: max_abs_err {err} against the float64 plain version")
    ms = cuda_median_ms(lambda: bc.table_counts_cuda(cm, n, specs, weights), device_only=True)
    plain_ms = cuda_median_ms(lambda: bc.table_counts_reference(cm, n, specs, weights),
                              reps=3, warmup=1)
    used = np.unique(np.concatenate([specs.cols[s, : specs.n_cols[s]] for s in range(len(specs))]))
    out_bytes = specs.total * got.element_size()
    nbytes = used.size * n * cm.element_size() + out_bytes \
        + (0 if weights is None else n * weights.element_size()) \
        + 8 * len(specs) * (6 + 2 * specs.cols.shape[1])
    bound_ms, bound_by = bound(nbytes, 2 * int(specs.n_cols.sum()) * n)
    lib_err, library_ms = library_bincount(name, cm, n, specs, ref, weights)
    row = {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    log(f"k1t {name} specs={len(specs)} rows={n} codes={cm.dtype} entries={specs.total} "
        f"weights={None if weights is None else weights.dtype} max_abs_err={err:.3e} "
        f"kernel_ms={ms:.5f} (device time, median of 20) plain_ms={plain_ms:.3f} (median of 3) "
        f"bound_ms={bound_ms:.6f} ({bound_by}) torch_bincount_ms={library_ms:.5f} (one call "
        f"over the {len(specs)} specs offset into one index space, median of 5; its max_abs_err "
        f"{lib_err:.3e})")
    return row


def spec_flat_host(host_codes, columns, strides, offset=0):
    """Host flat entries of one spec: the codes of ``columns`` times their
    strides."""
    flat = np.full(len(host_codes[columns[0]]), offset, dtype=np.int64)
    for column, stride in zip(columns, strides):
        flat += host_codes[column].astype(np.int64) * int(stride)
    return flat


def em_numpy_logp(cpds, codes, var_order, parents, cards, latent, K):
    """(n, K) log P(observed row, latent = k) under ``cpds`` in numpy float64
    (each CPD entry clamped at TINY as the E-step does): ``codes`` {variable:
    host codes} of the observed columns."""
    from pgmpy_tpu_torch.config import TINY

    n = len(next(iter(codes.values())))
    lp = np.zeros((n, K))
    for v in var_order:
        table = np.log(np.maximum(np.asarray(cpds[v].get_values(), dtype=np.float64), TINY))
        scope = [v] + parents[v]
        strides = np.cumprod([1] + [cards[u] for u in scope[::-1]])[:-1][::-1]
        if latent not in scope:
            lp += table.ravel()[spec_flat_host(codes, scope, strides)][:, None]
            continue
        for k in range(K):
            rows = {**codes, latent: np.full(n, k)}
            lp[:, k] += table.ravel()[spec_flat_host(rows, scope, strides)]
    return lp


def observed_loglik(lp):
    """The observed-data log-likelihood from :func:`em_numpy_logp`."""
    top = lp.max(axis=1, keepdims=True)
    return float((top[:, 0] + np.log(np.exp(lp - top).sum(axis=1))).sum())


def em_numpy_step(lp, codes, var_order, parents, cards, latent, K):
    """One M-step in numpy float64 from the E-step's ``lp``: {variable:
    (card, prod parent cards) table}, every column normalised, an empty
    column uniform."""
    n = lp.shape[0]
    w = np.exp(lp - lp.max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)
    out = {}
    for v in var_order:
        scope = [v] + parents[v]
        size = int(np.prod([cards[u] for u in scope]))
        strides = np.cumprod([1] + [cards[u] for u in scope[::-1]])[:-1][::-1]
        if latent not in scope:
            counts = np.bincount(spec_flat_host(codes, scope, strides), minlength=size)
            counts = counts.astype(np.float64)
        else:
            counts = np.zeros(size)
            for k in range(K):
                rows = {**codes, latent: np.full(n, k)}
                counts += np.bincount(spec_flat_host(rows, scope, strides), weights=w[:, k],
                                      minlength=size)
        counts = counts.reshape(cards[v], -1)
        counts[:, counts.sum(axis=0) == 0] = 1.0
        out[v] = counts / counts.sum(axis=0, keepdims=True)
    return out


def phase_latent(model, df, host_codes):
    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.estimators import (ExpectationMaximization, ExpertInLoop,
                                            MirrorDescentEstimator)
    from pgmpy_tpu_torch.estimators import base as estimators_base
    from pgmpy_tpu_torch.factors import JointProbabilityDistribution, NoisyORCPD, TabularCPD
    from pgmpy_tpu_torch.factors.jpd import model_joint_factor
    from pgmpy_tpu_torch.inference import VariableElimination
    from pgmpy_tpu_torch.inference.bp import JunctionTreeProgram
    from pgmpy_tpu_torch.models import DiscreteBayesianNetwork, NaiveBayes
    from pgmpy_tpu_torch.ops import bincount as bc
    from pgmpy_tpu_torch.ops import table_gather
    from pgmpy_tpu_torch.utils import get_example_model
    from pgmpy_tpu_torch.utils.interop import bn_from_numpy

    states = model.states
    check(not model.get_parents(LATENT) and len(list(model.get_children(LATENT))) == 69
          and len(states[LATENT]) == LATENT_CARD, f"{LATENT} is not a 5-state root of 69 children")
    predict_rows = df.iloc[-NB_PREDICT_ROWS:].drop(columns=[LATENT])
    em_data = df.drop(columns=[LATENT])
    em_states = {v: states[v] for v in em_data.columns}
    em_kwargs = dict(latent_card={LATENT: LATENT_CARD}, seed=0, init_cpds="random",
                     show_progress=False)
    alarm = get_example_model("alarm")
    md_frame = alarm.simulate(n_samples=MD_ROWS, seed=4, show_progress=False)
    md_model = alarm.to_markov_model()
    sachs = get_example_model("sachs")
    expert_frame = sachs.simulate(n_samples=EXPERT_ROWS, seed=3, show_progress=False)
    sachs_edges = set(sachs.edges())
    oracle_calls = []

    def oracle(u, v, **kwargs):
        oracle_calls.append((u, v))
        return (u, v) if (u, v) in sachs_edges else (v, u) if (v, u) in sachs_edges else None

    # instruments: the fit's count launch with its output, calibrations, CI tests
    recorded, calibrations, ci_tests = [], [0], [0]
    real_count = estimators_base._CodedData._count_specs
    real_calibrate = JunctionTreeProgram.calibrate
    real_effect = ExpertInLoop._effect

    def recording_count(self, table, weights=None):
        out = real_count(self, table, weights)
        recorded.append((self, table, out))
        return out

    def counting_calibrate(self, *args, **kwargs):
        calibrations[0] += 1
        return real_calibrate(self, *args, **kwargs)

    def counting_effect(self, *args, **kwargs):
        ci_tests[0] += 1
        return real_effect(self, *args, **kwargs)

    torch.cuda.synchronize()
    # ---- the main path, counted: NaiveBayes fit and predict, EM, mirror
    # descent, ExpertInLoop, is_imap and a noisy-OR query
    reset_launches()
    estimators_base._CodedData._count_specs = recording_count
    try:
        t0 = time.time()
        nb = NaiveBayes()
        nb.fit(df, parent_node=LATENT, state_names=states)
        torch.cuda.synchronize()
        nb_fit_s = time.time() - t0
    finally:
        estimators_base._CodedData._count_specs = real_count
    nb_fit_launches = bc.TABLE_LAUNCHES
    t0 = time.time()
    nb_probs = nb.predict_probability(predict_rows)
    nb_first_s = time.time() - t0

    before = bc.TABLE_LAUNCHES
    e_step_before = table_gather.LAUNCHES["e_step"]
    em = ExpectationMaximization(DiscreteBayesianNetwork(list(model.edges()), latents={LATENT}),
                                 em_data, state_names=em_states)
    torch.cuda.synchronize()
    t0 = time.time()
    em10 = em.get_parameters(max_iter=10, **em_kwargs)
    torch.cuda.synchronize()
    em10_s = time.time() - t0
    em_launches = bc.TABLE_LAUNCHES - before
    e_step_launches = table_gather.LAUNCHES["e_step"] - e_step_before

    JunctionTreeProgram.calibrate = counting_calibrate
    try:
        md = MirrorDescentEstimator(md_model, md_frame)
        torch.cuda.synchronize()
        t0 = time.time()
        md_jt = md.estimate(iterations=MD_ITERATIONS, show_progress=False)
        torch.cuda.synchronize()
        md_s = time.time() - t0
    finally:
        JunctionTreeProgram.calibrate = real_calibrate

    before = bc.TABLE_LAUNCHES
    ExpertInLoop._effect = counting_effect
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        expert_dag = ExpertInLoop(expert_frame).estimate(orientation_fn=oracle,
                                                         show_progress=False)
        torch.cuda.synchronize()
        expert_s = time.time() - t0
    finally:
        ExpertInLoop._effect = real_effect
    expert_launches = bc.TABLE_LAUNCHES - before

    asia = get_example_model("asia")
    asia_cpds = [(c.variable, int(c.variable_card), c.get_values(), list(c.variables[1:]),
                  [int(k) for k in c.cardinality[1:]], {v: [0, 1] for v in c.variables})
                 for c in asia.get_cpds()]
    asia01 = bn_from_numpy(list(asia.edges()), asia_cpds)
    joint = model_joint_factor(asia01)
    jpd = JointProbabilityDistribution(joint.variables, joint.cardinality, joint.values)
    marg = jpd.marginal_distribution(["dysp", "bronc"], inplace=False)
    marg = marg.values.permute([marg.variables.index("dysp"), marg.variables.index("bronc")])
    cut_cpds = [c if c[0] != "dysp" else
                ("dysp", 2, (marg / marg.sum(dim=0, keepdim=True)).cpu().numpy(), ["bronc"], [2],
                 {"dysp": [0, 1], "bronc": [0, 1]}) for c in asia_cpds]
    cut = bn_from_numpy([e for e in asia.edges() if e != ("either", "dysp")], cut_cpds)
    imap = (jpd.is_imap(asia01), asia01.is_imap(jpd), jpd.is_imap(cut), cut.is_imap(jpd))
    noisy = DiscreteBayesianNetwork([("flu", "fever"), ("cold", "fever")])
    noisy.add_cpds(NoisyORCPD("fever", [0.8, 0.6], evidence=["flu", "cold"]),
                   *[TabularCPD(v, 2, [[p], [1 - p]], state_names={v: ["True", "False"]})
                     for v, p in (("flu", 0.1), ("cold", 0.3))])
    fever = VariableElimination(noisy).query(["fever"], evidence={"flu": "True"})
    table_launches, bincount_launches = bc.TABLE_LAUNCHES, bc.LAUNCHES
    record_jt("latent")
    log(f"latent_path table_count_launches {table_launches} (NaiveBayes fit {nb_fit_launches}, "
        f"EM {em_launches}, ExpertInLoop {expert_launches}) bincount_launches "
        f"{bincount_launches}")

    # ---- NaiveBayes: one launch, every table against np.bincount
    check(nb_fit_launches == 1 and len(recorded) == 1,
          f"NaiveBayes.fit made {nb_fit_launches} launches")
    coded, table, out = recorded[0]
    flat = out.cpu().numpy()
    for s in range(len(table)):
        columns = [coded.variables[c] for c in table.cols[s, : table.n_cols[s]]]
        want = np.bincount(spec_flat_host(host_codes, columns, table.strides[s, : table.n_cols[s]]),
                           minlength=int(table.sizes[s]))
        got = flat[int(table.offsets[s]): int(table.offsets[s] + table.sizes[s])]
        check(np.array_equal(got, want), f"NaiveBayes.fit: the table of {columns} differs")
    check(len(table) == 1041 and int((table.n_cols == 2).sum()) == 1040,
          f"NaiveBayes.fit: {len(table)} specs")
    prior = np.log(np.asarray(nb.get_cpds(LATENT).get_values(), dtype=np.float64)[:, 0])
    logp = np.tile(prior, (NB_PREDICT_ROWS, 1))
    for feature in predict_rows.columns:
        values = np.asarray(nb.get_cpds(feature).get_values(), dtype=np.float64)
        with np.errstate(divide="ignore"):
            logp += np.log(values)[host_codes[feature][-NB_PREDICT_ROWS:]]
    logp -= logp.max(axis=1, keepdims=True)
    want = np.exp(logp)
    want /= want.sum(axis=1, keepdims=True)
    got = nb_probs.to_numpy(dtype=np.float64)
    check(got.shape == want.shape and not np.isnan(got).any(), f"NaiveBayes: {got.shape}, NaN")
    nb_err = float(np.abs(got - want).max())
    top2 = np.sort(want, axis=1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 1e-3
    check(nb_err <= 1e-4 and np.array_equal(got.argmax(1)[decided], want.argmax(1)[decided]),
          f"NaiveBayes predict_probability: {nb_err} from the log-space oracle")
    nb_s = host_median_s(lambda: nb.predict_probability(predict_rows))
    log(f"naive_bayes_munin class={LATENT} features={predict_rows.shape[1]} fit_s {nb_fit_s:.3f} "
        f"launches {nb_fit_launches}; 1041 tables equal to np.bincount; predict_probability rows="
        f"{NB_PREDICT_ROWS} nb_predict_rows_per_s {NB_PREDICT_ROWS / nb_s:.1f} (median of 3; "
        f"first call {nb_first_s:.3f} s) max_abs_err {nb_err:.3e} (limit 1e-4) from a numpy "
        f"float64 log-space oracle, argmax equal on {int(decided.sum())} rows with a margin "
        f"above 1e-3, no NaN")

    # ---- EM: one iteration against numpy, the ascent, the same seed twice
    check(em_launches == 10, f"EM: {em_launches} launches in 10 iterations")
    check(e_step_launches == 10, f"EM: {e_step_launches} E-step launches in 10 iterations")
    torch.cuda.synchronize()
    t0 = time.time()
    em1 = em.get_parameters(max_iter=1, **em_kwargs)
    torch.cuda.synchronize()
    em1_s = time.time() - t0
    em3 = em.get_parameters(max_iter=3, **em_kwargs)
    em3b = em.get_parameters(max_iter=3, **em_kwargs)
    torch.cuda.synchronize()
    t0 = time.time()
    em10b = em.get_parameters(max_iter=10, **em_kwargs)
    torch.cuda.synchronize()
    em10b_s = time.time() - t0
    # the device program the fits ran, built again (an estimator keeps none)
    program, cards, names = em._program({LATENT: LATENT_CARD})
    check(program.chunk_rows >= len(em_data), f"EM: {program.chunk_rows} rows per E-step chunk")
    var_order = program.var_order
    init = em._initial_cpds("random", 0, cards, names)
    obs_codes = {v: host_codes[v] for v in em_data.columns}
    numpy_args = (obs_codes, var_order, program.parents, cards, LATENT, LATENT_CARD)
    lp0 = em_numpy_logp(init, *numpy_args)
    want = em_numpy_step(lp0, *numpy_args)
    em_err = max(float(np.abs(np.asarray(c.get_values(), dtype=np.float64)
                              - want[c.variable]).max()) for c in em1)
    check(em_err <= 2e-5, f"EM: one iteration is {em_err} from numpy")
    lls = [observed_loglik(lp0)] + [
        observed_loglik(em_numpy_logp({c.variable: c for c in cpds}, *numpy_args))
        for cpds in (em1, em3, em10)]
    ascent = all(b >= a - 1e-6 * abs(a) for a, b in zip(lls, lls[1:]))
    check(ascent, f"EM: the observed-data log-likelihood fell along 0, 1, 3, 10 iterations: {lls}")
    def cpd_gap(first, second):
        return max(float(np.abs(np.asarray(a.get_values()) - np.asarray(b.get_values())).max())
                   for a, b in zip(first, second))

    # the weighted counts and the column sums add floats with atomics, and
    # EM's early iterations from a random start amplify what they leave
    repeat, repeat10 = cpd_gap(em3, em3b), cpd_gap(em10, em10b)
    check(repeat <= 1e-5, f"EM: the same seed twice differs by {repeat} after 3 iterations")
    prob = program.flat_of({c.variable: c for c in em10})
    weights = program.e_step(prob)
    iteration = lambda: float(torch.max(torch.abs(program.m_step(program.e_step(prob), False)  # noqa: E731
                                                - prob)))
    kernels, device_ms = profiled(iteration)
    by_name = kernels_by_name(iteration)
    # one iteration as the loop runs it, ending in its host read; the calls'
    # own set-up (the expanded rows, 1041 initial CPDs) varies by more than
    # nine iterations take, so the calls' difference cannot give it
    em_iter_s = host_median_s(iteration, reps=5)
    log(f"em_munin latent={LATENT} card={LATENT_CARD} rows={len(em_data)} expanded_rows="
        f"{program.coded.n} em_iter_s {em_iter_s:.4f} (median of 5; calls of 10 iterations "
        f"{em10b_s:.3f} s, of 1 {em1_s:.3f} s, the first of 10 {em10_s:.3f} s) kernels_per_iteration {kernels:.0f} device_ms_per_iteration "
        f"{device_ms:.4f} idle_share {1 - device_ms / (em_iter_s * 1e3):.4f} launches_per_iteration "
        f"1 (M-step) + 1 (E-step) e_step_launches_in_10_iterations {e_step_launches}; by name "
        f"{sum(c for c, _ in by_name.values())} kernels "
        f"{sum(us for _, us in by_name.values()) / 1e3:.4f} ms: "
        + "; ".join(f"{n[:50]} x{c} {us:.1f}us" for n, (c, us) in list(by_name.items())[:8]))
    log(f"em_check ok one iteration within {em_err:.3e} (limit 2e-5) of numpy float64; "
        f"observed-data log-likelihood over the {len(em_data)} rows at 0/1/3/10 iterations "
        f"{[round(x, 3) for x in lls]} never falls (limit 1e-6 relative); the same seed twice "
        f"within {repeat:.3e} after 3 iterations (limit 1e-5) and {repeat10:.3e} after 10")
    em_row = k1_shape_row("em_mstep_weighted", program.coded._column_codes(), program.coded.n,
                          program.specs, weights)
    GATHER_ROWS["table_gather/e_step"] = k11_kernel_row(program, prob)
    nb_row = k1_shape_row("naive_bayes_fit", coded._column_codes(), coded.n, table)
    del program, weights, prob

    # ---- mirror descent: the losses, the CPU run
    check(all(b <= a for a, b in zip(md.losses, md.losses[1:])),
          "mirror descent: an accepted loss increased")
    alarm_cpu = None
    with on_device("cpu"):
        alarm_cpu = get_example_model("alarm").to_markov_model()
        cpu_md = MirrorDescentEstimator(alarm_cpu, md_frame)
        cpu_jt = cpu_md.estimate(iterations=MD_ITERATIONS, show_progress=False)
    cpu = {frozenset(f.variables): f for f in cpu_jt.factors}
    md_err = 0.0
    for f in md_jt.factors:
        c = cpu[frozenset(f.variables)]
        a = f.values.double().cpu().numpy()
        b = np.transpose(c.values.double().numpy(), [c.variables.index(v) for v in f.variables])
        md_err = max(md_err, float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max()))
    check(md_err <= 1e-3, f"mirror descent: {md_err} (relative) from the CPU run")
    log(f"mirror_descent_alarm rows={MD_ROWS} cliques={len(md_jt.factors)} iterations "
        f"{MD_ITERATIONS} accepted {len(md.losses) - 1} mirror_descent_s {md_s:.3f} "
        f"calibrations {calibrations[0]} calibrations_per_s {calibrations[0] / md_s:.1f} loss "
        f"{md.losses[0]:.4e} -> {md.losses[-1]:.4e}; accepted losses never increase; fitted "
        f"count marginals within {md_err:.3e} (limit 1e-3 relative, counts below 1 absolute) "
        f"of the CPU run")

    # ---- ExpertInLoop: the CPU run
    with on_device("cpu"):
        cpu_dag = ExpertInLoop(expert_frame).estimate(orientation_fn=lambda u, v, **kw: (
            (u, v) if (u, v) in sachs_edges else (v, u) if (v, u) in sachs_edges else None),
            show_progress=False)
    check(sorted(expert_dag.edges()) == sorted(cpu_dag.edges()),
          "ExpertInLoop: the DAG differs from the CPU run's")
    log(f"expert_sachs rows={EXPERT_ROWS} expert_s {expert_s:.3f} oracle_calls "
        f"{len(oracle_calls)} ci_tests {ci_tests[0]} launches {expert_launches} edges "
        f"{len(expert_dag.edges())} of which true {len(set(expert_dag.edges()) & sachs_edges)}"
        f"/{len(sachs_edges)}; equal to the CPU run's")

    # ---- is_imap and the noisy-OR query
    check(joint.values.numel() == 256 and imap == (True, True, False, False),
          f"is_imap on ASIA: {imap}")
    p = 1 - (1 - 0.8) * (1 - 0.6 * 0.3)
    fever_err = float(np.abs(fever.values.double().cpu().numpy() - [p, 1 - p]).max())
    check(fever.values.is_cuda and fever_err <= 1e-6, f"noisy-OR query: {fever_err}")
    log(f"jpd_asia entries 256 is_imap ASIA True, without either->dysp False (both "
        f"directions); noisy-OR P(fever | flu) within {fever_err:.1e} of its closed form")
    check(config.DEVICE.type == "cuda", "device left on the CPU")
    return (table_launches, bincount_launches), em_row, nb_row, em_launches, nb_fit_launches


# --------------------------------------------------------------------------- #
# loopy inference: flooding BP on a 128 x 128 grid and a 600-leaf star, Mplp
# --------------------------------------------------------------------------- #
GRID_SIDE = 128
LOOPY_PROFILE_SIDE = 32  # the grid whose query the profiler reads (fresh_profile)
STAR_LEAVES = 600
MPLP_FRUSTRATED_SIDE = 12


def grid_tables(n, seed, coupling=0.2):
    """An n x n binary grid MRF: pairwise exp(coupling N(0,1)) tables."""
    rng = np.random.default_rng(seed)
    names = [[f"x{i}_{j}" for j in range(n)] for i in range(n)]
    scopes, tables = [], []
    for i in range(n):
        for j in range(n):
            for di, dj in ((0, 1), (1, 0)):
                if i + di < n and j + dj < n:
                    scopes.append([names[i][j], names[i + di][j + dj]])
                    tables.append(np.exp(coupling * rng.standard_normal((2, 2))))
    return scopes, {v: 2 for row in names for v in row}, tables


def mplp_grid(rows, cols, seed, diagonals=False):
    """The v4 golden's binary grid Markov network (exp N(0,1) unary and
    pairwise tables, drawn in its order); ``diagonals`` adds one diagonal per
    cell before the pairwise draws, so every cell holds two triangles whose
    random couplings frustrate the pairwise LP relaxation."""
    rng = np.random.default_rng(seed)
    nodes = [f"x{r}_{c}" for r in range(rows) for c in range(cols)]
    edges = []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                edges.append((f"x{r}_{c}", f"x{r}_{c + 1}"))
            if r + 1 < rows:
                edges.append((f"x{r}_{c}", f"x{r + 1}_{c}"))
    if diagonals:
        edges += [(f"x{r}_{c}", f"x{r + 1}_{c + 1}") for r in range(rows - 1)
                  for c in range(cols - 1)]
    unary = {n: np.exp(rng.normal(size=2)) for n in nodes}
    pairwise = {e: np.exp(rng.normal(size=(2, 2))) for e in edges}
    scopes = [[n] for n in nodes] + [list(e) for e in edges]
    tables = [unary[n] for n in nodes] + [pairwise[e] for e in edges]
    return scopes, {n: 2 for n in nodes}, tables


def loopy_grid(side=GRID_SIDE):
    """The ``side`` x ``side`` grid (scopes, cards, tables), its variables in
    order and its virtual evidence on every variable: a checkerboard of
    cells a quarter of the side wide (32 pixels on the 128 x 128 grid) with a
    tenth of the pixels flipped, [0.8, 0.2] or [0.2, 0.8]."""
    scopes, cards, tables = grid_tables(side, SEED)
    rng = np.random.default_rng(SEED + 5)
    i, j = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    image = (((i // (side // 4)) + (j // (side // 4))) % 2).ravel()
    noisy = np.where(rng.random(image.size) < 0.1, 1 - image, image)
    messages = {f"x{a}_{b}": [0.8, 0.2] if noisy[a * side + b] == 0 else [0.2, 0.8]
                for a in range(side) for b in range(side)}
    return scopes, cards, tables, sorted(cards), messages


def virtual_factors(variables, messages):
    from pgmpy_tpu_torch.factors import DiscreteFactor

    return [DiscreteFactor([v], [2], messages[v]) for v in variables]


def mixed_graph(seed=5):
    """A loopy graph of unary, pairwise and triple factors, cardinalities 2,
    3 and 5 (``tests/test_torch_loopy_kernel.py``'s)."""
    rng = np.random.default_rng(seed)
    cards = {"a": 2, "b": 3, "c": 5, "d": 2, "e": 3}
    scopes = [["a"], ["a", "b"], ["b", "c", "d"], ["c"], ["d", "e"], ["e", "a"],
              ["b", "e", "c"]]
    return scopes, cards, [rng.random([cards[v] for v in s]) + 0.1 for s in scopes]


def k7_case(name, plan, tables, messages):
    """K7's kernel against its plain version on the card on one graph's
    flood inputs (``messages`` {variable: fixed message}, uniform start):
    float32 within 1e-5 with rounds at most one apart (the stop compares a
    float32 change, summed in another order, with 4 eps), float64 within
    1e-12 with rounds equal.  Returns {dtype: (max_abs_err, (plan, fixed,
    init, tables, tol), rounds)}."""
    from pgmpy_tpu_torch.ops import loopy

    device = torch.device("cuda", 0)
    fixed = plan.mask.astype(np.float64)
    for var, message in messages.items():
        fixed[plan.var_edges[var], : len(message)] = message
    out = {}
    for dtype, limit in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        args = (plan, torch.as_tensor(fixed, dtype=dtype, device=device),
                torch.as_tensor(plan.mask / plan.cards[:, None], dtype=dtype, device=device),
                plan.build_tables(tables, dtype, device), max(1e-8, 4 * torch.finfo(dtype).eps))
        got = loopy.flood_cuda(*args[:4], 100, args[4])
        want = loopy.flood_reference(*args[:4], 100, args[4])
        torch.cuda.synchronize()
        err = float((got.f2v - want.f2v).abs().max())
        rounds, want_rounds = int(got.rounds), int(want.rounds)
        apart = 0 if dtype == torch.float64 else 1
        check(got.f2v.shape == want.f2v.shape and err <= limit and rounds < 100
              and abs(rounds - want_rounds) <= apart,
              f"k7 {name} {dtype}: {rounds} rounds (plain {want_rounds}), max_abs_err {err}")
        log(f"k7_check {name} edges={plan.n_edges} factors={plan.n_factors} dtype={dtype} rounds "
            f"{rounds} (plain {want_rounds}; limit {apart} apart) max_abs_err={err:.3e} (limit "
            f"{limit:g}) delta {float(got.delta):.3e} (plain {float(want.delta):.3e})")
        out[dtype] = (err, args, rounds)
    return out


def sync_sites(fn):
    """The synchronising CUDA calls ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them: one
    ``file:line`` each, the Python line that made the call."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        # the first switch to "warn" in a process also warns, once, that the
        # mode is a prototype: that notice is no synchronising call
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def phase_loopy():
    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.inference import BeliefPropagation, BeliefPropagationWithMessagePassing, Mplp
    from pgmpy_tpu_torch.ops import bincount as bc
    from pgmpy_tpu_torch.ops import einsum, loopy
    from pgmpy_tpu_torch.utils.interop import factor_graph_from_numpy, markov_network_from_numpy

    scopes, cards, tables, variables, messages = loopy_grid()
    star_scopes = [["hub", f"l{k:03d}"] for k in range(STAR_LEAVES)]
    star_rng = np.random.default_rng(SEED + 6)
    star_tabs = [np.exp(0.2 * star_rng.standard_normal((2, 2))) for _ in range(STAR_LEAVES)]
    small = grid_tables(8, 1)
    mplp_cases = {"v4_grid": mplp_grid(3, 3, 55),
                  "frustrated": mplp_grid(MPLP_FRUSTRATED_SIDE, MPLP_FRUSTRATED_SIDE, 8, True)}

    # ---- the main path, counted: loopy BP on the grid, the star, the 8 x 8
    # grid, Mplp on both grids
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    fg = factor_graph_from_numpy(scopes, cards, tables)
    bp = BeliefPropagationWithMessagePassing(fg)
    virtual = virtual_factors(variables, messages)
    build_s = time.time() - t0
    t0 = time.time()
    beliefs = bp.query(variables, virtual_evidence=virtual)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    grid_launches = {"flood": loopy.LAUNCHES, **einsum.LAUNCHES}
    rounds = bp._program.last_rounds
    star = BeliefPropagationWithMessagePassing(
        factor_graph_from_numpy(star_scopes, {v: 2 for s in star_scopes for v in s}, star_tabs))
    star_beliefs = star.query(["hub", "l000", "l599"])
    loopy8 = BeliefPropagationWithMessagePassing(factor_graph_from_numpy(*small))
    loopy8_beliefs = loopy8.query(["x0_0", "x3_4", "x7_7"])
    loopy_k3 = dict(einsum.LAUNCHES)
    mplp_results = {}
    for name, (m_scopes, m_cards, m_tables) in mplp_cases.items():
        mplp = Mplp(markov_network_from_numpy(m_scopes, m_cards, m_tables))
        t0 = time.time()
        assignment = mplp.map_query()
        mplp_results[name] = (assignment, mplp.get_integrality_gap(), time.time() - t0,
                              len(mplp.triplets))
    table_launches, bincount_launches = bc.TABLE_LAUNCHES, bc.LAUNCHES
    record_jt("loopy")
    log(f"loopy_path table_count_launches {table_launches} bincount_launches {bincount_launches}")
    check(grid_launches == {"flood": 1, "plan_block": 0, "plan_grid": 0},
          f"loopy grid query: launches {grid_launches} (want one flood and no K3)")
    check(loopy_k3 == {"plan_block": 0, "plan_grid": 0},
          f"loopy BP's three queries launched K3: {loopy_k3}")
    log(f"loopy_launches grid_query {grid_launches}; the three loopy BP queries (grid, star, "
        f"8 x 8) flood {GATHER_PATH_LAUNCHES['loopy']['loopy_bp/flood']} K3 {loopy_k3}; path B's "
        f"K3 after Mplp: plan_block {GATHER_PATH_LAUNCHES['loopy']['einsum_plan/plan_block']} "
        f"plan_grid {GATHER_PATH_LAUNCHES['loopy']['einsum_plan/plan_grid']}")

    # ---- the grid: the CPU run, rounds, the query's time and where it goes
    query_s = host_median_s(lambda: bp.query(variables, virtual_evidence=virtual), reps=2)
    split = dict(bp.timings)
    program = bp._program
    staged = bp._flood_inputs({v: np.asarray(m) for v, m in messages.items()})
    # a flood: one upload of the fixed and initial messages, a launch that
    # synchronises nothing, one read of the round count
    on_card = [torch.as_tensor(a, dtype=program.dtype, device=program.device)
               for a in staged[1:3]]
    launch_syncs = sync_sites(lambda: loopy.flood(program.plan, *on_card, staged[3],
                                                  program.max_iter, program._tol_eff))
    flood_syncs = sync_sites(lambda: program.run(*staged[1:]))
    check(launch_syncs == [] and len(flood_syncs) == 2 and len(set(flood_syncs)) == 2,
          f"loopy flood: the launch synchronised at {launch_syncs}, program.run at "
          f"{flood_syncs} (want nothing, and one upload and one read)")
    query_syncs = len(sync_sites(lambda: bp.query(variables, virtual_evidence=virtual)))
    fresh = fresh_profile()
    small_kernels = sum(c for c, _ in fresh["loopy_names"].values())
    small_device_ms = sum(us for _, us in fresh["loopy_names"].values()) / 1e3
    small_flood = sum(c for n, (c, _) in fresh["loopy_names"].items() if "flood_kernel" in n)
    small_k3 = sum(c for n, (c, _) in fresh["loopy_names"].items() if "plan_" in n)
    check(small_flood == 1 and small_k3 == 0,
          f"the {LOOPY_PROFILE_SIDE} x {LOOPY_PROFILE_SIDE} grid's query ran {small_flood} "
          f"flood kernels and {small_k3} K3 kernels on the profiler (want 1 and 0)")
    with on_device("cpu"):
        cpu_bp = BeliefPropagationWithMessagePassing(factor_graph_from_numpy(scopes, cards, tables))
        cpu_beliefs = cpu_bp.query(variables, virtual_evidence=virtual_factors(variables, messages))
    cpu_rounds = cpu_bp._program.last_rounds
    grid_err = max(float(np.abs(beliefs[v].values.double().cpu().numpy()
                                - cpu_beliefs[v].values.double().numpy()).max())
                   for v in variables)
    # the round count is a float32 threshold, which the card's and the CPU's
    # sums may put a round apart
    check(abs(rounds - cpu_rounds) <= 1 and rounds < program.max_iter and grid_err <= 1e-4,
          f"loopy grid: {rounds} rounds (CPU {cpu_rounds}), {grid_err} from the CPU run")

    # ---- K7 against its plain version: the grid's query inputs, the star,
    # the 8 x 8 grid, the mixed graph; the grid's flood timed
    k7 = k7_case(f"grid{GRID_SIDE}_virtual", program.plan, tables, messages)
    for name, (g_scopes, g_cards, g_tables) in (
            ("star600", (star_scopes, {v: 2 for s in star_scopes for v in s}, star_tabs)),
            ("grid8", small), ("mixed", mixed_graph())):
        k7_case(name, loopy.FloodPlan(g_scopes, g_cards), g_tables, {})
    err, args, k7_rounds = k7[torch.float32]
    ms = cuda_median_ms(lambda: loopy.flood_cuda(*args[:4], 100, args[4]), device_only=True)
    plain_ms = cuda_median_ms(lambda: loopy.flood_reference(*args[:4], 100, args[4]), reps=5)
    bound_ms, bound_by = loopy.bound_ms(program.plan, k7_rounds, torch.float32)
    GATHER_ROWS["loopy_bp/flood"] = {"err": max(err, k7[torch.float64][0]), "ms": ms,
                                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                                     "bound_by": bound_by, "library_ms": None}
    log(f"k7 flood grid{GRID_SIDE} edges={program.n_edges} rounds={k7_rounds} float32 "
        f"kernel_ms={ms:.5f} (device time, median of 20) device_ms_per_round={ms / k7_rounds:.5f} plain_ms={plain_ms:.4f} (median "
        f"of 5, its host reads included) bound_ms={bound_ms:.6f} ({bound_by}) library: none "
        f"max_abs_err={err:.3e}")

    # ---- the plain round (the host loop's unit before K7) and K3 on its
    # contractions
    f2v = torch.as_tensor(program.mask / program.cards[:, None], dtype=program.dtype,
                          device=program.device)
    log_fixed = torch.log(torch.as_tensor(program.mask, dtype=program.dtype, device=program.device))
    flood_tables = bp._tables[2]
    for k, call in enumerate(capture_contractions(
            lambda: program.round(f2v, log_fixed, flood_tables), [loopy])):
        k3_case(f"loopy_round_128x128[{k}]", call)
    by_name = kernels_by_name(lambda: program.round(f2v, log_fixed, flood_tables))
    plain_kernels = sum(c for c, _ in by_name.values())
    plain_device_ms = sum(us for _, us in by_name.values()) / 1e3
    round_s = host_median_s(lambda: float(program.round(f2v, log_fixed, flood_tables)[1]), reps=5)
    log(f"loopy_grid side={GRID_SIDE} variables={len(variables)} factors={len(scopes)} messages="
        f"{program.n_edges} rounds {rounds} loopy_rounds_per_s {rounds / query_s:.1f} query_s "
        f"{query_s:.4f} (median of 2; first call {first_s:.3f} s, graph build {build_s:.3f} s) "
        f"flood_launches 1 flood_sync_calls 2 (one upload, one read: {' '.join(flood_syncs)}; "
        f"the launch 0) query_sync_calls {query_syncs} flood_share_of_query "
        f"{ms / (query_s * 1e3):.6f} split staging_s "
        f"{split['staging_s']:.4f} flood_s {split['flood_s']:.4f} beliefs_s "
        f"{split['beliefs_s']:.4f} results_s {split['results_s']:.4f}; the plain round: "
        f"kernels {plain_kernels:.0f} device_ms {plain_device_ms:.4f} host_s {round_s:.5f}")
    log(f"loopy_grid{LOOPY_PROFILE_SIDE} (fresh process) query kernels {small_kernels} (flood "
        f"{small_flood}, K3 {small_k3}) device_ms {small_device_ms:.4f} query_s "
        f"{fresh['loopy_query_s']:.4f} (median of 3) idle_share "
        f"{1 - small_device_ms / (fresh['loopy_query_s'] * 1e3):.4f} by name "
        f"{json.dumps(fresh['loopy_names'])}")
    log(f"loopy_grid_check ok beliefs within {grid_err:.3e} (limit 1e-4) of the CPU run, "
        f"rounds {rounds} on the card and {cpu_rounds} on the CPU (limit: one apart)")

    # ---- the 8 x 8 grid against the junction tree, the star against exact
    exact = BeliefPropagation(markov_network_from_numpy(*small))
    exact.calibrate()
    small_err = max(float(np.abs(loopy8_beliefs[v].values.double().cpu().numpy()
                                 - exact.query([v], show_progress=False).values.double()
                                 .cpu().numpy()).max()) for v in loopy8_beliefs)
    check(small_err <= 0.02, f"loopy 8 x 8 grid: {small_err} from the junction tree")
    log_hub = sum(np.log(t.sum(axis=1)) for t in star_tabs)
    hub = np.exp(log_hub - log_hub.max())
    hub /= hub.sum()
    star_want = {"hub": hub}
    for k in (0, 599):
        t = star_tabs[k]
        star_want[f"l{k:03d}"] = (hub[:, None] * t / t.sum(axis=1, keepdims=True)).sum(axis=0)
    star_err = max(float(np.abs(star_beliefs[v].values.double().cpu().numpy()
                                - star_want[v]).max()) for v in star_want)
    check(star_err <= 1e-5, f"loopy star: {star_err} from the exact beliefs")
    log(f"loopy_small_check ok the 8 x 8 grid (seed 1) within {small_err:.3e} (limit 0.02) of "
        f"the junction tree; the {STAR_LEAVES}-leaf star within {star_err:.3e} (limit 1e-5) of "
        f"its exact beliefs in {star._program.last_rounds} rounds")

    # ---- Mplp: the CPU run
    for name, (m_scopes, m_cards, m_tables) in mplp_cases.items():
        with on_device("cpu"):
            cpu_assignment = Mplp(markov_network_from_numpy(m_scopes, m_cards, m_tables)).map_query()
        assignment, gap, mplp_s, triplets = mplp_results[name]
        check(assignment == cpu_assignment, f"Mplp {name}: the assignment differs from the CPU run's")
        log(f"mplp_{name} variables={len(m_cards)} factors={len(m_scopes)} mplp_s {mplp_s:.3f} "
            f"integrality_gap {gap:.6g} triplets {triplets}; assignment equal to the CPU run's")
    check(config.DEVICE.type == "cuda", "device left on the CPU")
    return table_launches, bincount_launches


# --------------------------------------------------------------------------- #
# the causal and SEM lane
# --------------------------------------------------------------------------- #
# MUNIN's do-query: a node with two parents, 7 x 7 = 49 combinations, whose
# state OTHER has no zero in its CPD row.  Every state of every MUNIN node
# with three parents (R_LNLW_APB_MUSIZE among them) has a zero at some
# combination of positive weight, so its adjusted answer is NaN in the JAX
# package's semantics; R_LNLW_APB_MUSIZE's 100 combinations still run, and
# the batched answer must be NaN where the loop's is.
CAUSAL_DO = ("R_APB_EFFMUS", "OTHER")
CAUSAL_DO_NAN = ("R_LNLW_APB_MUSIZE", "NORMAL")
SEM_ROWS = 50_000
IV_ROWS = 500_000
ADJUSTMENT_PAIRS = 20
MAG_BIDIRECTED = 6
# lower_manipulation's visibility test walks every simple path from each
# non-adjacent node until one qualifies: on this MAG it ends within a second
# for these nodes only (the others take 10-25 s each on a CPU)
MAG_MANIPULATED = ["CATECHOL", "LVEDVOLUME", "STROKEVOLUME"]
# Frontdoor enumerates the power set of the other observed nodes: only DAGs
# with at most this many candidates (8 of the 12 teaching DAGs)
FRONTDOOR_MAX_CANDIDATES = 11
# Fits on the card are held to the CPU's run of the same steps (the CPU's with
# exit_delta=0).  Bollen's whole fit is reproducible to float32 rounding: a
# relative 1e-7 change of its rows moves B by 1.3e-06 after 2,048 steps
# (tools/sem_fit_sensitivity.py on a CPU).  ecoli70's is not: Adam at lr 0.05
# is chaotic about that optimum, and the same change moves B by 9.7e-06 after
# 128 steps but 1.8e-03 after 256 (in float64 a 1e-15 change moves it 3.4e-04
# after 1,216).  So ecoli70 is held to the CPU over its first 64-step chunk,
# and its whole fit to its OLS coefficients, the ML optimum of a recursive path
# model: ten CPU fits of rows changed by 0 to 9e-7 stopped after 384 to 2,048
# steps between 1.0e-04 and 2.3e-03 from them.
SEM_FIT_LIMIT = 3e-5
SEM_OLS_LIMIT = 5e-3
# Bollen's fitted loadings and regressions against the parameters the rows
# were drawn from, in asymptotic standard errors of the ML estimate at
# SEM_ROWS rows: over 11 free entries, |z| > 5 has probability ~6e-6.  That
# holds for a fit that reached its stopping rule: with the default max_iter
# (2000) Adam stops Bollen's fit at 2,048 steps before exit_delta does, with
# dem60 -> y2 3.1 standard errors off on average over 16 draws; so Bollen is
# fitted with max_iter 8000 (tools/sem_fit_sensitivity.py).
BOLLEN_Z_LIMIT = 5.0
BOLLEN_MAX_ITER = 8000
# estimate_ate: a pair whose backdoor enumeration ends at once (the empty set
# is valid), and a pair that needs {eutG}, given explicitly: any ecoli70 edge
# that needs a non-empty set enumerates 2^18 or more subsets (119 s for
# sucA -> yfaD on a CPU)
ATE_SMALLEST = ("asnA", "lacA")
ATE_EXPLICIT = ("sucA", "yfaD", frozenset({"eutG"}))
# Bollen's industrialization and political democracy model (lavaan's
# documentation); parameters close to lavaan's published estimates
BOLLEN_LATENTS = ["ind60", "dem60", "dem65"]
BOLLEN_EDGES = {
    ("ind60", "x1"): 1.0, ("ind60", "x2"): 2.180, ("ind60", "x3"): 1.819,
    ("dem60", "y1"): 1.0, ("dem60", "y2"): 1.257, ("dem60", "y3"): 1.058, ("dem60", "y4"): 1.265,
    ("dem65", "y5"): 1.0, ("dem65", "y6"): 1.186, ("dem65", "y7"): 1.280, ("dem65", "y8"): 1.266,
    ("ind60", "dem60"): 1.483, ("ind60", "dem65"): 0.572, ("dem60", "dem65"): 0.837,
}
BOLLEN_SCALING = {("ind60", "x1"), ("dem60", "y1"), ("dem65", "y5")}
BOLLEN_ERR_COV = {("y1", "y5"): 0.624, ("y2", "y4"): 1.313, ("y2", "y6"): 2.153,
                  ("y3", "y7"): 0.795, ("y4", "y8"): 0.348, ("y6", "y8"): 1.356}
BOLLEN_VARIANCES = {"x1": 0.082, "x2": 0.120, "x3": 0.467, "y1": 1.891, "y2": 7.373,
                    "y3": 5.067, "y4": 3.148, "y5": 2.351, "y6": 4.954, "y7": 3.431,
                    "y8": 3.254, "ind60": 0.448, "dem60": 3.956, "dem65": 0.172}


def cpd_tuples(model):
    return [(c.variable, c.variable_card, c.get_values(), c.variables[1:],
             [int(x) for x in c.cardinality[1:]], c.state_names) for c in model.get_cpds()]


def truncated_network(model, do_var, state):
    """The network of P(. | do(do_var = state)): the edges into ``do_var``
    cut and its CPD a point mass on ``state``."""
    from pgmpy_tpu_torch.utils.interop import bn_from_numpy

    states = list(model.states[do_var])
    point = np.zeros((len(states), 1))
    point[states.index(state), 0] = 1.0
    cpds = [t if t[0] != do_var else (do_var, len(states), point, [], [], {do_var: states})
            for t in cpd_tuples(model)]
    return bn_from_numpy([e for e in model.edges() if e[1] != do_var], cpds,
                         nodes=list(model.nodes()))


def factor_diff(a, b):
    """Max |a - b| over two factors' values (NaN where exactly one is NaN)."""
    x, y = a.values.double().cpu(), b.values.double().cpu()
    check(list(a.variables) == list(b.variables), "factor variables differ")
    check(bool((x.isnan() == y.isnan()).all()), "factor NaN patterns differ")
    both = ~x.isnan()
    return float((x[both] - y[both]).abs().max()) if bool(both.any()) else 0.0


def do_query_case(name, model, cpu_model, variables, do, algo, truncated_limit):
    """A do-query on the card (one batched query), against the JAX package's
    per-combination loop on the card, the truncated factorisation and the
    CPU run; returns the numbers the phase prints."""
    from pgmpy_tpu_torch.inference import BeliefPropagation, CausalInference, VariableElimination

    engine = {"ve": VariableElimination, "bp": BeliefPropagation}[algo]
    loop_engine = type(f"Loop{engine.__name__}", (engine,), {"query_batch": None})
    ci = CausalInference(model)
    run = lambda: ci.query(variables, do=do, inference_algo=algo)  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.time()
    got = run()
    torch.cuda.synchronize()
    first_s = time.time() - t0
    query_s = host_median_s(run, reps=1)
    t0 = time.time()
    loop = ci.query(variables, do=do, inference_algo=loop_engine)
    torch.cuda.synchronize()
    loop_s = time.time() - t0
    (do_var, state), = do.items()
    combos = int(np.prod([model.get_cardinality(p) for p in model.get_parents(do_var)]))
    loop_err = factor_diff(got, loop)
    check(got.values.is_cuda and loop_err <= 1e-5,
          f"{name}: batched and per-combination answers differ by {loop_err}")
    finite = bool(torch.isfinite(got.values).all())
    out = {"first_s": first_s, "query_s": query_s, "loop_s": loop_s, "combos": combos,
           "loop_err": loop_err, "finite": finite}
    if finite:
        truth = engine(truncated_network(model, do_var, state)).query(variables)
        out["truncated_err"] = factor_diff(got, truth)
        check(out["truncated_err"] <= truncated_limit,
              f"{name}: {out['truncated_err']} from the truncated factorisation")
    with on_device("cpu"):
        cpu = CausalInference(cpu_model).query(variables, do=do, inference_algo=algo)
    out["cpu_err"] = factor_diff(got, cpu)
    check(out["cpu_err"] <= 1e-5, f"{name}: {out['cpu_err']} from the CPU run")
    return got, out


def teaching_dag(name):
    """A teaching DAG with the exposure and outcome its dagitty file marks."""
    import re

    from pgmpy_tpu_torch.utils import get_example_model
    from pgmpy_tpu_torch.utils.utils import _EXAMPLE_DIR

    with open(os.path.join(_EXAMPLE_DIR, f"{name}.txt")) as fh:
        text = fh.read()
    dag = get_example_model(name)
    for role in ("exposure", "outcome"):
        dag = dag.with_role(role, [re.search(r"^(\S+) \[" + role, text, re.M).group(1)],
                            inplace=False)
    return dag


def identification_outputs(munin, alarm):
    """Adjustment and Frontdoor on the teaching DAGs, minimal adjustment sets
    of seeded (X, Y) pairs of MUNIN and the MAG operations on ALARM: host
    graph code, returned whole to be compared with the CPU run."""
    import networkx as nx

    from pgmpy_tpu_torch.base import MAG
    from pgmpy_tpu_torch.identification import Adjustment, Frontdoor
    from pgmpy_tpu_torch.inference import CausalInference
    from pgmpy_tpu_torch.utils.utils import DAG_MODELS

    out, skipped = {}, []
    for name in sorted(DAG_MODELS):
        dag = teaching_dag(name)
        found, ok = Adjustment("minimal")(dag)
        row = [ok, found.get_role("adjustment")]
        x, y = dag.get_role("exposure")[0], dag.get_role("outcome")[0]
        if len(set(dag.observed) - {x, y}) <= FRONTDOOR_MAX_CANDIDATES:
            found, ok = Frontdoor("all")(dag)
            row += [ok, sorted(map(sorted, (g.get_role("frontdoor") for g in found)))
                    if ok else None]
        else:
            skipped.append(name)
        out[name] = row
    rng = np.random.default_rng(SEED + 11)
    nodes = sorted(munin.nodes())
    ci = CausalInference(munin)
    pairs = []
    while len(pairs) < ADJUSTMENT_PAIRS:
        x = nodes[rng.integers(len(nodes))]
        below = sorted(nx.descendants(munin, x))
        if below:
            pairs.append((x, below[rng.integers(len(below))]))
    out["munin_minimal_adjustment"] = [(x, y, ci.get_minimal_adjustment_set(x, y))
                                       for x, y in pairs]
    names = sorted(alarm.nodes())
    mag = MAG(directed_ebunch=list(alarm.edges()))
    rng = np.random.default_rng(SEED + 12)
    added = []
    while len(added) < MAG_BIDIRECTED:
        u, v = (str(n) for n in rng.choice(names, 2, replace=False))
        if mag.has_edge(u, v):
            continue
        mag.add_edge(u, v, ">", ">")
        if mag.is_ancestral():
            added.append((u, v))
        else:
            mag.remove_edge(u, v)
    triples = [(names[a], names[b], [names[c]]) for a, b, c in rng.choice(len(names), (40, 3))
               if len({a, b, c}) == 3]
    marks = lambda g: sorted((tuple(sorted((u, v))), tuple(sorted(d["marks"].items())))  # noqa: E731
                             for u, v, d in g.edges(data=True))
    out["alarm_mag"] = (added, [mag.is_mseparated(x, y, z) for x, y, z in triples],
                        marks(mag.lower_manipulation(set(MAG_MANIPULATED))),
                        marks(mag.upper_manipulation(set(MAG_MANIPULATED))))
    return out, skipped, pairs


def bollen_parameters(alg):
    """Bollen's B and S at the parameters above, in ``alg``'s variable order."""
    idx = {v: i for i, v in enumerate(alg.variables)}
    n = len(idx)
    B, S = np.zeros((n, n)), np.zeros((n, n))
    for (u, v), w in BOLLEN_EDGES.items():
        B[idx[v], idx[u]] = w
    for (u, v), w in BOLLEN_ERR_COV.items():
        S[idx[u], idx[v]] = S[idx[v], idx[u]] = w
    for v, w in BOLLEN_VARIANCES.items():
        S[idx[v], idx[v]] = w
    return B, S


def bollen_data(seed):
    """The Bollen SEM (scaling loadings fixed at 1) and SEM_ROWS rows drawn
    from it at the parameters above; checks that the implied covariance of
    the draw was computed on the card."""
    from pgmpy_tpu_torch.models import SEM

    sem = SEM.from_graph(
        ebunch=[(u, v, 1.0) if (u, v) in BOLLEN_SCALING else (u, v) for u, v in BOLLEN_EDGES],
        latents=BOLLEN_LATENTS, err_corr=list(BOLLEN_ERR_COV))
    alg = sem.to_lisrel()
    alg.set_params(*bollen_parameters(alg))
    devices, implied = [], alg.implied_covariance
    alg.implied_covariance = lambda B, S: (devices.append(B.device), implied(B, S))[1]
    df = alg.generate_samples(n_samples=SEM_ROWS, seed=seed)
    check([d.type for d in devices] == ["cuda"], f"Bollen's Sigma was built on {devices}")
    return sem, df


def bollen_standard_errors(alg, rows):
    """{(row, column): standard error} of the ML estimates of B's free
    entries at the parameters the rows were drawn from: the inverse of the
    Fisher information (rows / 2) tr(Sigma^-1 dSigma_i Sigma^-1 dSigma_j)
    over every parameter the fit frees (B's free entries, every variance, the
    error covariances), in float64 on the host with this script's own
    F (I - B)^-1 S (I - B)^-T F^T."""
    B0, S0 = (torch.tensor(m, dtype=torch.float64) for m in bollen_parameters(alg))
    n = len(alg.variables)
    b_at = np.argwhere(alg.B_mask & np.isnan(alg.B_fixed)).T
    s_at = np.array([(i, j) for i, j in np.argwhere(alg.S_mask & np.isnan(alg.S_fixed))
                     if i < j]).T
    diag = np.arange(n)
    observed = [alg.variables.index(v) for v in alg.observed]
    k = b_at.shape[1]

    def sigma(theta):
        B = B0.index_put((torch.as_tensor(b_at[0]), torch.as_tensor(b_at[1])), theta[:k])
        S = S0.index_put((torch.as_tensor(diag), torch.as_tensor(diag)), theta[k:k + n])
        S = S.index_put((torch.as_tensor(s_at[0]), torch.as_tensor(s_at[1])), theta[k + n:])
        S = S.index_put((torch.as_tensor(s_at[1]), torch.as_tensor(s_at[0])), theta[k + n:])
        inv = torch.linalg.inv(torch.eye(n, dtype=torch.float64) - B)
        return (inv @ S @ inv.T)[observed][:, observed]

    theta = torch.cat([B0[tuple(b_at)], S0[diag, diag], S0[tuple(s_at)]])
    jac = torch.autograd.functional.jacobian(sigma, theta)
    scaled = torch.einsum("ab,bci->aci", torch.linalg.inv(sigma(theta)), jac)
    information = rows / 2 * torch.einsum("abi,baj->ij", scaled, scaled)
    se = torch.linalg.inv(information).diagonal()[:k].sqrt().numpy()
    return {(int(r), int(c)): float(e) for r, c, e in zip(*b_at, se)}


def profiled_busy(fn):
    """(kernels, busy device ms, wall ms, {name: (count, us)}) of one call of
    ``fn`` under ``torch.profiler``; busy time is the union of the kernels'
    intervals (cuSOLVER's kernels overlap), of the session with the most
    records of three (see :func:`profiled`).  User annotations that the
    profiler also puts on the device's timeline (``Optimizer.step#Adam.step``
    spans a whole step) are left out."""
    best, counts = (0, 0.0, 0.0, {}), []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        with profile_session() as prof:
            fn()
        wall_ms = (time.time() - t0) * 1e3
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        busy, end = 0.0, float("-inf")
        by_name = {}
        for e in sorted(kernels, key=lambda e: e.time_range.start):
            start, stop = e.time_range.start, e.time_range.end
            busy += max(0.0, stop - max(start, end))
            end = max(end, stop)
            count, total = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (count + 1, total + stop - start)
        counts.append(len(kernels))
        if len(kernels) > best[0]:
            best = (len(kernels), busy / 1e3, wall_ms, by_name)
    count_sessions(counts)
    return best


class StepCount:
    """A loss function that counts its calls under autograd: one per
    optimizer step (``fit`` takes its final loss without gradients)."""

    def __init__(self, fn):
        self.fn, self.steps = fn, 0

    def __call__(self, params, args):
        self.steps += torch.is_grad_enabled()
        return self.fn(params, args)


def sem_fit_case(name, sem, df, hold_whole_fit, max_iter=2000):
    """``SEMEstimator.fit(method="ml")`` with its defaults but ``max_iter`` on
    the card; the kernels, busy device time and host time per step.  The whole
    fit (``hold_whole_fit``) or its first 64-step chunk is held to the CPU's
    run of the same steps."""
    from pgmpy_tpu_torch.estimators import SEMEstimator
    from pgmpy_tpu_torch.utils.optimizer import CHUNK

    estimator = SEMEstimator(sem)
    loss = estimator.ml_loss = StepCount(estimator.ml_loss)
    torch.cuda.synchronize()
    t0 = time.time()
    summary = estimator.fit(df, method="ml", max_iter=max_iter)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    steps = loss.steps
    t0 = time.time()
    chunk = SEMEstimator(sem).fit(df, method="ml", max_iter=CHUNK)
    torch.cuda.synchronize()
    chunk_s = time.time() - t0
    # a 16-step fit, profiled: kernels, busy device time and the busy share
    kernels, busy_ms, wall_ms, by_name = profiled_busy(
        lambda: SEMEstimator(sem).fit(df, method="ml", max_iter=16))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
    held, held_steps = (summary, steps) if hold_whole_fit else (chunk, CHUNK)
    with on_device("cpu"):
        t0 = time.time()
        cpu = SEMEstimator(sem).fit(df, method="ml", max_iter=held_steps, exit_delta=0.0)
        cpu_s = time.time() - t0
    err = float(np.abs(held["B"] - cpu["B"]).max())
    check(np.isfinite(summary["B"]).all() and np.isfinite(summary["loss"]),
          f"{name}: the fit is not finite")
    check(err <= SEM_FIT_LIMIT, f"{name}: B after {held_steps} steps {err} from the CPU run's")
    log(f"sem_{name} rows={len(df)} variables={len(summary['variables'])} observed="
        f"{summary['S_emp'].shape[0]} sem_fit_s {fit_s:.3f} max_iter {max_iter} steps {steps} "
        f"host_reads "
        f"{-(-steps // CHUNK)} (one per {CHUNK}-step chunk) "
        f"loss {summary['loss']:.6f} kernels_per_step {kernels / 16:.1f} device_ms_per_step "
        f"{busy_ms / 16:.4f} step_host_ms {chunk_s / CHUNK * 1e3:.3f} idle_share "
        f"{1 - busy_ms / wall_ms:.4f} (host ms from a {CHUNK}-step fit; kernels, busy device "
        f"ms and the busy share from a profiled 16-step fit, whose largest device operations "
        f"are {'; '.join(f'{n[:48]} x{c} {us / 1e3:.3f} ms' for n, (c, us) in top)}); "
        f"B after {held_steps} steps within {err:.3e} of the CPU run's (limit "
        f"{SEM_FIT_LIMIT}; the CPU's {held_steps} steps {cpu_s:.3f} s)")
    return summary


def phase_causal(munin):
    """The causal and SEM lane: do-queries on MUNIN (BeliefPropagation) and
    ALARM (VariableElimination), identification on the teaching DAGs, MUNIN
    and a MAG on ALARM, SEM fits of Bollen's model and of ecoli70, 2SLS and
    ``estimate_ate``."""
    import networkx as nx

    from pgmpy_tpu_torch.base import DAG
    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.estimators import IVEstimator
    from pgmpy_tpu_torch.inference import CausalInference, LinearEstimator
    from pgmpy_tpu_torch.models import SEM, LinearGaussianBayesianNetwork
    from pgmpy_tpu_torch.ops import bincount as bc
    from pgmpy_tpu_torch.utils import get_example_model
    from pgmpy_tpu_torch.utils.interop import bn_from_numpy

    alarm = get_example_model("alarm")
    ecoli = get_example_model("ecoli70")
    rng = np.random.default_rng(SEED + 13)
    n_iv = IV_ROWS
    u, z1, z2 = rng.standard_normal((3, n_iv))
    x_iv = 0.9 * z1 + 0.5 * z2 + u + 0.3 * rng.standard_normal(n_iv)
    iv_frame = pd.DataFrame({"Z1": z1, "Z2": z2, "X": x_iv,
                             "Y": 1.7 * x_iv - 2.0 * u + 0.3 * rng.standard_normal(n_iv)})
    iv_dag = DAG([("Z1", "X"), ("Z2", "X"), ("X", "Y"), ("U", "X"), ("U", "Y")], latents={"U"})

    with on_device("cpu"):
        cpu_munin, cpu_alarm = (bn_from_numpy(list(m.edges()), cpd_tuples(m), nodes=list(m.nodes()))
                                for m in (munin, alarm))

    # ---- the main path, counted
    torch.cuda.synchronize()
    reset_launches()
    phase_t0 = time.time()
    cases = {
        "munin_bp": do_query_case("munin_bp", munin, cpu_munin,
                                  [sorted(munin.get_children(CAUSAL_DO[0]))[0]],
                                  dict([CAUSAL_DO]), "bp", 1e-3),
        "munin_bp_nan": do_query_case("munin_bp_nan", munin, cpu_munin,
                                      [sorted(munin.get_children(CAUSAL_DO_NAN[0]))[0]],
                                      dict([CAUSAL_DO_NAN]), "bp", 1e-3),
        "alarm_ve_HR": do_query_case("alarm_ve_HR", alarm, cpu_alarm, ["HR"],
                                     {"CATECHOL": "HIGH"}, "ve", 1e-5),
        "alarm_ve_BP": do_query_case("alarm_ve_BP", alarm, cpu_alarm, ["BP"],
                                     {"CATECHOL": "HIGH"}, "ve", 1e-5),
    }
    t0 = time.time()
    ident, frontdoor_skipped, pairs = identification_outputs(munin, alarm)
    ident_s = time.time() - t0
    bollen, bollen_df = bollen_data(SEED + 14)
    bollen_fit = sem_fit_case("bollen", bollen, bollen_df, hold_whole_fit=True,
                              max_iter=BOLLEN_MAX_ITER)
    ecoli_df = ecoli.simulate(SEM_ROWS, seed=SEED + 15)
    ecoli_fit = sem_fit_case("ecoli70", SEM.from_graph(ebunch=list(ecoli.edges())), ecoli_df,
                             hold_whole_fit=False)
    torch.cuda.synchronize()
    t0 = time.time()
    iv_effect, iv_info = IVEstimator(iv_dag).fit("X", "Y", iv_frame)
    iv_s = time.time() - t0
    t0 = time.time()
    ate = CausalInference(ecoli).estimate_ate(*ATE_SMALLEST, ecoli_df)
    ate_s = time.time() - t0
    ate_explicit = CausalInference(ecoli).estimate_ate(
        *ATE_EXPLICIT[:2], ecoli_df, estimand_strategy=ATE_EXPLICIT[2])
    table_launches, bincount_launches = bc.TABLE_LAUNCHES, bc.LAUNCHES
    record_jt("causal")
    log(f"causal_path table_count_launches {table_launches} bincount_launches "
        f"{bincount_launches} (no count kernel on this lane)")

    # ---- do-queries
    for name, (_, out) in cases.items():
        log(f"causal_{name} combinations={out['combos']} causal_query_s {out['query_s']:.4f} "
            f"(a warm call; the first {out['first_s']:.3f} s) causal_query_loop_s "
            f"{out['loop_s']:.4f} finite {out['finite']} loop_err {out['loop_err']:.3e} "
            f"truncated_err {out.get('truncated_err', float('nan')):.3e} cpu_err "
            f"{out['cpu_err']:.3e}")
    check(all(cases[k][1]["finite"] for k in ("munin_bp", "alarm_ve_HR", "alarm_ve_BP")),
          "a do-query is not finite")
    check(not cases["munin_bp_nan"][1]["finite"],
          f"{CAUSAL_DO_NAN[0]}'s adjusted answer is finite")
    ci = CausalInference(munin)
    do_q = dict([CAUSAL_DO])
    child = list(cases["munin_bp"][0].variables)
    kernels, device_ms = profiled(lambda: ci.query(child, do=do_q, inference_algo="bp"))
    log(f"causal_munin_bp kernels_per_call {kernels:.0f} device_ms {device_ms:.4f} "
        f"(one query: the weights' query, one query_batch of the combinations, the sum)")
    log(f"causal_query_check ok batched within 1e-5 of the per-combination loop on the card "
        f"and of the CPU run; the truncated factorisation within 1e-3 (MUNIN, another junction "
        f"tree) and 1e-5 (ALARM, VariableElimination)")

    # ---- identification against the CPU run
    with on_device("cpu"):
        cpu_ident, _, _ = identification_outputs(cpu_munin, cpu_alarm)
    check(ident == cpu_ident, "identification differs from the CPU run")
    mas = ident["munin_minimal_adjustment"]
    log(f"identification teaching_dags {len(ident) - 2} frontdoor_skipped {frontdoor_skipped} "
        f"munin_pairs {len(pairs)} empty_sets {sum(1 for *_, s in mas if s == set())} "
        f"none {sum(1 for *_, s in mas if s is None)} alarm_mag bidirected "
        f"{len(ident['alarm_mag'][0])} mseparated {sum(ident['alarm_mag'][1])}/"
        f"{len(ident['alarm_mag'][1])} identification_s {ident_s:.3f}; equal to the CPU run's")

    # ---- ecoli70's fit against its OLS coefficients
    ols = LinearGaussianBayesianNetwork(list(ecoli.edges()))
    ols.add_nodes_from(ecoli.nodes())
    ols.fit(ecoli_df)
    names = ecoli_fit["variables"]
    ols_err = max(abs(ecoli_fit["B"][names.index(c.variable), names.index(p)] - b)
                  for c in ols.get_cpds() for p, b in zip(c.evidence, c.beta[1:]))
    check(ols_err <= SEM_OLS_LIMIT, f"ecoli70: fitted B {ols_err} from OLS")
    log(f"sem_ecoli70_ols_check ok fitted B within {ols_err:.3e} of the per-equation OLS "
        f"coefficients (limit {SEM_OLS_LIMIT})")

    # ---- Bollen's fit against the parameters its rows were drawn from
    alg = bollen.to_lisrel()
    check(list(alg.variables) == list(bollen_fit["variables"]), "Bollen's variables moved")
    se = bollen_standard_errors(alg, len(bollen_df))
    truth, _ = bollen_parameters(alg)
    z = {at: abs(bollen_fit["B"][at] - truth[at]) / e for at, e in se.items()}
    worst = max(z, key=z.get)
    check(z[worst] <= BOLLEN_Z_LIMIT, f"Bollen: fitted B {z[worst]} standard errors from "
          f"the generating {alg.variables[worst[1]]} -> {alg.variables[worst[0]]}")
    log(f"sem_bollen_truth_check ok {len(se)} free entries of B within {z[worst]:.3f} "
        f"standard errors of the generating parameters (worst "
        f"{alg.variables[worst[1]]} -> {alg.variables[worst[0]]}, error "
        f"{abs(bollen_fit['B'][worst] - truth[worst]):.3e}; standard errors "
        f"{min(se.values()):.3e}-{max(se.values()):.3e}; limit {BOLLEN_Z_LIMIT})")

    # ---- IVEstimator against numpy float64 2SLS
    Z = np.column_stack([np.ones(n_iv), z1, z2])
    b1 = np.linalg.lstsq(Z, x_iv, rcond=None)[0]
    want = np.linalg.lstsq(np.column_stack([np.ones(n_iv), Z @ b1]),
                           iv_frame["Y"].to_numpy(), rcond=None)[0][1]
    iv_err = abs(iv_effect - want)
    check(iv_err <= 1e-6 and iv_info["ivs"] == ["Z1", "Z2"], f"2SLS: {iv_effect} vs {want}")
    log(f"iv_2sls rows={n_iv} iv_fit_s {iv_s:.4f} effect {iv_effect:.6f} within {iv_err:.3e} "
        f"of numpy float64 2SLS (limit 1e-6)")

    # ---- estimate_ate against LinearEstimator on the explicit set
    sets = CausalInference(ecoli).get_all_backdoor_adjustment_sets(*ATE_SMALLEST)
    check(sets == frozenset(), f"{ATE_SMALLEST}: backdoor sets {sets}")
    for (x, y), effect, adjust in ((ATE_SMALLEST, ate, frozenset()),
                                   (ATE_EXPLICIT[:2], ate_explicit, ATE_EXPLICIT[2])):
        check(len(list(nx.all_simple_paths(ecoli, x, y))) == 1, f"{x} -> {y}: one path")
        direct = LinearEstimator(ecoli).fit(x, y, Z=adjust, data=ecoli_df)._get_ate()
        check(abs(effect - direct) <= 1e-9 * max(1.0, abs(direct)),
              f"estimate_ate {effect} against LinearEstimator {direct}")
        log(f"ate_ecoli70 {x}->{y} rows={len(ecoli_df)} ate {effect:.6f} adjustment "
            f"{sorted(adjust)}; equal to LinearEstimator on that set")
    log(f"ate_s {ate_s:.4f} ({ATE_SMALLEST[0]}->{ATE_SMALLEST[1]}, estimand_strategy="
        f"'smallest': the backdoor enumeration and the regression)")
    check(config.DEVICE.type == "cuda", "device left on the CPU")
    log(f"phase_causal_main_path_s {time.time() - phase_t0:.1f}")
    return table_launches, bincount_launches


# --------------------------------------------------------------------------- #
# the functional lane on ecoli70
# --------------------------------------------------------------------------- #
FUNCTIONAL_ROWS = 50_000
# Adam at optax's default rate: at 0.05 it never settles on ecoli70 (one CPU
# run swings between 0.02 and 4.7 least-squares standard errors from step 300
# to 1000); at 0.01 it converges smoothly, 0.208 standard errors after 1,600
# steps and 0.043 after 1,800 (CPU rehearsal; the card read 0.0427 at 1,800)
SVI_LR = 0.01
SVI_STEPS = 1600
SVI_CPU_STEPS = 50
FIT_SE_LIMIT = 0.5
# the point fit runs all its steps (exit_delta 0): the stopping rule reads
# two equal float32 losses before Adam has crossed ecoli70's flat directions
# (a CPU rehearsal stopped at 1,152 steps, 0.9 standard errors off)
POINT_MAX_ITER = 1600
MCMC_ROWS = 1000
MCMC_STEPS = 400
# the NUTS chain's draws are autocorrelated; at least this many are counted
# as independent
MCMC_MIN_ESS = 40


def ecoli_parents(ecoli):
    return {v: sorted(ecoli.get_parents(v), key=str) for v in ecoli.nodes()}


def linear_gaussian_cpds(parents):
    """One ``FunctionalCPD`` per node, ``Normal(b0 + sum_p b_p * parent_p,
    sigma)``, every coefficient and scale a learnable ``param``: 0 for the
    coefficients, 1 (softplus-constrained) for the scales."""
    from pgmpy_tpu_torch.factors import FunctionalCPD, param
    from pgmpy_tpu_torch.factors.distributions import Normal

    def make_fn(v):
        def fn(p):
            loc = param(f"{v}|b0", 0.0)
            for q in parents[v]:
                loc = loc + param(f"{v}|{q}", 0.0) * p[q]
            return Normal(loc, param(f"{v}|sigma", 1.0, constraint="positive"))
        return fn

    return [FunctionalCPD(v, make_fn(v), parents[v]) for v in parents]


def functional_network(ecoli, cpds=None):
    from pgmpy_tpu_torch.models import FunctionalBayesianNetwork

    fbn = FunctionalBayesianNetwork(list(ecoli.edges()))
    fbn.add_nodes_from(ecoli.nodes())
    if cpds:
        fbn.add_cpds(*cpds)
    return fbn


def least_squares(df, parents):
    """The closed-form maximum-likelihood fit of every node (numpy float64
    least squares, sigma = sqrt(RSS / n)) and each parameter's standard
    error, keyed as ``linear_gaussian_cpds`` names the parameters."""
    n = len(df)
    fit, se = {}, {}
    for v, ps in parents.items():
        X = np.column_stack([np.ones(n)] + [df[p].to_numpy(np.float64) for p in ps])
        y = df[v].to_numpy(np.float64)
        beta = np.linalg.lstsq(X, y, rcond=None)[0]
        sigma = float(np.sqrt(np.sum((y - X @ beta) ** 2) / n))
        errors = np.sqrt(np.diag(np.linalg.inv(X.T @ X))) * sigma
        for name, b, e in zip(["b0"] + ps, beta, errors):
            fit[f"{v}|{name}"], se[f"{v}|{name}"] = float(b), float(e)
        fit[f"{v}|sigma"], se[f"{v}|sigma"] = sigma, sigma / np.sqrt(2 * n)
    return fit, se


def numpy_loglik(df, parents, params):
    """sum over rows and nodes of log N(x_v | b0 + sum b_p x_p, sigma), float64."""
    total = 0.0
    for v, ps in parents.items():
        loc = params[f"{v}|b0"] + sum(params[f"{v}|{q}"] * df[q].to_numpy(np.float64) for q in ps)
        z = (df[v].to_numpy(np.float64) - loc) / params[f"{v}|sigma"]
        total += float(np.sum(-0.5 * z**2 - np.log(params[f"{v}|sigma"]) - 0.5 * np.log(2 * np.pi)))
    return total


def linear_gaussian_joint(parents, params, order, do=None):
    """(mean, covariance) over ``order`` of the linear-Gaussian network with
    ``params``; ``do`` ({node: value}) cuts a node's incoming edges and pins
    it."""
    do = do or {}
    index = {v: i for i, v in enumerate(order)}
    d = len(order)
    B, b0, noise = np.zeros((d, d)), np.zeros(d), np.zeros(d)
    for v, ps in parents.items():
        if v in do:
            b0[index[v]] = do[v]
            continue
        b0[index[v]] = params[f"{v}|b0"]
        noise[index[v]] = params[f"{v}|sigma"] ** 2
        for q in ps:
            B[index[v], index[q]] = params[f"{v}|{q}"]
    A = np.linalg.inv(np.eye(d) - B)
    return A @ b0, A @ np.diag(noise) @ A.T


def standard_error_gap(got, want, se):
    """(largest |got - want| in standard errors, its parameter)."""
    z = {k: abs(got[k] - want[k]) / se[k] for k in want}
    worst = max(z, key=z.get)
    return z[worst], worst


def host_params(fitted, names):
    """{name: float} of a dict of 0-d tensors, in one read of the device."""
    values = torch.stack([fitted[k].reshape(()) for k in names]).cpu().numpy().astype(np.float64)
    return dict(zip(names, values.tolist()))


class CallCount:
    """A function that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def phase_functional():
    """The functional lane on ecoli70 (46 nodes, 70 edges): SVI of the 162
    parameters of a linear-Gaussian FunctionalBayesianNetwork on 50,000 rows,
    ``simulate`` and ``log_likelihood`` at the fit, the MCMC fit of a
    conjugate model, the point fit, and a trace of one SVI step.  Returns the
    (table-count, bincount) launches of the path."""
    import json

    import networkx as nx

    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.factors import FunctionalCPD, clear_param_store
    from pgmpy_tpu_torch.factors.distributions import HalfNormal, Normal
    from pgmpy_tpu_torch.models import FunctionalBayesianNetwork
    from pgmpy_tpu_torch.ops import bincount as bc
    from pgmpy_tpu_torch.utils import get_example_model, trace

    ecoli = get_example_model("ecoli70")
    parents = ecoli_parents(ecoli)
    order = list(nx.topological_sort(ecoli))
    rng = np.random.default_rng(SEED + 18)
    xs = rng.normal(1.5, 1.0, MCMC_ROWS)
    conjugate = FunctionalBayesianNetwork()
    conjugate.add_node("x")
    mcmc_fn = CallCount(lambda priors, parents=None: Normal(priors["mu"], priors["sigma"]))
    conjugate.add_cpds(FunctionalCPD("x", mcmc_fn))

    def point_cpds(params):
        def make(v):
            def fn(pv):
                loc = params[f"{v}|b0"]
                for q in parents[v]:
                    loc = loc + params[f"{v}|{q}"] * pv[q]
                return Normal(loc, torch.exp(params[f"{v}|logsigma"]))
            return fn
        return {v: make(v) for v in parents}

    point_init = {}
    for v, ps in parents.items():
        point_init[f"{v}|b0"] = point_init[f"{v}|logsigma"] = 0.0
        point_init.update({f"{v}|{q}": 0.0 for q in ps})
    make_point = CallCount(point_cpds)

    # ---- the path, counted
    torch.cuda.synchronize()
    reset_launches()
    phase_t0 = time.time()
    df = ecoli.simulate(FUNCTIONAL_ROWS, seed=SEED + 16)
    fbn = functional_network(ecoli, linear_gaussian_cpds(parents))
    clear_param_store()
    torch.cuda.synchronize()
    t0 = time.time()
    fitted = fbn.fit(df, estimator="SVI", optimizer={"lr": SVI_LR}, num_steps=SVI_STEPS)
    torch.cuda.synchronize()
    svi_s = time.time() - t0
    names = list(fitted)
    check(all(fitted[k].is_cuda for k in names), "SVI parameters are not on the card")
    svi = host_params(fitted, names)
    t0 = time.time()
    sim = fbn.simulate(FUNCTIONAL_ROWS, seed=SEED + 17)
    simulate_first_s = time.time() - t0
    simulate_s = host_median_s(lambda: fbn.simulate(FUNCTIONAL_ROWS, seed=SEED + 17))
    again = fbn.simulate(FUNCTIONAL_ROWS, seed=SEED + 17)
    other = fbn.simulate(FUNCTIONAL_ROWS, seed=SEED + 19)
    do_node = max(order, key=lambda v: (len(list(ecoli.successors(v))), str(v)))
    do_value = float(df[do_node].mean() + 2 * df[do_node].std())
    sim_do = fbn.simulate(FUNCTIONAL_ROWS, do={do_node: do_value}, seed=SEED + 20)
    loglik = fbn.log_likelihood(df)
    loglik_s = host_median_s(lambda: fbn.log_likelihood(df))
    torch.cuda.synchronize()
    t0 = time.time()
    post = conjugate.fit(pd.DataFrame({"x": xs}), estimator="MCMC", seed=SEED,
                         prior_fn=lambda: {"mu": Normal(0.0, 1.0), "sigma": HalfNormal(5.0)},
                         num_steps=MCMC_STEPS)
    mcmc_s = time.time() - t0
    point = functional_network(ecoli)
    torch.cuda.synchronize()
    t0 = time.time()
    point_fit = point.fit(df, make_point, init_params=point_init, lr=SVI_LR,
                          max_iter=POINT_MAX_ITER, exit_delta=0.0)
    torch.cuda.synchronize()
    point_s = time.time() - t0
    point_steps = make_point.calls - 1  # one call per step, one for the final CPDs
    point_host = host_params(point_fit, list(point_fit))
    point_params = {k.replace("logsigma", "sigma"): (float(np.exp(x)) if "logsigma" in k else x)
                    for k, x in point_host.items()}
    traced = functional_network(ecoli, linear_gaussian_cpds(parents))
    with tempfile.TemporaryDirectory() as trace_dir:
        with trace(trace_dir):
            traced.fit(df, optimizer={"lr": SVI_LR}, num_steps=1)
        files = os.listdir(trace_dir)
        check(len(files) == 1, f"trace wrote {files}")
        with open(os.path.join(trace_dir, files[0])) as fh:
            events = json.load(fh)["traceEvents"]
    torch.cuda.synchronize()
    launches = (bc.TABLE_LAUNCHES, bc.LAUNCHES)
    record_jt("functional")
    path_s = time.time() - phase_t0
    log(f"functional_path table_count_launches {launches[0]} bincount_launches {launches[1]} "
        f"(no count kernel on this lane)")

    # ---- SVI against least squares, and the first steps against the CPU run
    want, se = least_squares(df, parents)
    check(set(names) == set(want) and len(names) == 162, f"{len(names)} SVI parameters")
    z, worst = standard_error_gap(svi, want, se)
    gap = numpy_loglik(df, parents, want) - numpy_loglik(df, parents, svi)
    check(z <= FIT_SE_LIMIT, f"SVI: {worst} {z} standard errors from least squares")
    # kernels, busy device time and host reads of the steps: a 3-step fit
    # less a 1-step fit, so the set-up of a fit drops out
    shots = {}
    for steps in (1, 3):
        model = functional_network(ecoli, linear_gaussian_cpds(parents))
        shots[steps] = profiled_busy(lambda: model.fit(df, optimizer={"lr": SVI_LR},
                                                       num_steps=steps))
    reads = {s: sum(c for name, (c, _) in shot[3].items() if "DtoH" in name)
             for s, shot in shots.items()}
    step_kernels, step_busy_ms, step_wall_ms = (
        (shots[3][i] - shots[1][i]) / 2 for i in range(3))
    top = sorted(shots[3][3].items(), key=lambda kv: -kv[1][1])[:4]
    card = functional_network(ecoli, linear_gaussian_cpds(parents))
    first = host_params(card.fit(df, optimizer={"lr": SVI_LR}, num_steps=SVI_CPU_STEPS), names)
    with on_device("cpu"):
        cpu_model = functional_network(ecoli, linear_gaussian_cpds(parents))
        t0 = time.time()
        cpu_fit = cpu_model.fit(df, optimizer={"lr": SVI_LR}, num_steps=SVI_CPU_STEPS)
        cpu_s = time.time() - t0
        cpu_first = {k: float(v) for k, v in cpu_fit.items()}
    rel = max(abs(first[k] - cpu_first[k]) / max(abs(cpu_first[k]), 1e-30) for k in names)
    check(all(np.isclose(first[k], cpu_first[k], rtol=1e-4, atol=1e-6) for k in names),
          f"SVI after {SVI_CPU_STEPS} steps differs from the CPU run: max rel {rel}")
    log(f"functional_svi ecoli70 rows={FUNCTIONAL_ROWS} params={len(names)} functional_svi_s "
        f"{svi_s:.3f} steps {SVI_STEPS} lr {SVI_LR} host_reads_in_fit {reads[1]} / {reads[3]} "
        f"(1- / 3-step fits; logging off) kernels_per_step {step_kernels:.1f} "
        f"device_ms_per_step {step_busy_ms:.4f} step_host_ms {svi_s / SVI_STEPS * 1e3:.3f} "
        f"idle_share {1 - step_busy_ms / step_wall_ms:.4f} (kernels, busy device ms and the busy "
        f"share per step from profiled 3- less 1-step fits; the 3-step fit's largest device "
        f"operations {'; '.join(f'{n[:40]} x{c} {us / 1e3:.3f} ms' for n, (c, us) in top)})")
    log(f"functional_svi_check ok {z:.4f} standard errors from least squares at worst ({worst}; "
        f"limit {FIT_SE_LIMIT}), log-likelihood {gap:.4f} below the optimum; after "
        f"{SVI_CPU_STEPS} steps within max rel {rel:.3e} of the CPU run (rtol 1e-4, atol 1e-6; "
        f"the CPU's {SVI_CPU_STEPS} steps {cpu_s:.3f} s)")

    # ---- simulate against the closed-form joint of the fitted network
    mean, cov = linear_gaussian_joint(parents, svi, order)
    n = FUNCTIONAL_ROWS
    rows = sim[order].to_numpy(np.float64)
    mean_z = np.abs(rows.mean(axis=0) - mean) / np.sqrt(np.diag(cov) / n)
    cov_se = np.sqrt((np.outer(np.diag(cov), np.diag(cov)) + cov**2) / n)
    cov_z = np.abs(np.cov(rows.T, bias=True) - cov) / cov_se
    check(mean_z.max() <= 5 and cov_z.max() <= 5,
          f"simulate: means {mean_z.max()} / covariances {cov_z.max()} standard errors off")
    check(sim.equals(again) and not sim.equals(other), "simulate: seeds do not fix the rows")
    do_mean, do_cov = linear_gaussian_joint(parents, svi, order, do={do_node: do_value})
    children = sorted(ecoli.successors(do_node), key=str)
    do_z = max(abs(sim_do[c].mean() - do_mean[order.index(c)])
               / np.sqrt(do_cov[order.index(c), order.index(c)] / n) for c in children)
    check((sim_do[do_node] == do_value).all() and do_z <= 5,
          f"do({do_node}): children {do_z} standard errors off")
    log(f"functional_simulate rows={n} functional_simulate_s {simulate_s:.4f} (median of 3; the "
        f"first {simulate_first_s:.3f}) means within {mean_z.max():.3f} and covariances within "
        f"{cov_z.max():.3f} standard errors of the fitted closed-form joint (limit 5); the same "
        f"seed gives equal rows; do({do_node}={do_value:.4f}) moves its {len(children)} children "
        f"to the closed form within {do_z:.3f} standard errors")

    # ---- log_likelihood against numpy float64
    want_ll = numpy_loglik(df, parents, svi)
    ll_err = abs(loglik - want_ll) / abs(want_ll)
    check(ll_err <= 1e-5, f"log_likelihood {loglik} vs numpy {want_ll}")
    log(f"functional_loglik rows={n} value {loglik:.4f} rel_err {ll_err:.3e} (limit 1e-5) "
        f"loglik_s {loglik_s:.4f} rows_per_s {n / loglik_s:.1f}")

    # ---- the MCMC fit against the conjugate posterior (sigma ~ 1 known)
    post_mu, post_sd = MCMC_ROWS * xs.mean() / (MCMC_ROWS + 1), 1 / np.sqrt(MCMC_ROWS + 1)
    limit = 5 * post_sd / np.sqrt(MCMC_MIN_ESS)
    mu_err = abs(post["mu"].mean() - post_mu)
    sigma_err = abs(post["sigma"].mean() - xs.std())
    check(post["mu"].shape == (MCMC_STEPS,) and (post["sigma"] > 0).all(), "MCMC samples")
    check(mu_err <= limit and sigma_err <= limit / np.sqrt(2),
          f"MCMC: mu {mu_err} / sigma {sigma_err} from the conjugate answer")
    log(f"functional_mcmc rows={MCMC_ROWS} samples={MCMC_STEPS} warmup={max(200, MCMC_STEPS // 2)} "
        f"functional_mcmc_s {mcmc_s:.3f} log_density_evaluations {mcmc_fn.calls} (leapfrogs and "
        f"the step-size search) posterior mean of mu {mu_err:.3e} and of sigma {sigma_err:.3e} "
        f"from the conjugate answer (limits {limit:.3e}, {limit / np.sqrt(2):.3e})")

    # ---- the point fit against least squares
    pz, pworst = standard_error_gap(point_params, want, se)
    check(pz <= FIT_SE_LIMIT, f"point fit: {pworst} {pz} standard errors from least squares")
    log(f"functional_point_fit rows={n} point_fit_s {point_s:.3f} steps {point_steps} "
        f"(max_iter {POINT_MAX_ITER}, lr {SVI_LR}, exit_delta 0) {pz:.4f} standard errors from "
        f"least squares at worst ({pworst}; limit {FIT_SE_LIMIT})")

    # ---- the trace
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(kernels, "the trace of one SVI step names no CUDA kernel")
    log(f"functional_trace events {len(events)} cuda_kernels {len(kernels)} e.g. "
        f"{sorted({e['name'][:40] for e in kernels})[:3]}")
    check(config.DEVICE.type == "cuda", "device left on the CPU")
    log(f"phase_functional_main_path_s {path_s:.1f}")
    return launches


# --------------------------------------------------------------------------- #
# the network file formats on MUNIN
# --------------------------------------------------------------------------- #
READWRITE_FORMATS = ("xmlbif", "net", "uai", "xdsl", "xbn")


def uai_names(model):
    """{var_i: name} in the UAI writer's canonical (cardinality-string, name)
    order."""
    domain = {str(v): str(model.get_cpds(v).variable_card) for v in model.nodes()}
    order = [v for v, _ in sorted(domain.items(), key=lambda x: (x[1], x[0]))]
    return {f"var_{i}": name for i, name in enumerate(order)}


def same_network(got, want, by_index=False, atol=0.0):
    """The largest CPD difference of ``got`` from ``want`` (raises on another
    structure or other states); ``by_index`` maps UAI's ``var_i`` names, and
    compares cardinalities, not state names."""
    names = uai_names(want) if by_index else {str(v): str(v) for v in got.nodes()}
    check(set(names.values()) == set(map(str, want.nodes())), "nodes differ")
    check({(names[str(u)], names[str(v)]) for u, v in got.edges()}
          == {(str(u), str(v)) for u, v in want.edges()}, "edges differ")
    worst = 0.0
    for var, name in names.items():
        g, w = got.get_cpds(var), want.get_cpds(name)
        check([names[str(x)] for x in g.variables] == [str(x) for x in w.variables],
              f"{name}: evidence {g.variables}")
        if not by_index:
            check(g.state_names == w.state_names, f"{name}: states differ")
        check(list(g.cardinality) == list(w.cardinality), f"{name}: cardinality")
        worst = max(worst, float(np.abs(g.get_values().astype(np.float64)
                                        - w.get_values().astype(np.float64)).max()))
    check(worst <= atol, f"CPDs {worst} apart (limit {atol})")
    return worst


def pomdpx_example():
    """The TBL example of ``tests/test_pomdpx.py``, read from the file's
    source (that test module imports the JAX package)."""
    import ast

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "test_pomdpx.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "POMDPX":
            return ast.literal_eval(node.value)
    raise AssertionError("tests/test_pomdpx.py holds no POMDPX example")


def pomdpx_data(reader):
    """The model dict ``PomdpXWriter`` takes, as ``reader`` reads it."""
    return {"description": reader.get_description(), "discount": reader.get_discount(),
            "variables": reader.get_variables(),
            "initial_state_belief": reader.get_initial_beliefs(),
            "state_transition_function": reader.get_state_transition_function(),
            "obs_function": reader.get_obs_function(),
            "reward_function": reader.get_reward_function()}


def phase_readwrite(model, df, fitted):
    """MUNIN through the five network formats (saved and loaded by extension),
    the junction tree of the read-back model calibrated, the read-back model
    fitted on the main path's rows, the reference-written files, PomdpX, and
    ``KernelTimer`` around a calibration.  Returns the (table-count, bincount)
    launches of the path."""
    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.estimators import BayesianEstimator
    from pgmpy_tpu_torch.inference import BeliefPropagation
    from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
    from pgmpy_tpu_torch.ops import bincount as bc
    from pgmpy_tpu_torch.readwrite import BIFReader, PomdpXReader, PomdpXWriter, get_reader
    from pgmpy_tpu_torch.utils import KernelTimer

    testdata = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "testdata")
    pomdpx_text = pomdpx_example()

    # ---- the path, counted
    torch.cuda.synchronize()
    reset_launches()
    phase_t0 = time.time()
    times, back = {}, {}
    with tempfile.TemporaryDirectory() as d:
        for fmt in READWRITE_FORMATS:
            path = os.path.join(d, f"munin.{fmt}")
            t0 = time.time()
            model.save(path)
            write_s = time.time() - t0
            t0 = time.time()
            back[fmt] = DiscreteBayesianNetwork.load(path)
            times[fmt] = (write_s, time.time() - t0, os.path.getsize(path))
        # a second copy, calibrated and then fitted in place
        read_model = DiscreteBayesianNetwork.load(os.path.join(d, "munin.xmlbif"))
        pomdpx_path = os.path.join(d, "example.pomdpx")
        pomdpx = pomdpx_data(PomdpXReader(string=pomdpx_text))
        PomdpXWriter(pomdpx).write_file(pomdpx_path)
        pomdpx_back = pomdpx_data(PomdpXReader(path=pomdpx_path))
    original_bp = BeliefPropagation(model)
    original_bp.calibrate()
    read_bp = BeliefPropagation(read_model)
    read_bp.calibrate()
    timer = KernelTimer()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with timer.time("calibrate"):
        start.record()
        read_bp._calibrate_junction_tree("marginalize")
        end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end)
    read_states = read_model.states  # from the file, before its CPDs go
    read_model.remove_cpds(*read_model.get_cpds())
    torch.cuda.synchronize()
    t0 = time.time()
    read_model.fit(df, estimator=BayesianEstimator, state_names=read_states,
                   prior_type="BDeu", equivalent_sample_size=5)
    torch.cuda.synchronize()
    refit_s = time.time() - t0
    references = {}
    for i in (0, 1):
        base = BIFReader(os.path.join(testdata, f"net{i}.bif")).get_model()
        for fmt in READWRITE_FORMATS:
            references[(i, fmt)] = (base, get_reader(fmt)(
                path=os.path.join(testdata, f"ref{i}.{fmt}")).get_model())
    torch.cuda.synchronize()
    launches = (bc.TABLE_LAUNCHES, bc.LAUNCHES)
    record_jt("readwrite")
    path_s = time.time() - phase_t0
    log(f"readwrite_path table_count_launches {launches[0]} bincount_launches {launches[1]} "
        f"(one: the fit of the model read back from XMLBIF)")
    check(launches == (1, 0), f"the read-back fit made {launches} count launches")

    # ---- round trips: every format writes repr(float) of the float32 tables
    for fmt in READWRITE_FORMATS:
        check(all(c.values.is_cuda for c in back[fmt].get_cpds()), f"{fmt}: CPDs not on the card")
        err = same_network(back[fmt], model, by_index=fmt == "uai")
        write_s, read_s, size = times[fmt]
        log(f"readwrite_{fmt} munin variables={len(model.nodes())} bytes {size} write_s "
            f"{write_s:.3f} read_s {read_s:.3f} max_abs_err {err:.1e} (precision 0: the "
            f"writer prints repr(float) of each float32 entry)"
            + (" by canonical index, cardinalities only" if fmt == "uai" else ""))

    # ---- calibration of the read-back tree
    want_cliques, got_cliques = original_bp.get_clique_beliefs(), read_bp.get_clique_beliefs()
    if set(want_cliques) == set(got_cliques):
        limit = 1e-6
        cal_err = max(float((got_cliques[c].values - phi.values).abs().max())
                      for c, phi in want_cliques.items())
    else:
        # another tree: compare each variable's marginal from one clique of each
        limit = 1e-3
        cal_err = 0.0
        for var in model.nodes():
            marginals = []
            for cliques in (want_cliques, got_cliques):
                phi = next(p for c, p in cliques.items() if var in c)
                marginals.append(phi.marginalize([v for v in phi.variables if v != var],
                                                 inplace=False).normalize(inplace=False).values)
            cal_err = max(cal_err, float((marginals[0] - marginals[1]).abs().max()))
    check(cal_err <= limit, f"the read-back calibration is {cal_err} from the original's")
    log(f"readwrite_calibration cliques original {len(want_cliques)} read {len(got_cliques)} "
        f"same_tree {set(want_cliques) == set(got_cliques)} max_abs_err {cal_err:.3e} (limit "
        f"{limit})")

    # ---- the read-back model's fit against the main path's
    for node in fitted.nodes():
        got, want = read_model.get_cpds(node), fitted.get_cpds(node)
        check(got.variables == want.variables and got.state_names == want.state_names
              and torch.equal(got.values, want.values), f"refit {node} differs")
    log(f"readwrite_refit rows={len(df)} fit_s {refit_s:.4f} every CPD equal (torch.equal) to the "
        f"main path's fit")

    # ---- files written by the reference pgmpy
    worst = 0.0
    for (i, fmt), (base, got) in references.items():
        check(all(c.values.is_cuda for c in got.get_cpds()), f"ref{i}.{fmt}: not on the card")
        if fmt == "uai":
            worst = max(worst, same_network(got, base, by_index=True, atol=1e-6))
            continue
        check({tuple(map(str, e)) for e in got.edges()} == {tuple(map(str, e)) for e in base.edges()},
              f"ref{i}.{fmt}: edges")
        for node in base.nodes():
            g, w = got.get_cpds(str(node)), base.get_cpds(str(node))
            order = [list(g.variables).index(v) for v in w.variables]
            values = g.values.permute(*order).cpu().double().numpy()
            err = float(np.abs(values - w.values.cpu().double().numpy()).max())
            worst = max(worst, err)
            check(err <= 1e-6, f"ref{i}.{fmt} {node}: {err}")
    log(f"readwrite_reference_files {len(references)} files (ref0/ref1 x {len(READWRITE_FORMATS)}) "
        f"equal to net0/net1.bif within {worst:.1e} (limit 1e-6)")

    # ---- PomdpX and the timer
    check(pomdpx_back == pomdpx, "PomdpX: the written file reads back to other dicts")
    kernel_ms = timer.summary()["calibrate"]["total_s"] * 1e3
    check(kernel_ms >= event_ms, f"KernelTimer {kernel_ms} ms < CUDA events {event_ms} ms")
    log(f"readwrite_pomdpx equal dicts; kernel_timer calibrate {kernel_ms:.4f} ms >= CUDA events "
        f"{event_ms:.4f} ms")
    check(config.DEVICE.type == "cuda", "device left on the CPU")
    log(f"phase_readwrite_main_path_s {path_s:.1f}")
    return launches


# --------------------------------------------------------------------------- #
# the multi-device lane: model-parallel calibration, sharded samplers, queries
# --------------------------------------------------------------------------- #
PARALLEL_SHARDS = 4
SHARDED_DRAWS = 262_144
SHARDED_LW_CHECKED = 20
# the sharded NUTS run: its shards step one after another on one card, so it
# keeps fewer draws than phase_mcmc's run (the limits follow the draws)
PARALLEL_NUTS_SAMPLES = 30
WORKER_TIMEOUT_S = 240


def schedule_rtol(program, u=2.0 ** -24, normalized=False):
    """The relative rounding (unit ``u``: float32 by default) that a junction
    tree's schedule allows between two calibrations that order their products
    differently, as ``tests/test_torch_bp.py::test_munin_beliefs_match``
    derives it: per message ceil(log2 m) for the sum of its m entries plus 3
    (the division by the previous message, the product into the destination,
    the sepset update), with ``normalized`` also ceil(log2 s) + 1 for the total
    of its s sepset entries and the division by it, plus the worst clique's
    own factor product and normalisation, twice (both calibrations round)."""
    import math

    per_message = [math.ceil(math.log2(max(2, math.prod(
        program.clique_shapes[src][a] for a in axes)))) + 3
        + (math.ceil(math.log2(max(2, math.prod(program.sepset_shapes[edge])))) + 1
           if normalized else 0)
        for src, _, axes, _, _, edge, _ in program.messages]
    per_clique = max(len(specs) + math.ceil(math.log2(max(2, math.prod(shape)))) + 1
                     for specs, shape in zip(program.potential_specs, program.clique_shapes))
    return 2 * u * (sum(per_message) + per_clique)


def beliefs_gap(got, want, rtol, atol):
    """Paired belief tensors held entry by entry to ``|a - b| <= atol + rtol
    |b|``.  Returns a phrase for the log: the worst relative gap over the
    entries of ``want`` above ``atol``, and their magnitudes (median,
    smallest nonzero, and how many nonzero ones lie below ``atol``)."""
    worst = 0.0
    for a, b in zip(got, want):
        diff = (a.to(b.device) - b).abs()
        check(bool((diff <= atol + rtol * b.abs()).all()),
              f"beliefs differ by {float(diff.max())} (rtol {rtol:.3e}, atol {atol:g})")
        held = b.abs() > atol
        if bool(held.any()):
            worst = max(worst, float((diff[held] / b[held].abs()).max()))
    mags = torch.cat([b.reshape(-1) for b in want]).abs()
    small = mags[mags > 0]
    return (f"worst relative gap {worst:.3e} over |b| > atol (rtol {rtol:.3e}, atol {atol:g}; "
            f"|b| median {float(mags.median()):.3e} smallest nonzero "
            f"{float(small.min()) if small.numel() else 0.0:.3e} nonzero below atol "
            f"{int((small < atol).sum())} of {mags.numel()})")


def single_device_atol(dtype):
    """The absolute slack of a sharded calibration held to the single-device
    program, which multiplies in another order: the smallest normal number of
    ``dtype``.  Below it an entry is subnormal and carries fewer significant
    bits than a relative limit assumes; every other entry is held relative to
    itself."""
    return torch.finfo(dtype).tiny


def part_lines(sharded):
    """One entry per part: its cliques, boundary cliques, waves (upward) and
    K2 launches on a card."""
    return [f"part {p}: cliques {len(part['cliques'])} boundary_cliques "
            f"{len(part['plan'].clique_shapes) - len(part['cliques'])} waves "
            f"{part['plan'].n_waves} (upward {part['plan'].n_up_waves}) launches "
            f"{1 + 2 * part['plan'].n_waves} depth {sharded.part_depth[p]}"
            for p, part in enumerate(sharded.parts)]


def check_part_cards(name, sharded, beliefs):
    """Every clique's belief on its part's device."""
    for p, part in enumerate(sharded.parts):
        for c in part["cliques"]:
            check(beliefs[c].device == sharded.device_of_part[p],
                  f"{name}: clique {c} left its part's card")


def crossing_bytes(program, sharded, elem=4):
    """Bytes that cross parts in one calibration: per boundary edge, the
    child's sigma up and the parent's sepset belief down."""
    boundary = [p["boundary_edge_id"] for p in sharded.parts if p["boundary_edge_id"] is not None]
    return 2 * elem * sum(int(np.prod(program.sepset_shapes[e])) for e in boundary), boundary


def calibration_times(program, sharded, arrays, reps):
    """The sharded and the single-device calibration, each timed with CUDA
    events: with the host's enqueue (median of 5), and its device time behind
    a covering device sleep (median of ``reps``, with the host's enqueue of
    one call).  Returns the log's phrase, the sharded device ms and its host
    enqueue in seconds."""
    sharded_ms = cuda_median_ms(lambda: sharded.calibrate(arrays), reps=5, warmup=1)
    single_ms = cuda_median_ms(lambda: program.calibrate(arrays), reps=5, warmup=1)
    device_ms, host_s = cuda_median_ms(lambda: sharded.calibrate(arrays), reps=reps,
                                       device_only=True, with_enqueue=True)
    single_device_ms, single_host_s = cuda_median_ms(
        lambda: program.calibrate(arrays), reps=reps, device_only=True, with_enqueue=True)
    return (f"sharded_ms {sharded_ms:.3f} single_device_ms {single_ms:.3f} (CUDA events, median "
            f"of 5) device_ms sharded {device_ms:.4f} single {single_device_ms:.4f} (CUDA events "
            f"behind a covering device sleep, median of {reps}) host_enqueue_ms sharded "
            f"{host_s * 1e3:.3f} single {single_host_s * 1e3:.3f}"), device_ms, host_s


def sharded_calibration_case(name, program, arrays, mesh, reference, rtol):
    """Calibrate MUNIN over ``mesh``'s parts (across cards, where the counted
    path's parts share one), hold every clique and sepset to the
    single-device ``reference``, and time both (:func:`calibration_times`)."""
    from pgmpy_tpu_torch.ops import jt
    from pgmpy_tpu_torch.parallel.jt_mesh import ShardedJunctionTreeCalibration

    sharded = ShardedJunctionTreeCalibration(program, mesh)
    jt.reset_launches()
    beliefs, mu = sharded.calibrate(arrays)
    torch.cuda.synchronize()
    check(jt.JT_LAUNCHES == sharded.launches(), f"{name}: {jt.JT_LAUNCHES} K2 launches, the "
          f"part plans make {sharded.launches()}")
    check_part_cards(name, sharded, beliefs)
    atol = single_device_atol(arrays[0].dtype)
    clique_gap = beliefs_gap(beliefs, reference[0], rtol, atol)
    sepset_gap = beliefs_gap(mu, reference[1], rtol, atol)
    crossing, boundary = crossing_bytes(program, sharded)
    moved = [arrays[i] for p, part in enumerate(sharded.parts) for i in part["factor_ids"]
             if sharded.device_of_part[p] != arrays[i].device]
    inputs = sum(a.numel() * a.element_size() for a in moved)
    times, _, _ = calibration_times(program, sharded, arrays, 5)
    kernels, _ = profiled(lambda: sharded.calibrate(arrays))
    single_kernels, _ = profiled(lambda: program.calibrate(arrays))
    sizes = sorted(len(p["cliques"]) for p in sharded.parts)
    log(f"parallel_jt_{name} cliques {len(program.cliques)} messages {len(program.messages)} "
        f"shards {mesh.size} devices {sorted({str(d) for d in sharded.device_of_part})} parts "
        f"{sharded.n_parts} part_sizes {sizes} boundary_edges {len(boundary)} "
        f"crossing_bytes_per_calibration {crossing} (a sigma up and a sepset belief down per "
        f"boundary edge, float32) input_tables_moved_per_calibration {len(moved)} "
        f"({inputs} bytes: factor tables of parts on another card than the tables) k2_launches "
        f"sharded {sharded.launches()} single {1 + 2 * program.wave_plan().n_waves} {times} "
        f"profiler_kernels sharded {kernels:.0f} single {single_kernels:.0f} (lower bounds late "
        f"in the process) against the single-device program: cliques {clique_gap}; sepsets "
        f"{sepset_gap}; " + "; ".join(part_lines(sharded)))


def k12_kernel_row(program, sharded, arrays, beliefs, mu, rtol):
    """K12 on the counted path's MUNIN in parts of one card: the part plans
    through K2's kernels against the same part plans through the plain
    version on the card (every clique and sepset within ``rtol`` and no
    absolute slack: both multiply in plan order, so rounding is the only
    gap); the sharded and the single-device calibration timed
    (:func:`calibration_times`); the plain version's time (CUDA events around
    its eager ops); and the bound: every part plan's K2 bound
    (:func:`jt_bounds`) and the bytes that cross parts."""
    plain = sharded.calibrate(arrays, kernel=False)
    torch.cuda.synchronize()
    gaps = beliefs_gap(beliefs, plain[0], rtol, 0.0), beliefs_gap(mu, plain[1], rtol, 0.0)
    err = max(float((a - b).abs().max()) for a, b in zip(beliefs + mu, plain[0] + plain[1]))
    del plain
    times, ms, host_s = calibration_times(program, sharded, arrays, 10)
    plain_ms = cuda_median_ms(lambda: sharded.calibrate(arrays, kernel=False), reps=3, warmup=1)
    elem = arrays[0].element_size()
    total_bytes = total_ops = 0
    bound_ms = 0.0
    for part in sharded.parts:
        for nbytes, ops in jt_bounds(part["plan"], elem).values():
            bound_ms += bound(nbytes, ops)[0]
            total_bytes += nbytes
            total_ops += ops
    crossing, boundary = crossing_bytes(program, sharded, elem)
    bound_ms += bound(crossing, 0)[0]
    log(f"k12 jt_mesh/calibrate_parts munin parts {sharded.n_parts} launches "
        f"{sharded.launches()} kernel_ms {ms:.5f} (device time: CUDA events around one sharded "
        f"calibration behind a covering device sleep, median of 10; host enqueue "
        f"{host_s * 1e3:.3f} ms) plain_ms {plain_ms:.3f} (the same part plans through the plain "
        f"version on the card, CUDA events, median of 3) bound_ms {bound_ms:.6f} (each part "
        f"plan's K2 bound per kernel, summed: {total_bytes} bytes, {total_ops} operations; "
        f"crossing {crossing} bytes) max_abs_err {err:.3e} against the plain version: cliques "
        f"{gaps[0]}; sepsets {gaps[1]}; library_ms null: no PyTorch call calibrates a tree")
    log(f"parallel_jt_one_card cliques {len(program.cliques)} messages {len(program.messages)} "
        f"shards {PARALLEL_SHARDS} devices ['cuda:0'] parts {sharded.n_parts} part_sizes "
        f"{sorted(len(p['cliques']) for p in sharded.parts)} boundary_edges {len(boundary)} "
        f"crossing_bytes_per_calibration {crossing} (a sigma up and a sepset belief down per "
        f"boundary edge) k2_launches sharded {sharded.launches()} single "
        f"{1 + 2 * program.wave_plan().n_waves} {times}; " + "; ".join(part_lines(sharded)))
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if total_bytes / HBM_BYTES_PER_S >= total_ops / PLAIN_OPS_PER_S
            else "operations", "library_ms": None}


def markov_sharded_case():
    """ALARM's Markov model (normalised messages) with its factors scaled by
    random positive numbers, in 4 parts of cuda:0 against the single-device
    program: every clique and sepset, and the launches."""
    from pgmpy_tpu_torch.inference import BeliefPropagation
    from pgmpy_tpu_torch.ops import jt
    from pgmpy_tpu_torch.parallel.jt_mesh import ShardedJunctionTreeCalibration
    from pgmpy_tpu_torch.parallel.mesh import Mesh
    from pgmpy_tpu_torch.utils import get_example_model

    markov = BeliefPropagation(get_example_model("alarm").to_markov_model())
    program = markov._program
    check(program.normalize_messages, "ALARM's Markov model does not normalise")
    rng = np.random.default_rng(SEED)
    scaled = [(f.values * float(rng.uniform(0.25, 4.0))).contiguous()
              for f in markov._input_factors]
    sharded = ShardedJunctionTreeCalibration(program, Mesh([torch.device("cuda", 0)]
                                                           * PARALLEL_SHARDS))
    jt.reset_launches()
    beliefs, mu = sharded.calibrate(scaled)
    torch.cuda.synchronize()
    check(jt.JT_LAUNCHES == sharded.launches(), f"alarm_markov: {jt.JT_LAUNCHES} K2 launches, "
          f"the part plans make {sharded.launches()}")
    ref = program.calibrate(scaled)
    rtol = schedule_rtol(program, normalized=True)
    atol = single_device_atol(scaled[0].dtype)
    gaps = beliefs_gap(beliefs, ref[0], rtol, atol), beliefs_gap(mu, ref[1], rtol, atol)
    log(f"parallel_jt_alarm_markov normalize_messages True parts {sharded.n_parts} part_sizes "
        f"{sorted(len(p['cliques']) for p in sharded.parts)} k2_launches {sharded.launches()} "
        f"against the single-device program: cliques {gaps[0]}; sepsets {gaps[1]}")


def two_process_run(backend):
    """``tests/_torch_distributed_worker.py`` in two processes joined over a
    localhost coordinator, 2 shards each: gloo with both ranks on cuda:0, or
    NCCL with one card per rank."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                          "_torch_distributed_worker.py")
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-u", worker, str(rank), str(port), "cuda", backend],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0 and f"WORKER {rank} OK" in out,
              f"two-process {backend} rank {rank} failed:\n{out[-3000:]}")
    log(f"parallel_two_process backend {backend} ranks 2 shards_per_rank 2 wall_s "
        f"{time.time() - t0:.1f} ok (global mesh of 4, cross-process psum of arange(8) = 28, "
        f"distinct host_fold_key seeds, rain/wet P(rain | wet) within 0.02 of [1/3, 2/3], "
        f"sharded query_batch equal, VectorizedNUTS.sample(axis_name='chains') ends at one "
        f"final_stepsize on both ranks)")


def lw_evidence(model, marginals):
    """(leaf, state) for the likelihood-weighted draws: the first leaf, in name
    order, whose second most probable state has probability >= 0.1 and whose
    CPD gives that state a probability that moves by >= 0.2 with the parents
    (so that the weights differ between draws)."""
    for v in sorted(model.nodes(), key=str):
        if model.get_children(v) or not model.get_parents(v):
            continue
        k = int(np.argsort(marginals[v])[-2])
        row = model.get_cpds(v).get_values()[k]
        if marginals[v][k] >= 0.1 and row.max() - row.min() >= 0.2:
            return v, model.states[v][k]
    raise AssertionError("no leaf suits likelihood weighting")


def phase_parallel(model, context):
    """The multi-device lane on 4 shards of cuda:0 (and on every card when
    there are more): MUNIN calibrated in parts, sharded forward and
    likelihood-weighted draws of MUNIN, the 2,048 prediction rows as a sharded
    ``query_batch``, sharded Gibbs on HEPAR2 and NUTS on ecoli70, and a
    two-process run.  The calibration in parts is K12: every part's plan on
    K2's kernels, held to the single-device program and to the same part
    plans through the plain version, and timed; ALARM's Markov model in parts
    beside it.  Returns the (table-count, bincount) launches of the path, the
    K1 row at the sharded moments' shape and its launches, and K12's row."""
    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.inference import BeliefPropagation, VariableElimination
    from pgmpy_tpu_torch.ops import bincount as bc
    from pgmpy_tpu_torch.ops import jt
    from pgmpy_tpu_torch.parallel import (get_mesh, sharded_gibbs_marginals,
                                          sharded_nuts_moments, sharded_query_batch,
                                          sharded_sample_marginals)
    from pgmpy_tpu_torch.parallel.jt_mesh import ShardedJunctionTreeCalibration
    from pgmpy_tpu_torch.parallel.mesh import Mesh, _marginal_specs
    from pgmpy_tpu_torch.sampling.core import CompiledAncestralSampler
    from pgmpy_tpu_torch.utils import get_example_model

    card = torch.device("cuda", 0)
    mesh = Mesh([card] * PARALLEL_SHARDS)
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        log(f"parallel: {n_cards} cards: the cross-card mesh and the NCCL run follow the "
            f"4 shards of cuda:0")
    else:
        log("parallel: one card: the cross-card copies and the NCCL run need more than one "
            "card and are not run; every other check runs on 4 shards of cuda:0")
    device_before = config.DEVICE

    # ---- inputs, built before the counted path
    bp = BeliefPropagation(model)
    program = bp._program
    arrays = [f.values for f in bp._input_factors]
    bp.calibrate()
    marginals = exact_marginals(bp)
    leaf, state = lw_evidence(model, marginals)
    rng = np.random.default_rng(SEED)
    checked = sorted(rng.choice([v for v in sorted(model.nodes(), key=str) if v != leaf],
                                SHARDED_LW_CHECKED, replace=False).tolist(), key=str)
    fitted, targets, test = context["predict_rows"]
    rows = {v: test[v].tolist() for v in test.columns}
    hepar, ecoli = get_example_model("hepar2"), get_example_model("ecoli70")

    # ---- the path, counted
    per_call, k2_per_call = {}, {}

    def counted(name, fn):
        before, k2_before = bc.TABLE_LAUNCHES, jt.JT_LAUNCHES
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        per_call[name] = (bc.TABLE_LAUNCHES - before, time.time() - t0)
        k2_per_call[name] = jt.JT_LAUNCHES - k2_before
        return out

    torch.cuda.synchronize()
    reset_launches()
    phase_t0 = time.time()
    sharded = counted("partition", lambda: ShardedJunctionTreeCalibration(program, mesh))
    beliefs, mu = counted("calibrate", lambda: sharded.calibrate(arrays))
    forward = counted("forward", lambda: sharded_sample_marginals(
        model, SHARDED_DRAWS, mesh=mesh, seed=SEED))
    weighted = counted("weighted", lambda: sharded_sample_marginals(
        model, SHARDED_DRAWS, mesh=mesh, evidence={leaf: state}, seed=SEED))
    values, names = counted("query_batch", lambda: sharded_query_batch(
        fitted, targets, rows, mesh=mesh))
    gibbs = counted("gibbs", lambda: sharded_gibbs_marginals(
        hepar, HEPAR_CHAINS, HEPAR_SWEEPS, mesh=mesh, burn_in=HEPAR_BURN_IN, seed=SEED))
    nuts = counted("nuts", lambda: sharded_nuts_moments(
        ecoli, NUTS_CHAINS, PARALLEL_NUTS_SAMPLES, num_adapt=NUTS_ADAPT, stepsize=0.17,
        mesh=mesh, max_depth=6, seed=SEED))
    torch.cuda.synchronize()
    launches = (bc.TABLE_LAUNCHES, bc.LAUNCHES)
    record_jt("parallel")
    path_s = time.time() - phase_t0
    gibbs_launches = GATHER_PATH_LAUNCHES["parallel"]["gibbs/sweep"]
    nuts_launches = GATHER_PATH_LAUNCHES["parallel"]["hmc/nuts_step"]
    log(f"parallel_path table_count_launches {launches[0]} bincount_launches {launches[1]} "
        + " ".join(f"{k} {n} launches {s:.3f} s" for k, (n, s) in per_call.items())
        + f" path_s {path_s:.1f} (each sampler's moments: one launch per shard) "
        f"gibbs_sweep_launches {gibbs_launches} (one per shard and sweep) nuts_step_launches "
        f"{nuts_launches} (one per shard and transition)")
    check(gibbs_launches == PARALLEL_SHARDS * HEPAR_SWEEPS,
          f"sharded Gibbs made {gibbs_launches} sweep launches for {PARALLEL_SHARDS} shards x "
          f"{HEPAR_SWEEPS} sweeps")
    nuts_steps = NUTS_ADAPT + PARALLEL_NUTS_SAMPLES
    check(nuts_launches == PARALLEL_SHARDS * nuts_steps,
          f"sharded NUTS made {nuts_launches} nuts_step launches for {PARALLEL_SHARDS} shards x "
          f"{nuts_steps} transitions")
    want = {"partition": 0, "calibrate": 0, "forward": PARALLEL_SHARDS,
            "weighted": PARALLEL_SHARDS, "query_batch": 0, "gibbs": PARALLEL_SHARDS, "nuts": 0}
    check({k: n for k, (n, _) in per_call.items()} == want and launches[1] == 0,
          f"parallel path launches {per_call}, {launches}")
    # K12: every part's calibration on K2's kernels, 1 + 2 W_p launches a part
    # (W_p its plan's waves), and no other step of the path calibrates
    waves = sum(part["plan"].n_waves for part in sharded.parts)
    k2_want = {"clique_potentials": sharded.n_parts, "sepset_wave": waves, "absorb_wave": waves}
    log(f"parallel_k2_launches {k2_per_call} want calibrate {sharded.launches()} "
        f"(sum over {sharded.n_parts} parts of 1 + 2 x waves) by kernel "
        f"{JT_PATH_LAUNCHES['parallel']}; " + "; ".join(part_lines(sharded)))
    check(k2_per_call == {k: sharded.launches() if k == "calibrate" else 0 for k in per_call}
          and JT_PATH_LAUNCHES["parallel"] == k2_want,
          f"parallel path K2 launches {k2_per_call}, by kernel {JT_PATH_LAUNCHES['parallel']}, "
          f"want {k2_want}")
    check(config.DEVICE == device_before, f"config.DEVICE left at {config.DEVICE}")
    moments_launches = 3 * PARALLEL_SHARDS

    # ---- model-parallel calibration against the single-device program
    rtol = schedule_rtol(program)
    reference = program.calibrate(arrays)
    atol = single_device_atol(arrays[0].dtype)
    gap = (beliefs_gap(beliefs, reference[0], rtol, atol),
           beliefs_gap(mu, reference[1], rtol, atol))
    check_part_cards("parallel_jt_path", sharded, beliefs)
    log(f"parallel_jt_path against the single-device program: cliques {gap[0]}; sepsets "
        f"{gap[1]}; every belief on its part's card")
    k12_row = k12_kernel_row(program, sharded, arrays, beliefs, mu, rtol)
    if n_cards > 1:
        sharded_calibration_case("all_cards", program, arrays, get_mesh(), reference, rtol)
    del beliefs, mu, reference
    markov_sharded_case()

    # ---- forward draws against the exact marginals; the same seed twice
    nodes = sorted(model.nodes(), key=str)
    worst = 0.0
    for v in nodes:
        check(bool(within_mc_error(forward[v], marginals[v], SHARDED_DRAWS).all()),
              f"sharded forward {v}: {forward[v]} against {marginals[v]}")
        worst = max(worst, float(np.abs(forward[v] - marginals[v]).max()))
    again = sharded_sample_marginals(model, SHARDED_DRAWS, mesh=mesh, seed=SEED)
    check(all(np.array_equal(again[v], forward[v]) for v in nodes),
          "sharded forward: the same seed gave other counts")
    log(f"parallel_forward munin draws {SHARDED_DRAWS} shards {PARALLEL_SHARDS} variables "
        f"{len(nodes)} max_abs_err {worst:.3e} (limit 5*sqrt(p(1-p)/n)+1e-4) same seed twice: "
        f"equal counts")
    if n_cards > 1:
        spread = sharded_sample_marginals(model, SHARDED_DRAWS, mesh=get_mesh(), seed=SEED)
        check(all(within_mc_error(spread[v], marginals[v], SHARDED_DRAWS).all() for v in nodes),
              "sharded forward over every card")
        log(f"parallel_forward_all_cards cards {n_cards} within the same limits")

    # ---- likelihood-weighted draws against BP queries, at the effective size
    sampler = CompiledAncestralSampler(model)
    state_index = list(model.states[leaf]).index(state)
    codes, logw = sampler.likelihood_weighted(SHARDED_DRAWS // PARALLEL_SHARDS,
                                              {leaf: state_index}, seed=SEED)
    w = torch.exp(logw - logw.max()).double()
    ess = float(w.sum() ** 2 / (w * w).sum()) * PARALLEL_SHARDS
    worst = 0.0
    for v in checked:
        exact = bp.query([v], evidence={leaf: state}).values.double().cpu().numpy()
        check(bool(within_mc_error(weighted[v], exact, ess).all()),
              f"sharded likelihood weighting {v}: {weighted[v]} against {exact}")
        worst = max(worst, float(np.abs(weighted[v] - exact).max()))
    log(f"parallel_weighted munin evidence {leaf}={state} draws {SHARDED_DRAWS} effective "
        f"{ess:.0f} (one shard's weights, times the shards) variables {len(checked)} max_abs_err "
        f"{worst:.3e} against BeliefPropagation.query (limit 5*sqrt(p(1-p)/ess)+1e-4)")

    # ---- the 2,048 prediction rows: sharded query_batch against query_batch
    ve_values, ve_names = VariableElimination(fitted).query_batch(targets, rows)
    ve_values = ve_values.cpu().numpy()
    gaps = {}
    for shards, got, got_names in [(PARALLEL_SHARDS, values, names)] + [
            (k, *sharded_query_batch(fitted, targets, rows, mesh=Mesh([card] * k)))
            for k in (1, 3)]:
        check(got_names == ve_names and got.shape == ve_values.shape
              and np.allclose(got, ve_values, rtol=1e-5, atol=1e-7),
              f"sharded query_batch over {shards} shards differs from query_batch")
        gaps[shards] = float(np.abs(got - ve_values).max())
    log(f"parallel_query_batch munin rows {len(test)} evidence_columns {len(rows)} query "
        f"{targets} max_abs_err by shards {gaps} (rtol 1e-5, atol 1e-7; 3 shards pad 2 rows)")

    # ---- Gibbs on HEPAR2 and NUTS on ecoli70
    hepar_bp = BeliefPropagation(hepar)
    hepar_bp.calibrate()
    hepar_exact = exact_marginals(hepar_bp)
    worst = max(float(np.abs(gibbs[v] - hepar_exact[v]).max()) for v in gibbs)
    check(worst <= 0.02, f"sharded hepar2 Gibbs off by {worst}")
    log(f"parallel_gibbs hepar2 chains {HEPAR_CHAINS} sweeps {HEPAR_SWEEPS} burn_in "
        f"{HEPAR_BURN_IN} shards {PARALLEL_SHARDS} run_s {per_call['gibbs'][1]:.3f} "
        f"max_abs_marginal_err {worst:.4e} (limit 0.02)")
    variables, mean, cov = ecoli.joint_gaussian()
    moments = moments_check("sharded_nuts", np.array([nuts[v][0] for v in variables]),
                            np.array([nuts[v][1] for v in variables]), mean, cov,
                            NUTS_CHAINS * PARALLEL_NUTS_SAMPLES / 10)
    log(f"parallel_nuts ecoli70 chains {NUTS_CHAINS} adapt {NUTS_ADAPT} samples "
        f"{PARALLEL_NUTS_SAMPLES} shards {PARALLEL_SHARDS} run_s {per_call['nuts'][1]:.3f} "
        f"{moments}")

    # ---- K1 at the shape of one shard's moments: MUNIN's one-column specs
    cm = bc.column_major_codes(codes, max(sampler.cards))
    row = k1_shape_row("sharded_moments", cm, codes.shape[0], _marginal_specs(sampler.cards),
                       torch.exp(logw - logw.max()))

    # ---- two processes
    two_process_run("gloo")
    if n_cards > 1:
        two_process_run("nccl")
    check(config.DEVICE == device_before, f"config.DEVICE left at {config.DEVICE}")
    log(f"phase_parallel_main_path_s {path_s:.1f}")
    return launches, row, moments_launches, k12_row


# --------------------------------------------------------------------------- #
# K5, K11 and K13: the ancestral sweep and the two table-gather entry points,
# each against its plain version at MUNIN's width, timed beside its bound
# --------------------------------------------------------------------------- #
K5_NOISE_ROWS = 4096
# operations per (chain, state) of the exponential race (the Gibbs sweep's
# draw): a quarter of a Philox-4x32-10 block (10 rounds of 2 high and 2 low
# multiplies, 4 xors and 2 key adds), the uniform, two logarithms, a max, a
# subtraction and a comparison
K5_OPS_PER_STATE = 25 + 7
# the ancestral sweep's inverse-CDF draw: per (row, drawn node) a quarter of a
# Philox block and the uniform's conversion and scale, per (row, drawn state)
# a comparison and an add
K5_OPS_PER_NODE = 25 + 2
K5_OPS_PER_CDF_STATE = 2


def k5_kernel_row(sampler, n_sim):
    """K5 on MUNIN: the kernel against its plain version on explicit noise
    (4,096 rows; a plain draw, evidence on the last node, and clamps with
    partial codes: codes and log weights equal to the bit), its device time
    at the simulate shape (``n_sim`` rows, Philox from a generator) beside
    the parent commit's kernel where it is unpacked, in turns (parent,
    kernel, kernel, parent; each the smaller median of 20 behind a device
    sleep), the plain version's (CUDA events around its eager ops, median of
    5) and the card's bound."""
    from pgmpy_tpu_torch.ops import ancestral
    from pgmpy_tpu_torch.utils.mathext import seeded_generator

    sweep = sampler._sweep_tables
    d, n = len(sweep.cards), K5_NOISE_ROWS
    noise = torch.rand((d, n), generator=seeded_generator(SEED), dtype=torch.float64,
                       device=sweep.device)
    rng = np.random.default_rng(SEED)
    roots = [i for i, (parents, _, _) in enumerate(sampler._node_specs) if not parents]
    given = np.full(d, -1)
    given[roots[:2]] = 0
    partial = np.stack([rng.integers(0, c, n) for c in sweep.cards], axis=1)
    partial[rng.random(partial.shape) < 0.9] = -1
    partial = torch.as_tensor(partial, device=sweep.device)
    for case, kwargs in (("draw", {}), ("evidence", {"evidence": {d - 1: 0}}),
                         ("clamp_partial", {"given": given, "partial": partial})):
        got = ancestral.sweep_cuda(sweep, n, None, noise=noise, **kwargs)
        want = ancestral.sweep_reference(sweep, n, None, noise=noise, **kwargs)
        check(torch.equal(got[0], want[0]), f"k5 {case}: the kernel's codes differ from the "
                                            f"plain version's on the same noise")
        check(got[1] is None if "evidence" not in kwargs else torch.equal(got[1], want[1]),
              f"k5 {case}: the kernel's log weights differ from the plain version's")
    gen = seeded_generator(SEED)
    old = PARENT.get("modules", {}).get("ancestral")
    parent = None
    if old is not None:
        old_sweep = old.SweepTables(sampler._node_specs, sampler.cards, sampler._out_dtype)
        parent = lambda: old.sweep_cuda(old_sweep, n_sim, gen)  # noqa: E731
    ms, parent_ms, runs = paired_ms(lambda: ancestral.sweep_cuda(sweep, n_sim, gen), parent)
    plain_ms = cuda_median_ms(lambda: ancestral.sweep_reference(sweep, n_sim, gen), reps=5,
                              warmup=1)
    code_bytes = sampler._out_dtype.itemsize
    rows, _, shared = ancestral.plan_tile(
        d, code_bytes, sweep.groups, n_sim,
        torch.cuda.get_device_properties(sweep.device).multi_processor_count, sweep.stage_bytes,
        ancestral.card_resident(sweep.device, sweep.node_specs[0][2].element_size(), code_bytes))
    nbytes = n_sim * d * sampler._out_dtype.itemsize + 4 * sweep.total + sweep.nodes.nbytes
    bound_ms, bound_by = bound(nbytes, n_sim * (d * K5_OPS_PER_NODE
                                                + sum(sweep.cards) * K5_OPS_PER_CDF_STATE))
    log(f"k5 sweep rows={n_sim} nodes={d} states={sum(sweep.cards)} codes={sampler._out_dtype} "
        f"explicit-noise checks at {n} rows (draw, evidence, clamps and partial codes): codes and "
        f"log weights equal to the bit; groups={sweep.groups} levels={sweep.n_levels} "
        f"stage_nodes={sweep.stage_nodes} rows_a_block={rows} shared_bytes={shared} "
        f"blocks={-(-n_sim // rows)} kernel_ms={ms:.5f} parent_ms="
        f"{'not timed' if parent_ms is None else f'{parent_ms:.5f}'} (device time, Philox, "
        f"each the smaller median of 20 of two turns: " + "/".join(f"{t:.5f}" for t in runs)
        + f") plain_ms={plain_ms:.3f} (median of 5) bound_ms={bound_ms:.6f} ({bound_by}; "
        f"{K5_OPS_PER_NODE} operations per row and node, {K5_OPS_PER_CDF_STATE} per row and "
        f"state, the codes written once: "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms) library: none")
    return {"err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "parent_ms": parent_ms}


# K6's timed shapes beside MUNIN's 4,096 chains: HEPAR2 as the MCMC path
# (10,000 chains) and a shard of the multi-device path (2,500) run it
K6_HEPAR_SHAPES = (HEPAR_CHAINS, 2500)


def k6_bound(tables, n, code_bytes, elem):
    """(bound_ms, bound_by, nbytes) of one sweep of ``n`` chains: per chain
    every state's race and its blanket factors' adds, and each (variable,
    factor) row's multiply-add per other variable; the codes read and
    written once, the tables and descriptors read once."""
    d = len(tables.cards)
    nbytes = (2 * n * d * code_bytes + elem * tables.total + tables.vars.nbytes
              + tables.specs.nbytes + tables.others.nbytes)
    per_chain = sum(c * (K5_OPS_PER_STATE + k) for c, k in zip(tables.cards, tables.vars[:, 3]))
    per_chain += 2 * tables.others.shape[0]
    return (*bound(nbytes, n * per_chain), nbytes)


def paired_ms(kernel, parent):
    """Device times (median of 20 behind a device sleep) of ``kernel`` and,
    where given, the parent commit's ``parent`` in turns: parent, kernel,
    kernel, parent.  Returns (kernel ms, parent ms or None), each the
    smaller of its two medians, and the four medians."""
    if parent is None:
        ms = cuda_median_ms(kernel, device_only=True)
        return ms, None, [ms]
    runs = [cuda_median_ms(fn, device_only=True) for fn in (parent, kernel, kernel, parent)]
    return min(runs[1:3]), min(runs[0], runs[3]), runs


def k6_shape(name, tables, codes, parent_tables=None):
    """One K6 shape: the kernel against its plain version on explicit noise
    (codes equal to the bit), then the kernel's, the parent commit's and the
    plain version's times and the bound, from the same start states."""
    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.ops import gibbs as gibbs_ops
    from pgmpy_tpu_torch.utils.mathext import race_noise, seeded_generator

    n = codes.shape[0]
    noise = race_noise((sum(tables.cards), n), seeded_generator(SEED), config.DTYPE)
    got = gibbs_ops.sweep_cuda(tables, codes, None, noise=noise)
    want = gibbs_ops.sweep_reference(tables, codes, None, noise=noise)
    check(torch.equal(got, want), f"k6 {name}: the kernel's codes differ from the plain "
                                  f"version's on the same noise")
    gen = seeded_generator(SEED)
    out = torch.empty_like(codes)
    parent = None
    if parent_tables is not None:
        parent_gibbs = PARENT["modules"]["gibbs"]
        parent = lambda: parent_gibbs.sweep_cuda(parent_tables, codes, gen, out=out)  # noqa: E731
    ms, parent_ms, runs = paired_ms(lambda: gibbs_ops.sweep_cuda(tables, codes, gen, out=out),
                                    parent)
    plain_ms = cuda_median_ms(lambda: gibbs_ops.sweep_reference(tables, codes, gen), reps=5,
                              warmup=1)
    bound_ms, bound_by, nbytes = k6_bound(tables, n, codes.element_size(),
                                          config.DTYPE.itemsize)
    blocks, rows, _, staged, plan_staged, shared = gibbs_ops.launch_plan(tables, n, codes.device)
    log(f"k6 gibbs_sweep {name} chains={n} variables={len(tables.cards)} "
        f"states={sum(tables.cards)} factor_rows={tables.specs.shape[0]} pieces="
        f"{len(tables.pieces)} combines={len(tables.combines)} levels={tables.n_levels} "
        f"groups={tables.groups} critical_path={tables.critical_path} blocks={blocks} "
        f"rows={rows} staged_tables={'yes' if staged else 'no'} staged_plan="
        f"{'yes' if plan_staged else 'no'} shared_bytes={shared} "
        f"codes={codes.dtype} explicit noise: codes equal to the bit; kernel_ms={ms:.5f} "
        f"parent_ms={'not timed' if parent_ms is None else f'{parent_ms:.5f}'} (device time, "
        f"Philox, each the smaller median of 20 of two turns: "
        + "/".join(f"{t:.5f}" for t in runs)
        + f") plain_ms={plain_ms:.3f} (median of 5) bound_ms={bound_ms:.6f} ({bound_by}; "
        f"{K5_OPS_PER_STATE} operations per chain and state, one add per state and factor, two "
        f"per factor row and other variable; the codes read and written once: "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms) library: none")
    return {"name": name, "chains": n, "ms": ms, "parent_ms": parent_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def k6_kernel_row(gibbs, init):
    """K6: the Gibbs sweep kernel against its plain version on explicit
    noise and timed at each shape the paths launch: MUNIN's 4,096 start
    states (the row's own numbers), HEPAR2 at 10,000 and 2,500 chains from
    random states; ALARM's Markov model at 4,096 chains checked only.  Each
    time is the device time of single calls behind a device sleep (median
    of 20), beside the parent commit's kernel in turns where
    ``tools/parent_kernels.py`` unpacked it, the plain version's (CUDA
    events around its eager ops, median of 5) and the card's bound."""
    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.ops import gibbs as gibbs_ops
    from pgmpy_tpu_torch.sampling import GibbsSampling
    from pgmpy_tpu_torch.utils import get_example_model
    from pgmpy_tpu_torch.utils.mathext import race_noise, seeded_generator

    def parent_tables(tables):
        if "gibbs" not in PARENT.get("modules", {}):
            return None
        return PARENT["modules"]["gibbs"].GibbsTables(tables.var_specs, tables.cards,
                                                      tables.out_dtype)

    tables = gibbs._compiled._tables
    n = init.shape[0]
    markov = GibbsSampling(get_example_model("alarm").to_markov_model())
    markov_tables = markov._compiled._tables
    markov_init = torch.as_tensor(markov.random_state(n, SEED), device=init.device)
    noise = race_noise((sum(markov_tables.cards), n), seeded_generator(SEED), config.DTYPE)
    check(torch.equal(gibbs_ops.sweep_cuda(markov_tables, markov_init, None, noise=noise),
                      gibbs_ops.sweep_reference(markov_tables, markov_init, None, noise=noise)),
          "k6 alarm_markov: the kernel's codes differ from the plain version's on the same noise")
    row = k6_shape("munin", tables, init, parent_tables(tables))
    hepar = GibbsSampling(get_example_model("hepar2"))
    shapes = [row]
    for chains in K6_HEPAR_SHAPES:
        codes = torch.as_tensor(hepar.random_state(chains, SEED), device=init.device).to(
            hepar._compiled._out_dtype)
        shapes.append(k6_shape(f"hepar2_{chains}", hepar._compiled._tables, codes,
                               parent_tables(hepar._compiled._tables)))
    log(f"k6 explicit-noise checks: MUNIN at {n} chains, ALARM's Markov model at {n}, HEPAR2 at "
        f"{', '.join(str(c) for c in K6_HEPAR_SHAPES)}: codes equal to the bit")
    return {"err": 0.0, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
            "parent_ms": row["parent_ms"], "shapes": shapes}


def k9_kernel_row(pf, particles, evidence):
    """K9 on ALARM as a 2-TBN: one transition slice from the filter's final
    particles with the filter's evidence on the leaves, against the plain
    version on explicit noise (codes and log weights equal to the bit), its
    device time at the filter's shape (Philox; median of 20 behind a device
    sleep; beside the parent commit's kernel in turns where it is unpacked),
    the plain version's (median of 5), the card's bound, and beside it the
    slice's library calls timed the same way: the softmax with the effective
    sample size, and the systematic resample."""
    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.ops import ancestral
    from pgmpy_tpu_torch.utils.mathext import seeded_generator

    n, d = pf.n_particles, len(pf.variables)
    tables = pf._trans_specs
    ev_codes = np.full(d, -1)
    for (v, t), code in evidence.items():
        if t == 1:
            ev_codes[pf.var_index[v]] = code
    ev = {i: int(ev_codes[c]) for i, c in enumerate(tables.columns) if ev_codes[c] >= 0}
    check(bool(ev), "k9: the slice has no evidence")
    prev = torch.as_tensor(np.ascontiguousarray(particles.T),
                           device=tables.device).to(pf._out_dtype)
    noise = torch.rand((d, n), generator=seeded_generator(SEED), dtype=torch.float64,
                       device=tables.device)
    got = ancestral.sweep_cuda(tables, n, None, evidence=ev, noise=noise, prev=prev,
                               out=pf._code_matrix())
    want = ancestral.sweep_reference(tables, n, None, evidence=ev, noise=noise, prev=prev,
                                     out=pf._code_matrix())
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "k9: the kernel's codes or log weights differ from the plain version's on the same "
          "noise")
    gen = seeded_generator(SEED)
    out = pf._code_matrix()
    old = PARENT.get("modules", {}).get("ancestral")
    parent = None
    if old is not None:
        old_tables = old.SweepTables(tables.node_specs, tables.cards, pf._out_dtype,
                                     columns=tables.columns, particle=True)
        parent = lambda: old.sweep_cuda(old_tables, n, gen, evidence=ev, prev=prev,  # noqa: E731
                                        out=out)
    ms, parent_ms, runs = paired_ms(
        lambda: ancestral.sweep_cuda(tables, n, gen, evidence=ev, prev=prev, out=out), parent)
    plain_ms = cuda_median_ms(lambda: ancestral.sweep_reference(tables, n, gen, evidence=ev,
                                                                prev=prev, out=out),
                              reps=5, warmup=1)
    elem = config.DTYPE.itemsize
    prev_columns = {p - d for ps, _, _ in tables.node_specs for p in ps if p >= d}
    nbytes = (n * (d + len(prev_columns)) * prev.element_size() + n * elem
              + elem * tables.total + tables.nodes.nbytes)
    drawn = sum(c for i, c in enumerate(tables.cards) if i not in ev)
    parents = sum(len(ps) for ps, _, _ in tables.node_specs)
    drawn_nodes = len(tables.cards) - len(ev)
    bound_ms, bound_by = bound(nbytes, n * (drawn_nodes * K5_OPS_PER_NODE
                                            + drawn * K5_OPS_PER_CDF_STATE + 2 * parents
                                            + len(ev)))
    logw = got[1]
    offset = torch.rand((), generator=gen, dtype=config.DTYPE, device=prev.device)

    def weights():
        w = torch.softmax(logw, dim=0)
        return 1.0 / torch.sum(w * w)

    softmax_ms = cuda_median_ms(weights, device_only=True)
    resample_ms = cuda_median_ms(lambda: pf._systematic_resample(got[0], logw, offset),
                                 device_only=True)
    log(f"k9 particle_sweep particles={n} variables={d} drawn_states={drawn} "
        f"evidence_nodes={len(ev)} previous_slice_columns={len(prev_columns)} "
        f"levels={tables.n_levels} groups={tables.groups} codes={pf._out_dtype} explicit-noise "
        f"check: codes and log weights equal to the bit; kernel_ms={ms:.5f} parent_ms="
        f"{'not timed' if parent_ms is None else f'{parent_ms:.5f}'} (device time, Philox, "
        f"each the smaller median of 20 of two turns: " + "/".join(f"{t:.5f}" for t in runs)
        + f") plain_ms={plain_ms:.3f} (median of 5) bound_ms={bound_ms:.6f} ({bound_by}; "
        f"{K5_OPS_PER_NODE} operations per particle and drawn node, {K5_OPS_PER_CDF_STATE} per "
        f"particle and drawn state; the codes written and the "
        f"previous slice's columns read once: {nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms) library: "
        f"none; the slice's library calls: softmax_and_ess_ms={softmax_ms:.5f} "
        f"resample_ms={resample_ms:.5f} (float64 cumsum, searchsorted, index_select)")
    return {"err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "parent_ms": parent_ms}


def k10_shape(name, infer, variables, evidence, slices):
    """One K10 shape: ``filter_scan`` over ``slices`` - 1 transition slices
    against the plain version (the host loop of plain planned contractions)
    on the same inputs, its device time beside the parent commit's kernel in
    turns where it is unpacked (median of 20 behind a device sleep), the
    plain version's (median of 3, eager), and the bounds: bytes (the
    transition tables, codes, alpha and output moved once), operations (two
    a union entry of every step of every slice, pinned dims at their code
    counted once) and the dependency chain (``k10_dependency_ms``)."""
    from pgmpy_tpu_torch.factors.factor_ops import factor_sum_product
    from pgmpy_tpu_torch.inference.dbn import scan_reference

    inputs = infer._scan_inputs(variables, evidence, slices)
    alpha = factor_sum_product(inputs["iface0"], inputs["factors0"]).normalize(
        inplace=False).values
    program = infer._scan_program(inputs)
    codes, trans = inputs["codes"], inputs["trans_arrays"]
    got = program.run(alpha, trans, codes)
    want = scan_reference(inputs, alpha)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    limit = 1e-5 if got.dtype == torch.float32 else 1e-12
    check(got.shape == want.shape and err <= limit,
          f"k10 {name}: max_abs_err {err} (limit {limit})")
    parent = None
    old = PARENT.get("modules", {}).get("einsum")
    if old is not None:
        shapes = [inputs["alpha_shape"]] + [tuple(a.shape) for a in trans] + [
            (c,) for c in inputs["delta_cards"]]
        old_program = old.ScanProgram(inputs["operand_axes"], inputs["outputs"], shapes,
                                      [tuple(a.stride()) for a in trans], alpha.element_size())
        old_err = float((old_program.run(alpha, trans, codes) - got).abs().max())
        check(old_err <= limit, f"k10 {name}: {old_err} from the parent's kernel")
        parent = lambda: old_program.run(alpha, trans, codes)  # noqa: E731
    ms, parent_ms, runs = paired_ms(lambda: program.run(alpha, trans, codes), parent)
    plain_ms = cuda_median_ms(lambda: scan_reference(inputs, alpha), reps=3, warmup=1)
    n = codes.shape[0]
    observed = tuple(int(j) for j in np.flatnonzero((codes >= 0).any(axis=0)))
    rows, pairs = program.tables_for(observed)
    unions = k10_unions(program, observed, codes)
    nbytes = sum(t.numel() * t.element_size() for t in [*trans, alpha, got]) + codes.size * 4
    bound_ms, bound_by = bound(nbytes, 2 * unions)
    dependency_ms = k10_dependency_ms(program.n_levels + 1, n)
    staged, _, _, shared_bytes = program.layout(observed)
    log(f"k10 filter_scan {name} slices={n} queries={len(variables)} steps_per_slice={len(rows)} "
        f"(pair {int((rows[:, 0] == 2).sum())}, one-input {int((rows[:, 0] == 1).sum())}; no "
        f"delta operands, {len(observed)} evidence variables pinned; {len(pairs)} offset pairs; "
        f"lanes {rows[:, 6].tolist()}) levels={program.n_levels} "
        f"level_sizes={np.bincount(program.levels).tolist()} barriers_per_slice="
        f"{program.n_levels + 1} work_items={len(program.work)} unions_this_run={unions} "
        f"arena={program.arena} ({'shared' if program.shared else 'global'}) factors_and_tables="
        f"{'staged' if staged else 'global'} shared_bytes={shared_bytes} kernel_ms={ms:.5f} "
        f"parent_ms={'not timed' if parent_ms is None else f'{parent_ms:.5f}'} (device time, one "
        f"launch, each the smaller median of 20 of two turns: "
        + "/".join(f"{t:.5f}" for t in runs)
        + f") plain_ms={plain_ms:.3f} (median of 3) bound_ms={bound_ms:.6f} ({bound_by}) "
        f"dependency_bound_ms={dependency_ms:.5f} ({program.n_levels + 1} barriers a slice x "
        f"{n} slices x {K10_LEVEL_CYCLES} cycles at {SM_MAX_MHZ[0]:.0f} MHz) library: none "
        f"max_abs_err={err:.3e} (limit {limit:g})")
    return {"name": name, "slices": n, "err": err, "ms": ms, "parent_ms": parent_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "dependency_bound_ms": dependency_ms, "levels": program.n_levels,
            "steps": len(rows)}


def k10_unions(program, observed, codes):
    """Union entries (output x reduced) of every step over the slices, as
    this run's data needs them: an output entry whose pinned digit differs
    from its slice's code and a reduced entry off a pinned code are not
    counted."""
    from pgmpy_tpu_torch.ops.einsum import MAX_LABELS, SCAN_HEADER

    rows, _ = program.tables_for(observed)
    total = 0
    for code in np.asarray(codes):
        for row in rows:
            n_po, n_pr = int(row[7]), int(row[8])
            outs, reds = int(row[4]), int(row[5])
            for i in range(n_po):
                var, _, ext = (int(x) for x in row[SCAN_HEADER + 3 * i:SCAN_HEADER + 3 * i + 3])
                outs //= ext if code[var] >= 0 else 1
            at = SCAN_HEADER + 3 * MAX_LABELS
            for i in range(n_pr):
                var, _, ext = (int(x) for x in row[at + 3 * i:at + 3 * i + 3])
                reds *= 1 if code[var] >= 0 else ext
            total += outs * reds
    return total


def k10_dependency_ms(barriers, slices):
    """The dependency bound of a filter_scan launch: its barriers (levels + 1
    a slice) times the cycles of one barrier and one dependent shared-memory
    read (``K10_LEVEL_CYCLES``, a ``tools/stamp_kernels.py k10`` reading) at
    the card's highest SM clock."""
    return barriers * slices * K10_LEVEL_CYCLES / (SM_MAX_MHZ[0] * 1e3)


def k10_kernel_row(infer, variables, evidence, rain_infer, rain_evidence):
    """K10: ``filter_scan`` on ALARM as a 2-TBN over its 49 transition
    slices (the row's own numbers: the smoke's queries and evidence) and on
    the rain / umbrella network over 199 (``k10_shape``)."""
    alarm = k10_shape("alarm_2tbn", infer, variables, evidence, ALARM_SLICES)
    rain = k10_shape("rain_umbrella", rain_infer, ["rain"], rain_evidence, PF_SLICES)
    return {**{key: alarm[key] for key in ("err", "ms", "plain_ms", "bound_ms", "bound_by",
                                           "parent_ms", "dependency_bound_ms")},
            "library_ms": None, "shapes": [alarm, rain]}


def gather_bytes(gather, codes, table, out_elem):
    """Bytes a table-gather launch must move: every code column it reads and
    the table once, its output once, the node table."""
    used = np.unique(np.concatenate([c.cpu().numpy() for c, _, _ in gather.groups]))
    n = codes.shape[1]
    return (used.size * n * codes.element_size() + table.numel() * table.element_size()
            + n * out_elem + gather.nodes.nbytes)


def gather_operations(gather, n_rows):
    """A multiply-add per (row, code read) and an add per (row, node)."""
    per_row = int((gather.nodes[:, 1].astype(np.int64) * 2 + 1).sum())
    return per_row * n_rows


def k13_parent_gather(prob, old):
    """The parent commit's ``TableGather`` over ``prob``'s nodes, built as
    ``BayesianModelProbability`` builds its own."""
    specs, cards = prob.sampler._node_specs, prob.sampler.cards
    sizes = [int(log_table.numel()) for _, _, log_table in specs]
    return old.TableGather(
        [(i,) + tuple(parents) for i, (parents, _, _) in enumerate(specs)],
        [(1,) + tuple(s * cards[i] for s in strides) for i, (_, strides, _) in enumerate(specs)],
        np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64), int(sum(sizes)),
        prob._table.device)


def k13_kernel_row(prob, codes):
    """K13 on MUNIN's rows: ``row_sums`` against its plain version (rtol
    1e-5: the kernel sums in float64 and rounds once, the plain version sums
    float32 group by group) and, where it is unpacked, the parent commit's
    kernel, device times (median of 20 behind a device sleep; the parent's in
    turns) and the card's bound."""
    from pgmpy_tpu_torch.ops import table_gather

    gather, table = prob._gather, prob._table
    got = gather.row_sums_cuda(table, codes)
    want = gather.row_sums_reference(table, codes)
    err = float((got.double() - want.double()).abs().max())
    rel = float(((got.double() - want.double()).abs() / want.double().abs()).max())
    check(bool(torch.isfinite(got).all()) and rel <= 1e-5,
          f"k13: the kernel is {rel} (relative) from the plain version")
    parent = None
    old = PARENT.get("modules", {}).get("table_gather")
    if old is not None:
        old_gather = k13_parent_gather(prob, old)
        old_rel = float(((old_gather.row_sums_cuda(table, codes).double() - got.double()).abs()
                         / want.double().abs()).max())
        check(old_rel <= 1e-5, f"k13: {old_rel} (relative) from the parent's kernel")
        parent = lambda: old_gather.row_sums_cuda(table, codes)  # noqa: E731
    ms, parent_ms, runs = paired_ms(lambda: gather.row_sums_cuda(table, codes), parent)
    plain_ms = cuda_median_ms(lambda: gather.row_sums_reference(table, codes), device_only=True)
    bound_ms, bound_by = bound(gather_bytes(gather, codes, table, got.element_size()),
                               gather_operations(gather, codes.shape[1]))
    rows, slices, block, _, tiles = table_gather.plan_rows(codes.shape[1])
    log(f"k13 row_sums rows={codes.shape[1]} nodes={gather.nodes.shape[0]} codes={codes.dtype} "
        f"table={table.dtype} tiles={tiles} of {rows} rows, {slices} node slices, block={block} "
        f"max_abs_err={err:.3e} max_rel_err={rel:.3e} (limit 1e-5) kernel_ms={ms:.5f} "
        f"parent_ms={'not timed' if parent_ms is None else f'{parent_ms:.5f}'} (device time, each "
        f"the smaller median of 20 of two turns: " + "/".join(f"{t:.5f}" for t in runs)
        + f") plain_ms={plain_ms:.5f} (median of 20) bound_ms={bound_ms:.6f} ({bound_by}) "
        f"library: none")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "parent_ms": parent_ms}


def e_step_node_rows(gather, latent_only):
    """The E-step's node rows (the latent nodes' alone where
    ``latent_only``) and their node indices."""
    row_words = 2 + 2 * gather.width
    n_shared, n_nodes = len(gather.shared_nodes), len(gather.shared_nodes) + len(
        gather.latent_nodes)
    rows = gather.nodes[: n_nodes * row_words].reshape(n_nodes, row_words)
    if latent_only:
        return rows[n_shared:], gather.latent_nodes
    return rows, gather.shared_nodes + gather.latent_nodes


def e_step_bytes(gather, codes, sizes, table_elem, n_out, out_elem, latent_only):
    """Bytes the E-step must move: every observed code column its nodes read,
    once per row; their table entries (``sizes`` per node); its weights
    (``n_out``) once; their node rows and the grid.  ``latent_only``: the
    latent nodes alone, which is all the weights need (the shared nodes add
    one finite sum, the same for every configuration, to a row's
    log-probabilities, and the softmax cancels it)."""
    rows, nodes = e_step_node_rows(gather, latent_only)
    used = {int(c) for row in rows for c in row[2: 2 + row[1]] if c >= 0}
    return (len(used) * codes.shape[1] * codes.element_size()
            + int(np.asarray(sizes)[nodes].sum()) * table_elem + n_out * out_elem
            + (rows.size + gather.grid.size) * 4)


def e_step_operations(gather, n_rows, latent_only):
    """The least operations a row takes: a shared node's index, a
    multiply-add per code, and its add, once; a latent node's data part of
    the index once, then per configuration an add of its latent part and
    an add of its term.  The shared nodes are left out where
    ``latent_only``."""
    rows, _ = e_step_node_rows(gather, False)
    n_shared = len(gather.shared_nodes)
    data = np.array([int((row[2: 2 + row[1]] >= 0).sum()) for row in rows], dtype=np.int64)
    per_row = int((2 * data[n_shared:] + 2 * gather.K).sum())
    if not latent_only:
        per_row += int((2 * data[:n_shared] + 1).sum())
    return per_row * n_rows


def k11_kernel_row(program, prob):
    """K11 on MUNIN with DIFFN_PATHO latent: ``e_step`` over the 50,000
    observed rows against its plain version (atol 1e-6: both take the softmax
    in float64 and round the weights to float32 once; the float64 sums differ
    in order only) and against the parent commit's kernel where it is
    unpacked (over the same observed rows), device times (median of 20 behind a
    device sleep; the parent's in turns), the plain version's, and the bound
    of the bytes the weights need (the latent nodes' columns, tables and the
    weights: ``e_step_bytes``) beside the bound of every column any node
    reads and the old one that counted the expanded codes."""
    from pgmpy_tpu_torch.config import TINY

    gather, K = program.gather, program.K
    table = torch.log(torch.clamp_min(prob, TINY).to(torch.float64))
    codes = program.obs._column_codes()[:, : program.n]
    got = gather.e_step_cuda(table, codes, prob.dtype)
    want = gather.e_step_reference(table, codes, prob.dtype)
    err = float((got.double() - want.double()).abs().max())
    check(got.shape == want.shape and err <= 1e-6,
          f"k11: the E-step kernel is {err} from the plain version")
    parent, parent_rows = None, "none"
    expanded = program.coded._column_codes()[:, : program.coded.n]
    old = PARENT.get("modules", {}).get("table_gather")
    specs, n_nodes = program.specs, len(program.var_order)
    if old is not None:
        obs = program.obs
        latents = [v for v in program.var_order if v not in obs.var_index]
        source = {v: -1 - j for j, v in enumerate(latents)}
        source.update({v: obs.var_index[v] for v in program.var_order if v in obs.var_index})
        old_gather = old.LatentGather(
            [[source[program.var_order[c]] for c in specs.cols[s, : specs.n_cols[s]]]
             for s in range(n_nodes)],
            [specs.strides[s, : specs.n_cols[s]] for s in range(n_nodes)], specs.offsets,
            specs.total, gather.grid, table.device)
        parent = lambda: old_gather.e_step_cuda(table, codes, prob.dtype)  # noqa: E731
        parent_rows = f"the same {codes.shape[1]} observed rows"
    if parent is not None:
        old_err = float((parent().double() - got.double()).abs().max())
        check(old_err <= 1e-6, f"k11: {old_err} from the parent's kernel")
    ms, parent_ms, runs = paired_ms(lambda: gather.e_step_cuda(table, codes, prob.dtype), parent)
    plain_ms = cuda_median_ms(lambda: gather.e_step_reference(table, codes, prob.dtype),
                              device_only=True)
    sizes, n = program.specs.sizes, codes.shape[1]
    nbytes = e_step_bytes(gather, codes, sizes, table.element_size(), got.numel(),
                          got.element_size(), latent_only=True)
    bound_ms, bound_by = bound(nbytes, e_step_operations(gather, n, latent_only=True))
    all_bytes = e_step_bytes(gather, codes, sizes, table.element_size(), got.numel(),
                             got.element_size(), latent_only=False)
    all_ms, all_by = bound(all_bytes, e_step_operations(gather, n, latent_only=False))
    old_bytes = (expanded.shape[0] * expanded.shape[1] * expanded.element_size()
                 + table.numel() * table.element_size() + got.numel() * got.element_size())
    rows, slices, block, shared = plan_e_step_of(gather)
    log(f"k11 e_step rows={codes.shape[1]} K={K} nodes={len(gather.shared_nodes)} shared + "
        f"{len(gather.latent_nodes)} latent codes={codes.dtype} weights={got.dtype} tile_rows="
        f"{rows} latent_slices={slices} block={block} shared_bytes={shared} max_abs_err="
        f"{err:.3e} (limit 1e-6) kernel_ms={ms:.5f} parent_ms="
        f"{'not timed' if parent_ms is None else f'{parent_ms:.5f}'} (device time, each the "
        f"smaller median of 20 of two turns: " + "/".join(f"{t:.5f}" for t in runs)
        + f"; the parent over {parent_rows}) plain_ms={plain_ms:.5f} "
        f"(median of 20) bound_ms={bound_ms:.6f} ({bound_by}: {nbytes} bytes, the columns the "
        f"latent nodes read once, their tables, the weights; operations_ms="
        f"{e_step_operations(gather, n, True) / PLAIN_OPS_PER_S * 1e3:.6f}) all_nodes_bound_ms="
        f"{all_ms:.6f} ({all_by}: {all_bytes} bytes, every column any node reads, as the kernel "
        f"sums the shared nodes too) expanded_bound_ms={old_bytes / HBM_BYTES_PER_S * 1e3:.6f} "
        f"(the expanded codes, {old_bytes} bytes, read by the kernel before the redesign) library: "
        f"none")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "parent_ms": parent_ms,
            "all_nodes_bound_ms": all_ms,
            "expanded_bound_ms": old_bytes / HBM_BYTES_PER_S * 1e3}


def plan_e_step_of(gather):
    from pgmpy_tpu_torch.ops import table_gather

    return table_gather.plan_e_step(gather.K, gather.width, len(gather.shared_nodes),
                                    len(gather.latent_nodes), gather.L)


def ptxas_summary(text):
    """One line per kernel of ``nvcc -Xptxas -v``'s output: registers,
    shared memory, stack and spills."""
    import re

    types = {"f": "float", "d": "double", "a": "int8", "s": "int16", "i": "int32",
             "l": "int64"}
    out, name = [], None
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '\w*?([a-z]+(?:_[a-z]+)*)I(\w*?)EEv", line)
        if entry and re.fullmatch(r"[fdasil]+", entry.group(2)):
            name = entry.group(1) + "<" + ", ".join(types[t] for t in entry.group(2)) + ">"
        elif entry:
            args = re.findall(r"Lb(\d)E|Li(\d+)E|^([fd])|(?<=E)([fd])", entry.group(2))
            name = entry.group(1) + "<" + ", ".join(
                types.get(t or u, "") or ("true" if b == "1" else "false" if b else i)
                for b, i, t, u in args) + ">"
        elif name and "bytes spill stores" in line:
            spills = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {regs} registers, {smem.group(1) if smem else 0} bytes smem, "
                       f"{spills}")
            name = None
    return out


def build_kernels():
    """Build every kernel source of the port at once (one nvcc per source,
    all started together), then load each, and log each build's time and
    what ptxas says of each kernel."""
    from pgmpy_tpu_torch.ops import (_build, ancestral, bincount, einsum, gibbs, hmc, jt, loopy,
                                     table_gather)

    t0 = time.time()
    _build.build_libraries({"bincount": ["bincount.cu"], "jt_calibrate": ["jt_calibrate.cu"],
                            "table_gather": ["table_gather.cu"], "ancestral": ["ancestral.cu"],
                            "gibbs": ["gibbs.cu"], "einsum_plan": ["einsum_plan.cu"],
                            "hmc": ["hmc.cu"], "loopy_bp": ["loopy_bp.cu"]})
    for load in (bincount._library, jt._library, table_gather._library, ancestral._library,
                 gibbs._library, einsum._library, hmc._library, loopy._library):
        load()
    log(f"kernels_built_s {time.time() - t0:.2f} (csrc/bincount.cu, jt_calibrate.cu, "
        f"table_gather.cu, ancestral.cu, gibbs.cu, einsum_plan.cu, hmc.cu and loopy_bp.cu, one "
        f"nvcc each, started together)")
    for name, built in _build.BUILDS.items():
        log(f"kernels_built {name} nvcc_s {built['seconds']:.2f}")
        for line in ptxas_summary(built["ptxas"]):
            log(f"ptxas {name} {line}")


# the parent commit's wrappers over its kernels, where ``tools/parent_kernels.py
# unpack`` left them in the tree: {"rev", "modules"}; those timed beside this
# tree's (K5 and K9, K3 and K10, K11; K6 and K8 whenever "gibbs" and "hmc" are
# added)
PARENT = {}
PARENT_WRAPPERS = {"ancestral": "ancestral.cu", "einsum": "einsum_plan.cu",
                   "table_gather": "table_gather.cu"}


def parent_tool():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "parent_kernels.py")
    spec = importlib.util.spec_from_file_location("parent_kernels", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def start_parent_builds():
    """Start building the parent commit's kernels of ``PARENT_WRAPPERS``
    beside this tree's where ``tools/parent_kernels.py unpack`` left them in
    the tree (a checkout of the commit alone has none: its rows then say
    "not timed")."""
    tool = parent_tool()
    if not tool.available():
        log("parent kernels: none unpacked (tools/parent_kernels.py unpack): not timed")
        return None
    return tool, tool.start_builds(wrappers=PARENT_WRAPPERS)


def load_parent(parent):
    if parent is None:
        return
    tool, builds = parent
    modules, report = tool.load(builds)
    PARENT.update(rev=tool.revision(), modules=modules)
    for name, (seconds, ptxas) in report.items():
        log(f"parent_kernels {tool.revision()} {name} nvcc_s {seconds:.2f}")
        for line in ptxas_summary(ptxas):
            log(f"ptxas parent {name} {line}")


def main():
    if "PYTHONHASHSEED" not in os.environ:
        # MUNIN's junction tree follows the string hash seed: pin it, so that
        # every run times the same tree
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from pgmpy_tpu_torch.config import config

    config.set_device("cuda")
    if sys.argv[1:] == ["--fresh-profile"]:
        fresh_profile_main()
        return 0
    started = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    SM_MAX_MHZ[0] = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    log(f"sm_max_mhz {SM_MAX_MHZ[0]:.0f}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    parent = start_parent_builds()
    build_kernels()
    load_parent(parent)
    bincount_results = phase_bincount()
    model, df, codes = load_and_sample()
    context, kernels = phase_slice(model, df, codes, bincount_results,
                                   phase_table_counts(model, codes))
    log(f"phase_main_s {time.time() - t0:.1f} (builds, K1's checks, the main path and K2)")
    # the second path: its launches are counted on their own, from zero
    t0 = time.time()
    table_launches, bincount_launches = phase_simulate_predict(model, context)
    kernels[0]["launches_simulate_fit_predict"] = bincount_launches
    kernels[1]["launches_simulate_fit_predict"] = table_launches
    log(f"phase_simulate_predict_s {time.time() - t0:.1f}")
    t0 = time.time()
    phase_k3(context)
    log(f"phase_k3_s {time.time() - t0:.1f}")
    # the third path
    t0 = time.time()
    table_launches, bincount_launches = phase_mcmc(model)
    kernels[0]["launches_mcmc"] = bincount_launches
    kernels[1]["launches_mcmc"] = table_launches
    log(f"phase_mcmc_s {time.time() - t0:.1f}")
    # the fourth and fifth paths, and K1 at the two shapes they give it
    t0 = time.time()
    (temporal_tables, temporal_bincounts), weighted, filter_launches = phase_temporal()
    log(f"phase_temporal_s {time.time() - t0:.1f}")
    t0 = time.time()
    (structure_tables, structure_bincounts), pairs = phase_structure(df)
    log(f"phase_structure_s {time.time() - t0:.1f}")
    # the sixth path, and K1 at the shape of a PC level
    t0 = time.time()
    (constraint_tables, constraint_bincounts), level1 = phase_constraint(context["fitted"], df)
    log(f"phase_constraint_s {time.time() - t0:.1f}")
    for row, temporal, structure, constraint in (
            (kernels[0], temporal_bincounts, structure_bincounts, constraint_bincounts),
            (kernels[1], temporal_tables, structure_tables, constraint_tables)):
        row["launches_temporal"] = temporal
        row["launches_structure"] = structure
        row["launches_constraint"] = constraint
    # the seventh and eighth paths, and K1 at the two shapes the latent lane gives it
    t0 = time.time()
    ((latent_tables, latent_bincounts), em_row, nb_row, em_launches,
     nb_fit_launches) = phase_latent(model, df, codes)
    log(f"phase_latent_s {time.time() - t0:.1f}")
    t0 = time.time()
    loopy_tables, loopy_bincounts = phase_loopy()
    log(f"phase_loopy_s {time.time() - t0:.1f}")
    # the ninth path
    t0 = time.time()
    causal_tables, causal_bincounts = phase_causal(model)
    log(f"phase_causal_s {time.time() - t0:.1f}")
    # the tenth and eleventh paths
    t0 = time.time()
    functional_tables, functional_bincounts = phase_functional()
    log(f"phase_functional_s {time.time() - t0:.1f}")
    t0 = time.time()
    readwrite_tables, readwrite_bincounts = phase_readwrite(model, df, context["fitted"])
    log(f"phase_readwrite_s {time.time() - t0:.1f}")
    # the twelfth path, and K1 at the shape of one shard's moments
    t0 = time.time()
    (parallel_tables, parallel_bincounts), moments_row, moments_launches, k12_row = (
        phase_parallel(model, context))
    log(f"phase_parallel_s {time.time() - t0:.1f}")
    for name, launches, result in (
            ("table_counts/particle_marginals_weighted", filter_launches, weighted),
            ("table_counts/pair_tables", 1, pairs),
            ("table_counts/pc_level1", 1, level1),
            ("table_counts/em_mstep_weighted", em_launches, em_row),
            ("table_counts/naive_bayes_fit", nb_fit_launches, nb_row),
            ("table_counts/sharded_moments", moments_launches, moments_row)):
        kernels.append({
            "name": name, "route": "cuda", "source": kernels[1]["source"],
            "replaces": kernels[1]["replaces"], "launches": launches,
            "max_abs_err": result["err"],
            **{key: result[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "launches_temporal": temporal_tables, "launches_structure": structure_tables,
            "launches_constraint": constraint_tables,
        })
    for row in kernels:
        first = row is kernels[0]  # weighted_bincount's row; the others are table_counts'
        row["launches_latent"] = latent_bincounts if first else latent_tables
        row["launches_loopy"] = loopy_bincounts if first else loopy_tables
        row["launches_causal"] = causal_bincounts if first else causal_tables
        row["launches_functional"] = functional_bincounts if first else functional_tables
        row["launches_readwrite"] = readwrite_bincounts if first else readwrite_tables
        row["launches_parallel"] = parallel_bincounts if first else parallel_tables
    # K2's rows: one per kernel, its launches on the main path and on each
    # other path, counted in the same runs as K1's
    k2 = context["k2"]
    for name, result in k2["kernels"].items():
        kernels.append({
            "name": f"jt_calibrate/{name}", "route": "cuda", "source": JT_SOURCE,
            "replaces": JT_REPLACES, "launches": JT_PATH_LAUNCHES["main"][name],
            "max_abs_err": result["err"],
            **{key: result[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            **{f"launches_{path}": counts[name] for path, counts in JT_PATH_LAUNCHES.items()
               if path != "main"},
        })
    log("k2_launches_by_path " + " ".join(
        f"{path} {sum(counts.values())}" for path, counts in JT_PATH_LAUNCHES.items()))
    # K12's row: K2's kernels on the multi-device path's part plans; its
    # launches are the K2 launches of that path's counted run, all made by
    # the sharded calibration (checked in phase_parallel)
    k12_launches = sum(JT_PATH_LAUNCHES["parallel"].values())
    check(k12_launches > 0, "the parallel path did not launch K2 on its part plans")
    kernels.append({
        "name": "jt_mesh/calibrate_parts", "route": "cuda", "source": JT_SOURCE,
        "replaces": "pgmpy_tpu/parallel/jt_mesh.py:121", "launches": k12_launches,
        "launches_counted_on": "parallel", "max_abs_err": k12_row["err"],
        **{key: k12_row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    })
    # K5's, K9's, K6's, K13's, K11's, K3's, K10's, K8's and K7's rows: each kernel's
    # launches on the path that drives it (set to 0 before that path and read
    # after it), and on the others
    for name, (source, replaces, path) in GATHER_KERNELS.items():
        launches = GATHER_PATH_LAUNCHES[path][name]
        check(launches > 0, f"the {path} path did not launch {name}")
        result = GATHER_ROWS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_counted_on": path, "max_abs_err": result["err"],
            **{key: result[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            **{key: result[key] for key in ("parent_ms", "shapes", "dependency_bound_ms",
                                            "all_nodes_bound_ms", "expanded_bound_ms")
               if key in result},
            **{f"launches_{other}": counts[name] for other, counts in GATHER_PATH_LAUNCHES.items()
               if other != path},
        })
    log("k5_k9_k6_k11_k13_k3_k10_k8_k7_launches_by_path " + " ".join(
        f"{path} {counts}" for path, counts in GATHER_PATH_LAUNCHES.items()))
    log(f"profiler_sessions {PROFILE_SESSIONS['sessions']} short {PROFILE_SESSIONS['short']} "
        f"(in this process: sessions that kept fewer device records than the fullest of their "
        f"call)")
    log(f"script_s {time.time() - started:.1f}")
    log(smi)  # again near the end, where a reader of the output's tail finds it
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
