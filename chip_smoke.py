"""End-to-end check of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Runs from the repository root and needs one CUDA card.  It

1. builds the hand-written count kernels (``pgmpy_tpu_torch/csrc/bincount.cu``)
   and holds both entry points against their plain PyTorch versions on the
   card: ``weighted_bincount`` on index vectors, ``table_counts`` on MUNIN's
   1041 (node, parents) tables over the 50,000-row code matrix;
2. drives the port's main path at full width: load MUNIN (1041 variables),
   draw 50,000 rows with a seeded numpy ancestral sampler, fit every CPD with
   the BDeu Bayesian estimator (one table-count launch for all 1041 tables),
   calibrate the junction tree, then run ``query`` and ``query_batch`` (2048
   rows).  The fit no longer calls ``weighted_bincount``, so that entry point
   is driven, counted, checked and timed on its own: one direct call that
   tabulates the evidence variable's observed states over the 50,000 rows;
3. checks the fit against host ``np.bincount`` counts, the calibration
   against the junction-tree identities and the port's own CPU run, and the
   queries against the CPU run;
4. drives simulate -> fit -> predict at the same width: ``model.simulate``
   draws 52,048 rows of the true MUNIN on the card (state frequencies against
   the exact marginals of a calibrated junction tree; the same seed twice
   gives equal codes), a fresh network is fitted on the first 50,000 (one
   table-count launch), ``predict`` and ``predict_probability`` fill three
   dropped columns of the last 2,048 rows (against a numpy float64 oracle
   computed from the fitted CPD tables, and against the CPU run), one
   sparse-evidence ``VariableElimination`` query runs if its planned
   contraction stays under a memory guard (against BeliefPropagation), and
   ``ApproxInference`` answers one query from 50,000 draws;
5. prints the card, the timings, one JSON line describing each kernel (its
   time beside the plain version's, the card's bound for the same bytes and,
   where one PyTorch call computes the same function, that call's time), and,
   as the last line, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the exit code is not 0 and no result line is
printed.  Without a CUDA device it exits with code 1 before doing anything.
"""

import contextlib
import json
import subprocess
import sys
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


def cuda_median_ms(fn, reps=20, warmup=2, device_only=False):
    """Median of ``reps`` single-call timings taken with CUDA events.

    With ``device_only`` each call is queued behind a ~1 ms device sleep, so
    the events time the call's kernels on the device and not the host's
    Python work between them (which a call of a few microseconds of kernels
    would otherwise measure)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes, operations):
    """(bound_ms, bound_by): the least time the card could take to move
    ``nbytes`` once or to do ``operations``, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = operations / PLAIN_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def profiled(fn, reps=1):
    """(kernels per call, device ms per call) of ``fn`` from ``torch.profiler``:
    the device operations it starts and the sum of their times."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels) / reps, sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps


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
        "plain_ms": cuda_median_ms(lambda: bc.weighted_bincount_reference(idx, w, length),
                                   device_only=True),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }
    if library:
        lib = torch.bincount(idx, weights=w, minlength=length)
        check(torch.equal(lib.to(got.dtype), got), f"k1 {name}: torch.bincount differs")
        out["library_ms"] = cuda_median_ms(
            lambda: torch.bincount(idx, weights=w, minlength=length), device_only=True)
    log(f"k1 {name} n={n} length={length} {idx.dtype} {w.dtype} max_abs_err={err:.3e} "
        f"kernel_ms={out['ms']:.5f} plain_ms={out['plain_ms']:.5f} "
        f"bound_ms={bound_ms:.6f} ({bound_by}) torch_bincount_ms={out['library_ms']} "
        f"(device time, median of 20)")
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
    return {"err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


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
    from pgmpy_tpu_torch.ops import weighted_bincount
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
    bc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    fitted.fit(df, estimator=BayesianEstimator, state_names=states,
               prior_type="BDeu", equivalent_sample_size=5)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    fit_launches = (bc.TABLE_LAUNCHES, bc.LAUNCHES)
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
    bc.reset_launches()
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
    log(f"calibrate_median_ms {cal_ms:.4f} (15 runs, CUDA events)")
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
    context = {"fitted": fitted, "q_var": q_var, "e_var": e_var, "bp_single": single}
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
    from pgmpy_tpu_torch.ops import bincount as bc
    from pgmpy_tpu_torch.sampling import BayesianModelSampling
    from pgmpy_tpu_torch.utils.interop import bn_from_numpy

    states = model.states
    nodes = sorted(model.nodes(), key=str)
    n_sim = N_ROWS + BATCH_ROWS

    # ---- 1. simulate on the card
    torch.cuda.synchronize()
    t0 = time.time()
    df = model.simulate(n_samples=n_sim, seed=SEED, show_progress=False)
    torch.cuda.synchronize()
    simulate_first_s = time.time() - t0
    simulate_s = host_median_s(
        lambda: model.simulate(n_samples=n_sim, seed=SEED, show_progress=False))
    sampler = BayesianModelSampling(model).sampler  # the one simulate compiled
    device_codes = sampler.forward(n_sim, seed=SEED)
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
    bc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    fitted.fit(train, estimator=BayesianEstimator, state_names=states,
               prior_type="BDeu", equivalent_sample_size=5)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    table_launches, bincount_launches = bc.TABLE_LAUNCHES, bc.LAUNCHES
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
    return table_launches, bincount_launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from pgmpy_tpu_torch.config import config

    config.set_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    bincount_results = phase_bincount()
    model, df, codes = load_and_sample()
    context, kernels = phase_slice(model, df, codes, bincount_results,
                                   phase_table_counts(model, codes))
    # the second path: its launches are counted on their own, from zero
    table_launches, bincount_launches = phase_simulate_predict(model, context)
    kernels[0]["launches_simulate_fit_predict"] = bincount_launches
    kernels[1]["launches_simulate_fit_predict"] = table_launches
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
