"""Where the time goes on the port's MUNIN path, on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 tools/profile_port_munin.py

It builds the same MUNIN model and 50,000-row data set as ``chip_smoke.py``
and prints, one ``key value`` pair per line:

* the fit broken into data coding (``_CodedData``) and ``get_parameters``,
  and the count step of the fit (all 1041 tables through ``multi_counts``, as
  ``get_parameters`` calls it): device operations, their device time, the
  table-count kernel's share, and the host time of the call;
* per calibration: kernels launched, device time (the sum of kernel times
  from ``torch.profiler``), the host's enqueue time, the CUDA-event wall time,
  the device's idle share, and the bytes the schedule must move with the time
  that takes at the card's published 3.35 TB/s;
* the device time of one 2048-row ``query_batch``;
* per ``simulate`` of 52,048 rows: kernels and device time of the sampler's
  sweep, its host time, and the host time of the whole call (the sweep plus the
  pandas frame); per ``predict`` and ``predict_probability`` of 2,048 rows
  with three columns missing: kernels, device time, host time, and the same
  for the batched contraction alone (codes already on the card);
* per Gibbs sweep of 4,096 chains over MUNIN's 1041 variables, and per NUTS
  step of 1,024 chains on ecoli70: kernels, device time, host time, the idle
  share and the device operations by name;
* per time slice of the particle filter (262,144 particles) and of
  ``DBNInference.forward_scan`` (6 queries) on ALARM unrolled as a 2-TBN, as
  ``chip_smoke.py`` builds it: kernels, device time, host time, the idle share
  and the device operations by name;
* for the first iteration of ``HillClimbSearch`` on 2,000 simulated ALARM rows
  (1,369 BIC scores from one ``table_counts`` launch): device operations,
  device time and host time, split into the count call and the host's float64
  score reductions; and for the Chow-Liu launch on MUNIN (541,320 pair
  tables): device operations by name and host time of the call.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from pgmpy_tpu_torch.config import as_tensor, config  # noqa: E402
from pgmpy_tpu_torch.estimators import BIC, BayesianEstimator, TreeSearch  # noqa: E402
from pgmpy_tpu_torch.inference import BeliefPropagation, DBNInference, VariableElimination  # noqa: E402
from pgmpy_tpu_torch.models import DiscreteBayesianNetwork  # noqa: E402
from pgmpy_tpu_torch.ops import bincount as bc  # noqa: E402
from pgmpy_tpu_torch.sampling import BayesianModelSampling, GibbsSampling, VectorizedNUTS  # noqa: E402
from pgmpy_tpu_torch.sampling.smc import ParticleFilter  # noqa: E402
from pgmpy_tpu_torch.utils import get_example_model  # noqa: E402
from pgmpy_tpu_torch.utils.mathext import seeded_generator  # noqa: E402

HBM_BYTES_PER_S = chip_smoke.HBM_BYTES_PER_S


profiled = chip_smoke.profiled


def print_top_kernels(label, fn, top=6):
    """The device operations of one call of ``fn`` summed by name, largest
    first: count, total microseconds, name."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            count, total = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (count + 1, total + e.time_range.elapsed_us())
    for name, (count, total) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"{label}_device_op x{count} {total:.1f}us {name[:100]}")


def main():
    if not torch.cuda.is_available():
        print("profile_port_munin: no CUDA device is available", file=sys.stderr)
        return 1
    config.set_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    model = get_example_model("munin")
    states = model.states
    df, _ = chip_smoke.ancestral_sample(model, chip_smoke.N_ROWS, chip_smoke.SEED)
    fitted = DiscreteBayesianNetwork()
    fitted.add_nodes_from(model.nodes())
    fitted.add_edges_from(model.edges())
    fitted.fit(df, estimator=BayesianEstimator, state_names=states,
               prior_type="BDeu", equivalent_sample_size=5)  # warm-up

    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        est = BayesianEstimator(fitted, df, state_names=states)
        torch.cuda.synchronize()
        t1 = time.time()
        est.get_parameters(prior_type="BDeu", equivalent_sample_size=5)
        torch.cuda.synchronize()
        print(f"fit_coding_s {t1 - t0:.4f} fit_get_parameters_s {time.time() - t1:.4f}")
    coded = est._coded
    specs = [(n, sorted(fitted.get_parents(n), key=str)) for n in sorted(fitted.nodes(), key=str)]
    coded.multi_counts(specs)  # warm-up
    host_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.time()
        coded.multi_counts(specs)
        host_ms.append((time.time() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        coded.multi_counts(specs)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    table_ms = sum(e.time_range.elapsed_us() for e in kernels if "table_count" in e.name) / 1e3
    print(f"counts_tables {len(specs)} counts_device_ops {len(kernels)} "
          f"counts_device_ms {sum(e.time_range.elapsed_us() for e in kernels) / 1e3:.4f} "
          f"table_count_kernel_ms {table_ms:.4f} multi_counts_host_ms_median "
          f"{float(np.median(host_ms)):.3f}")
    for e in kernels:
        print(f"counts_device_op {e.time_range.elapsed_us():.1f}us {e.name[:90]}")
    code_bytes = coded._column_codes().element_size() * coded.n * len(coded.variables)
    print(f"counts_code_bytes {code_bytes} byte_bound_ms {code_bytes / HBM_BYTES_PER_S * 1e3:.4f} "
          f"int32_code_bytes {4 * coded.n * len(coded.variables)} int32_byte_bound_ms "
          f"{4 * coded.n * len(coded.variables) / HBM_BYTES_PER_S * 1e3:.4f}")

    bp = BeliefPropagation(fitted)
    program = bp._program
    arrays = [f.values for f in bp._input_factors]
    program.calibrate(arrays)
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.time()
        program.calibrate(arrays)
        enqueue.append((time.time() - t0) * 1e3)
        torch.cuda.synchronize()
    wall_ms = chip_smoke.cuda_median_ms(lambda: program.calibrate(arrays), reps=15, warmup=1)
    n_kernels, device_ms = profiled(lambda: program.calibrate(arrays), reps=3)
    sizes = [int(np.prod(s)) for s in program.clique_shapes]
    nbytes = sum(4 * (sizes[src] + 2 * sizes[dst]) for src, dst, *_ in program.messages)
    print(f"cliques {len(program.cliques)} messages {len(program.messages)} "
          f"clique_entries {sum(sizes)}")
    print(f"calibrate_kernels {n_kernels:.0f} calibrate_device_ms {device_ms:.3f} "
          f"calibrate_enqueue_ms_median {float(np.median(enqueue)):.3f} "
          f"calibrate_event_median_ms {wall_ms:.3f} idle_share {1 - device_ms / wall_ms:.3f}")
    print(f"calibrate_bytes {nbytes} byte_bound_ms {nbytes / HBM_BYTES_PER_S * 1e3:.3f}")

    nodes = sorted(fitted.nodes(), key=str)
    q_var, e_var = nodes[0], nodes[len(nodes) // 2]
    e_states = states[e_var]
    rows = {e_var: [e_states[i % len(e_states)] for i in range(chip_smoke.BATCH_ROWS)]}
    bp.query_batch([q_var], rows)
    n_kernels, device_ms = profiled(lambda: bp.query_batch([q_var], rows), reps=5)
    print(f"query_batch_kernels {n_kernels:.0f} query_batch_device_ms {device_ms:.4f}")

    # ---- simulate: the sampler's sweep, then the whole call
    n_sim = chip_smoke.N_ROWS + chip_smoke.BATCH_ROWS
    sampler = BayesianModelSampling(model).sampler
    sampler.forward(n_sim, seed=0)  # warm-up
    sweep_s = chip_smoke.host_median_s(lambda: sampler.forward(n_sim, seed=0), reps=5)
    n_kernels, device_ms = profiled(lambda: sampler.forward(n_sim, seed=0), reps=2)
    simulate_s = chip_smoke.host_median_s(
        lambda: model.simulate(n_sim, seed=0, show_progress=False), reps=3)
    print(f"simulate_rows {n_sim} sweep_kernels {n_kernels:.0f} sweep_device_ms {device_ms:.3f} "
          f"sweep_host_s {sweep_s:.4f} sweep_idle_share {1 - device_ms / (sweep_s * 1e3):.3f} "
          f"simulate_s {simulate_s:.4f}")
    print_top_kernels("sweep", lambda: sampler.forward(n_sim, seed=0))

    # ---- predict: the whole call, then the batched contraction alone
    targets = chip_smoke.independent_targets(fitted)
    test = df.iloc[-chip_smoke.BATCH_ROWS:].drop(columns=targets)
    fitted.predict(test)  # warm-up: prune, gather tables, plan
    fitted.predict_probability(test)
    for name, call in (("predict", lambda: fitted.predict(test)),
                       ("predict_probability", lambda: fitted.predict_probability(test))):
        host_s = chip_smoke.host_median_s(call, reps=3)
        n_kernels, device_ms = profiled(call, reps=2)
        print(f"{name}_rows {len(test)} {name}_kernels {n_kernels:.0f} {name}_device_ms "
              f"{device_ms:.4f} {name}_host_s {host_s:.4f} "
              f"{name}_idle_share {1 - device_ms / (host_s * 1e3):.4f}")
        print_top_kernels(name, call, top=4)
    ve = VariableElimination(fitted)
    ev_vars = sorted(test.columns, key=str)
    run, _, code_maps = ve._get_batch_program(tuple(targets), tuple(ev_vars))
    codes = torch.as_tensor(
        np.stack([[code_maps[k][s] for s in test[v].tolist()]
                  for k, v in enumerate(ev_vars)], axis=1), dtype=torch.int64, device="cuda")
    run(codes)
    host_s = chip_smoke.host_median_s(lambda: run(codes), reps=5)
    n_kernels, device_ms = profiled(lambda: run(codes), reps=5)
    print(f"predict_contraction_kernels {n_kernels:.0f} predict_contraction_device_ms "
          f"{device_ms:.4f} predict_contraction_host_s {host_s:.5f}")

    # ---- Gibbs: one sweep of every chain over all variables
    gibbs = GibbsSampling(model)._compiled
    states = sampler.forward(chip_smoke.GIBBS_CHAINS, seed=0).to(torch.int64).T.contiguous()
    gen = seeded_generator(0)
    gibbs._sweep(states, gen)  # warm-up
    sweep_s = chip_smoke.host_median_s(lambda: gibbs._sweep(states, gen), reps=5)
    n_kernels, device_ms = profiled(lambda: gibbs._sweep(states, gen), reps=2)
    print(f"gibbs_chains {chip_smoke.GIBBS_CHAINS} gibbs_pairs "
          f"{sum(len(specs) for specs in gibbs._var_specs)} gibbs_sweep_kernels {n_kernels:.0f} "
          f"gibbs_sweep_device_ms {device_ms:.3f} gibbs_sweep_host_s {sweep_s:.4f} "
          f"gibbs_sweep_idle_share {1 - device_ms / (sweep_s * 1e3):.3f}")
    print_top_kernels("gibbs_sweep", lambda: gibbs._sweep(states, gen), top=8)

    # ---- NUTS: one step of every chain on ecoli70, started from the joint
    ecoli = get_example_model("ecoli70")
    _, mu, cov = ecoli.joint_gaussian()
    nuts = VectorizedNUTS(ecoli, max_depth=6)
    draws = np.random.default_rng(0).multivariate_normal(mu, cov, size=chip_smoke.NUTS_CHAINS)
    positions = as_tensor(draws)
    nuts._nuts_step(gen, positions, 0.17)  # warm-up
    nuts.leaf_iterations = nuts.host_reads = 0
    step_s = chip_smoke.host_median_s(lambda: nuts._nuts_step(gen, positions, 0.17), reps=5)
    leaves, reads = nuts.leaf_iterations / 5, nuts.host_reads / 5
    n_kernels, device_ms = profiled(lambda: nuts._nuts_step(gen, positions, 0.17), reps=2)
    print(f"nuts_chains {chip_smoke.NUTS_CHAINS} nuts_step_leaf_iterations {leaves:.1f} "
          f"nuts_step_host_reads {reads:.1f} nuts_step_kernels {n_kernels:.0f} "
          f"nuts_step_device_ms {device_ms:.3f} nuts_step_host_s {step_s:.4f} "
          f"nuts_step_idle_share {1 - device_ms / (step_s * 1e3):.3f}")
    print_top_kernels("nuts_step", lambda: nuts._nuts_step(gen, positions, 0.17), top=8)

    # ---- the temporal lane on ALARM as a 2-TBN: per slice of the particle
    # filter and of forward_scan
    alarm = get_example_model("alarm")
    dbn, persistent, _ = chip_smoke.alarm_2tbn(alarm, chip_smoke.ALARM_PERSISTENT)
    leaves = sorted((v for v in alarm.nodes() if not alarm.get_children(v)),
                    key=str)[:chip_smoke.ALARM_EVIDENCE_LEAVES]
    slices = 10
    truth = chip_smoke.dbn_trajectory(dbn, slices, chip_smoke.SEED)
    evidence = {(v, t): truth[(v, t)] for v in leaves for t in range(slices)}
    pf = ParticleFilter(dbn, n_particles=chip_smoke.ALARM_PARTICLES)
    infer = DBNInference(dbn)
    for name, per_call, call in (
            ("particle_filter", slices,
             lambda: pf.filter(evidence, n_time_slices=slices, seed=0)),
            ("forward_scan", slices - 1,
             lambda: infer.forward_scan(persistent, evidence, n_time_slices=slices))):
        call()  # warm-up: plans, the descriptor
        host_s = chip_smoke.host_median_s(call, reps=3)
        n_kernels, device_ms = profiled(call)
        print(f"{name}_slices {per_call} {name}_kernels_per_slice {n_kernels / per_call:.1f} "
              f"{name}_device_ms_per_slice {device_ms / per_call:.4f} {name}_host_ms_per_slice "
              f"{host_s / per_call * 1e3:.3f} {name}_idle_share "
              f"{1 - device_ms / (host_s * 1e3):.3f}")
        print_top_kernels(name, call, top=8)

    # ---- structure search: the first hill-climb iteration on ALARM
    frame = alarm.simulate(n_samples=chip_smoke.HILLCLIMB_ROWS, seed=3, show_progress=False)
    scorer = BIC(frame)
    columns = list(frame.columns)
    first = [(v, ()) for v in columns] + [(v, (u,)) for v in columns for u in columns if u != v]
    scorer.local_scores_batch(first)  # warm-up
    count_s = chip_smoke.host_median_s(
        lambda: scorer._coded.multi_counts_padded(first, dtype=np.float64), reps=5)
    batch_s = chip_smoke.host_median_s(lambda: scorer.local_scores_batch(first), reps=5)
    # the launch alone (specs built, plan and descriptor kept on them): CUDA
    # events behind a device sleep, as chip_smoke.py times K1
    coded = scorer._coded
    table = bc.table_specs(
        [[coded.var_index[v]] + [coded.var_index[u] for u in ps] for v, ps in first],
        [[coded.cards[v]] + [coded.cards[u] for u in ps] for v, ps in first])
    device_ms = chip_smoke.cuda_median_ms(
        lambda: bc.table_counts_cuda(coded._column_codes(), coded.n, table), device_only=True)
    print(f"hillclimb_first_iteration_specs {len(first)} count_launch_device_ms {device_ms:.4f} "
          f"count_call_host_s {count_s:.4f} scores_host_s {batch_s - count_s:.4f} "
          f"host_share {1 - device_ms / (batch_s * 1e3):.5f}")
    print_top_kernels("hillclimb_first_iteration", lambda: scorer.local_scores_batch(first), top=4)

    # ---- structure search: the Chow-Liu launch on MUNIN's 50,000 rows
    search = TreeSearch(df)
    variables = list(search.variables)
    _, table, _, _ = search._pair_tables(variables)  # warm-up
    launch_s = chip_smoke.host_median_s(lambda: search._pair_tables(variables), reps=3)
    coded = search._coded
    device_ms = chip_smoke.cuda_median_ms(
        lambda: bc.table_counts_cuda(coded._column_codes(), coded.n, table), reps=5, warmup=1,
        device_only=True)
    print(f"chow_liu_pairs {len(table)} pair_launch_device_ms {device_ms:.3f} (memset and "
          f"kernel, the descriptor already on the card; CUDA events) pair_tables_host_s "
          f"{launch_s:.4f} (specs, plan, descriptor upload, launch)")
    print_top_kernels("chow_liu", lambda: search._pair_tables(variables), top=4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
