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
  for the batched contraction alone (codes already on the card).
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
from pgmpy_tpu_torch.config import config  # noqa: E402
from pgmpy_tpu_torch.estimators import BayesianEstimator  # noqa: E402
from pgmpy_tpu_torch.inference import BeliefPropagation, VariableElimination  # noqa: E402
from pgmpy_tpu_torch.models import DiscreteBayesianNetwork  # noqa: E402
from pgmpy_tpu_torch.sampling import BayesianModelSampling  # noqa: E402
from pgmpy_tpu_torch.utils import get_example_model  # noqa: E402

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
