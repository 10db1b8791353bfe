"""Time both K3 schedules (``plan_block``, ``plan_grid``) on the contractions
the schedule choice is set from, on one CUDA card, and fit the choice's
cost models to the times.

Run from a tree's root on a machine with one CUDA card:

    python3 tools/k3_schedules.py

The contractions: ``chip_smoke.k3_probe_contractions`` (scalar and
four-output reductions, chains of mat-vec products, 16 independent mat-vec
products with their product) and the ones the smoke captures on MUNIN's own
CPDs (a VariableElimination query, a BeliefPropagation query, a 2,048-row
``query_batch``, a do-query, and ``predict`` / ``predict_probability`` of
three dropped columns of 2,048 simulated rows).  Each is held against the
plain version under both schedules (``chip_smoke.k3_case``), then both are
timed (``chip_smoke.k3_schedules``: device time, median of 20 behind a
device sleep).  The fit (least squares in relative error):

* ``plan_block``: ms = launch + unit x ``PlanTable.block_units``;
* ``plan_grid``: ms = launch + step x steps + entry x ``PlanTable.grid_work``,

printed as ``k3_fit`` in microseconds beside the constants of
``ops/einsum.py``, with, under each set, the contractions where the model
picks the slower schedule.  The card's name and power limit come first.
"""

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def munin_contractions(cs):
    """The smoke's K3 contractions on MUNIN's own CPDs (phase_k3's)."""
    from pgmpy_tpu_torch.inference import (BeliefPropagation, CausalInference,
                                           VariableElimination, bp, ve)
    from pgmpy_tpu_torch.utils import get_example_model

    model = get_example_model("munin")
    nodes = sorted(model.nodes(), key=str)
    q_var, e_var = nodes[0], nodes[len(nodes) // 2]
    states = model.states[e_var]
    evidence = {e_var: states[0]}
    batch = {e_var: [states[i % len(states)] for i in range(cs.BATCH_ROWS)]}
    engine = VariableElimination(model)
    tree = BeliefPropagation(model)
    tree.calibrate()
    child = sorted(model.get_children(cs.CAUSAL_DO[0]))[0]
    captured = (
        ("munin_ve_query", lambda: engine.query([q_var], evidence=evidence), [ve]),
        ("munin_bp_query", lambda: tree.query([q_var], evidence=evidence), [bp]),
        ("munin_query_batch_2048", lambda: tree.query_batch([q_var], batch), [bp]),
        ("munin_do_query", lambda: CausalInference(model).query(
            [child], do=dict([cs.CAUSAL_DO]), inference_algo="bp"), [bp, ve]))
    # predict / predict_probability of three dropped columns, as the smoke
    # runs them (on MUNIN's own CPDs and 2,048 simulated rows)
    test = model.simulate(cs.BATCH_ROWS, seed=7)
    targets = cs.independent_targets(model)
    test = test.drop(columns=targets)
    captured += (("munin_predict", lambda: model.predict(test), [ve]),
                 ("munin_predict_probability", lambda: model.predict_probability(test), [ve]))
    calls, seen = [], set()
    for name, fn, modules in captured:
        for k, call in enumerate(cs.capture_contractions(fn, modules)):
            signature = (call[0], call[1], tuple(tuple(a.shape) for a in call[2]))
            if signature not in seen:
                seen.add(signature)
                calls.append((f"{name}[{k}]", call))
    return calls


def fit(rows, columns):
    """Least squares in relative error: ms ~ rows[:, columns] @ c."""
    a = np.array([[r[c] for c in columns] for r in rows], dtype=float)
    y = np.array([r["ms"] for r in rows], dtype=float)
    return np.linalg.lstsq(a / y[:, None], np.ones(len(y)), rcond=None)[0]


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    if not torch.cuda.is_available():
        sys.exit("k3_schedules: needs a CUDA card")
    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.ops import einsum as E

    config.set_device("cuda")
    import chip_smoke as cs

    calls = cs.k3_probe_contractions(torch.device("cuda")) + munin_contractions(cs)
    measured = []
    for name, call in calls:
        cs.k3_case(name, call)
        times, _ = cs.k3_schedules(name, call)
        block = cs.k3_table(call, "plan_block") if times["plan_block"] is not None else None
        grid = cs.k3_table(call, "plan_grid")
        measured.append({"name": name, "one": 1.0, "steps": len(grid.steps),
                         "units": None if block is None else block.block_units,
                         "work": grid.grid_work, "block_ms": times["plan_block"],
                         "grid_ms": times["plan_grid"],
                         "candidate": cs.k3_table(call).block_us is not None})
    block_rows = [dict(r, ms=r["block_ms"]) for r in measured if r["block_ms"] is not None]
    grid_rows = [dict(r, ms=r["grid_ms"]) for r in measured]
    b_launch, b_unit = fit(block_rows, ("one", "units")) * 1e3
    g_launch, g_step, g_entry = fit(grid_rows, ("one", "steps", "work")) * 1e3
    print(f"k3_fit block_launch_us={b_launch:.4f} block_unit_us={b_unit:.5f} "
          f"grid_launch_us={g_launch:.4f} grid_step_us={g_step:.4f} grid_entry_us={g_entry:.5f} "
          f"over {len(block_rows)} block and {len(grid_rows)} grid times")
    for label, (bl, bu, gl, gs, ge) in (
            ("fitted", (b_launch, b_unit, g_launch, g_step, g_entry)),
            ("ops/einsum.py", (E.BLOCK_LAUNCH_US, E.BLOCK_UNIT_US, E.GRID_LAUNCH_US,
                               E.GRID_STEP_US, E.GRID_ENTRY_US))):
        slower = []
        for r in measured:
            block = bl + bu * r["units"] if r["candidate"] else None
            pick = E.choose_schedule(block, gl + gs * r["steps"] + ge * r["work"])
            times = {"plan_block": r["block_ms"], "plan_grid": r["grid_ms"]}
            best = min((k for k, v in times.items() if v is not None), key=times.get)
            if pick != best:
                slower.append(f"{r['name']} ({pick} {times[pick]:.5f} against {best} "
                              f"{times[best]:.5f} ms)")
        print(f"k3_fit_picks {label}: the faster schedule on {len(measured) - len(slower)} of "
              f"{len(measured)}; slower on {slower or 'none'}")


if __name__ == "__main__":
    main()
