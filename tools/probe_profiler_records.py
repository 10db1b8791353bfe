"""Count the device records ``torch.profiler`` keeps of two calls, session by
session, in a process of its own on one CUDA card.

Run from a tree's root on a machine with one CUDA card:

    PYTHONPATH=. python3 tools/probe_profiler_records.py [nuts|forward_scan]

* ``nuts``: one ``VectorizedNUTS`` transition of ecoli70's 1,024 chains (the
  key's draw, ``nuts_kernel`` and four elementwise operations), profiled
  alone and after a sequence of five elementwise operations, against that
  sequence profiled alone before and after;
* ``forward_scan``: ALARM as a 2-TBN (``chip_smoke.alarm_2tbn``, 6
  persistent roots, three leaves observed) filtered over 50 and over 2
  slices, four calls a round for three rounds.

Each session prints how many device records it kept (and, for
``forward_scan``, which ones differ from the first session).
Late in ``chip_smoke.py``'s long process every session of a call can lose the
same records; a process of its own keeps them all, so the smoke takes both
readings from one (``chip_smoke.fresh_profile``).
"""

import sys
from collections import Counter

import torch
from torch.profiler import ProfilerActivity, profile

from pgmpy_tpu_torch.config import as_tensor, config
from pgmpy_tpu_torch.utils import get_example_model
from pgmpy_tpu_torch.utils.mathext import seeded_generator


def records(fn):
    """The names of the device records of one profiled call of ``fn``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name[:60] for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def probe_nuts():
    from pgmpy_tpu_torch.sampling import VectorizedNUTS

    ecoli = get_example_model("ecoli70")
    _, mu, _ = ecoli.joint_gaussian()
    nuts = VectorizedNUTS(ecoli, max_depth=6)
    draws = nuts.sample(mu, num_samples=5, num_adapt=5, stepsize=0.17, n_chains=1024, seed=0)
    positions, gen = as_tensor(draws[-1]), seeded_generator(0)
    x = torch.randn(1000, device="cuda")

    def five():
        y = x * 2
        y = y + 1
        y = y.exp()
        y = y - 3
        return y * y

    def step():
        return nuts._nuts_step(gen, positions, 0.17)

    for label, fn, sessions in (("five_before", five, 3), ("nuts", step, 4),
                                ("five_after", five, 6), ("five_then_nuts",
                                                          lambda: (five(), step()), 3),
                                ("nuts_x3", lambda: [step() for _ in range(3)], 3),
                                ("five_end", five, 6)):
        for i in range(sessions):
            names = records(fn)
            print(label, i, len(names), names, flush=True)


def probe_forward_scan():
    import chip_smoke
    from pgmpy_tpu_torch.inference import DBNInference

    alarm = get_example_model("alarm")
    dbn, persistent, _ = chip_smoke.alarm_2tbn(alarm, chip_smoke.ALARM_PERSISTENT)
    leaves = sorted((v for v in alarm.nodes() if not alarm.get_children(v)), key=str)[:3]
    truth = chip_smoke.dbn_trajectory(dbn, 50, 0)
    evidence = {(v, t): truth[(v, t)] for v in leaves for t in range(50)}
    infer = DBNInference(dbn)
    infer.forward_scan(persistent, evidence, n_time_slices=2)
    infer.forward_scan(persistent, evidence, n_time_slices=50)
    base = None
    for rnd in range(3):
        for slices in (50, 2, 50, 2):
            kept = Counter(records(lambda: infer.forward_scan(persistent, evidence,
                                                              n_time_slices=slices)))
            if base is None:
                base = kept
                print("base", sum(kept.values()), dict(kept), flush=True)
            print(rnd, slices, sum(kept.values()), "more:", dict(kept - base), "less:",
                  dict(base - kept), flush=True)


def main():
    if not torch.cuda.is_available():
        print("probe_profiler_records: no CUDA device is available", file=sys.stderr)
        return 1
    config.set_device("cuda")
    which = sys.argv[1:] or ["nuts", "forward_scan"]
    for name in which:
        {"nuts": probe_nuts, "forward_scan": probe_forward_scan}[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
