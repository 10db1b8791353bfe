"""Launch-plan sweep of the count kernels on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 tools/sweep_count_kernel.py

It times ``table_counts`` on MUNIN's fit (1041 tables, 50,000 rows, unweighted
and f32-weighted) and ``weighted_bincount`` at the shapes ``chip_smoke.py``
times, once per setting of the wrapper's plan constants in
``pgmpy_tpu_torch/ops/bincount.py`` that move those shapes (blocks wanted per
multiprocessor, threads per block, replicated shared-memory entries), and
prints one ``key value`` line per setting.  Times are device times: the
median of 20 single calls, each queued behind a device sleep.  The first line
is the setting the package ships with.
"""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from pgmpy_tpu_torch.config import config  # noqa: E402
from pgmpy_tpu_torch.ops import bincount as bc  # noqa: E402


def timed(fn):
    return chip_smoke.cuda_median_ms(fn, device_only=True)


def main():
    if not torch.cuda.is_available():
        print("sweep_count_kernel: no CUDA device is available", file=sys.stderr)
        return 1
    config.set_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    model, _, codes = chip_smoke.load_and_sample()
    host, cm, cards, col_lists, card_lists = chip_smoke.munin_count_inputs(model, codes)
    n_rows = host.shape[0]
    specs = bc.table_specs(col_lists, card_lists)
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.rand(n_rows, generator=gen, device="cuda")
    expect = bc.table_counts_cuda(cm, n_rows, specs)

    def vectors(n, length):
        return (torch.randint(0, length, (n,), generator=gen, device="cuda", dtype=torch.int32),
                torch.ones(n, device="cuda"))

    shapes = {"50000x600": vectors(50_000, 600), "1000003x600": vectors(1_000_003, 600),
              "5000x1": vectors(5000, 1)}

    def report(label):
        check = bc.table_counts_cuda(cm, n_rows, specs)
        torch.cuda.synchronize()
        if not torch.equal(check, expect):
            raise AssertionError(f"{label}: counts changed")
        line = (f"{label} table_counts_ms {timed(lambda: bc.table_counts_cuda(cm, n_rows, specs)):.5f} "
                f"weighted_ms {timed(lambda: bc.table_counts_cuda(cm, n_rows, specs, w)):.5f}")
        for name, (idx, ones) in shapes.items():
            length = int(name.split("x")[1])
            line += f" bincount_{name}_ms {timed(lambda: bc.weighted_bincount_cuda(idx, ones, length)):.5f}"
        print(line, flush=True)

    defaults = {name: getattr(bc, name) for name in
                ("_BLOCKS_PER_SM", "_BLOCK", "_REPLICATED_ENTRIES")}
    report("shipped " + " ".join(f"{k}={v}" for k, v in defaults.items()))
    sweeps = {
        "_BLOCKS_PER_SM": [1, 2, 3, 8, 16, 32],
        "_BLOCK": [128, 512, 1024],
        "_REPLICATED_ENTRIES": [1, 1024, 2048, 8192],
    }
    for name, values in sweeps.items():
        for value in values:
            setattr(bc, name, value)
            specs.launch_plans.clear()  # plan again under the new constant
            report(f"{name}={value}")
        setattr(bc, name, defaults[name])
        specs.launch_plans.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
