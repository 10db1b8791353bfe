"""The multi-card parts of ``chip_smoke.phase_parallel``, alone, on a machine
with two or more CUDA cards.

Run from the repository root:

    python3 tools/parallel_multicard.py

It prints the cards, then

* MUNIN's junction tree calibrated in connected parts over 4 shards of
  cuda:0 and over one shard per card (``chip_smoke.sharded_calibration_case``:
  parts, boundary edges, the sepset and factor-table bytes that cross, the
  CUDA-event times of 5 sharded and 5 single-device calibrations, kernels and
  device time, every clique and sepset against the single-device program at
  the tolerance float32 rounding over the schedule allows);
* 262,144 sharded forward draws of MUNIN over as many shards of cuda:0 as
  there are cards, and over one shard per card, against the exact marginals
  (5 standard errors + 1e-4), with the host time of each;
* the two-process worker (``tests/_torch_distributed_worker.py``) with NCCL,
  one card per rank, then with gloo, both ranks on cuda:0;

and ends with ``MULTICARD OK``.  Any failed check raises.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.inference import BeliefPropagation
    from pgmpy_tpu_torch.parallel import get_mesh, sharded_sample_marginals
    from pgmpy_tpu_torch.parallel.mesh import Mesh
    from pgmpy_tpu_torch.utils import get_example_model

    config.set_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    n_cards = torch.cuda.device_count()
    cs.check(n_cards > 1, f"{n_cards} CUDA card(s): this script needs two or more")
    print("cards", n_cards, flush=True)
    card = torch.device("cuda", 0)
    model = get_example_model("munin")
    bp = BeliefPropagation(model)
    program = bp._program
    arrays = [f.values for f in bp._input_factors]
    bp.calibrate()
    marginals = cs.exact_marginals(bp)
    reference = program.calibrate(arrays)
    rtol = cs.schedule_rtol(program)
    cs.sharded_calibration_case("one_card", program, arrays, Mesh([card] * 4), reference, rtol)
    cs.sharded_calibration_case("all_cards", program, arrays, get_mesh(), reference, rtol)
    nodes = sorted(model.nodes(), key=str)
    for name, mesh in (("one_card", Mesh([card] * n_cards)), ("all_cards", get_mesh())):
        sharded_sample_marginals(model, 4096, mesh=mesh, seed=1)  # builds K1 and the samplers
        torch.cuda.synchronize()
        t0 = time.time()
        got = sharded_sample_marginals(model, cs.SHARDED_DRAWS, mesh=mesh, seed=cs.SEED)
        host_s = time.time() - t0
        cs.check(all(cs.within_mc_error(got[v], marginals[v], cs.SHARDED_DRAWS).all()
                     for v in nodes), f"sharded forward draws over {name}")
        print(f"forward {name} shards {mesh.size} devices "
              f"{sorted({str(d) for d in mesh.devices.reshape(-1)})} draws {cs.SHARDED_DRAWS} "
              f"host_s {host_s:.3f} within 5 standard errors", flush=True)
    cs.two_process_run("nccl")
    cs.two_process_run("gloo")
    print("MULTICARD OK", flush=True)


if __name__ == "__main__":
    main()
