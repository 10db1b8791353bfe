"""Time the table-gather and sweep kernels (K13, K11, K5, K9, K6) at the
smoke's shapes on one CUDA card.

Run from a tree's root on a machine with one CUDA card:

    python3 tools/time_gather_kernels.py [--groups 2,4,8] [--row-blocks 64,128]
                                         [--e-step-blocks 128,256]
                                         [--gibbs-groups 8,16,32]
                                         [--gibbs-tile-rows 16,32] [--label NAME]

It loads MUNIN (1041 variables), simulates 50,000 rows and builds the same
inputs as ``chip_smoke.py``, then times, each as device time behind a device
sleep (median of 20, CUDA events):

* ``row_sums`` (K13): ``BayesianModelProbability._logp`` of the 50,000 rows,
  int8 codes, float32 log tables;
* ``e_step`` (K11): EM's E-step with DIFFN_PATHO latent at 5 states, 250,000
  expanded rows, from seeded random CPDs;
* ``sweep`` (K5): ``forward`` of 52,048 rows (Philox from a seeded generator);
* ``particle_sweep`` (K9): one transition slice of ALARM as a 2-TBN
  (``chip_smoke.alarm_2tbn``) over 262,144 particles with three leaves
  observed, from random previous particles;
* ``gibbs_sweep`` (K6): one Gibbs sweep of MUNIN's 4,096 chains from
  ancestral samples;

beside the plain versions (median of 5), and checks each against its plain
version (the sweeps on explicit noise, to the bit).  The options time the
kernels again under other launch settings: threads per row of the ancestral
and particle sweeps (``ops.ancestral.GROUPS``), rows per ``row_sums`` block
(``ops.table_gather.ROW_BLOCK``), threads per ``e_step`` block
(``ops.table_gather.E_STEP_BLOCK``), threads per chain of the Gibbs sweep at
most (``ops.gibbs.GROUPS``) and chains per Gibbs tile at most
(``ops.gibbs.MAX_TILE_ROWS``); a setting the tree's modules do not have is
skipped.  It prints one ``key value`` line per timing and, last, one JSON
object of every timing under ``--label``, with the card's name and power
limit.  Run it in two trees in one call to compare two versions of the
kernels on one card.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from pgmpy_tpu_torch.config import TINY, config  # noqa: E402
from pgmpy_tpu_torch.estimators import ExpectationMaximization  # noqa: E402
from pgmpy_tpu_torch.metrics import BayesianModelProbability  # noqa: E402
from pgmpy_tpu_torch.models import DiscreteBayesianNetwork  # noqa: E402
from pgmpy_tpu_torch.ops import ancestral, table_gather  # noqa: E402
from pgmpy_tpu_torch.ops import gibbs as gibbs_ops  # noqa: E402
from pgmpy_tpu_torch.sampling import CompiledAncestralSampler, GibbsSampling  # noqa: E402
from pgmpy_tpu_torch.sampling.smc import ParticleFilter  # noqa: E402
from pgmpy_tpu_torch.utils import get_example_model  # noqa: E402
from pgmpy_tpu_torch.utils.mathext import race_noise, seeded_generator  # noqa: E402

N_ROWS = 50_000
N_SIM = 52_048
LATENT, LATENT_CARD = "DIFFN_PATHO", 5
PARTICLES = 262_144
CHAINS = 4096


def ints(text):
    return [int(x) for x in text.split(",")] if text else []


def time_pair(fn, plain):
    """(kernel ms, plain ms): device time behind a device sleep, medians."""
    return (chip_smoke.cuda_median_ms(fn, device_only=True),
            chip_smoke.cuda_median_ms(plain, reps=5, warmup=1))


def inputs():
    model = get_example_model("munin")
    frame = model.simulate(N_ROWS, seed=0, show_progress=False)
    prob = BayesianModelProbability(model)
    codes = prob._encode(frame)
    em = ExpectationMaximization(DiscreteBayesianNetwork(list(model.edges()), latents={LATENT}),
                                 frame.drop(columns=[LATENT]))
    program, cards, names = em._program({LATENT: LATENT_CARD})
    weights = program.flat_of(em._initial_cpds("random", 0, cards, names))
    log_table = torch.log(torch.clamp_min(weights, TINY).to(torch.float64))
    em_codes = program.coded._column_codes()[:, : program.coded.n]
    return model, prob, codes, program, log_table, em_codes, weights.dtype


def time_row_sums(prob, codes):
    gather, table = prob._gather, prob._table
    got, want = gather.row_sums_cuda(table, codes), gather.row_sums_reference(table, codes)
    rel = float(((got.double() - want.double()).abs() / want.double().abs()).max())
    chip_smoke.check(rel <= 1e-5, f"row_sums: {rel} (relative) from the plain version")
    return time_pair(lambda: gather.row_sums_cuda(table, codes),
                     lambda: gather.row_sums_reference(table, codes))


def time_e_step(program, log_table, em_codes, dtype):
    gather, K = program.gather, program.K
    got = gather.e_step_cuda(log_table, em_codes, K, dtype)
    err = float((got.double() - gather.e_step_reference(log_table, em_codes, K, dtype)).abs().max())
    chip_smoke.check(err <= 1e-6, f"e_step: {err} from the plain version")
    return time_pair(lambda: gather.e_step_cuda(log_table, em_codes, K, dtype),
                     lambda: gather.e_step_reference(log_table, em_codes, K, dtype))


def time_sweep(model):
    sampler = CompiledAncestralSampler(model)
    sweep = sampler._sweep_tables
    noise = torch.rand((len(sweep.cards), 4096), generator=seeded_generator(0),
                       dtype=torch.float64, device="cuda")
    got = ancestral.sweep_cuda(sweep, 4096, None, noise=noise)
    chip_smoke.check(torch.equal(got[0], ancestral.sweep_reference(sweep, 4096, None,
                                                                   noise=noise)[0]),
                     "sweep: the codes differ from the plain version's on the same noise")
    gen = seeded_generator(0)
    return time_pair(lambda: ancestral.sweep_cuda(sweep, N_SIM, gen),
                     lambda: ancestral.sweep_reference(sweep, N_SIM, gen))


def time_particle_sweep():
    alarm = get_example_model("alarm")
    dbn, _, _ = chip_smoke.alarm_2tbn(alarm, chip_smoke.ALARM_PERSISTENT)
    pf = ParticleFilter(dbn, n_particles=PARTICLES)
    tables, d = pf._trans_specs, len(pf.variables)
    leaves = sorted((v for v in alarm.nodes() if not alarm.get_children(v)), key=str)[:3]
    evidence = {i: 0 for i, c in enumerate(tables.columns) if pf.variables[c] in leaves}
    rng = np.random.default_rng(0)
    prev = torch.as_tensor(np.stack([rng.integers(0, pf.cards[v], PARTICLES)
                                     for v in pf.variables]), device="cuda").to(pf._out_dtype)
    noise = torch.rand((d, PARTICLES), generator=seeded_generator(0), dtype=torch.float64,
                       device="cuda")
    got = ancestral.sweep_cuda(tables, PARTICLES, None, evidence=evidence, noise=noise,
                               prev=prev, out=pf._code_matrix())
    want = ancestral.sweep_reference(tables, PARTICLES, None, evidence=evidence, noise=noise,
                                     prev=prev, out=pf._code_matrix())
    chip_smoke.check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                     "particle_sweep: the codes or weights differ from the plain version's")
    gen, out = seeded_generator(0), pf._code_matrix()
    return time_pair(
        lambda: ancestral.sweep_cuda(tables, PARTICLES, gen, evidence=evidence, prev=prev,
                                     out=out),
        lambda: ancestral.sweep_reference(tables, PARTICLES, gen, evidence=evidence, prev=prev,
                                          out=out))


def time_gibbs_sweep(model):
    init = CompiledAncestralSampler(model).forward(CHAINS, seed=0)
    tables = GibbsSampling(model)._compiled._tables
    noise = race_noise((sum(tables.cards), CHAINS), seeded_generator(0), config.DTYPE)
    chip_smoke.check(torch.equal(gibbs_ops.sweep_cuda(tables, init, None, noise=noise),
                                 gibbs_ops.sweep_reference(tables, init, None, noise=noise)),
                     "gibbs_sweep: the codes differ from the plain version's on the same noise")
    gen, out = seeded_generator(0), torch.empty_like(init)
    return time_pair(lambda: gibbs_ops.sweep_cuda(tables, init, gen, out=out),
                     lambda: gibbs_ops.sweep_reference(tables, init, gen))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--groups", default="")
    parser.add_argument("--row-blocks", default="")
    parser.add_argument("--e-step-blocks", default="")
    parser.add_argument("--gibbs-groups", default="")
    parser.add_argument("--gibbs-tile-rows", default="")
    parser.add_argument("--label", default=os.path.basename(ROOT))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_gather_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    config.set_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    model, prob, codes, program, log_table, em_codes, dtype = inputs()
    results = {}

    def record(name, pair):
        results[name] = {"ms": pair[0], "plain_ms": pair[1]}
        print(f"{name} kernel_ms {pair[0]:.5f} plain_ms {pair[1]:.5f}", flush=True)

    record("row_sums", time_row_sums(prob, codes))
    record("e_step", time_e_step(program, log_table, em_codes, dtype))
    record("sweep", time_sweep(model))
    record("particle_sweep", time_particle_sweep())
    record("gibbs_sweep", time_gibbs_sweep(model))
    for module, attr, values, name, run in (
            (table_gather, "ROW_BLOCK", ints(args.row_blocks), "row_sums",
             lambda: time_row_sums(prob, codes)),
            (table_gather, "E_STEP_BLOCK", ints(args.e_step_blocks), "e_step",
             lambda: time_e_step(program, log_table, em_codes, dtype)),
            (ancestral, "GROUPS", ints(args.groups), "sweep", lambda: time_sweep(model)),
            (ancestral, "GROUPS", ints(args.groups), "particle_sweep", time_particle_sweep),
            (gibbs_ops, "GROUPS", ints(args.gibbs_groups), "gibbs_sweep",
             lambda: time_gibbs_sweep(model)),
            (gibbs_ops, "MAX_TILE_ROWS", ints(args.gibbs_tile_rows), "gibbs_sweep",
             lambda: time_gibbs_sweep(model))):
        if not hasattr(module, attr):
            continue
        kept = getattr(module, attr)
        try:
            for value in values:
                setattr(module, attr, value)
                record(f"{name}_{attr.lower()}_{value}", run())
        finally:
            setattr(module, attr, kept)
    print(json.dumps({"label": args.label, "card": card, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
