"""K2's kernels on MUNIN under other settings, on one CUDA card.

Run from the root of a checkout on a machine with one CUDA card:

    PYTHONHASHSEED=0 python3 tools/sweep_jt_kernels.py [--phase-only]

It builds MUNIN's junction tree on the network's own CPDs (the string hash
seed fixes the tree), times a calibration, and runs
``chip_smoke.phase_jt_kernels`` on it: every K2 check of the smoke, each
kernel's device time beside its bound.  Then it prints, one line per setting,
the device time of a calibration's ``clique_potentials`` launch (alone behind
a device sleep, median of 10; whether it equals the plain version's stage 0
to the bit), or of its ``sepset_wave`` and ``absorb_wave`` launches (each
alone behind a device sleep, medians summed) and the worst relative gap of
the beliefs to the plain version:

* ``clique_potentials`` under settings of its plan constants
  (``ENTRIES_PER_BLOCK``, ``TABLE_BYTES``);
* the wave kernels under settings of ``sepset_wave``'s plan constants
  (``MIN_WALK``, ``MAX_WALK`` in ``pgmpy_tpu_torch/ops/jt.py``);
* all three for copies of ``csrc/jt_calibrate.cu`` built with other
  compile-time constants (``VARIANTS``: loads in flight per lane, blocks per
  SM that the registers allow, entries per ``absorb_wave`` block, factors per
  ``clique_potentials`` pass), twice each, in turns.

The first line of each sweep is the setting the package ships with.  With
``--phase-only`` it stops after the phase: so it can time another checkout's
kernels on the same tree (a parent commit unpacked with ``git archive``), run
from that checkout's root, whose package and ``chip_smoke.py`` it imports; in
one call on one card, parent, change, change, parent compares the two.
"""

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402
from pgmpy_tpu_torch.config import config  # noqa: E402
from pgmpy_tpu_torch.inference import BeliefPropagation  # noqa: E402
from pgmpy_tpu_torch.ops import _build, jt  # noqa: E402
from pgmpy_tpu_torch.utils import get_example_model  # noqa: E402

WALKS = [(16, 32), (8, 32), (16, 64), (32, 64)]  # (MIN_WALK, MAX_WALK)
# (ENTRIES_PER_BLOCK, TABLE_BYTES) of clique_potentials
POTENTIALS = [(16384, 32768), (4096, 32768), (8192, 32768), (32768, 32768), (65536, 40960),
              (16384, 8192)]
# compile-time settings: name -> text substitutions in csrc/jt_calibrate.cu
VARIANTS = {
    "shipped": [],
    "walk_unroll_8": [("kWalkUnroll = 4;", "kWalkUnroll = 8;")],
    "sepset_blocks_6": [("sizeof(T) == 4 ? 8 : 6;", "sizeof(T) == 4 ? 6 : 6;")],
    "absorb_blocks_4": [("sizeof(T) == 4 ? 6 : 4;", "sizeof(T) == 4 ? 4 : 4;")],
    "absorb_blocks_8": [("sizeof(T) == 4 ? 6 : 4;", "sizeof(T) == 4 ? 8 : 4;")],
    "absorb_entries_4096": [("kAbsorbEntries = 2048;", "kAbsorbEntries = 4096;")],
    "potential_blocks_3": [("sizeof(T) == 4 ? 4 : 4;", "sizeof(T) == 4 ? 3 : 4;")],
    "potential_blocks_6": [("sizeof(T) == 4 ? 4 : 4;", "sizeof(T) == 4 ? 6 : 4;")],
    "factor_pass_2": [("kFactorPass = 4;", "kFactorPass = 2;")],
}


def potential_time(plan, arrays, want):
    """(clique_potentials ms, equal to the plain version's stage 0 ``want``
    to the bit) of one launch on the current library."""
    arena = torch.empty_like(want)
    jt.clique_potentials_cuda(plan, arrays, arena)
    torch.cuda.synchronize()
    same = bool(torch.equal(arena, want))
    ms = chip_smoke.cuda_median_ms(lambda: jt.clique_potentials_cuda(plan, arrays, arena),
                                   reps=10, warmup=1, device_only=True)
    return ms, same


def wave_times(plan, arrays, want):
    """(sepset_wave ms, absorb_wave ms, worst relative belief gap) of one
    calibration on the current library."""
    arena, sepsets = jt.calibrate_waves_cuda(plan, arrays)
    torch.cuda.synchronize()
    gap = float(((arena - want).abs() / want.abs().clamp_min(1e-30)).max())
    scratch, partial = jt.wave_scratch(plan, arena)
    work, sep_work = arena.clone(), sepsets.clone()
    sepset = sum(chip_smoke.cuda_median_ms(
        lambda w=w: jt.sepset_wave_cuda(plan, w, arena, sep_work, scratch, partial), reps=5,
        warmup=1, device_only=True) for w in range(plan.n_waves))
    absorb = sum(chip_smoke.cuda_median_ms(
        lambda w=w: jt.absorb_wave_cuda(plan, w, work, scratch), reps=5, warmup=1,
        device_only=True) for w in range(plan.n_waves))
    return sepset, absorb, gap


def build_variants(shipped):
    """{name: ctypes library} of VARIANTS, built side by side; the shipped
    library's argument types."""
    source = open(os.path.join(_build.CSRC, "jt_calibrate.cu")).read()
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise AssertionError(f"variant {name}: {old!r} is not in jt_calibrate.cu")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        for line in chip_smoke.ptxas_summary(log):
            if "<float, 16>" in line or "<float, false, false, 16>" in line or \
                    "<double, 16>" in line:
                print(f"variant {name} {line}", flush=True)
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        for fn in ("pgmpy_jt_clique_potentials", "pgmpy_jt_sepset_wave", "pgmpy_jt_absorb_wave"):
            getattr(lib, fn).argtypes = getattr(shipped, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        print("sweep_jt_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    config.set_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"checkout {os.getcwd()} PYTHONHASHSEED {os.environ.get('PYTHONHASHSEED')}", flush=True)
    chip_smoke.build_kernels()
    bp = BeliefPropagation(get_example_model("munin"))
    bp.calibrate()
    torch.cuda.synchronize()
    wall_ms = chip_smoke.cuda_median_ms(lambda: bp._calibrate_junction_tree("marginalize"),
                                        reps=15, warmup=1)
    print(f"calibrate_median_ms {wall_ms:.4f}", flush=True)
    out = chip_smoke.phase_jt_kernels(bp)
    print("kernels " + " ".join(f"{name} {row['ms']:.5f} (bound {row['bound_ms']:.6f})"
                                for name, row in out["kernels"].items()), flush=True)
    if "--phase-only" in sys.argv:
        return 0
    program = bp._program
    arrays = [f.values.contiguous() for f in bp._input_factors]
    want = jt.calibrate_waves_reference(program.wave_plan(), arrays)[0]
    plan = program.wave_plan()
    want0 = torch.empty_like(want)  # the plain version's stage 0
    jt.clique_potentials_reference(plan, arrays, jt.arena_views(
        plan, want0, torch.empty(plan.sepset_total, dtype=want.dtype, device="cuda"))[0])
    shipped_potentials = (jt.ENTRIES_PER_BLOCK, jt.TABLE_BYTES)
    for entries, table_bytes in POTENTIALS:
        jt.ENTRIES_PER_BLOCK, jt.TABLE_BYTES = entries, table_bytes
        plan = jt.build_plan(program)
        ms, same = potential_time(plan, arrays, want0)
        print(f"potentials ENTRIES_PER_BLOCK {entries} TABLE_BYTES {table_bytes} "
              f"clique_potentials_ms {ms:.5f} blocks {plan.potential_blocks} shared_bytes "
              f"{jt.potential_shared(plan)} equal_to_plain {same}", flush=True)
    jt.ENTRIES_PER_BLOCK, jt.TABLE_BYTES = shipped_potentials
    shipped = (jt.MIN_WALK, jt.MAX_WALK, jt.MAX_BLOCK_WALK)
    for min_walk, max_walk in WALKS:
        jt.MIN_WALK, jt.MAX_WALK = min_walk, max_walk
        plan = jt.build_plan(program)
        sepset, absorb, gap = wave_times(plan, arrays, want)
        print(f"walks MIN_WALK {min_walk} MAX_WALK {max_walk} sepset_ms {sepset:.5f} absorb_ms "
              f"{absorb:.5f} sepset_blocks {int(plan.sepset_blocks.sum())} worst_rel {gap:.3e}",
              flush=True)
    jt.MIN_WALK, jt.MAX_WALK, jt.MAX_BLOCK_WALK = shipped
    libs = build_variants(jt._library())
    shipped_entries = jt.ABSORB_ENTRIES
    for turn in range(2):
        for name, lib in libs.items():
            jt._library = lambda lib=lib: lib
            jt.ABSORB_ENTRIES = next(
                (int(new.split("= ")[1].rstrip(";")) for old, new in VARIANTS[name]
                 if old.startswith("kAbsorbEntries")), shipped_entries)
            plan = jt.build_plan(program)
            potentials, same = potential_time(plan, arrays, want0)
            sepset, absorb, gap = wave_times(plan, arrays, want)
            print(f"variant {name} turn {turn} clique_potentials_ms {potentials:.5f} sepset_ms "
                  f"{sepset:.5f} absorb_ms {absorb:.5f} worst_rel {gap:.3e} potentials_equal "
                  f"{same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
