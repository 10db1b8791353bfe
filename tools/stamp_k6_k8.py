"""Where the Gibbs sweep (K6) and the NUTS transition (K8 ``nuts_step``)
spend their cycles: ``clock64()`` stamps in a diagnostic build.

Run from a tree's root on a machine with one CUDA card, after
``python3 tools/parent_kernels.py unpack`` for the parent commit:

    python3 tools/stamp_k6_k8.py [parent|this ...]     # default: both

For each version it copies that version's ``csrc/gibbs.cu`` / ``hmc.cu`` and
wrappers into ``pgmpy_tpu_torch/_build/diag/<version>/`` (git-ignored),
inserts the stamps at fixed lines of the source (the script fails if a line
has moved), builds them with ``tools/parent_kernels.py`` and runs, on random
states and Philox draws:

* K6 at MUNIN's 4,096 chains and HEPAR2's 10,000 and 2,500: per level, the
  cycles from the level's start until the block's barrier, and until the
  chain-0 thread of each group has worked its share (each block's first
  block-sized slice of stamps), averaged over the blocks; their sums over
  the levels (the block's critical path and the mean group's busy time);
* K8 ``nuts_step`` on ecoli70 at 1,024 and 256 chains from draws of the
  joint at step 0.17, ``max_depth`` 6: per chain the cycles of the leaves,
  and within them of the gradients (with the log-density's butterfly in the
  parent), the other butterflies and U-turn checks, and the Philox take
  uniform, as means per leaf over the chains.

This tree's wrappers run in two variants each: the Gibbs plan staged in
shared memory or read from L2 (``ops.gibbs.SHARED_LIMIT`` 0), the
precision matrix in registers or in shared memory (``ops.hmc.register_form``
false).  Then the unstamped kernels are timed, the parent's and this tree's
variants in turns at the same shapes and at the HMC draws' launch (64 x 150
x 17), each the device time of single calls behind a device sleep (median
of 20, ``chip_smoke.cuda_median_ms``).  The stamps cost cycles of their own
(a clock read and a store per group and level; clock reads around each leaf
phase).  Prints ptxas's report of each build, one line per measurement and,
last, a JSON object of all of them with the card's name and power limit.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import parent_kernels  # noqa: E402
from pgmpy_tpu_torch.config import config  # noqa: E402
from pgmpy_tpu_torch.ops import _build  # noqa: E402

BLOCKS, LEVELS, GROUPS, CHAINS = 512, 32, 32, 1024

PRELUDE = f"""
#define STAMP_BLOCKS {BLOCKS}
#define STAMP_LEVELS {LEVELS}
#define STAMP_GROUPS {GROUPS}
#define STAMP_CHAINS {CHAINS}
__device__ long long stamp_level[STAMP_BLOCKS * STAMP_LEVELS];
__device__ long long stamp_group[STAMP_BLOCKS * STAMP_LEVELS * STAMP_GROUPS];
__device__ long long stamp_nuts[STAMP_CHAINS * 5];
__device__ long long stamp_piece[STAMP_BLOCKS * STAMP_GROUPS * 4];
"""

GROUP_STAMP = ("if (r == 0 && blockIdx.x < STAMP_BLOCKS && level < STAMP_LEVELS && g < STAMP_GROUPS)"
               " stamp_group[(blockIdx.x * STAMP_LEVELS + level) * STAMP_GROUPS + g] ="
               " clock64() - stamp_t0;\n")
LEVEL_STAMP = ("if (threadIdx.x == 0 && blockIdx.x < STAMP_BLOCKS && level < STAMP_LEVELS)"
               " stamp_level[blockIdx.x * STAMP_LEVELS + level] = clock64() - stamp_t0;\n")

# (old, new) replacements per version and source, each old text found once
EDITS = {
    ("parent", "gibbs.cu"): [
        ("  const uint2 k = noise == nullptr ? pgmpy_race::launch_key(key) : make_uint2(0u, 0u);\n",
         "  const uint2 k = noise == nullptr ? pgmpy_race::launch_key(key) : make_uint2(0u, 0u);\n"
         "  const long long stamp_t0 = clock64();\n"),
        ("    __syncthreads();  // the level's codes are in the tile\n",
         "    " + GROUP_STAMP + "    __syncthreads();\n    " + LEVEL_STAMP),
    ],
    ("this", "gibbs.cu"): [
        ("  const int width = (card + 3) & ~3;\n",
         "  const int width = (card + 3) & ~3;\n  const long long sp0 = clock64();\n"),
        ("  int best = 0;\n  T best_v = T(0);\n  for (int s0 = 0; s0 < card; s0 += 4) {\n"
         "    T acc[4] = {",
         "  const long long sp1 = clock64();\n  long long c_race = 0;\n"
         "  int best = 0;\n  T best_v = T(0);\n  for (int s0 = 0; s0 < card; s0 += 4) {\n"
         "    T acc[4] = {"),
        ("      race_chunk<T>(acc, s0, card, first_state, i, row, n, noise, key, best, best_v);\n",
         "      const long long sr = clock64();\n"
         "      race_chunk<T>(acc, s0, card, first_state, i, row, n, noise, key, best, best_v);\n"
         "      c_race += clock64() - sr;\n"),
        ("  if (slot < 0) mine[i] = (C)best;\n",
         "  if (slot < 0) mine[i] = (C)best;\n"
         "  if (r == 0 && blockIdx.x < STAMP_BLOCKS && threadIdx.x / rows < STAMP_GROUPS) {\n"
         "    long long* at = stamp_piece + (blockIdx.x * STAMP_GROUPS + threadIdx.x / rows) * 4;\n"
         "    const long long sp2 = clock64();\n"
         "    at[0] += sp1 - sp0;\n    at[1] += sp2 - sp1 - c_race;\n    at[2] += c_race;\n"
         "    at[3] += 1;\n  }\n"),
        ("  const uint2 k = noise == nullptr ? pgmpy_race::launch_key(key) : make_uint2(0u, 0u);\n",
         "  const uint2 k = noise == nullptr ? pgmpy_race::launch_key(key) : make_uint2(0u, 0u);\n"
         "  const long long stamp_t0 = clock64();\n"),
        ("    __syncthreads();  // the level's codes and partial sums are in shared memory\n",
         "    " + GROUP_STAMP + "    __syncthreads();\n"),
        ("      __syncthreads();  // the split variables' codes are in the tile\n    }\n",
         "      __syncthreads();\n    }\n    " + LEVEL_STAMP),
    ],
    ("parent", "hmc.cu"): [
        ("  bool stopped = false, turned = false, diverged = false;\n\n  for (int depth",
         "  bool stopped = false, turned = false, diverged = false;\n"
         "  long long c_leaf = 0, c_grad = 0, c_bfly = 0, c_rand = 0;\n\n  for (int depth"),
        ("      for (int k = 0; k < K; ++k) {\n        r[k] = r[k] + half * g[k];\n"
         "        z[k] = z[k] + eps * r[k];\n      }\n"
         "      const T logp = grad_value<T, K>(P, dim, row, mu, z, g, lane);\n",
         "      for (int k = 0; k < K; ++k) {\n        r[k] = r[k] + half * g[k];\n"
         "        z[k] = z[k] + eps * r[k];\n      }\n"
         "      const long long s_grad = clock64();\n"
         "      const T logp = grad_value<T, K>(P, dim, row, mu, z, g, lane);\n"
         "      c_grad += clock64() - s_grad;\n"),
        ("      const T delta = logp - T(0.5) * norm2<T, K>(r) - energy0;\n",
         "      long long s_b = clock64();\n      const T n2 = norm2<T, K>(r);\n"
         "      c_bfly += clock64() - s_b;\n      const T delta = logp - T(0.5) * n2 - energy0;\n"),
        ("      const T tu = given ? take_row[leaf]\n"
         "                         : uniform<T>(philox(counter(chain, depth, leaf, kTake), key).x);\n",
         "      const long long s_r = clock64();\n      const T tu = given ? take_row[leaf]\n"
         "                         : uniform<T>(philox(counter(chain, depth, leaf, kTake), key).x);\n"
         "      c_rand += clock64() - s_r;\n"),
        ("          sub_turning = is_turning<T, K>(rc, r, sub);\n",
         "          s_b = clock64();\n          sub_turning = is_turning<T, K>(rc, r, sub);\n"
         "          c_bfly += clock64() - s_b;\n"),
    ],
    ("this", "hmc.cu"): [
        ("  bool stopped = false, turned = false, diverged = false;\n\n  for (int depth",
         "  bool stopped = false, turned = false, diverged = false;\n"
         "  long long c_leaf = 0, c_grad = 0, c_bfly = 0, c_rand = 0;\n\n  for (int depth"),
        ("      sums[0] = gradient<T, K, REG>(P, dim, mu, z, g);\n",
         "      const long long s_grad = clock64();\n"
         "      sums[0] = gradient<T, K, REG>(P, dim, mu, z, g);\n"
         "      c_grad += clock64() - s_grad;\n"),
        ("        warp_sums<T, 4>(sums);\n",
         "        long long s_b = clock64();\n        warp_sums<T, 4>(sums);\n"
         "        c_bfly += clock64() - s_b;\n"),
        ("        warp_sums<T, 2>(two);\n",
         "        long long s_b = clock64();\n        warp_sums<T, 2>(two);\n"
         "        c_bfly += clock64() - s_b;\n"),
        ("      const T tu = given ? take_row[leaf]\n"
         "                         : uniform<T>(philox(counter(chain, depth, leaf, kTake), key).x);\n",
         "      const long long s_r = clock64();\n      const T tu = given ? take_row[leaf]\n"
         "                         : uniform<T>(philox(counter(chain, depth, leaf, kTake), key).x);\n"
         "      c_rand += clock64() - s_r;\n"),
        ("          sub_turning = is_turning<T, K>(rc, r, sub);\n",
         "          const long long s_t = clock64();\n"
         "          sub_turning = is_turning<T, K>(rc, r, sub);\n"
         "          c_bfly += clock64() - s_t;\n"),
    ],
}
LEAF_EDITS = [
    ("    for (int leaf = 0; leaf < (1 << depth) && !sub_turning && !sub_diverging; ++leaf) {\n",
     "    for (int leaf = 0; leaf < (1 << depth) && !sub_turning && !sub_diverging; ++leaf) {\n"
     "      const long long s_leaf = clock64();\n"),
    ("      ++sub_leaves;\n    }\n",
     "      ++sub_leaves;\n      c_leaf += clock64() - s_leaf;\n    }\n"),
    ("    flags_out[chain] = (signed char)((turned ? 1 : 0) | (diverged ? 2 : 0));\n",
     "    flags_out[chain] = (signed char)((turned ? 1 : 0) | (diverged ? 2 : 0));\n"
     "    if (chain < STAMP_CHAINS) {\n"
     "      stamp_nuts[chain * 5] = c_leaf;\n      stamp_nuts[chain * 5 + 1] = c_grad;\n"
     "      stamp_nuts[chain * 5 + 2] = c_bfly;\n      stamp_nuts[chain * 5 + 3] = c_rand;\n"
     "      stamp_nuts[chain * 5 + 4] = n_leaf;\n    }\n"),
]
READER = """
extern "C" int pgmpy_stamps_clear() {
  void* p = nullptr;
  cudaGetSymbolAddress(&p, stamp_level);
  cudaMemset(p, 0, sizeof(stamp_level));
  cudaGetSymbolAddress(&p, stamp_group);
  cudaMemset(p, 0, sizeof(stamp_group));
  cudaGetSymbolAddress(&p, stamp_nuts);
  cudaMemset(p, 0, sizeof(stamp_nuts));
  cudaGetSymbolAddress(&p, stamp_piece);
  return (int)cudaMemset(p, 0, sizeof(stamp_piece));
}

extern "C" int pgmpy_stamps_read(void* dst, int which, long long bytes) {
  const void* src = nullptr;
  if (which == 0) cudaGetSymbolAddress((void**)&src, stamp_level);
  if (which == 1) cudaGetSymbolAddress((void**)&src, stamp_group);
  if (which == 2) cudaGetSymbolAddress((void**)&src, stamp_nuts);
  if (which == 3) cudaGetSymbolAddress((void**)&src, stamp_piece);
  return (int)cudaMemcpy(dst, src, bytes, cudaMemcpyDeviceToHost);
}
"""


def instrument(text, edits):
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"stamp anchor not found once: {old[:60]!r}")
        text = text.replace(old, new)
    at = text.index("namespace {")
    return text[:at] + PRELUDE + text[at:] + READER


def diag_tree(version):
    """The version's sources with stamps, under the build directory."""
    src = parent_kernels.PARENT if version == "parent" else ROOT
    dest = os.path.join(_build.BUILD_DIR, "diag", version)
    shutil.rmtree(dest, ignore_errors=True)
    for sub in ("ops", "csrc"):
        os.makedirs(os.path.join(dest, "pgmpy_tpu_torch", sub))
    for name in ("gibbs.py", "hmc.py"):
        shutil.copy(os.path.join(src, "pgmpy_tpu_torch", "ops", name),
                    os.path.join(dest, "pgmpy_tpu_torch", "ops", name))
    csrc = os.path.join(src, "pgmpy_tpu_torch", "csrc")
    shutil.copy(os.path.join(csrc, "race.cuh"), os.path.join(dest, "pgmpy_tpu_torch", "csrc"))
    for name in ("gibbs.cu", "hmc.cu"):
        with open(os.path.join(csrc, name)) as fh:
            text = fh.read()
        edits = EDITS[(version, name)] + (LEAF_EDITS if name == "hmc.cu" else [])
        with open(os.path.join(dest, "pgmpy_tpu_torch", "csrc", name), "w") as fh:
            fh.write(instrument(text, edits))
    with open(os.path.join(dest, "REV"), "w") as fh:
        fh.write(f"stamps_{version}\n")
    return dest


def read(lib, which, count):
    import ctypes

    out = np.zeros(count, dtype=np.int64)
    lib.pgmpy_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
    err = lib.pgmpy_stamps_read(out.ctypes.data, which, out.nbytes)
    if err:
        raise RuntimeError(f"stamps read failed: cudaError_t {err}")
    return out


def clear(lib):
    err = lib.pgmpy_stamps_clear()
    if err:
        raise RuntimeError(f"stamps clear failed: cudaError_t {err}")


def k6_inputs(module, name, n):
    from pgmpy_tpu_torch.sampling import GibbsSampling
    from pgmpy_tpu_torch.utils import get_example_model

    gibbs = GibbsSampling(get_example_model(name))
    port = gibbs._compiled._tables
    tables = module.GibbsTables(port.var_specs, port.cards, port.out_dtype)
    codes = torch.as_tensor(gibbs.random_state(n, 0), device="cuda").to(port.out_dtype)
    return tables, codes


def k6_stamps(module, lib, name, n, label):
    from pgmpy_tpu_torch.utils.mathext import seeded_generator

    tables, codes = k6_inputs(module, name, n)
    gen = seeded_generator(0)
    for _ in range(3):
        module.sweep_cuda(tables, codes, gen)
    torch.cuda.synchronize()
    clear(lib)
    module.sweep_cuda(tables, codes, gen)
    torch.cuda.synchronize()
    levels, groups = tables.n_levels, tables.groups
    level = read(lib, 0, BLOCKS * LEVELS).reshape(BLOCKS, LEVELS)[:, :levels]
    group = read(lib, 1, BLOCKS * LEVELS * GROUPS).reshape(BLOCKS, LEVELS, GROUPS)[:, :levels,
                                                                                   :groups]
    used = level[:, -1] > 0
    level, group = level[used], group[used]
    begin = np.concatenate([np.zeros((len(level), 1), np.int64), level[:, :-1]], axis=1)
    span = (level - begin).mean(axis=0)
    busy = np.maximum(group - begin[:, :, None], 0)
    out = {"label": label, "name": name, "chains": n, "blocks_stamped": int(used.sum()),
           "levels": levels, "groups": groups,
           "level_cycles": span.round().astype(int).tolist(),
           "busiest_group_cycles": busy.max(axis=2).mean(axis=0).round().astype(int).tolist(),
           "mean_group_cycles": busy.mean(axis=2).mean(axis=0).round().astype(int).tolist()}
    if label.startswith("this"):  # per piece: its rows, its sums, its race (chain-0 threads)
        piece = read(lib, 3, BLOCKS * GROUPS * 4).reshape(BLOCKS, GROUPS, 4)[:, :groups]
        piece = piece[piece[:, :, 3] > 0]
        out["cycles_per_piece"] = {key: round(float(piece[:, j].sum() / piece[:, 3].sum()), 1)
                                   for j, key in enumerate(("rows", "sums", "race"))}
        print(f"k6 {label} {name} chains={n} pieces_per_chain_0_thread "
              f"{float(piece[:, 3].mean()):.2f} cycles_per_piece {out['cycles_per_piece']}",
              flush=True)
    out["critical_path_cycles"] = int(sum(out["level_cycles"]))
    out["busiest_group_sum_cycles"] = int(sum(out["busiest_group_cycles"]))
    out["mean_group_sum_cycles"] = int(sum(out["mean_group_cycles"]))
    print(f"k6 {label} {name} chains={n} blocks={out['blocks_stamped']} levels={levels} "
          f"groups={groups} critical_path_cycles={out['critical_path_cycles']} "
          f"busiest_group_sum_cycles={out['busiest_group_sum_cycles']} "
          f"mean_group_sum_cycles={out['mean_group_sum_cycles']} level_cycles "
          f"{out['level_cycles']} busiest_group_cycles {out['busiest_group_cycles']}", flush=True)
    return out


def nuts_inputs(module, n):
    from pgmpy_tpu_torch.utils import get_example_model

    _, mean, cov = get_example_model("ecoli70").joint_gaussian()
    target = module.GaussianTarget(mean, np.linalg.inv(cov), dtype=torch.float32, device="cuda")
    z = np.random.default_rng(0).multivariate_normal(mean, cov, size=n)
    return target, torch.as_tensor(z, dtype=torch.float32, device="cuda")


def nuts_stamps(module, lib, n, label):
    from pgmpy_tpu_torch.utils.mathext import seeded_generator

    target, z = nuts_inputs(module, n)
    gen = seeded_generator(0)
    for _ in range(3):
        module.nuts_step_cuda(target, z, 0.17, 6, gen=gen)
    torch.cuda.synchronize()
    clear(lib)
    module.nuts_step_cuda(target, z, 0.17, 6, gen=gen)
    torch.cuda.synchronize()
    stamps = read(lib, 2, CHAINS * 5).reshape(CHAINS, 5)[:min(n, CHAINS)]
    leaves = stamps[:, 4].sum()
    per_leaf = {key: float(stamps[:, j].sum() / leaves)
                for j, key in enumerate(("leaf", "gradient", "butterflies", "philox"))}
    per_leaf["control"] = per_leaf["leaf"] - per_leaf["gradient"] - per_leaf["butterflies"] \
        - per_leaf["philox"]
    out = {"label": label, "chains": n, "mean_leaves": float(leaves / len(stamps)),
           "most_leaves": int(stamps[:, 4].max()),
           "slowest_chain_cycles": int(stamps[:, 0].max()),
           "cycles_per_leaf": {k: round(v, 1) for k, v in per_leaf.items()}}
    print(f"k8 {label} nuts_step chains={n} mean_leaves {out['mean_leaves']:.2f} most "
          f"{out['most_leaves']} slowest_chain_cycles {out['slowest_chain_cycles']} "
          f"cycles_per_leaf {out['cycles_per_leaf']}", flush=True)
    return out


# what each variant changes in the wrappers of this tree
VARIANTS = {
    "plan_staged": {},
    "plan_in_l2": {"gibbs": {"SHARED_LIMIT": 0}},
    "p_in_registers": {},
    "p_in_shared": {"hmc": {"register_form": lambda dim, elem: False}},
}
K6_SHAPES = (("munin", 4096), ("hepar2", 10_000), ("hepar2", 2500))
NUTS_SHAPES = (1024, 256)


def patched(modules, variant):
    """Set the variant's attributes on the wrapper modules; returns the old
    ones."""
    saved = []
    for name, attrs in VARIANTS[variant].items():
        for attr, value in attrs.items():
            saved.append((modules[name], attr, getattr(modules[name], attr)))
            setattr(modules[name], attr, value)
    return saved


def restore(saved):
    for module, attr, value in saved:
        setattr(module, attr, value)


def timings(parent, this):
    """Device times of the unstamped kernels (median of 20 behind a device
    sleep, ``chip_smoke.cuda_median_ms``) of the parent and of this tree's
    variants at each shape, in turns: parent, variants, variants reversed,
    parent; each the smaller of its two medians."""
    import chip_smoke
    from pgmpy_tpu_torch.utils.mathext import seeded_generator

    out = []

    def turns(label, shape, calls):
        runs = {}
        for key in list(calls) + list(reversed(calls)):
            saved = patched(this, key) if key in VARIANTS else []
            runs.setdefault(key, []).append(chip_smoke.cuda_median_ms(calls[key], device_only=True))
            restore(saved)
        row = {"kernel": label, "shape": shape,
               **{key: min(v) for key, v in runs.items()}, "runs": runs}
        print(f"time {label} {shape} " + " ".join(f"{k} {min(v):.5f}" for k, v in runs.items()),
              flush=True)
        out.append(row)

    gen = seeded_generator(0)
    for name, n in K6_SHAPES:
        tables, codes = k6_inputs(this["gibbs"], name, n)
        calls = {key: lambda: this["gibbs"].sweep_cuda(tables, codes, gen)
                 for key in ("plan_staged", "plan_in_l2")}
        if parent:
            old, old_codes = k6_inputs(parent["gibbs"], name, n)
            calls = {"parent": lambda: parent["gibbs"].sweep_cuda(old, old_codes, gen), **calls}
        turns("gibbs_sweep", f"{name}_{n}", calls)
    for n in NUTS_SHAPES:
        target, z = nuts_inputs(this["hmc"], n)
        calls = {"p_in_registers": lambda: this["hmc"].nuts_step_cuda(target, z, 0.17, 6, gen=gen),
                 "p_in_shared": lambda: this["hmc"].nuts_step_cuda(target, z, 0.17, 6, gen=gen)}
        if parent:
            old_target, old_z = nuts_inputs(parent["hmc"], n)
            calls = {"parent": lambda: parent["hmc"].nuts_step_cuda(old_target, old_z, 0.17, 6,
                                                                     gen=gen), **calls}
        turns("nuts_step", f"ecoli70_{n}", calls)
    target, z = nuts_inputs(this["hmc"], 64)
    calls = {"p_in_registers": lambda: this["hmc"].hmc_step_cuda(target, z, 0.17, 17, gen=gen,
                                                                 transitions=150),
             "p_in_shared": lambda: this["hmc"].hmc_step_cuda(target, z, 0.17, 17, gen=gen,
                                                              transitions=150)}
    if parent:
        old_target, old_z = nuts_inputs(parent["hmc"], 64)
        calls = {"parent": lambda: parent["hmc"].hmc_step_cuda(old_target, old_z, 0.17, 17, gen=gen,
                                                               transitions=150), **calls}
    turns("hmc_step", "ecoli70_64x150x17", calls)
    return out


def main():
    versions = sys.argv[1:] or ["parent", "this"]
    if not torch.cuda.is_available():
        print("stamp_k6_k8: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pgmpy_tpu_torch.ops import gibbs, hmc

    config.set_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    result = {"device": smi}
    builds = {v: parent_kernels.start_builds(diag_tree(v)) for v in versions}
    plain = parent_kernels.start_builds() if parent_kernels.available() else None
    _build.build_libraries({"gibbs": ["gibbs.cu"], "hmc": ["hmc.cu"]})
    for name, built in _build.BUILDS.items():
        for line in chip_smoke.ptxas_summary(built["ptxas"]):
            print(f"ptxas this {name} {line}", flush=True)
    for version in versions:
        modules, report = parent_kernels.load(builds[version])
        libs = {name: modules[name].load_library() for name in modules}
        for name, (seconds, ptxas) in report.items():
            for line in chip_smoke.ptxas_summary(ptxas):
                print(f"ptxas stamped {version} {name} {line}", flush=True)
        result[version] = {"k6": [], "nuts_step": []}
        for variant in (["plan_staged", "plan_in_l2"] if version == "this" else ["parent"]):
            saved = patched(modules, variant) if variant in VARIANTS else []
            result[version]["k6"] += [k6_stamps(modules["gibbs"], libs["gibbs"], name, n,
                                                f"{version}/{variant}") for name, n in K6_SHAPES]
            restore(saved)
        for variant in (["p_in_registers", "p_in_shared"] if version == "this" else ["parent"]):
            saved = patched(modules, variant) if variant in VARIANTS else []
            result[version]["nuts_step"] += [nuts_stamps(modules["hmc"], libs["hmc"], n,
                                                         f"{version}/{variant}")
                                             for n in NUTS_SHAPES]
            restore(saved)
    parent = parent_kernels.load(plain)[0] if plain else None
    result["times"] = timings(parent, {"gibbs": gibbs, "hmc": hmc})
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
