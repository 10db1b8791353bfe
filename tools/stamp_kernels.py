"""Where a hand-written kernel spends its cycles: ``clock64()`` stamps in a
diagnostic build, for any ``csrc/*.cu`` with its wrapper that has a probe
here, beside this tree's and the parent commit's unstamped kernels.

Run from a tree's root on a machine with one CUDA card, after
``python3 tools/parent_kernels.py unpack`` for the parent commit:

    python3 tools/stamp_kernels.py KERNEL [parent|this ...]   # default: both

KERNEL is one of ``PROBES`` (``k3``, ``k5``, ``k6``, ``k8``, ``k10``, ``k10tasks``,
``k11``, ``k13``).  For each
version it copies that version's wrapper and source (``PROBES[k].wrapper``,
``.source``) into ``pgmpy_tpu_torch/_build/diag/<version>/`` (git-ignored),
inserts the stamps at fixed lines of the source (the first set of anchors in
``EDITS[source]`` that the source holds, each exactly once; the script fails
if none does), builds it with ``tools/parent_kernels.py`` and runs the
kernel's probe:

* ``k5`` (``ancestral.cu``): the sweep at MUNIN's 52,048 rows and K9's slice
  of ALARM as a 2-TBN (262,144 particles, 3 leaves observed): per level the
  cycles from its start until the block's barrier and until each group's
  row-0 thread has drawn its share (each block's first slice of stamps,
  averaged over the blocks stamped), their sums over the levels, the mean
  split of a node's draw (parent index; the CPD row's first read and the
  race in the parent; the Philox uniform and the CDF row's read and count
  in this tree's), and the blocks a multiprocessor holds
  (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the wrapper's tile);
* ``k3`` (``einsum_plan.cu``): ``plan_grid`` on the contraction of a
  2,048-row MUNIN ``query_batch``: per step the cycles of its tasks and of
  its grid barrier (block 0 and the slowest block stamped), and the blocks a
  multiprocessor holds; and (a tree whose ``plan_block`` runs by levels)
  ``plan_block`` on a MUNIN VE query's contraction: the staging's cycles,
  then per level its cycles (thread 0's clock), the busiest warp's work and
  the warps' mean wait at its barrier;
* ``k6`` / ``k8`` (``gibbs.cu``, ``hmc.cu``): K6's levels and pieces at
  MUNIN's 4,096 chains and HEPAR2's 10,000 and 2,500, K8 ``nuts_step``'s
  leaf phases at 1,024 and 256 chains, each in this tree's variants
  (``VARIANTS``);
* ``k10`` (``einsum_plan.cu``, ``filter_scan``): ALARM as a 2-TBN over 49
  slices and rain / umbrella over 199 (``chip_smoke``'s inputs): per level
  of a slice (the normalisation last) its cycles (thread 0's clock), the
  warps' mean wait at its barrier (each warp's clock before and after it)
  and the busiest warp's work (the level less its shortest wait), averaged
  over the slices; and the
  dependency probe, one block of 512 threads taking rounds of a dependent
  shared-memory read and a barrier (and of the read alone): the cycles of
  one level's unavoidable chain, which ``chip_smoke.K10_LEVEL_CYCLES`` keeps;
  ``k10tasks``: thread 0's clock around the parts of each task it runs
  (setting up the inputs, the partial sum, the shuffles and the store) and
  around reading its level's work range;
* ``k11`` (``table_gather.cu``, ``e_step``): MUNIN's E-step with
  DIFFN_PATHO latent at 5 states over 50,000 rows: per tile and warp the
  cycles of its shared-node slice, its latent tasks, its wait at the
  barrier after them and the softmax with the writes (the mean warp and the
  slowest, over the blocks stamped), tiles per block and the blocks a
  multiprocessor holds; timed also with the latent nodes alone (their
  weights equal the full sum's: the shared nodes add the same to every
  configuration) and at 128 threads;
* ``k13`` (``table_gather.cu``, ``row_sums``): MUNIN's 50,000 rows: per
  tile and warp the cycles of its slice of the nodes, its wait at the
  barrier and the combine with the stores (the mean warp and the slowest,
  over the blocks stamped), tiles per block and the blocks a multiprocessor
  holds; timed also at other tiles and blocks (``K13_TILES``).

Then the unstamped kernels are timed, the parent's and this tree's in turns
(parent, this, this, parent) at the same shapes, each the device time of
single calls behind a device sleep (median of 20,
``chip_smoke.cuda_median_ms``); ``k3`` adds ``plan_block`` and one
``torch.einsum`` over the whole contraction, and on the VE query both
versions' ``plan_block`` (this tree's also with its tables read from global
memory), ``plan_grid`` and ``torch.einsum``; ``k10`` its tables read from
global memory.  The stamps cost cycles of their own (a clock read and a
store per group and level; clock reads and an ordering ``asm`` around each
phase of a draw; ``k10`` and ``k11`` keep memory accesses from moving
across a stamp).  Prints ptxas's report of
each build, one line per measurement and, last, a JSON object of all of
them with the card's name and power limit.
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

BLOCKS, LEVELS, GROUPS, CHAINS, THREADS, STEPS = 512, 32, 32, 1024, 1024, 64

PRELUDE = f"""
#define STAMP_BLOCKS {BLOCKS}
#define STAMP_LEVELS {LEVELS}
#define STAMP_GROUPS {GROUPS}
#define STAMP_CHAINS {CHAINS}
#define STAMP_THREADS {THREADS}
#define STAMP_STEPS {STEPS}
__device__ long long stamp_level[STAMP_BLOCKS * STAMP_LEVELS];
__device__ long long stamp_group[STAMP_BLOCKS * STAMP_LEVELS * STAMP_GROUPS];
__device__ long long stamp_nuts[STAMP_CHAINS * 5];
__device__ long long stamp_piece[STAMP_BLOCKS * STAMP_GROUPS * 4];
__device__ long long stamp_node[STAMP_BLOCKS * STAMP_THREADS * 4];
__device__ long long stamp_step[STAMP_BLOCKS * STAMP_STEPS * 2];
__device__ long long stamp_t0_g;
__device__ int stamp_count[STAMP_THREADS];
"""
ARRAYS = ("stamp_level", "stamp_group", "stamp_nuts", "stamp_piece", "stamp_node", "stamp_step")

GROUP_STAMP = ("if (r == 0 && blockIdx.x < STAMP_BLOCKS && level < STAMP_LEVELS && g < STAMP_GROUPS)"
               " stamp_group[(blockIdx.x * STAMP_LEVELS + level) * STAMP_GROUPS + g] ="
               " clock64() - stamp_t0;\n")
LEVEL_STAMP = ("if (threadIdx.x == 0 && blockIdx.x < STAMP_BLOCKS && level < STAMP_LEVELS)"
               " stamp_level[blockIdx.x * STAMP_LEVELS + level] = clock64() - stamp_t0;\n")
NODE_STAMP = ("  if (blockIdx.x < STAMP_BLOCKS && threadIdx.x < STAMP_THREADS) {\n"
              "    long long* at = stamp_node + ((long long)blockIdx.x * STAMP_THREADS"
              " + threadIdx.x) * 4;\n"
              "    at[0] += sn1 - sn0;\n    at[1] += sn2 - sn1;\n    at[2] += sn3 - sn2;\n"
              "    at[3] += 1;\n  }\n")
KEY_LINE = "  const uint2 k = noise == nullptr ? pgmpy_race::launch_key(key) : make_uint2(0u, 0u);\n"
T0_EDIT = (KEY_LINE, KEY_LINE + "  const long long stamp_t0 = clock64();\n")

# (old, new) replacements of each version of K6 and K8 (267308f and later)
_K6K8 = {
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

# per source, the sets of (old, new) replacements of its known versions, each
# old text found once: the first set that fits is applied
EDITS = {
    "gibbs.cu": [_K6K8[("parent", "gibbs.cu")], _K6K8[("this", "gibbs.cu")]],
    "hmc.cu": [_K6K8[("parent", "hmc.cu")] + LEAF_EDITS, _K6K8[("this", "hmc.cu")] + LEAF_EDITS],
}

# K5: the level stamps of the sweep kernel, shared by both versions
K5_LEVELS = [
    T0_EDIT,
    ("    __syncthreads();  // the level's codes are in the tile\n",
     "    " + GROUP_STAMP + "    __syncthreads();\n    " + LEVEL_STAMP),
]
EDITS["ancestral.cu"] = [
    # the exponential race (ae46b85): parent index, the row's first read, the race
    K5_LEVELS + [
        ("  const int card = __ldg(nd);\n"
         "  const int flat = flat_row<C>(nd, width, mine, d, prev, prev_ld, row);\n"
         "  const T* logits = tables + __ldg(nd + 1) + (long long)flat * card;\n",
         "  const long long sn0 = clock64();\n"
         "  const int card = __ldg(nd);\n"
         "  const int flat = flat_row<C>(nd, width, mine, d, prev, prev_ld, row);\n"
         "  asm volatile(\"\" ::\"r\"(flat));\n"
         "  const long long sn1 = clock64();\n"
         "  const T* logits = tables + __ldg(nd + 1) + (long long)flat * card;\n"
         "  double pre = 0.0;\n"
         "  for (int s = 0; s < card; ++s) pre += (double)logits[s];\n"
         "  asm volatile(\"\" ::\"d\"(pre));\n"
         "  const long long sn2 = clock64();\n"),
        ("  if (partial != nullptr) {\n    const long long p = partial[row * d + i];\n",
         "  asm volatile(\"\" ::\"r\"(best));\n  const long long sn3 = clock64();\n" + NODE_STAMP
         + "  if (partial != nullptr) {\n    const long long p = partial[row * d + i];\n"),
    ],
    # the inverse CDF with staged node rows: parent index, the Philox uniform,
    # the row's read and count
    [T0_EDIT,
     ("    __syncthreads();  // the level's codes are in the tile, the next level staged\n",
      "    " + GROUP_STAMP + "    __syncthreads();\n    " + LEVEL_STAMP),
     ("  const int i = nd[kNode];\n",
      "  const long long sn0 = clock64();\n  const int i = nd[kNode];\n"),
     ("  const int flat = flat_row<C>(nd, width, mine, d, prev, prev_ld, row);\n"
      "  const double2* c",
      "  const int flat = flat_row<C>(nd, width, mine, d, prev, prev_ld, row);\n"
      "  asm volatile(\"\" ::\"r\"(flat));\n  const long long sn1 = clock64();\n"
      "  const double2* c"),
     ("  const double u = noise != nullptr ? noise[(long long)i * n + row] :"
      " uniforms.at(row, x, key);\n",
      "  const double u = noise != nullptr ? noise[(long long)i * n + row] :"
      " uniforms.at(row, x, key);\n"
      "  asm volatile(\"\" ::\"d\"(u));\n  const long long sn2 = clock64();\n"),
     ("  if (partial != nullptr) {\n    const long long p = partial[row * d + i];\n",
      "  asm volatile(\"\" ::\"r\"(best));\n  const long long sn3 = clock64();\n" + NODE_STAMP
      + "  if (partial != nullptr) {\n    const long long p = partial[row * d + i];\n")],
]
# the level schedule's barrier (run_levels, shared by plan_block and K10
# since 846aee6's successor): each warp's arrival and the release, indexed by
# slice (the thread's count of run_levels calls in the launch, read once a
# call; one block: no race; the kernel zeroes it) and level
_LEVEL_BARRIER = [
    ("  const int warp = threadIdx.x >> 5;\n  for (int level = 0; level < n_levels; ++level) {\n",
     "  const int warp = threadIdx.x >> 5;\n  const int stamp_t = stamp_count[threadIdx.x];\n"
     "  for (int level = 0; level < n_levels; ++level) {\n"),
    ("    __syncthreads();  // the level's results are written\n  }\n",
     "    " + 'asm volatile("" ::: "memory");' + " const long long stamp_a = clock64();\n"
     "    __syncthreads();\n"
     "    const long long stamp_b = clock64();\n"
     "    if ((threadIdx.x & 31) == 0 && stamp_t < STAMP_BLOCKS && level < STAMP_LEVELS"
     " && warp < STAMP_GROUPS)\n"
     "      stamp_group[((long long)stamp_t * STAMP_LEVELS + level) * STAMP_GROUPS + warp] ="
     " stamp_b - stamp_a;\n"
     "    if (threadIdx.x == 0 && stamp_t < STAMP_BLOCKS && level < STAMP_LEVELS)\n"
     "      stamp_level[stamp_t * STAMP_LEVELS + level] = stamp_b - stamp_t0_g;\n  }\n"
     "  stamp_count[threadIdx.x] = stamp_t + 1;\n")]
_LEVEL_START = ("const long long stamp_t0 = clock64(); if (threadIdx.x == 0) stamp_t0_g = stamp_t0;"
                " stamp_count[threadIdx.x] = 0;\n")
# K3: per step of plan_grid, its tasks and its grid barrier; plan_block (this
# tree): its staging (stamp_step[0]) and per level its release and each
# warp's wait (the k10 layout at one slice)
_GRID_STEPS = ("    run_tasks<T>(desc[s & 1], ops, arena, out, scratch, first, stride);\n"
      "    if (s + 1 < n_steps) grid.sync();\n",
      "    const long long st0 = clock64();\n"
      "    run_tasks<T>(desc[s & 1], ops, arena, out, scratch, first, stride);\n"
      "    __syncthreads();\n    const long long st1 = clock64();\n"
      "    if (s + 1 < n_steps) grid.sync();\n    const long long st2 = clock64();\n"
      "    if (threadIdx.x == 0 && blockIdx.x < STAMP_BLOCKS && s < STAMP_STEPS) {\n"
      "      stamp_step[(blockIdx.x * STAMP_STEPS + s) * 2] = st1 - st0;\n"
      "      stamp_step[(blockIdx.x * STAMP_STEPS + s) * 2 + 1] = st2 - st1;\n    }\n")
EDITS["einsum_plan.cu"] = [
    [_GRID_STEPS, *_LEVEL_BARRIER,
     ("  int* s_table = reinterpret_cast<int*>(smem_raw + table_at);\n  if (staged) {\n"
      "    const LevelTable g = level_table(table, n_steps, 0, n_levels, n_work, n_ptrs);\n",
      "  int* s_table = reinterpret_cast<int*>(smem_raw + table_at);\n  " + _LEVEL_START
      + "  if (staged) {\n"
      "    const LevelTable g = level_table(table, n_steps, 0, n_levels, n_work, n_ptrs);\n"),
     ("  const LevelTable t = level_table(staged ? s_table : table, n_steps, 0, n_levels, n_work,\n",
      "  if (threadIdx.x == 0) stamp_step[0] = clock64() - stamp_t0;\n"
      "  const LevelTable t = level_table(staged ? s_table : table, n_steps, 0, n_levels, n_work,\n")],
    [_GRID_STEPS],
]
# K10 (this tree's filter_scan): per slice and level, each warp's arrival at
# the level's barrier and the barrier's release (the normalisation phase as
# level n_levels)
_ARRIVE = ("asm volatile(\"\" ::: \"memory\");"
           " const long long stamp_a{tag} = clock64();\n")
_RELEASE = ("const long long stamp_b{tag} = clock64();"
            " if (lane == 0 && t < STAMP_BLOCKS && {level} < STAMP_LEVELS && warp < STAMP_GROUPS)"
            " stamp_group[((long long)t * STAMP_LEVELS + {level}) * STAMP_GROUPS + warp] ="
            " stamp_b{tag} - stamp_a{tag};\n"
            " if (threadIdx.x == 0 && t < STAMP_BLOCKS && {level} < STAMP_LEVELS)"
            " stamp_level[t * STAMP_LEVELS + {level}] = stamp_b{tag} - stamp_t0;\n")
_NORMALISE = (
    "        s_code[i] = codes[(long long)(t + 1) * n_vars + i];\n    }\n    __syncthreads();\n",
    "        s_code[i] = codes[(long long)(t + 1) * n_vars + i];\n    }\n    "
    + _ARRIVE.format(tag="n") + "    __syncthreads();\n    "
    + _RELEASE.format(level="n_levels", tag="n"))
EDITS["k10"] = [[
    ("  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;\n"
     "  for (int t = 0; t < n_slices; ++t) {\n"
     "    run_levels<T>(lt, n_levels, s_code, s_ops, ops, arena, nullptr);\n",
     "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;\n"
     "  " + _LEVEL_START + "  for (int t = 0; t < n_slices; ++t) {\n"
     "    run_levels<T>(lt, n_levels, s_code, s_ops, ops, arena, nullptr);\n"),
    *_LEVEL_BARRIER, _NORMALISE,
], [
    ("  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;\n"
     "  for (int t = 0; t < n_slices; ++t) {\n",
     "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;\n"
     "  const long long stamp_t0 = clock64();\n  for (int t = 0; t < n_slices; ++t) {\n"),
    ("      __syncthreads();  // the level's results are written\n",
     "      " + _ARRIVE.format(tag="l") + "      __syncthreads();\n      "
     + _RELEASE.format(level="level", tag="l")),
    _NORMALISE,
]]
# K10's tasks (probe ``k10tasks``): thread 0's clock around the parts of each
# task it runs (setting up the inputs, the partial sum, the shuffles and the
# store; a sink store before each stamp waits for the part's values) and
# around reading its level's work range; counters in stamp_step[0] and [1]
_F = 'asm volatile("" ::: "memory");'
_K10_TASKS = [
    ("  const T* a = scan_input<T>(d[sIn0], staged, op_off, ops, arena);\n",
     "  " + _F + " const long long q0 = clock64();\n"
     "  const T* a = scan_input<T>(d[sIn0], staged, op_off, ops, arena);\n"),
    ("  const int lane = threadIdx.x & 31;\n"
     "  for (int first = 32 * rank; first < tasks; first += 32 * group) {\n",
     "  const int lane = threadIdx.x & 31;\n"
     "  stamp_step[2 + threadIdx.x] = (long long)a ^ (long long)b ^ (long long)dst ^ tasks;\n"
     "  " + _F + " const long long q1 = clock64();\n"
     "  for (int first = 32 * rank; first < tasks; first += 32 * group) {\n"),
    ("    for (int s = lanes >> 1; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s, lanes);\n"
     "    if (t < tasks && (t & (lanes - 1)) == 0) dst[t >> shift] = (T)v;\n  }\n",
     "    stamp_step[1024 + threadIdx.x] = __double_as_longlong(v);\n"
     "    " + _F + " const long long q2 = clock64();\n"
     "    for (int s = lanes >> 1; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s, lanes);\n"
     "    if (t < tasks && (t & (lanes - 1)) == 0) dst[t >> shift] = (T)v;\n"
     "    " + _F + " const long long q3 = clock64();\n"
     "    if (threadIdx.x == 0 && stamp_step[0] < STAMP_BLOCKS * STAMP_THREADS) {\n"
     "      long long* r = stamp_node + 4 * stamp_step[0];\n"
     "      r[0] = q1 - q0;\n      r[1] = q2 - q1;\n      r[2] = q3 - q2;\n"
     "      r[3] = (long long)d[sOutCount] * 1000 + d[sLanes];\n      stamp_step[0] += 1;\n"
     "    }\n  }\n"),
]
_WORK_RANGE = (
    "  " + _F + " const long long p0 = clock64();\n"
    "  const int* at = {table}level_start + level * kScanWarps + warp;\n"
    "  if (threadIdx.x == 0 && stamp_step[1] < STAMP_CHAINS * 5) {{\n"
    "    stamp_step[4096] = at[0] + at[1];\n"
    "    " + _F + " stamp_nuts[stamp_step[1]] = clock64() - p0;\n"
    "    stamp_step[1] += 1;\n  }}\n")
EDITS["k10tasks"] = [
    _K10_TASKS + [("  for (int level = 0; level < n_levels; ++level) {\n"
                   "    const int* at = t.level_start + level * kScanWarps + warp;\n",
                   "  for (int level = 0; level < n_levels; ++level) {\n"
                   + _WORK_RANGE.format(table="t."))],
    _K10_TASKS + [("    for (int level = 0; level < n_levels; ++level) {\n"
                   "      const int* at = level_start + level * kScanWarps + warp;\n",
                   "    for (int level = 0; level < n_levels; ++level) {\n"
                   + _WORK_RANGE.format(table=""))],
]
# K11 (e_step): per block and warp, summed over its tiles, the cycles of its
# shared-node slice, of its latent tasks, of its wait at the barrier after
# them, and of the softmax and the writes; tiles per block.  One set per
# version of its slice line (this tree's node_slice, then 846aee6's).
_FENCE = '    asm volatile("" ::: "memory");\n'  # no memory access moves across a stamp
_TILE_STAMPS = (
    "    if (lane == 0 && blockIdx.x < STAMP_BLOCKS && warp < STAMP_GROUPS) {\n"
    "      long long* at = stamp_piece + ((long long)blockIdx.x * STAMP_GROUPS + warp) * 4;\n"
    "      at[0] += se1 - se0;\n      at[1] += se2 - se1;\n      at[2] += se3 - se2;\n"
    "      at[3] += clock64() - se3;\n    }\n"
    "    if (threadIdx.x == 0 && blockIdx.x < STAMP_BLOCKS)"
    " stamp_level[blockIdx.x * STAMP_LEVELS] += 1;\n")


def _around(line):
    """``line`` between the stamps se0 and se1."""
    return (line, _FENCE + "    const long long se0 = clock64();\n" + line + _FENCE
            + "    const long long se1 = clock64();\n")


EDITS["k11"] = [[
    _around(line),
    ("        if (k < kc) s_lp[(long long)p * KR + (k0 + k) * R + r] = acc[k];\n      }\n    }\n"
     "    __syncthreads();\n",
     "        if (k < kc) s_lp[(long long)p * KR + (k0 + k) * R + r] = acc[k];\n      }\n    }\n"
     + _FENCE + "    const long long se2 = clock64();\n    __syncthreads();\n"
     "    const long long se3 = clock64();\n"),
    ("    __syncthreads();  // the tile's sums are read before the next tile writes them\n",
     "    __syncthreads();\n" + _TILE_STAMPS),
] for line in (
    "    s_part[threadIdx.x] = chunk_sum<W>(0.0, codes + r0 + min(mine.row, here - 1), ld, table,\n"
    "                                       rows + mine.first * kRow, mine.count, true);\n",
    "    s_part[threadIdx.x] = chunk_sum<W>(0.0, codes + r0 + min(row, here - 1), ld, table,\n"
    "                                       rows + first * kRow, count, true);\n")]
# K13 (this tree's row_sums): the same per block and warp: its slice of the
# nodes (se0-se1), its wait at the barrier (se1-se2, se2 = se3), the combine
# and the stores (to the tile's last barrier); tiles per block
EDITS["k13"] = [[
    _around("    s_part[threadIdx.x] = chunk_sum<W>(0.0, codes + r0 + min(mine.row, here - 1), ld,"
            " table,\n                                       nodes + mine.first * kRow,"
            " mine.count, missing != 0);\n"),
    ("    __syncthreads();\n    for (int r = warp; r < here; r += warps) {\n"
     "      const double v = combine_slices(s_part, slices, R, r, lane);\n",
     "    __syncthreads();\n    const long long se2 = clock64(), se3 = se2;\n"
     "    for (int r = warp; r < here; r += warps) {\n"
     "      const double v = combine_slices(s_part, slices, R, r, lane);\n"),
    ("    __syncthreads();  // the slice sums are read before the next tile's are written\n",
     "    __syncthreads();\n" + _TILE_STAMPS),
]]
# K10's dependency probe: one block of `threads` threads, `iters` rounds of a
# dependent shared-memory read and a barrier (or the read alone)
EXTRA = {"k10": """
__global__ void stamp_barrier_kernel(int iters, int barrier, long long* out) {
  __shared__ int ring[1024];
  ring[threadIdx.x] = (threadIdx.x + 33) % blockDim.x;
  __syncthreads();
  int x = threadIdx.x;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    x = ring[x];
    if (barrier) __syncthreads();
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = x;
  }
}

extern "C" int pgmpy_stamps_barrier(int threads, int iters, int barrier, void* out) {
  stamp_barrier_kernel<<<1, threads>>>(iters, barrier, static_cast<long long*>(out));
  return (int)cudaDeviceSynchronize();
}
"""}
# the kernel whose resident blocks a probe asks for, by source
OCCUPANCY = {"ancestral.cu": "sweep_kernel<float, int8_t>",
             "einsum_plan.cu": "plan_grid_kernel<float>",
             "table_gather.cu": "e_step_kernel<4, int8_t, double, float>",
             "k13": "row_sums_kernel<4, int8_t, float>"}

READER = "".join(
    [f"""
extern "C" int pgmpy_stamps_clear_{k}() {{
  void* p = nullptr;
  cudaGetSymbolAddress(&p, {name});
  return (int)cudaMemset(p, 0, sizeof({name}));
}}
""" for k, name in enumerate(ARRAYS)]
    + ["""
extern "C" int pgmpy_stamps_read(void* dst, int which, long long bytes) {
  const void* src = nullptr;
"""]
    + [f"  if (which == {k}) cudaGetSymbolAddress((void**)&src, {name});\n"
       for k, name in enumerate(ARRAYS)]
    + ["""  return (int)cudaMemcpy(dst, src, bytes, cudaMemcpyDeviceToHost);
}
"""])
OCCUPANCY_READER = """
extern "C" int pgmpy_stamps_occupancy(int threads, long long smem, int* out) {
  if (smem > 46 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(KERNEL,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, KERNEL, threads, (size_t)smem);
}
"""


class Probe:
    """A kernel the tool stamps: its wrapper module, its source, the probe
    that runs a stamped build (``stamps(module, lib, version)``), the
    timings of the unstamped kernels (``times(parent_module or None,
    this_module)``) and the key of its stamps in ``EDITS`` (the source's by
    default)."""

    def __init__(self, wrapper, source, stamps, times, edits=None):
        self.wrapper, self.source, self.stamps, self.times = wrapper, source, stamps, times
        self.edits = edits or source


def instrument(text, source, key=None):
    """The source with the first of ``EDITS[key or source]``'s anchor sets
    that it holds (each anchor exactly once) applied, the stamp arrays, their
    reader, ``EXTRA[key]`` where there is one and, where ``OCCUPANCY`` names
    a kernel of the source, its occupancy."""
    for edits in EDITS[key or source]:
        if all(text.count(old) == 1 for old, _ in edits):
            break
    else:
        raise RuntimeError(f"no set of stamp anchors fits {source}")
    for old, new in edits:
        text = text.replace(old, new)
    at = text.index("namespace {")
    text = text[:at] + PRELUDE + text[at:] + READER + EXTRA.get(key, "")
    kernel = OCCUPANCY.get(key) or OCCUPANCY.get(source)
    if kernel and kernel.split("<")[0] in text:
        text += OCCUPANCY_READER.replace("KERNEL", kernel)
    return text


def diag_tree(version, probe):
    """The version's wrapper and source with stamps, under the build
    directory."""
    src = parent_kernels.PARENT if version == "parent" else ROOT
    dest = os.path.join(_build.BUILD_DIR, "diag", version)
    shutil.rmtree(dest, ignore_errors=True)
    for sub in ("ops", "csrc"):
        os.makedirs(os.path.join(dest, "pgmpy_tpu_torch", sub))
    shutil.copy(os.path.join(src, "pgmpy_tpu_torch", "ops", f"{probe.wrapper}.py"),
                os.path.join(dest, "pgmpy_tpu_torch", "ops", f"{probe.wrapper}.py"))
    csrc = os.path.join(src, "pgmpy_tpu_torch", "csrc")
    for header in os.listdir(csrc):
        if header.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, header), os.path.join(dest, "pgmpy_tpu_torch", "csrc"))
    with open(os.path.join(csrc, probe.source)) as fh:
        text = fh.read()
    with open(os.path.join(dest, "pgmpy_tpu_torch", "csrc", probe.source), "w") as fh:
        fh.write(instrument(text, probe.source, probe.edits))
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
    for k in range(len(ARRAYS)):
        err = getattr(lib, f"pgmpy_stamps_clear_{k}")()
        if err:
            raise RuntimeError(f"stamps clear failed: cudaError_t {err}")


def occupancy(lib, threads, smem):
    import ctypes

    out = ctypes.c_int(0)
    fn = lib.pgmpy_stamps_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    err = fn(int(threads), int(smem), ctypes.byref(out))
    if err:
        raise RuntimeError(f"occupancy query failed: cudaError_t {err}")
    return out.value


def level_stamps(lib, levels, groups):
    """Per level: the mean cycles from its start until the block's barrier,
    the busiest and the mean group's, over the blocks stamped."""
    level = read(lib, 0, BLOCKS * LEVELS).reshape(BLOCKS, LEVELS)[:, :levels]
    group = read(lib, 1, BLOCKS * LEVELS * GROUPS).reshape(BLOCKS, LEVELS, GROUPS)[:, :levels,
                                                                                   :groups]
    used = level[:, -1] > 0
    level, group = level[used], group[used]
    begin = np.concatenate([np.zeros((len(level), 1), np.int64), level[:, :-1]], axis=1)
    span = (level - begin).mean(axis=0)
    busy = np.maximum(group - begin[:, :, None], 0)
    out = {"blocks_stamped": int(used.sum()), "levels": levels, "groups": groups,
           "level_cycles": span.round().astype(int).tolist(),
           "busiest_group_cycles": busy.max(axis=2).mean(axis=0).round().astype(int).tolist(),
           "mean_group_cycles": busy.mean(axis=2).mean(axis=0).round().astype(int).tolist()}
    out["critical_path_cycles"] = int(sum(out["level_cycles"]))
    out["busiest_group_sum_cycles"] = int(sum(out["busiest_group_cycles"]))
    out["mean_group_sum_cycles"] = int(sum(out["mean_group_cycles"]))
    return out


def turns(label, shape, calls):
    """Device times (median of 20 behind a device sleep) of ``calls`` in
    turns, the list and then the list reversed; each the smaller of its two
    medians."""
    import chip_smoke

    runs = {}
    for key in list(calls) + list(reversed(calls)):
        runs.setdefault(key, []).append(chip_smoke.cuda_median_ms(calls[key], device_only=True))
    print(f"time {label} {shape} " + " ".join(f"{k} {min(v):.5f}" for k, v in runs.items()),
          flush=True)
    return {"kernel": label, "shape": shape, **{key: min(v) for key, v in runs.items()},
            "runs": runs}


# --------------------------------------------------------------------------- #
# K6 and K8
# --------------------------------------------------------------------------- #
def k6_inputs(module, name, n):
    from pgmpy_tpu_torch.sampling import GibbsSampling
    from pgmpy_tpu_torch.utils import get_example_model

    gibbs = GibbsSampling(get_example_model(name))
    port = gibbs._compiled._tables
    tables = module.GibbsTables(port.var_specs, port.cards, port.out_dtype)
    codes = torch.as_tensor(gibbs.random_state(n, 0), device="cuda").to(port.out_dtype)
    return tables, codes


def k6_shape_stamps(module, lib, name, n, label):
    from pgmpy_tpu_torch.utils.mathext import seeded_generator

    tables, codes = k6_inputs(module, name, n)
    gen = seeded_generator(0)
    for _ in range(3):
        module.sweep_cuda(tables, codes, gen)
    torch.cuda.synchronize()
    clear(lib)
    module.sweep_cuda(tables, codes, gen)
    torch.cuda.synchronize()
    out = {"label": label, "name": name, "chains": n,
           **level_stamps(lib, tables.n_levels, tables.groups)}
    piece = read(lib, 3, BLOCKS * GROUPS * 4).reshape(BLOCKS, GROUPS, 4)[:, :tables.groups]
    piece = piece[piece[:, :, 3] > 0]
    if len(piece):  # per piece: its rows, its sums, its race (chain-0 threads)
        out["cycles_per_piece"] = {key: round(float(piece[:, j].sum() / piece[:, 3].sum()), 1)
                                   for j, key in enumerate(("rows", "sums", "race"))}
        print(f"k6 {label} {name} chains={n} pieces_per_chain_0_thread "
              f"{float(piece[:, 3].mean()):.2f} cycles_per_piece {out['cycles_per_piece']}",
              flush=True)
    print(f"k6 {label} {name} chains={n} blocks={out['blocks_stamped']} levels={out['levels']} "
          f"groups={out['groups']} critical_path_cycles={out['critical_path_cycles']} "
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


def nuts_shape_stamps(module, lib, n, label):
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


# what each variant of this tree's wrapper changes
VARIANTS = {
    "gibbs": {"plan_staged": {}, "plan_in_l2": {"SHARED_LIMIT": 0}},
    "hmc": {"p_in_registers": {}, "p_in_shared": {"register_form": lambda dim, elem: False}},
}
K6_SHAPES = (("munin", 4096), ("hepar2", 10_000), ("hepar2", 2500))
NUTS_SHAPES = (1024, 256)


def variants(module, version):
    """(label, attributes to set) of each variant a version runs in."""
    if version != "this":
        return [(version, {})]
    name = module.__name__.rsplit(".", 1)[-1].replace("parent_", "")
    return [(f"this/{key}", attrs) for key, attrs in VARIANTS[name].items()]


def patched_run(module, attrs, fn):
    saved = {attr: getattr(module, attr) for attr in attrs}
    for attr, value in attrs.items():
        setattr(module, attr, value)
    try:
        return fn()
    finally:
        for attr, value in saved.items():
            setattr(module, attr, value)


def k6_stamps(module, lib, version):
    return [patched_run(module, attrs,
                        lambda label=label: [k6_shape_stamps(module, lib, name, n, label)
                                             for name, n in K6_SHAPES])
            for label, attrs in variants(module, version)]


def nuts_stamps(module, lib, version):
    return [patched_run(module, attrs,
                        lambda label=label: [nuts_shape_stamps(module, lib, n, label)
                                             for n in NUTS_SHAPES])
            for label, attrs in variants(module, version)]


def timed_variants(this, name, call):
    """{variant: a call of this tree's wrapper with the variant set}."""
    return {key: (lambda attrs=attrs: patched_run(this, attrs, call))
            for key, attrs in VARIANTS[name].items()}


def k6_times(parent, this):
    from pgmpy_tpu_torch.utils.mathext import seeded_generator

    gen = seeded_generator(0)
    out = []
    for name, n in K6_SHAPES:
        tables, codes = k6_inputs(this, name, n)
        calls = timed_variants(this, "gibbs", lambda: this.sweep_cuda(tables, codes, gen))
        if parent:
            old, old_codes = k6_inputs(parent, name, n)
            calls = {"parent": lambda: parent.sweep_cuda(old, old_codes, gen), **calls}
        out.append(turns("gibbs_sweep", f"{name}_{n}", calls))
    return out


def k8_times(parent, this):
    from pgmpy_tpu_torch.utils.mathext import seeded_generator

    gen = seeded_generator(0)
    out = []
    for n in NUTS_SHAPES:
        target, z = nuts_inputs(this, n)
        calls = timed_variants(this, "hmc",
                               lambda: this.nuts_step_cuda(target, z, 0.17, 6, gen=gen))
        if parent:
            old_target, old_z = nuts_inputs(parent, n)
            calls = {"parent": lambda: parent.nuts_step_cuda(old_target, old_z, 0.17, 6,
                                                             gen=gen), **calls}
        out.append(turns("nuts_step", f"ecoli70_{n}", calls))
    target, z = nuts_inputs(this, 64)
    calls = timed_variants(this, "hmc", lambda: this.hmc_step_cuda(target, z, 0.17, 17, gen=gen,
                                                                   transitions=150))
    if parent:
        old_target, old_z = nuts_inputs(parent, 64)
        calls = {"parent": lambda: parent.hmc_step_cuda(old_target, old_z, 0.17, 17, gen=gen,
                                                        transitions=150), **calls}
    out.append(turns("hmc_step", "ecoli70_64x150x17", calls))
    return out


# --------------------------------------------------------------------------- #
# K5 with K9's slice
# --------------------------------------------------------------------------- #
K5_ROWS = 52_048  # MUNIN's simulate in chip_smoke.py
K9_PARTICLES = 262_144  # chip_smoke.ALARM_PARTICLES
_K5_MODELS = {}


def k5_models():
    """MUNIN's sampler and ALARM's 2-TBN particle filter (chip_smoke's), made
    once."""
    if not _K5_MODELS:
        import chip_smoke
        from pgmpy_tpu_torch.sampling import CompiledAncestralSampler
        from pgmpy_tpu_torch.sampling.smc import ParticleFilter
        from pgmpy_tpu_torch.utils import get_example_model

        _K5_MODELS["munin"] = CompiledAncestralSampler(get_example_model("munin"))
        alarm = get_example_model("alarm")
        dbn, _, _ = chip_smoke.alarm_2tbn(alarm, chip_smoke.ALARM_PERSISTENT)
        _K5_MODELS["alarm"] = ParticleFilter(dbn, n_particles=K9_PARTICLES)
        _K5_MODELS["leaves"] = sorted((v for v in alarm.nodes() if not alarm.get_children(v)),
                                      key=str)[:3]
    return _K5_MODELS["munin"], _K5_MODELS["alarm"]


def k5_shapes(module):
    """{shape: (the shape's tables built by ``module``, rows, the call's
    keyword arguments)}: MUNIN's sweep, and ALARM's transition slice with
    three leaves observed at state 0 (``tools/time_gather_kernels.py``'s)
    from random previous particles."""
    munin, pf = k5_models()
    spec = pf._trans_specs
    slice_tables = module.SweepTables(spec.node_specs, spec.cards, pf._out_dtype,
                                      columns=spec.columns, particle=True)
    evidence = {i: 0 for i, c in enumerate(spec.columns)
                if pf.variables[c] in _K5_MODELS["leaves"]}
    rng = np.random.default_rng(0)
    prev = torch.as_tensor(np.stack([rng.integers(0, pf.cards[v], K9_PARTICLES)
                                     for v in pf.variables]), device="cuda").to(pf._out_dtype)
    return {
        f"munin_{K5_ROWS}": (module.SweepTables(munin._node_specs, munin.cards, munin._out_dtype),
                             K5_ROWS, {}),
        f"alarm_slice_{K9_PARTICLES}": (slice_tables, K9_PARTICLES,
                                        {"evidence": evidence, "prev": prev,
                                         "out": pf._code_matrix()}),
    }


def k5_tile(module, tables, n):
    """The tile the version's wrapper launches with."""
    code_bytes = torch.empty((), dtype=tables.out_dtype).element_size()
    if not hasattr(module, "card_resident"):  # ae46b85: rows from the default 48 KB
        return module.plan_tile(len(tables.cards), code_bytes, tables.groups)
    return module.plan_tile(len(tables.cards), code_bytes, tables.groups, n,
                            torch.cuda.get_device_properties(0).multi_processor_count,
                            tables.stage_bytes,
                            module.card_resident(torch.device("cuda", 0),
                                                 tables.node_specs[0][2].element_size(),
                                                 code_bytes))


def k5_stamps(module, lib, version):
    from pgmpy_tpu_torch.utils.mathext import seeded_generator

    split = (("parent_index", "uniform", "row_read_and_count") if hasattr(module, "cdf_rows")
             else ("parent_index", "row_first_read", "race"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for shape, (tables, n, kwargs) in k5_shapes(module).items():
        gen = seeded_generator(0)
        for _ in range(2):
            module.sweep_cuda(tables, n, gen, **kwargs)
        torch.cuda.synchronize()
        clear(lib)
        module.sweep_cuda(tables, n, gen, **kwargs)
        torch.cuda.synchronize()
        row = {"label": version, "shape": shape, **level_stamps(lib, tables.n_levels,
                                                                tables.groups)}
        node = read(lib, 4, BLOCKS * THREADS * 4).reshape(-1, 4)
        node = node[node[:, 3] > 0]
        row["draws_per_thread"] = round(float(node[:, 3].mean()), 2)
        row["cycles_per_draw"] = {key: round(float(node[:, j].sum() / node[:, 3].sum()), 1)
                                  for j, key in enumerate(split)}
        rows, _, shared = k5_tile(module, tables, n)
        row.update(rows=rows, threads=rows * tables.groups, shared_bytes=shared,
                   blocks=-(-n // rows),
                   blocks_per_sm=occupancy(lib, rows * tables.groups, shared))
        row["rounds"] = round(row["blocks"] / (row["blocks_per_sm"] * sms), 3)
        print(f"k5 {version} {shape} blocks={row['blocks']} rows={rows} "
              f"threads={row['threads']} shared_bytes={shared} blocks_per_sm="
              f"{row['blocks_per_sm']} rounds={row['rounds']} levels={row['levels']} "
              f"groups={row['groups']} critical_path_cycles={row['critical_path_cycles']} "
              f"busiest_group_sum_cycles={row['busiest_group_sum_cycles']} "
              f"mean_group_sum_cycles={row['mean_group_sum_cycles']} level_cycles "
              f"{row['level_cycles']} busiest_group_cycles {row['busiest_group_cycles']} "
              f"mean_group_cycles {row['mean_group_cycles']} draws_per_thread "
              f"{row['draws_per_thread']} cycles_per_draw {row['cycles_per_draw']}", flush=True)
        out.append(row)
    return out


# this tree's sweep under other settings: threads a row at most, stage bytes
K5_VARIANTS = {"groups12": {"GROUPS": 12}, "groups16": {"GROUPS": 16},
               "stage4k": {"STAGE_BYTES": 4400}, "stage16k": {"STAGE_BYTES": 16 * 1024},
               "groups16_stage16k": {"GROUPS": 16, "STAGE_BYTES": 16 * 1024}}


def k5_times(parent, this):
    from pgmpy_tpu_torch.utils.mathext import seeded_generator

    gen = seeded_generator(0)
    shapes = k5_shapes(this)
    old = k5_shapes(parent) if parent else {}
    out = []
    variants = {name: patched_run(this, attrs, lambda: k5_shapes(this))
                for name, attrs in K5_VARIANTS.items()}
    for shape, (tables, n, kwargs) in shapes.items():
        calls = {"this": lambda t=tables, n=n, k=kwargs: this.sweep_cuda(t, n, gen, **k)}
        for name, built in variants.items():
            t = built[shape][0]
            if (t.groups, t.n_levels, t.stage_nodes) != (tables.groups, tables.n_levels,
                                                          tables.stage_nodes):
                calls[f"this_{name}"] = lambda t=t, n=n, k=kwargs: this.sweep_cuda(t, n, gen, **k)
        if parent:
            t_old, _, k_old = old[shape]
            calls = {"parent": lambda: parent.sweep_cuda(t_old, n, gen, **k_old), **calls}
        out.append(turns("ancestral_sweep", shape, calls))
    return out


# --------------------------------------------------------------------------- #
# K3
# --------------------------------------------------------------------------- #
_K3_CALL = []


def k3_call():
    """The contraction a 2,048-row MUNIN ``query_batch`` hands K3 (the smoke's
    query and evidence on MUNIN's own CPDs), captured once."""
    if not _K3_CALL:
        import chip_smoke
        from pgmpy_tpu_torch.inference import BeliefPropagation, bp
        from pgmpy_tpu_torch.utils import get_example_model

        model = get_example_model("munin")
        nodes = sorted(model.nodes(), key=str)
        q_var, e_var = nodes[0], nodes[len(nodes) // 2]
        states = model.states[e_var]
        batch_ev = {e_var: [states[i % len(states)] for i in range(chip_smoke.BATCH_ROWS)]}
        tree = BeliefPropagation(model)
        tree.calibrate()
        _K3_CALL.append(chip_smoke.capture_contractions(
            lambda: tree.query_batch([q_var], batch_ev), [bp])[-1])
    return _K3_CALL[0]


def k3_table(module, schedule=None):
    axes, out, arrays = k3_call()
    shapes = tuple(tuple(a.shape) for a in arrays)
    strides = tuple(tuple(a.stride()) for a in arrays)
    plan = module.contraction_plan(axes, out, shapes)
    return module.PlanTable(axes, out, shapes, strides, arrays[0].element_size(), plan,
                            schedule=schedule)


def k3_ve_call():
    """The contraction of a MUNIN ``VariableElimination`` query (the smoke's
    query and evidence on MUNIN's own CPDs: 28 steps in 12 levels), captured
    once."""
    if not _K3_CALL[1:]:
        import chip_smoke
        from pgmpy_tpu_torch.inference import VariableElimination, ve
        from pgmpy_tpu_torch.utils import get_example_model

        k3_call()
        model = get_example_model("munin")
        nodes = sorted(model.nodes(), key=str)
        q_var, e_var = nodes[0], nodes[len(nodes) // 2]
        _K3_CALL.append(chip_smoke.capture_contractions(
            lambda: VariableElimination(model).query(
                [q_var], evidence={e_var: model.states[e_var][0]}), [ve])[-1])
    return _K3_CALL[1]


def k3_block_stamps(module, lib, version):
    """``plan_block`` on the VE query's contraction: its staging and per
    level the release (thread 0's clock from the launch's start) and each
    warp's wait at the level's barrier."""
    axes, out, arrays = k3_ve_call()
    shapes = tuple(tuple(a.shape) for a in arrays)
    table = module.PlanTable(axes, out, shapes, tuple(tuple(a.stride()) for a in arrays),
                             arrays[0].element_size(), module.contraction_plan(axes, out, shapes),
                             schedule="plan_block")
    for _ in range(2):
        module.launch_plan(table, arrays)
    torch.cuda.synchronize()
    clear(lib)
    module.launch_plan(table, arrays)
    torch.cuda.synchronize()
    levels = table.n_levels
    release = read(lib, 0, BLOCKS * LEVELS).reshape(BLOCKS, LEVELS)[0, :levels]
    wait = read(lib, 1, BLOCKS * LEVELS * GROUPS).reshape(BLOCKS, LEVELS, GROUPS)[
        0, :levels, :module.SCAN_WARPS]
    staging = int(read(lib, 5, 1)[0])
    begin = np.concatenate([[staging], release[:-1]])
    span = release - begin
    row = {"label": version, "shape": "munin_ve_query", "steps": len(table.steps),
           "levels": levels, "level_sizes": np.bincount(table.levels).tolist(),
           "staged": bool(table.staged), "shared_bytes": int(table.shared_bytes),
           "staging_cycles": staging, "level_cycles": span.tolist(),
           "busiest_warp_cycles": (span[:, None] - wait).max(axis=1).tolist(),
           "mean_wait_cycles": wait.mean(axis=1).round().astype(int).tolist(),
           "total_cycles": int(release[-1])}
    print(f"k3 {version} plan_block munin_ve_query steps={row['steps']} levels={levels} "
          f"level_sizes {row['level_sizes']} staged={row['staged']} shared_bytes="
          f"{row['shared_bytes']} staging_cycles {staging} level_cycles {row['level_cycles']} "
          f"busiest_warp_cycles {row['busiest_warp_cycles']} mean_wait_cycles "
          f"{row['mean_wait_cycles']} total_cycles {row['total_cycles']}", flush=True)
    return [row]


def k3_stamps(module, lib, version):
    rows = k3_block_stamps(module, lib, version) if hasattr(module, "deal_levels") else []
    if "plan_grid" not in module.LAUNCHES:
        print(f"k3 {version}: no plan_grid to stamp", flush=True)
        return rows
    arrays = k3_call()[2]
    table = k3_table(module, "plan_grid")
    for _ in range(2):
        module.launch_plan(table, arrays)
    torch.cuda.synchronize()
    clear(lib)
    module.launch_plan(table, arrays)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = occupancy(lib, module.GRID_THREADS, 0)
    blocks = min(table.grid, per_sm * sms)
    n_steps = len(table.steps)
    steps = read(lib, 5, BLOCKS * STEPS * 2).reshape(BLOCKS, STEPS, 2)[:min(blocks, BLOCKS),
                                                                       :n_steps]
    row = {"label": version, "shape": "munin_query_batch_2048", "steps": n_steps,
           "grid_wanted": table.grid, "blocks_per_sm": per_sm, "blocks": blocks,
           "out_counts": table.steps[:, 6].tolist(), "red_counts": table.steps[:, 7].tolist(),
           "lanes": table.steps[:, 8].tolist(),
           "tasks_block0_cycles": steps[0, :, 0].tolist(),
           "tasks_slowest_cycles": steps[:, :, 0].max(axis=0).tolist(),
           "barrier_mean_cycles": steps[:, :, 1].mean(axis=0).round().astype(int).tolist()}
    row["block0_total_cycles"] = int(steps[0].sum())
    print(f"k3 {version} plan_grid munin_query_batch_2048 steps={n_steps} blocks={blocks} "
          f"(wanted {table.grid}, {per_sm} a multiprocessor) out_counts {row['out_counts']} "
          f"red_counts {row['red_counts']} lanes {row['lanes']} tasks_block0_cycles "
          f"{row['tasks_block0_cycles']} tasks_slowest_cycles {row['tasks_slowest_cycles']} "
          f"barrier_mean_cycles {row['barrier_mean_cycles']} block0_total_cycles "
          f"{row['block0_total_cycles']}", flush=True)
    return rows + [row]


# plan_grid's variants: (reduced entries a lane is aimed at, blocks at most)
K3_GRIDS = ((32, None), (8, None), (8, 264), (8, 132), (16, 132), (4, 264))


def k3_times(parent, this):
    axes, out, arrays = k3_call()
    block = k3_table(this, "plan_block")
    grids = {}
    for entries, most in K3_GRIDS:
        attrs = {"GRID_LANE_ENTRIES": entries, "MAX_GRID_BLOCKS": most or this.MAX_GRID_BLOCKS}
        grids[f"{entries}_{most or 'all'}"] = patched_run(
            this, attrs, lambda: k3_table(this, "plan_grid"))
    dense, args = {}, []
    for a, ax in zip(arrays, axes):
        args += [a, [dense.setdefault(label, len(dense)) for label in ax]]
    args.append([dense[label] for label in out])
    calls = {**{f"plan_grid_{e}": (lambda g=g: this.launch_plan(g, arrays))
                for e, g in grids.items()},
             "plan_block": lambda: this.launch_plan(block, arrays),
             "torch_einsum": lambda: torch.einsum(*args)}
    if parent:
        old = k3_table(parent)
        calls = {f"parent_{old.schedule}": lambda: parent.launch_plan(old, arrays), **calls}
    out = [turns("einsum_plan", "munin_query_batch_2048", calls)]
    # plan_block on the VE query: the parent's, this tree's (its tables
    # staged, and read from global memory), plan_grid and torch.einsum
    axes, outs, arrays = k3_ve_call()
    shapes = tuple(tuple(a.shape) for a in arrays)

    def table(module, schedule, **attrs):
        return patched_run(module, attrs, lambda: module.PlanTable(
            axes, outs, shapes, tuple(tuple(a.stride()) for a in arrays),
            arrays[0].element_size(), module.contraction_plan(axes, outs, shapes),
            schedule=schedule))

    tables = {"plan_block": table(this, "plan_block"),
              "plan_block_global": table(this, "plan_block", SCAN_STAGE_BYTES=0),
              "plan_grid": table(this, "plan_grid")}
    dense, args = {}, []
    for a, ax in zip(arrays, axes):
        args += [a, [dense.setdefault(label, len(dense)) for label in ax]]
    args.append([dense[label] for label in outs])
    calls = {key: (lambda t=t: this.launch_plan(t, arrays)) for key, t in tables.items()}
    calls["torch_einsum"] = lambda: torch.einsum(*args)
    if parent:
        old = table(parent, "plan_block")
        calls = {"parent_plan_block": lambda: parent.launch_plan(old, arrays), **calls}
    out.append(turns("einsum_plan", "munin_ve_query", calls))
    return out


# --------------------------------------------------------------------------- #
# K10 and K11
# --------------------------------------------------------------------------- #
_INPUTS = {}


def k10_calls(module):
    """{shape: (program, alpha, transition tensors, codes)} of this tree's
    ``filter_scan`` (``module`` the wrapper; the parent's takes its deltas'
    program and int32 codes on the card): ALARM as a 2-TBN over 49 slices
    and rain / umbrella over 199, chip_smoke's inputs."""
    import chip_smoke
    from pgmpy_tpu_torch.factors.factor_ops import factor_sum_product
    from pgmpy_tpu_torch.inference import DBNInference
    from pgmpy_tpu_torch.utils import get_example_model

    if "k10" not in _INPUTS:
        alarm = get_example_model("alarm")
        dbn, persistent, _ = chip_smoke.alarm_2tbn(alarm, chip_smoke.ALARM_PERSISTENT)
        leaves = sorted((v for v in alarm.nodes() if not alarm.get_children(v)),
                        key=str)[:chip_smoke.ALARM_EVIDENCE_LEAVES]
        truth = chip_smoke.dbn_trajectory(dbn, chip_smoke.ALARM_SLICES, chip_smoke.SEED)
        ev = {(v, t): truth[(v, t)] for v in leaves for t in range(chip_smoke.ALARM_SLICES)}
        rain_ev = {("umbrella", t): t % 2 for t in range(0, chip_smoke.PF_SLICES, 3)}
        _INPUTS["k10"] = {}
        for shape, model, variables, evidence, slices in (
                ("alarm_2tbn_49", dbn, persistent, ev, chip_smoke.ALARM_SLICES),
                ("rain_umbrella_199", chip_smoke.rain_umbrella_dbn(), ["rain"], rain_ev,
                 chip_smoke.PF_SLICES)):
            infer = DBNInference(model)
            inputs = infer._scan_inputs(variables, evidence, slices)
            alpha = factor_sum_product(inputs["iface0"], inputs["factors0"]).normalize(
                inplace=False).values
            _INPUTS["k10"][shape] = (inputs, alpha)
    out = {}
    for shape, (inputs, alpha) in _INPUTS["k10"].items():
        trans = inputs["trans_arrays"]
        shapes = [inputs["alpha_shape"]] + [tuple(a.shape) for a in trans] + [
            (c,) for c in inputs["delta_cards"]]
        program = module.ScanProgram(inputs["operand_axes"], inputs["outputs"], shapes,
                                     [tuple(a.stride()) for a in trans], alpha.element_size())
        codes = inputs["codes"] if hasattr(program, "tables_for") else torch.as_tensor(
            inputs["codes"], dtype=torch.int32, device="cuda")
        out[shape] = (program, alpha, trans, codes)
    return out


def barrier_cycles(lib, threads=512, iters=4096):
    """Cycles a round of the dependency probe: a dependent shared-memory read
    and a barrier, and the read alone."""
    import ctypes

    fn = lib.pgmpy_stamps_barrier
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = {}
    for barrier in (1, 0):
        buf = torch.zeros(2, dtype=torch.int64, device="cuda")
        runs = []
        for _ in range(5):
            err = fn(threads, iters, barrier, buf.data_ptr())
            if err:
                raise RuntimeError(f"barrier probe failed: cudaError_t {err}")
            runs.append(int(buf[0]) / iters)
        out["read_and_barrier" if barrier else "read"] = round(float(np.median(runs)), 2)
    return out


def k10_stamps(module, lib, version):
    if not hasattr(module, "deal_level"):
        print(f"k10 {version}: no level schedule to stamp", flush=True)
        return []
    rows = []
    probe = barrier_cycles(lib)
    print(f"k10 {version} dependency probe (512 threads, cycles a round) {probe}", flush=True)
    for shape, (program, alpha, trans, codes) in k10_calls(module).items():
        for _ in range(2):
            program.run(alpha, trans, codes)
        torch.cuda.synchronize()
        clear(lib)
        program.run(alpha, trans, codes)
        torch.cuda.synchronize()
        slices = min(len(codes), BLOCKS)
        phases = program.n_levels + 1
        release = read(lib, 0, BLOCKS * LEVELS).reshape(BLOCKS, LEVELS)[:slices, :phases]
        wait = read(lib, 1, BLOCKS * LEVELS * GROUPS).reshape(BLOCKS, LEVELS, GROUPS)[
            :slices, :phases, :module.SCAN_WARPS]
        # a phase begins at the release of the one before (the slice's
        # first at the previous slice's last; the launch's first at 0)
        previous = np.concatenate([[0], release[:-1, -1]])
        begin = np.concatenate([previous[:, None], release[:, :-1]], axis=1)
        span = release - begin
        work = span[:, :, None] - wait  # each warp's own clock: its wait at the barrier
        row = {"label": version, "shape": shape, "slices": int(len(codes)),
               "levels": program.n_levels, "steps": len(program.steps),
               "level_sizes": np.bincount(program.levels).tolist(),
               "phase_cycles": span.mean(axis=0).round().astype(int).tolist(),
               "busiest_warp_cycles": work.max(axis=2).mean(axis=0).round().astype(int).tolist(),
               "mean_wait_cycles": wait.mean(axis=(0, 2)).round().astype(int).tolist(),
               "slice_cycles": int(span.sum(axis=1).mean()), "dependency_probe": probe}
        print(f"k10 {version} {shape} levels={row['levels']} steps={row['steps']} level_sizes "
              f"{row['level_sizes']} slice_cycles {row['slice_cycles']} phase_cycles "
              f"{row['phase_cycles']} busiest_warp_cycles {row['busiest_warp_cycles']} "
              f"mean_wait_cycles {row['mean_wait_cycles']}", flush=True)
        rows.append(row)
    return rows


def k10_task_stamps(module, lib, version):
    """Thread 0's tasks: the mean cycles of setting up a task's inputs, its
    partial sum and its shuffles with the store, and of reading its level's
    work range, over one launch of each shape."""
    if not hasattr(module, "deal_level"):
        print(f"k10tasks {version}: no level schedule to stamp", flush=True)
        return []
    rows = []
    for shape, (program, alpha, trans, codes) in k10_calls(module).items():
        program.run(alpha, trans, codes)
        torch.cuda.synchronize()
        clear(lib)
        program.run(alpha, trans, codes)
        torch.cuda.synchronize()
        counts = read(lib, 5, 2)
        tasks = read(lib, 4, 4 * int(counts[0])).reshape(-1, 4)
        entries = read(lib, 2, int(counts[1]))
        row = {"label": version, "shape": shape, "thread0_tasks": int(counts[0]),
               "inputs_cycles": round(float(tasks[:, 0].mean()), 1),
               "partial_cycles": round(float(tasks[:, 1].mean()), 1),
               "shuffle_and_store_cycles": round(float(tasks[:, 2].mean()), 1),
               "work_range_cycles": round(float(entries.mean()), 1)}
        print(f"k10tasks {version} {shape} " + " ".join(f"{k} {v}" for k, v in row.items()
                                                          if k not in ("label", "shape")),
              flush=True)
        rows.append(row)
    return rows


def k10_times(parent, this):
    out = []
    new = k10_calls(this)
    old = k10_calls(parent) if parent else {}
    for shape, (program, alpha, trans, codes) in new.items():
        calls = {"this": lambda p=program, a=alpha, t=trans, c=codes: p.run(a, t, c),
                 "this_tables_global": lambda p=program, a=alpha, t=trans, c=codes: patched_run(
                     this, {"SCAN_STAGE_BYTES": 0}, lambda: p.run(a, t, c))}
        if shape in old:
            p, a, t, c = old[shape]
            calls = {"parent": lambda: p.run(a, t, c), **calls}
        out.append(turns("filter_scan", shape, calls))
    return out


def k11_inputs():
    """MUNIN's E-step with DIFFN_PATHO latent at 5 states (chip_smoke's
    shape): the program over 50,000 simulated rows and a log table."""
    if "k11" not in _INPUTS:
        from pgmpy_tpu_torch.estimators.base import _CodedData
        from pgmpy_tpu_torch.estimators.em import _EMProgram
        from pgmpy_tpu_torch.utils import get_example_model

        model = get_example_model("munin")
        frame = model.simulate(50_000, seed=3, show_progress=False).drop(columns=["DIFFN_PATHO"])
        coded = _CodedData(frame)
        var_order = sorted(model.nodes(), key=str)
        parents = {v: sorted(model.get_parents(v), key=str) for v in var_order}
        cards = dict(coded.cards, DIFFN_PATHO=5)
        names = dict(coded.state_names, DIFFN_PATHO=list(range(5)))
        program = _EMProgram(coded, var_order, parents, ["DIFFN_PATHO"], cards, names, 1000)
        prob = torch.rand(program.gather.total, dtype=torch.float64, device="cuda") + 1e-3
        _INPUTS["k11"] = (program, coded, torch.log(prob))
    return _INPUTS["k11"]


def k11_call(module, latent_only=False):
    """A call of ``module``'s E-step at MUNIN's shape: this tree's over the
    observed rows (with ``latent_only``, its latent nodes alone: the shared
    nodes' sum is the same for every k and cancels in the softmax, so the
    weights agree to rounding), the parent's over the expanded rows."""
    program, coded, table = k11_inputs()
    if hasattr(module, "LatentGather"):
        specs, gather = program.specs, program.gather
        cols = _latent_cols(program)
        keep = [i for i, c in enumerate(cols) if min(c) < 0 or not latent_only]
        g = module.LatentGather(
            [cols[i] for i in keep], [specs.strides[i, :specs.n_cols[i]] for i in keep],
            specs.offsets[keep], specs.total, gather.grid, torch.device("cuda"))
        codes = coded._column_codes()[:, :coded.n]
        return g, lambda: g.e_step_cuda(table, codes, torch.float32)
    specs = program.specs
    n = len(program.var_order)
    g = module.TableGather([specs.cols[s, :specs.n_cols[s]] for s in range(n)],
                           [specs.strides[s, :specs.n_cols[s]] for s in range(n)], specs.offsets,
                           specs.total, torch.device("cuda"))
    expanded = program.coded._column_codes()[:, :program.coded.n]
    return g, lambda: g.e_step_cuda(table, expanded, program.K, torch.float32)


def _latent_cols(program):
    """Each node's E-step columns, as ``_EMProgram`` gives them."""
    specs, obs = program.specs, program.obs
    latents = [v for v in program.var_order if v not in obs.var_index]  # sorted, as the program's
    source = {v: -1 - j for j, v in enumerate(latents)}
    source.update({v: obs.var_index[v] for v in program.var_order if v in obs.var_index})
    return [[source[program.var_order[c]] for c in specs.cols[s, :specs.n_cols[s]]]
            for s in range(len(program.var_order))]


def k11_stamps(module, lib, version):
    if not hasattr(module, "LatentGather"):
        print(f"k11 {version}: no observed-row E-step to stamp", flush=True)
        return []
    gather, call = k11_call(module)
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    clear(lib)
    call()
    torch.cuda.synchronize()
    n_shared, n_latent = len(gather.shared_nodes), len(gather.latent_nodes)
    rows, slices, block, smem = module.plan_e_step(gather.K, gather.width, n_shared, n_latent,
                                                   gather.L)
    per_sm = occupancy(lib, block, smem)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warps = block // 32
    tiles = read(lib, 0, BLOCKS * LEVELS).reshape(BLOCKS, LEVELS)[:, 0]
    piece = read(lib, 3, BLOCKS * GROUPS * 4).reshape(BLOCKS, GROUPS, 4)[:, :warps]
    used = tiles > 0
    per_tile = piece[used] / tiles[used][:, None, None]
    keys = ("shared_slice", "latent_tasks", "barrier_wait", "softmax_and_writes")
    out = {"label": version, "shape": "munin_50000_K5", "tile_rows": rows,
           "latent_slices": slices, "block": block, "smem": smem,
           "blocks_per_sm": per_sm, "blocks": min(per_sm * sms, -(-50_000 // rows)),
           "blocks_stamped": int(used.sum()), "tiles_per_block": float(tiles[used].mean()),
           "mean_cycles_per_tile": {k: round(float(per_tile[:, :, j].mean()), 1)
                                    for j, k in enumerate(keys)},
           "slowest_warp_cycles_per_tile": {k: round(float(per_tile[:, :, j].max(axis=1).mean()),
                                                      1) for j, k in enumerate(keys)}}
    print(f"k11 {version} munin_50000_K5 tile_rows={rows} latent_slices={slices} block={block} "
          f"smem={smem} blocks_per_sm={per_sm} blocks={out['blocks']} "
          f"tiles_per_block {out['tiles_per_block']:.2f} mean_cycles_per_tile "
          f"{out['mean_cycles_per_tile']} slowest_warp_cycles_per_tile "
          f"{out['slowest_warp_cycles_per_tile']}", flush=True)
    return [out]


def k11_times(parent, this):
    _, call = k11_call(this)
    full = call()
    latent, latent_call = k11_call(this, latent_only=True)
    gap = float((latent_call().double() - full.double()).abs().max())
    print(f"e_step latent nodes alone ({len(latent.latent_nodes)}, no shared): max abs gap "
          f"{gap:.3e} to the full sum's weights", flush=True)
    calls = {"this": call, "this_latent_only": latent_call,
             "this_block_128": lambda: patched_run(this, {"E_STEP_BLOCK": 128}, call)}
    if parent:
        _, old = k11_call(parent)
        calls = {"parent": old, **calls}
    return [turns("e_step", "munin_50000_K5", calls)]


def k13_inputs():
    """MUNIN's 50,000 simulated rows as ``BayesianModelProbability`` codes
    them (chip_smoke's K13 shape, MUNIN's own CPDs)."""
    if "k13" not in _INPUTS:
        from pgmpy_tpu_torch.metrics import BayesianModelProbability
        from pgmpy_tpu_torch.utils import get_example_model

        model = get_example_model("munin")
        prob = BayesianModelProbability(model)
        codes = prob._encode(model.simulate(50_000, seed=3, show_progress=False))
        _INPUTS["k13"] = (prob, codes)
    return _INPUTS["k13"]


def k13_call(module):
    """A ``row_sums`` call of ``module``'s kernel at MUNIN's shape."""
    import chip_smoke

    prob, codes = k13_inputs()
    gather = chip_smoke.k13_parent_gather(prob, module)
    return gather, lambda: gather.row_sums_cuda(prob._table, codes)


def k13_stamps(module, lib, version):
    if not hasattr(module, "ROW_TILE"):
        print(f"k13 {version}: no row tiles to stamp", flush=True)
        return []
    _, call = k13_call(module)
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    clear(lib)
    call()
    torch.cuda.synchronize()
    rows, slices, block, smem, tiles = module.plan_rows(50_000)
    per_sm = occupancy(lib, block, smem)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warps = block // 32
    count = read(lib, 0, BLOCKS * LEVELS).reshape(BLOCKS, LEVELS)[:, 0]
    piece = read(lib, 3, BLOCKS * GROUPS * 4).reshape(BLOCKS, GROUPS, 4)[:, :warps]
    used = count > 0
    per_tile = piece[used] / count[used][:, None, None]
    keys = ("slice", "barrier_wait", "unused", "combine_and_store")
    out = {"label": version, "shape": "munin_50000", "tile_rows": rows, "slices": slices,
           "block": block, "smem": smem, "blocks_per_sm": per_sm,
           "blocks": min(per_sm * sms, tiles), "blocks_stamped": int(used.sum()),
           "tiles_per_block": float(count[used].mean()),
           "mean_cycles_per_tile": {k: round(float(per_tile[:, :, j].mean()), 1)
                                    for j, k in enumerate(keys) if k != "unused"},
           "slowest_warp_cycles_per_tile": {
               k: round(float(per_tile[:, :, j].max(axis=1).mean()), 1)
               for j, k in enumerate(keys) if k != "unused"}}
    print(f"k13 {version} munin_50000 tile_rows={rows} slices={slices} block={block} "
          f"blocks_per_sm={per_sm} blocks={out['blocks']} tiles_per_block "
          f"{out['tiles_per_block']:.2f} mean_cycles_per_tile {out['mean_cycles_per_tile']} "
          f"slowest_warp_cycles_per_tile {out['slowest_warp_cycles_per_tile']}", flush=True)
    return [out]


# row_sums' variants: (rows a tile, threads a block)
K13_TILES = ((16, 256), (8, 256), (32, 128), (64, 256))


def k13_times(parent, this):
    _, call = k13_call(this)
    calls = {"this": call}
    for tile, block in K13_TILES:
        calls[f"this_tile{tile}_block{block}"] = (
            lambda t=tile, b=block: patched_run(this, {"ROW_TILE": t, "ROW_BLOCK": b}, call))
    if parent:
        _, old = k13_call(parent)
        calls = {"parent": old, **calls}
    return [turns("row_sums", "munin_50000", calls)]


PROBES = {
    "k3": Probe("einsum", "einsum_plan.cu", k3_stamps, k3_times),
    "k10": Probe("einsum", "einsum_plan.cu", k10_stamps, k10_times, edits="k10"),
    "k10tasks": Probe("einsum", "einsum_plan.cu", k10_task_stamps, k10_times, edits="k10tasks"),
    "k11": Probe("table_gather", "table_gather.cu", k11_stamps, k11_times, edits="k11"),
    "k13": Probe("table_gather", "table_gather.cu", k13_stamps, k13_times, edits="k13"),
    "k5": Probe("ancestral", "ancestral.cu", k5_stamps, k5_times),
    "k6": Probe("gibbs", "gibbs.cu", k6_stamps, k6_times),
    "k8": Probe("hmc", "hmc.cu", nuts_stamps, k8_times),
}


def main():
    import importlib

    args = sys.argv[1:]
    if not args or args[0] not in PROBES:
        print(__doc__)
        return 2
    probe, versions = PROBES[args[0]], args[1:] or ["parent", "this"]
    if not torch.cuda.is_available():
        print("stamp_kernels: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    config.set_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    result = {"device": smi, "kernel": args[0]}
    wrappers = {probe.wrapper: probe.source}
    builds = {}
    for version in versions:
        try:
            builds[version] = parent_kernels.start_builds(diag_tree(version, probe), wrappers)
        except RuntimeError as err:  # a version with no stamp anchors: timed only
            print(f"stamps {version}: {err}", flush=True)
    plain = parent_kernels.start_builds(wrappers=wrappers) if parent_kernels.available() else None
    this = importlib.import_module(f"pgmpy_tpu_torch.ops.{probe.wrapper}")
    this._library()
    for name, built in _build.BUILDS.items():
        for line in chip_smoke.ptxas_summary(built["ptxas"]):
            print(f"ptxas this {name} {line}", flush=True)
    for version in builds:
        modules, report = parent_kernels.load(builds[version])
        for name, (seconds, ptxas) in report.items():
            for line in chip_smoke.ptxas_summary(ptxas):
                print(f"ptxas stamped {version} {name} {line}", flush=True)
        module = modules[probe.wrapper]
        result[version] = probe.stamps(module, module.load_library(), version)
    parent = None
    if plain:
        modules, report = parent_kernels.load(plain)
        parent = modules[probe.wrapper]
        for name, (seconds, ptxas) in report.items():
            for line in chip_smoke.ptxas_summary(ptxas):
                print(f"ptxas parent {name} {line}", flush=True)
    result["times"] = probe.times(parent, this)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
