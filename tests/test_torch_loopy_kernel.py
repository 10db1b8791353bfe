"""K7, loopy BP's flooding engine (``ops/loopy.py``), on the CPU.

* The plain version ``flood_reference`` against the JAX package's
  ``_FloodingProgram.run`` on the same numpy inputs: messages within 1e-5,
  rounds equal (the 8 x 8 grid with virtual evidence and with hard evidence,
  a loopy graph of unary, pairwise and triple factors with cardinalities 2,
  3 and 5).
* A float64 numpy walk of what ``csrc/loopy_bp.cu`` computes, read from the
  ``FloodPlan``'s tables as its threads read them (per edge the CSR row of
  its variable, the table walked with its own axis held by an odometer over
  the others, the double-buffered messages, the centred logs carried from
  phase 2 to the next round's phase 1, the per-round stop), against the
  plain version at 1e-12 with rounds equal.  It is the only CPU check of
  the kernel's arithmetic.
* The plan's tables, the arity limit and the routing of a CPU tensor.
"""

import itertools

import numpy as np
import pytest
import torch

from pgmpy_tpu.inference.fg_bp import _FloodingProgram as JaxProgram

from _torch_parity import np_values  # noqa: F401  (sets the port to the CPU)
from pgmpy_tpu_torch.ops import loopy

TOL64 = 1e-8  # the programs' default tolerance, above 4 float64 eps
TOL32 = 4.0 * float(np.finfo(np.float32).eps)  # the float32 floor of the tolerance


def grid_tables(n, seed, coupling=0.2):
    rng = np.random.default_rng(seed)
    names = [[f"x{i}_{j}" for j in range(n)] for i in range(n)]
    scopes, tables = [], []
    for i in range(n):
        for j in range(n):
            for di, dj in ((0, 1), (1, 0)):
                if i + di < n and j + dj < n:
                    scopes.append([names[i][j], names[i + di][j + dj]])
                    tables.append(np.exp(coupling * rng.standard_normal((2, 2))))
    return scopes, {v: 2 for row in names for v in row}, tables


def mixed_tables(seed=5):
    """A loopy graph of unary, pairwise and triple factors, cardinalities
    2, 3 and 5."""
    rng = np.random.default_rng(seed)
    cards = {"a": 2, "b": 3, "c": 5, "d": 2, "e": 3}
    scopes = [["a"], ["a", "b"], ["b", "c", "d"], ["c"], ["d", "e"], ["e", "a"],
              ["b", "e", "c"]]
    tables = [rng.random([cards[v] for v in s]) + 0.1 for s in scopes]
    return scopes, cards, tables


def star_tables(leaves, seed=0):
    rng = np.random.default_rng(seed)
    scopes = [["hub", f"l{k:03d}"] for k in range(leaves)]
    tables = [np.exp(0.2 * rng.standard_normal((2, 2))) for _ in range(leaves)]
    return scopes, {v: 2 for s in scopes for v in s}, tables


def zeros_tables():
    """A loop of three variables whose tables hold zeros, one slice of one
    table all zero."""
    rng = np.random.default_rng(9)
    cards = {"a": 2, "b": 3, "c": 2}
    scopes = [["a", "b"], ["b", "c"], ["c", "a"], ["b"]]
    tables = [rng.random([cards[v] for v in s]) for s in scopes]
    tables[0][0, :] = 0.0  # a = 0 allows nothing
    tables[1][1, 0] = 0.0
    tables[3][2] = 0.0
    return scopes, cards, tables


def hard_fixed(plan, states):
    """Point-mass fixed messages for ``states`` ({var: state}), 1 elsewhere
    on each edge's states."""
    fixed = plan.mask.astype(np.float64)
    for var, state in states.items():
        rows = plan.var_edges[var]
        fixed[rows, : plan.cards[rows[0]]] = 0.0
        fixed[rows, state] = 1.0
    return fixed


def virtual_fixed(plan, seed, share=0.5):
    """Random positive fixed messages on about ``share`` of the variables."""
    rng = np.random.default_rng(seed)
    fixed = plan.mask.astype(np.float64)
    for var, rows in plan.var_edges.items():
        if rng.random() < share:
            card = int(plan.cards[rows[0]])
            fixed[rows, :card] = rng.random(card) + 0.2
    return fixed


def uniform_init(plan):
    return plan.mask / plan.cards[:, None]


def reference(plan, tables, fixed, init, max_iter, tol, dtype):
    arena = plan.build_tables(tables, dtype, torch.device("cpu"))
    out = loopy.flood_reference(plan, torch.as_tensor(fixed, dtype=dtype),
                                torch.as_tensor(init, dtype=dtype), arena, max_iter, tol)
    return out.f2v.double().numpy(), int(out.rounds), float(out.delta)


# ---------------------------------------------------------------------- #
# the plain version against the JAX program
# ---------------------------------------------------------------------- #
def jax_flood(scopes, cards, tables, fixed, init):
    program = JAX_PROGRAMS.get(id(tables))
    if program is None:
        program = JAX_PROGRAMS[id(tables)] = JaxProgram(scopes, cards)
    out = program.run(fixed.astype(np.float32), init.astype(np.float32),
                      program.build_tables(tables))
    return np.asarray(out, dtype=np.float64), program.last_rounds


JAX_PROGRAMS = {}  # one JAX program (one compile) per graph
GRID8 = grid_tables(8, seed=1)
MIXED = mixed_tables()


@pytest.mark.parametrize("case", ["grid8_virtual", "grid8_hard", "mixed"])
def test_plain_flood_matches_jax(case):
    scopes, cards, tables = MIXED if case == "mixed" else GRID8
    plan = loopy.FloodPlan(scopes, cards)
    if case == "grid8_hard":
        fixed = hard_fixed(plan, {"x0_0": 1, "x3_4": 0, "x7_7": 1})
    else:
        fixed = virtual_fixed(plan, seed=3)
    init = uniform_init(plan)
    want, want_rounds = jax_flood(scopes, cards, tables, fixed, init)
    got, rounds, _ = reference(plan, tables, fixed, init, 100, TOL32, torch.float32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert rounds == want_rounds < 100


def test_padded_tables_equal_jax_buckets():
    scopes, cards, tables = MIXED
    plan = loopy.FloodPlan(scopes, cards)
    program = JaxProgram(scopes, cards)
    padded = plan.build_tables(tables, torch.float32, torch.device("cpu")).padded()
    assert [shape for shape, _, _ in plan.groups] == [shape for shape, _, _ in program._groups]
    for got, want in zip(padded, program.build_tables(tables)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------- #
# the kernel's schedule, walked in numpy
# ---------------------------------------------------------------------- #
def nan_max(values):
    """torch.amax's maximum of a row: a NaN wins."""
    return np.nan if np.isnan(values).any() else values.max()


def centred_log(row):
    with np.errstate(divide="ignore"):
        logs = np.log(row)
    top = nan_max(logs)
    return logs - (top if np.isfinite(top) else 0.0)


def walk_flood(plan, arena, fixed, init, max_iter, tol):
    """The kernel's flood on ``plan``'s int32 tables, float64: (messages,
    rounds, last delta)."""
    words, starts = plan.host_words()
    E, C = plan.n_edges, plan.max_card
    edges = words[starts[0]:starts[1]].reshape(E, loopy.EDGE_WORDS)
    factors = words[starts[1]:starts[2]].reshape(-1, loopy.FACTOR_WORDS)
    var_offsets, var_ids = words[starts[2]:starts[3]], words[starts[3]:]
    buf = [np.where(np.arange(C)[None, :] < edges[:, 1][:, None], init, 0.0), np.zeros((E, C))]
    logs = np.array([centred_log(row) for row in buf[0]]).reshape(E, C)
    v2f = np.zeros((E, C))
    rounds, last = 0, np.inf
    for r in range(max_iter):
        cur, nxt = buf[r & 1], buf[(r + 1) & 1]
        for e in range(E):  # phase 1: a thread per edge
            var = edges[e, 3]
            row = np.empty(C)
            for c in range(C):
                total = 0.0
                for i in range(var_offsets[var], var_offsets[var + 1]):
                    if var_ids[i] != e:
                        total += logs[var_ids[i], c]
                with np.errstate(divide="ignore"):
                    row[c] = total + np.log(fixed[e, c])
            top = nan_max(row)
            row = np.exp(row - (top if np.isfinite(top) else 0.0))
            norm = row.sum()
            v2f[e] = row / norm if norm > 0 else row
        worst = 0.0
        for e in range(E):  # phase 2: a thread per edge (f, k)
            f, card, stride_k = edges[e, :3]
            offset, arity, first = factors[f]
            others = [first + j for j in range(arity) if j != e - first]
            row = np.zeros(C)
            for s in range(card):
                total = 0.0
                for digits in itertools.product(*(range(edges[o, 1]) for o in others)):
                    pos = offset + s * stride_k + sum(d * edges[o, 2] for d, o in zip(digits, others))
                    p = arena[pos]
                    for d, o in zip(digits, others):
                        p *= v2f[o, d]
                    total += p
                row[s] = total
            norm = row.sum()
            if norm > 0:
                row = row / norm
            nxt[e] = row
            d = nan_max(np.abs(row - cur[e]))
            worst = d if (d > worst or np.isnan(d)) else worst
            logs[e] = centred_log(row)
        rounds, last = r + 1, worst
        if last < tol:
            break
    return buf[rounds & 1], rounds, last


def warm_init(plan, tables, fixed):
    """Messages after two rounds from uniform: a warm start."""
    return reference(plan, tables, fixed, uniform_init(plan), 2, TOL64, torch.float64)[0]


WALK_CASES = {
    "grid8": lambda p, t: (virtual_fixed(p, seed=4), uniform_init(p), 100),
    "mixed": lambda p, t: (virtual_fixed(p, seed=6, share=1.0), uniform_init(p), 100),
    "star50": lambda p, t: (p.mask.astype(np.float64), uniform_init(p), 100),
    "zeros_hard": lambda p, t: (hard_fixed(p, {"a": 0, "c": 1}), uniform_init(p), 100),
    "warm_start": lambda p, t: (virtual_fixed(p, seed=7),
                                warm_init(p, t, virtual_fixed(p, seed=7)), 100),
    "max_iter_0": lambda p, t: (virtual_fixed(p, seed=8), uniform_init(p), 0),
    "max_iter_1": lambda p, t: (virtual_fixed(p, seed=8), uniform_init(p), 1),
}
WALK_GRAPHS = {"grid8": GRID8, "mixed": MIXED, "star50": star_tables(50), "zeros_hard":
               zeros_tables(), "warm_start": GRID8, "max_iter_0": GRID8, "max_iter_1": MIXED}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_kernel_walk_matches_plain_version(case):
    scopes, cards, tables = WALK_GRAPHS[case]
    plan = loopy.FloodPlan(scopes, cards)
    fixed, init, max_iter = WALK_CASES[case](plan, tables)
    arena = plan.build_tables(tables, torch.float64, torch.device("cpu")).arena.numpy()
    got, rounds, delta = walk_flood(plan, arena, fixed, init, max_iter, TOL64)
    want, want_rounds, want_delta = reference(plan, tables, fixed, init, max_iter, TOL64,
                                              torch.float64)
    assert rounds == want_rounds
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    if max_iter == 0:
        assert rounds == 0 and delta == want_delta == np.inf
        np.testing.assert_array_equal(got, init * plan.mask)
    else:
        assert abs(delta - want_delta) <= 1e-12
    if case == "zeros_hard":
        with np.errstate(divide="ignore"):
            assert np.isneginf(np.log(got[plan.mask])).any()  # -inf logs occurred


# ---------------------------------------------------------------------- #
# the plan, the limit, the routing, the bound
# ---------------------------------------------------------------------- #
def test_plan_csr_equals_var_edges():
    for scopes, cards, _ in (GRID8, MIXED, star_tables(50)):
        plan = loopy.FloodPlan(scopes, cards)
        assert list(plan.var_offsets[1:] - plan.var_offsets[:-1]) == \
            [len(v) for v in plan.var_edges.values()]
        for i, edges in enumerate(plan.var_edges.values()):
            assert list(plan.var_ids[plan.var_offsets[i]:plan.var_offsets[i + 1]]) == edges
            assert set(plan.edge_var[edges]) == {i}
        for f, scope in enumerate(scopes):
            offset, arity, first = plan.factor_rows[f]
            assert arity == len(scope) and offset == plan.factor_offset[f]
            assert [plan.edges[first + k] for k in range(arity)] == [(f, v) for v in scope]
            strides = np.array(np.empty([cards[v] for v in scope]).strides) // 8
            assert list(plan.edge_stride[first:first + arity]) == list(strides)


def test_arity_limit():
    wide = [[f"v{i}" for i in range(loopy.MAX_ARITY + 1)]]
    cards = {v: 2 for v in wide[0]}
    with pytest.raises(ValueError, match=f"MAX_ARITY = {loopy.MAX_ARITY}"):
        loopy.check_arity(loopy.FloodPlan(wide, cards))
    loopy.check_arity(loopy.FloodPlan([wide[0][:-1]], cards))


def test_cpu_tensor_takes_the_plain_version():
    scopes, cards, tables = MIXED
    plan = loopy.FloodPlan(scopes, cards)
    arena = plan.build_tables(tables, torch.float32, torch.device("cpu"))
    fixed = torch.as_tensor(virtual_fixed(plan, seed=2), dtype=torch.float32)
    init = torch.as_tensor(uniform_init(plan), dtype=torch.float32)
    loopy.reset_launches()
    got = loopy.flood(plan, fixed, init, arena, 100, TOL32)
    want = loopy.flood_reference(plan, fixed, init, arena, 100, TOL32)
    assert loopy.LAUNCHES == 0
    assert torch.equal(got.f2v, want.f2v) and int(got.rounds) == int(want.rounds)
    with pytest.raises(ValueError, match="CUDA"):
        loopy.flood_cuda(plan, fixed, init, arena, 100, TOL32)
    with pytest.raises(ValueError, match="fixed"):
        loopy.flood(plan, fixed.double(), init, arena, 100, TOL32)


def test_bound_counts_bytes_on_the_grid():
    plan = loopy.FloodPlan(*grid_tables(16, seed=0)[:2])
    ms, by = loopy.bound_ms(plan, 9, torch.float32)
    words = plan.edge_rows.size + plan.factor_rows.size + plan.n_edges + len(plan.var_edges) + 1
    messages = 4 * plan.n_edges * 2
    # the plan, the tables, the fixed and initial messages once; the
    # messages read and written each round
    nbytes = 4 * words + 4 * plan.arena_size + 2 * messages + 9 * 2 * messages
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert loopy.bound_ms(plan, 9, torch.float64)[0] > ms
