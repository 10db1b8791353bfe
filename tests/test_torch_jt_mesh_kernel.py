"""The model-parallel calibration (``parallel/jt_mesh.py``) as K2's part
plans, on the CPU, where every part runs the plain version of K2's kernels.

Each part is a junction-tree program of its own: its cliques, plus one
factorless boundary clique per boundary edge.  These tests hold the part
programs' structure (every internal edge in one part, every boundary edge a
boundary clique of the sepset's canonical shape in both of its parts, the
split of a calibration at ``n_up_waves``, the launches a calibration makes on
a card), a boundary message with no reduced axis, a one-clique part and a
forest, and the beliefs: to the port's single-device program in float64 at
1e-12; the port's and the JAX package's ``ShardedJunctionTreeCalibration``
in float32 each to the port's float64 calibration at atol 1e-5 and the
relative float32 rounding the part schedules allow (``rounding_limit``),
and to each other at atol 1e-5 (with normalised messages, whose boundary
sigma is normalised once more here, also at the sum of the two limits).
"""

import math

import networkx as nx
import numpy as np
import pytest
import torch

from pgmpy_tpu.inference.bp import JunctionTreeProgram as JaxProgram
from pgmpy_tpu.parallel import get_mesh as jax_get_mesh
from pgmpy_tpu.parallel.jt_mesh import ShardedJunctionTreeCalibration as JaxSharded

from _torch_parity import np_values
from pgmpy_tpu_torch.inference.bp import JunctionTreeProgram
from pgmpy_tpu_torch.ops import jt
from pgmpy_tpu_torch.parallel import jt_mesh
from pgmpy_tpu_torch.parallel.jt_mesh import ShardedJunctionTreeCalibration
from pgmpy_tpu_torch.parallel.mesh import Mesh
from pgmpy_tpu_torch.utils import get_example_model

CPU = torch.device("cpu")
ATOL = 1e-5


def cpu_mesh(n):
    return Mesh([CPU] * n)


def network(name, suffix=""):
    """(factor scopes, cardinalities, float64 numpy tables) of a network's CPDs."""
    factors = [cpd.to_factor() for cpd in get_example_model(name).get_cpds()]
    scopes = [[v + suffix for v in f.variables] for f in factors]
    cards = {v + suffix: int(c) for f in factors for v, c in zip(f.variables, f.cardinality)}
    return scopes, cards, [np_values(f.values) for f in factors]


def markov(name, seed):
    """A network's CPD scopes with random positive tables from a numpy seed
    (up to 50 an entry): a Markov network that needs normalised messages."""
    scopes, cards, tables = network(name)
    rng = np.random.default_rng(seed)
    return scopes, cards, [rng.random(t.shape) * 50 + 0.1 for t in tables]


def programs(scopes, cards, normalize):
    """The port's and the JAX package's programs of one factor list (built in
    one process, so the same tree)."""
    port = JunctionTreeProgram.from_factors(scopes, cards, normalize_messages=normalize)
    jax_program = JaxProgram.from_factors(scopes, cards, normalize_messages=normalize)
    assert port.cliques == jax_program.cliques
    return port, jax_program


def tensors(tables, dtype=torch.float32):
    return [torch.from_numpy(np.asarray(t)).to(dtype) for t in tables]


def clique_tree(program):
    tree = nx.Graph()
    tree.add_nodes_from(range(len(program.cliques)))
    for key in program.edge_ids:
        c1, c2 = tuple(key)
        tree.add_edge(program.index[c1], program.index[c2])
    return tree


def edge_between(program, c1, c2):
    return program.edge_ids[frozenset((program.cliques[c1], program.cliques[c2]))]


def boundary_variables(sharded, p_idx, bc):
    return list(sharded.parts[p_idx]["program"].cliques[bc])


# ---------------------------------------------------------------------- #
# the part programs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n_parts", [2, 3, 8])
def test_part_programs_on_alarm(n_parts):
    scopes, cards, _ = network("alarm")
    program = JunctionTreeProgram.from_factors(scopes, cards, normalize_messages=False)
    sharded = ShardedJunctionTreeCalibration(program, cpu_mesh(n_parts))
    assert sharded.n_parts > 1
    boundary = {p["boundary_edge_id"] for p in sharded.parts} - {None}
    internal = []
    for p_idx, part in enumerate(sharded.parts):
        local, plan = part["program"], part["plan"]
        n_own = len(part["cliques"])
        # the part's cliques, then its boundary cliques: one per child part
        # and one for the edge to the parent part
        n_boundary = len(part["in_up"]) + (part["out_up"] is not None)
        assert len(local.cliques) == n_own + n_boundary
        assert [local.cliques[i] for i in range(n_own)] == [program.cliques[c]
                                                            for c in part["cliques"]]
        assert all(not local.potential_specs[i] for i in range(n_own, len(local.cliques)))
        for pair, e in local.edge_of.items():
            a, b = sorted(pair)
            if b < n_own:
                internal.append(part["edge_ids"][e])
                assert part["edge_ids"][e] == edge_between(program, part["cliques"][a],
                                                           part["cliques"][b])
        # each child part's edge: a boundary clique under the receiving clique,
        # spanning the sepset in canonical order; the same in the child part
        for ch, recv, bc, e, edge_id in part["in_up"]:
            assert edge_id in boundary and part["edge_ids"][e] == edge_id
            assert local.edge_of[frozenset((recv, bc))] == e
            top = sharded.parts[ch]["top"]
            sepset = sorted(set(program.cliques[top]) & set(program.cliques[part["cliques"][recv]]),
                            key=str)
            assert boundary_variables(sharded, p_idx, bc) == sepset
            assert plan.clique_shapes[bc] == program.sepset_shapes[edge_id]
            assert plan.sepset_shapes[e] == program.sepset_shapes[edge_id]
            child_bc, child_e = sharded.parts[ch]["out_up"]
            assert boundary_variables(sharded, ch, child_bc) == sepset
            assert sharded.parts[ch]["plan"].sepset_shapes[child_e] == program.sepset_shapes[edge_id]
            assert sharded.parts[ch]["boundary_edge_id"] == edge_id
            assert sharded.parts[ch]["in_down"] == e
        assert part["factor_ids"] == [f for c in part["cliques"]
                                      for f, _, _ in program.potential_specs[c]]
    # every internal edge in exactly one part; with the boundary edges, all
    assert len(internal) == len(set(internal))
    assert set(internal) | boundary == set(range(program.n_edges))
    assert not set(internal) & boundary
    assert len(boundary) == sharded.n_parts - 1
    assert sharded.launches() == sum(1 + 2 * p["plan"].n_waves for p in sharded.parts)


@pytest.mark.parametrize("n_parts", [2, 3, 8])
def test_split_at_n_up_waves(n_parts):
    """A part with a parent part sends to its parent boundary clique alone in
    its last upward wave and hears back alone in its first downward wave; the
    boundary clique hung under a leaf raises that leaf's height."""
    scopes, cards, _ = network("alarm")
    program = JunctionTreeProgram.from_factors(scopes, cards, normalize_messages=False)
    sharded = ShardedJunctionTreeCalibration(program, cpu_mesh(n_parts))
    for part in sharded.parts:
        plan = part["plan"]
        top = part["local_of"][part["top"]]
        n_up = plan.n_up_waves
        specs = plan.message_specs
        assert all(specs[m][6] for w in range(n_up) for m in plan.wave(w)[0])
        assert not any(specs[m][6] for w in range(n_up, plan.n_waves) for m in plan.wave(w)[0])
        assert plan.n_waves == 2 * n_up
        if part["out_up"] is None:
            continue
        bc, e = part["out_up"]
        (up,), _ = plan.wave(n_up - 1)
        (down,), _ = plan.wave(n_up)
        assert specs[up][:2] == (top, bc) and specs[up][5] == e
        assert specs[down][:2] == (bc, top) and specs[down][5] == e
        # the message back from the boundary clique reduces nothing
        assert specs[down][2] == () and plan.messages[down, jt.MSG_NRED] == 0
    for part in sharded.parts:
        plan = part["plan"]
        for _, recv, bc, _, _ in part["in_up"]:
            # the child part's sigma goes into its receiving clique in wave 0
            m = next(m for m, s in enumerate(plan.message_specs) if s[:2] == (bc, recv))
            assert m in plan.wave(0)[0] and plan.message_specs[m][2] == ()
            # ... and the receiving clique sends up no earlier than wave 1
            sends = [w for w in range(plan.n_up_waves) for m in plan.wave(w)[0]
                     if plan.message_specs[m][0] == recv]
            assert all(w >= 1 for w in sends)


def test_schedule_and_launch_count(monkeypatch):
    """A calibration runs each part's stage 0 once and its waves in two
    halves split at ``n_up_waves``: on a card 1 + 2 W_p K2 launches a part.
    ``kernel=True`` on the CPU raises: no fallback."""
    scopes, cards, tables = network("alarm")
    program = JunctionTreeProgram.from_factors(scopes, cards, normalize_messages=False)
    sharded = ShardedJunctionTreeCalibration(program, cpu_mesh(4))
    calls = []
    stage0, run_waves = jt.stage0, jt.run_waves

    def counted_stage0(plan, arrays, kernel, **kw):
        calls.append((id(plan), "stage0", kernel))
        return stage0(plan, arrays, kernel, **kw)

    def counted_waves(plan, arena, sepsets, waves, *args):
        calls.append((id(plan), tuple(waves), args[-1]))
        return run_waves(plan, arena, sepsets, waves, *args)

    monkeypatch.setattr(jt, "stage0", counted_stage0)
    monkeypatch.setattr(jt, "run_waves", counted_waves)
    sharded.calibrate(tensors(tables))
    for part in sharded.parts:
        plan = part["plan"]
        mine = [c[1:] for c in calls if c[0] == id(plan)]
        assert mine == [("stage0", False), (tuple(range(plan.n_up_waves)), False),
                        (tuple(range(plan.n_up_waves, plan.n_waves)), False)]
    launches = sum(1 if c[1] == "stage0" else 2 * len(c[1]) for c in calls)
    assert launches == sharded.launches()
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        sharded.calibrate(tensors(tables), kernel=True)


# ---------------------------------------------------------------------- #
# a boundary message with no reduced axis
# ---------------------------------------------------------------------- #
def chain_program(normalize):
    """Two cliques (x, y) and (y, z): in two parts, a part of one clique each."""
    scopes, cards = [["x", "y"], ["y", "z"]], {"x": 2, "y": 3, "z": 2}
    rng = np.random.default_rng(3)
    tables = [rng.random((2, 3)) * 4 + 0.1, rng.random((3, 2)) * 4 + 0.1]
    return JunctionTreeProgram.from_factors(scopes, cards, normalize_messages=normalize), tables


@pytest.mark.parametrize("normalize", [False, True])
def test_message_with_no_reduced_axis(normalize):
    """The parent part's wave 0 carries the boundary clique's values, as
    they are (or normalised), into the receiving clique: sigma is the
    boundary clique itself, the fresh ratio is sigma."""
    program, tables = chain_program(normalize)
    sharded = ShardedJunctionTreeCalibration(program, cpu_mesh(2))
    root = next(p for p in sharded.parts if p["out_up"] is None)
    plan = root["plan"]
    (_, recv, bc, e, _), = root["in_up"]
    m = next(m for m, s in enumerate(plan.message_specs) if s[:2] == (bc, recv))
    row = plan.messages[m]
    assert (row[jt.MSG_NRED], row[jt.MSG_REDUCED], row[jt.MSG_CHUNKS]) == (0, 1, 1)
    assert row[jt.MSG_PER_THREAD] == jt.MIN_WALK
    arrays = [torch.from_numpy(tables[i]) for i in root["factor_ids"]]
    arena, sepsets = jt.stage0(plan, arrays, kernel=False)
    beliefs, mu = jt.arena_views(plan, arena, sepsets)
    stage = beliefs[recv].clone()
    values = torch.from_numpy(np.random.default_rng(1).random(plan.clique_shapes[bc]) + 0.5)
    beliefs[bc].copy_(values)
    jt.run_waves(plan, arena, sepsets, [0], "marginalize", normalize, kernel=False)
    sigma = values / values.sum() if normalize else values
    torch.testing.assert_close(mu[e], sigma, rtol=1e-15, atol=0)
    # the sepset is (y,): sigma broadcast along the receiving clique's y axis
    assert list(root["program"].cliques[bc]) == ["y"]
    shape = [3 if v == "y" else 1 for v in root["program"].cliques[recv]]
    torch.testing.assert_close(beliefs[recv], stage * sigma.reshape(shape), rtol=1e-15, atol=0)


@pytest.mark.parametrize("normalize", [False, True])
def test_one_clique_parts_against_the_joint(normalize):
    """Two parts of one clique each, in float64, against the normalised
    joint summed by numpy: every clique and the one sepset at 1e-12 (relative
    to the beliefs' scale with normalised messages)."""
    program, tables = chain_program(normalize)
    sharded = ShardedJunctionTreeCalibration(program, cpu_mesh(2))
    assert sorted(len(p["cliques"]) for p in sharded.parts) == [1, 1]
    beliefs, mu = sharded.calibrate(tensors(tables, torch.float64))
    joint = np.einsum("xy,yz->xyz", *tables)
    want = {("x", "y"): joint.sum(2), ("y", "z"): joint.sum(0)}
    for clique, b in zip(program.cliques, beliefs):
        got = np_values(b)
        np.testing.assert_allclose(got / got.sum(), want[clique] / joint.sum(), rtol=1e-12)
    (m,) = mu
    np.testing.assert_allclose(np_values(m) / float(m.sum()), joint.sum((0, 2)) / joint.sum(),
                               rtol=1e-12)
    ref_beliefs, ref_mu = program.calibrate(tensors(tables, torch.float64))
    for got, want_t in zip(beliefs + mu, ref_beliefs + ref_mu):
        np.testing.assert_allclose(np_values(got), np_values(want_t), rtol=1e-12)


def test_forest_of_two_components():
    """ASIA beside a renamed CANCER: each component partitioned on its own,
    a root part per component; float64 within 1e-12 of the single-device
    program, float32 within 1e-5 of the JAX package's."""
    a, b = network("asia"), network("cancer", suffix="_2")
    scopes, cards, tables = a[0] + b[0], {**a[1], **b[1]}, a[2] + b[2]
    port, jax_program = programs(scopes, cards, normalize=False)
    assert len(port.component_roots) == 2
    sharded = ShardedJunctionTreeCalibration(port, cpu_mesh(4))
    assert sum(p["out_up"] is None for p in sharded.parts) == 2
    beliefs, mu = sharded.calibrate(tensors(tables, torch.float64))
    ref = port.calibrate(tensors(tables, torch.float64))
    for got, want in zip(beliefs + mu, ref[0] + ref[1]):
        np.testing.assert_allclose(np_values(got), np_values(want), rtol=1e-12, atol=1e-15)
    compare_jax(port, jax_program, tables, 4)


# ---------------------------------------------------------------------- #
# the beliefs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name, n_parts", [("alarm", 3), ("alarm", 8), ("insurance", 4)])
def test_float64_against_the_single_device_program(name, n_parts):
    scopes, cards, tables = network(name)
    program = JunctionTreeProgram.from_factors(scopes, cards, normalize_messages=False)
    sharded = ShardedJunctionTreeCalibration(program, cpu_mesh(n_parts))
    arrays = tensors(tables, torch.float64)
    beliefs, mu = sharded.calibrate(arrays)
    ref_beliefs, ref_mu = program.calibrate(arrays)
    assert all(b.dtype == torch.float64 for b in beliefs + mu)
    for got, want in zip(beliefs + mu, ref_beliefs + ref_mu):
        np.testing.assert_allclose(np_values(got), np_values(want), rtol=1e-12, atol=1e-15)


EPS32 = float(np.finfo(np.float32).eps)  # 2**-23: a float32 rounding is within EPS32 / 2


def rounding_limit(sharded, normalize):
    """The relative error a float32 sharded calibration may carry against
    exact arithmetic, to first order, counted over its part programs'
    schedules (the reckoning of ``tests/test_torch_bp.py::
    test_munin_beliefs_match``).  Every operand is nonnegative, so a sum of
    m entries carries at most ceil(log2 m) roundings and never amplifies the
    error of its inputs, while products and quotients add the relative
    errors of their operands.  A belief is its clique's factor product times
    messages that each fold in the messages before them, so its error is at
    most EPS32 / 2 times the count, over every message of every part
    program, of ceil(log2 m) + 3 (the sum, the division by the previous
    message, the product into the destination, the sepset update), with
    ``normalize`` ceil(log2 s) + 1 more (the total of the s sepset entries
    and the division by it), plus the worst clique's own factor product and
    normalisation.  The limit comes from the schedule, not from a measured
    gap."""
    count = 0
    for part in sharded.parts:
        program = part["program"]
        for src, _, axes, _, _, edge, _ in program.messages:
            count += math.ceil(math.log2(max(2, math.prod(
                program.clique_shapes[src][a] for a in axes)))) + 3
            if normalize:
                count += math.ceil(math.log2(max(2, math.prod(program.sepset_shapes[edge])))) + 1
    count += max(len(specs) + math.ceil(math.log2(max(2, math.prod(shape)))) + 1
                 for part in sharded.parts
                 for specs, shape in zip(part["program"].potential_specs,
                                         part["program"].clique_shapes))
    return count * EPS32 / 2


def compare_jax(port, jax_program, tables, n_parts, normalize=False):
    """The part plans' plain schedule and ``pgmpy_tpu``'s
    ``ShardedJunctionTreeCalibration`` on the same float32 tables, each held
    to the port's float64 calibration of the same part plans (itself held
    to one device at 1e-12: ``test_float64_against_the_single_device_program``)
    at :func:`rounding_limit` relative and ``ATOL``; then to each other at
    the sum of the two limits (with ``normalize``; the CPD trees' beliefs
    are probabilities, held at ``ATOL`` alone as before).  Returns the worst
    relative gaps (port, JAX, between them) over entries above ``ATOL``."""
    sharded = ShardedJunctionTreeCalibration(port, cpu_mesh(n_parts))
    limit = rounding_limit(sharded, normalize)
    exact = [np_values(t) for t in sum(sharded.calibrate(tensors(tables, torch.float64)), [])]
    got = [np_values(t) for t in sum(sharded.calibrate(tensors(tables)), [])]
    jax_beliefs, jax_mu = JaxSharded(jax_program, jax_get_mesh(n_parts)).calibrate(
        [np.asarray(t, dtype=np.float32) for t in tables])
    want = [np_values(t) for t in list(jax_beliefs) + list(jax_mu)]
    assert len(got) == len(want) == len(exact)
    worst = [0.0, 0.0, 0.0]
    for a, b, x in zip(got, want, exact):
        assert np.isfinite(b).all()
        np.testing.assert_allclose(a, x, atol=ATOL, rtol=limit)
        np.testing.assert_allclose(b, x, atol=ATOL, rtol=limit)
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=2 * limit if normalize else 0.0)
        held = np.abs(x) > ATOL
        if held.any():
            for j, (u, v) in enumerate(((a, x), (b, x), (a, b))):
                worst[j] = max(worst[j], float((np.abs(u - v)[held] / np.abs(v[held])).max()))
    return worst, limit


@pytest.mark.parametrize("name, n_parts", [("alarm", 2), ("alarm", 8), ("insurance", 3)])
def test_cpd_trees_against_jax(name, n_parts):
    scopes, cards, tables = network(name)
    compare_jax(*programs(scopes, cards, normalize=False), tables, n_parts)


@pytest.mark.parametrize("seed, n_parts", [(0, 4), (1, 3)])
def test_markov_network_against_jax(seed, n_parts):
    """Random tables on ALARM's scopes with normalised messages: the beliefs
    stay unnormalised (up to about 2e4), so each package is held relative to
    the float64 calibration.  Case (0, 4): 602 roundings, a limit of
    3.59e-05; over the entries above ATOL the port's float32 beliefs lie
    within 5.1e-07 (relative) of float64, the JAX package's within 1.19e-06,
    and the two 1.31e-06 apart, past the rtol 1e-6 this test once asked of
    them."""
    scopes, cards, tables = markov("alarm", seed)
    (port_gap, jax_gap, between), limit = compare_jax(
        *programs(scopes, cards, normalize=True), tables, n_parts, normalize=True)
    assert max(port_gap, jax_gap) <= limit and between <= 2 * limit


def test_part_program_alone():
    """``part_program`` of a whole tree rooted at the program's root is the
    program's own schedule: the same waves, the same messages."""
    scopes, cards, _ = network("insurance")
    program = JunctionTreeProgram.from_factors(scopes, cards, normalize_messages=False)
    tree = clique_tree(program)
    root = program.index[program.component_roots[0]]
    order = list(range(len(program.cliques)))
    local = jt_mesh.part_program(program, order, tree.edges(), [], root)
    plan, whole = jt.build_plan(local), program.wave_plan()
    assert local.n_edges == program.n_edges
    assert (plan.n_waves, plan.n_up_waves) == (whole.n_waves, whole.n_up_waves)
    assert plan.clique_shapes == whole.clique_shapes
    assert sorted(s[:2] for s in plan.message_specs) == sorted(s[:2] for s in whole.message_specs)
