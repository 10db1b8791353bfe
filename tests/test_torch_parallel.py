"""The port's multi-device lane (``pgmpy_tpu_torch/parallel``) against
``pgmpy_tpu.parallel``, on the CPU.

Meshes of repeated CPU devices (``Mesh([cpu] * 8)``) stand for the JAX
tests' 8 virtual CPU devices.  Exact paths are held to the JAX package and to
the port's single-device programs: sharded junction-tree beliefs at atol 1e-5
(the JAX tests' tolerance), ``sharded_query_batch`` at rtol 1e-5 / atol 1e-6,
``partition_rooted_tree`` equal.  Samplers are held by distribution against
VariableElimination (the JAX tests' absolute tolerances), and their per-shard
moments (the count kernel's plain version here) exactly against numpy.
"""

import os
import socket
import subprocess
import sys

import networkx as nx
import numpy as np
import pytest
import torch

import pgmpy_tpu.factors
import pgmpy_tpu.models
from pgmpy_tpu.inference.bp import BeliefPropagation as JaxBP
from pgmpy_tpu.parallel import get_mesh as jax_get_mesh
from pgmpy_tpu.parallel import sharded_query_batch as jax_sharded_query_batch
from pgmpy_tpu.parallel.jt_mesh import partition_rooted_tree as jax_partition
from pgmpy_tpu.parallel.jt_mesh import sharded_jt_calibrate as jax_sharded_jt
from pgmpy_tpu.utils import get_example_model as jax_example

from _torch_parity import np_values, to_port
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.factors import DiscreteFactor, LinearGaussianCPD, TabularCPD
from pgmpy_tpu_torch.inference import BeliefPropagation, VariableElimination
from pgmpy_tpu_torch.models import (DiscreteBayesianNetwork, DiscreteMarkovNetwork,
                                    LinearGaussianBayesianNetwork)
from pgmpy_tpu_torch.parallel import (distributed, get_mesh, sharded_gibbs_marginals,
                                      sharded_nuts_moments, sharded_query_batch,
                                      sharded_sample_marginals)
from pgmpy_tpu_torch.parallel.jt_mesh import (ShardedJunctionTreeCalibration,
                                              partition_rooted_tree, sharded_jt_calibrate)
from pgmpy_tpu_torch.parallel.mesh import Mesh, _marginal_specs, _one_hot_moments, pmax, psum
from pgmpy_tpu_torch.sampling.core import CompiledAncestralSampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
BELIEF_ATOL = 1e-5
QUERY_TOL = dict(rtol=1e-5, atol=1e-6)


def cpu_mesh(n):
    return Mesh([CPU] * n)


def student_bn(package=None):
    """The JAX tests' student network, built with ``package``'s classes (the
    port's by default)."""
    if package is None:
        bn, cpd = DiscreteBayesianNetwork, TabularCPD
    else:
        bn, cpd = package.models.DiscreteBayesianNetwork, package.factors.TabularCPD
    model = bn([("diff", "grade"), ("intel", "grade"), ("grade", "letter"), ("intel", "SAT")])
    model.add_cpds(
        cpd("diff", 2, [[0.6], [0.4]]),
        cpd("intel", 2, [[0.7], [0.3]]),
        cpd("grade", 3, [[0.3, 0.05, 0.9, 0.5], [0.4, 0.25, 0.08, 0.3], [0.3, 0.7, 0.02, 0.2]],
            evidence=["intel", "diff"], evidence_card=[2, 2]),
        cpd("letter", 2, [[0.1, 0.4, 0.99], [0.9, 0.6, 0.01]], evidence=["grade"],
            evidence_card=[3]),
        cpd("SAT", 2, [[0.95, 0.2], [0.05, 0.8]], evidence=["intel"], evidence_card=[2]),
    )
    return model


def exact(model, var, evidence=None):
    return np_values(VariableElimination(model).query([var], evidence=evidence).values)


# ---------------------------------------------------------------------- #
# the mesh and its collectives
# ---------------------------------------------------------------------- #
def test_mesh_shape_and_context():
    assert get_mesh().devices.size == 1  # one CPU device by default
    mesh = cpu_mesh(8)
    assert mesh.devices.size == 8 and mesh.devices.shape == (8,)
    assert mesh.axis_names == ("chains",)
    assert [g for g, _ in mesh.local_shards] == list(range(8))
    assert get_mesh(n_devices=3, devices=[CPU] * 8).devices.size == 3
    with mesh as entered:
        assert entered is mesh
    with pytest.raises(ValueError, match="one name per axis"):
        Mesh([CPU] * 2, axis_names=("hosts", "chains"))


def test_config_mesh_is_stored_only():
    mesh = cpu_mesh(2)
    assert config.MESH is None
    config.set_mesh(mesh)
    try:
        assert config.MESH is mesh
    finally:
        config.set_mesh(None)


def test_collectives_reduce_in_shard_order():
    mesh = cpu_mesh(4)
    parts = [torch.tensor([float(g), -float(g)]) for g, _ in mesh.local_shards]
    assert psum(mesh, parts).tolist() == [6.0, -6.0]
    assert pmax(mesh, parts).tolist() == [3.0, 0.0]


@pytest.mark.parametrize("weighted", [False, True])
def test_one_hot_moments_against_numpy(weighted):
    """The per-shard moments (one table_counts call; its plain version on the
    CPU) equal numpy's bincount per variable: exactly without weights, 1e-12
    in float64 with them."""
    rng = np.random.default_rng(0)
    cards = [2, 3, 5, 4]
    codes = np.stack([rng.integers(0, c, 1001) for c in cards], axis=1)
    weights = rng.random(1001) if weighted else None
    got = _one_hot_moments(torch.as_tensor(codes, dtype=torch.int8),
                           None if weights is None else torch.as_tensor(weights),
                           cards, _marginal_specs(cards))
    want = np.concatenate([np.bincount(codes[:, j], weights=weights, minlength=c)
                           for j, c in enumerate(cards)])
    if weighted:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    else:
        assert got.dtype == torch.int32 and got.tolist() == want.tolist()


# ---------------------------------------------------------------------- #
# the sharded samplers, by distribution (the JAX tests' tolerances)
# ---------------------------------------------------------------------- #
def test_sharded_forward_marginals():
    model = student_bn()
    marginals = sharded_sample_marginals(model, 40000, mesh=cpu_mesh(8), seed=0)
    for var in ["grade", "letter"]:
        np.testing.assert_allclose(marginals[var], exact(model, var), atol=0.02)


def test_sharded_lw_marginals_with_evidence():
    model = student_bn()
    marginals = sharded_sample_marginals(model, 80000, mesh=cpu_mesh(8),
                                         evidence={"letter": 1}, seed=0)
    np.testing.assert_allclose(marginals["diff"], exact(model, "diff", {"letter": 1}), atol=0.03)


def test_evidence_by_name_and_index():
    """A state name and its index give the same draws; an unknown name or an
    index outside the states raises ValueError (the JAX package's ``int(s)``
    fails less usefully)."""
    model = get_port("alarm")
    by_name = sharded_sample_marginals(model, 4000, mesh=cpu_mesh(2), evidence={"HR": "HIGH"})
    index = list(model.states["HR"]).index("HIGH")
    by_index = sharded_sample_marginals(model, 4000, mesh=cpu_mesh(2), evidence={"HR": index})
    for var in by_name:
        np.testing.assert_array_equal(by_name[var], by_index[var])
    for bad in ("VERY_HIGH", 7):
        with pytest.raises(ValueError, match="HR"):
            sharded_sample_marginals(model, 100, mesh=cpu_mesh(2), evidence={"HR": bad})


def test_sharded_gibbs_marginals():
    model = student_bn()
    marginals = sharded_gibbs_marginals(model, n_chains=256, n_sweeps=200, burn_in=100,
                                        mesh=cpu_mesh(8), seed=0)
    for var in ["grade", "SAT"]:
        np.testing.assert_allclose(marginals[var], exact(model, var), atol=0.025)


def test_shard_count_invariance():
    """Same total draws on 2 and 8 shards give consistent answers; the same
    seed gives the same counts."""
    model = student_bn()
    m8 = sharded_sample_marginals(model, 16000, mesh=cpu_mesh(8), seed=0)
    m2 = sharded_sample_marginals(model, 16000, mesh=cpu_mesh(2), seed=0)
    again = sharded_sample_marginals(model, 16000, mesh=cpu_mesh(8), seed=0)
    for var in m8:
        np.testing.assert_allclose(m8[var], m2[var], atol=0.03)
        np.testing.assert_array_equal(m8[var], again[var])


def test_alarm_sharded_lw_matches_exact():
    model = get_port("alarm")
    marginals = sharded_sample_marginals(model, 60000, mesh=cpu_mesh(8),
                                         evidence={"HR": "HIGH"}, seed=0)
    np.testing.assert_allclose(marginals["CATECHOL"],
                               exact(model, "CATECHOL", {"HR": "HIGH"}), atol=0.03)


def test_sharded_nuts_moments_match_closed_form():
    """The JAX test's bounds (mean within 0.25, std within 15%) on 2 shards of
    32 chains, fewer steps: NUTS runs host loops, slow on the CPU."""
    model = LinearGaussianBayesianNetwork([("x1", "x2")])
    model.add_cpds(LinearGaussianCPD("x1", [1], 2),
                   LinearGaussianCPD("x2", [0, 1.0], 1, evidence=["x1"]))
    moments = sharded_nuts_moments(model, n_chains=64, num_samples=150, num_adapt=60,
                                   stepsize=0.2, max_depth=5, seed=0, mesh=cpu_mesh(2))
    _, mean, cov = model.joint_gaussian()
    std = np.sqrt(np.diag(cov))
    for i, (var, (m, s)) in enumerate(moments.items()):
        assert abs(m - mean[i]) < 0.25, var
        assert abs(s - std[i]) / std[i] < 0.15, var


def test_device_restored_after_a_shard_raises(monkeypatch):
    """Shards run with ``config.DEVICE`` set to their device; after a shard
    raises, the caller's device is back."""
    model = student_bn()
    seen = []

    def failing_forward(self, n, seed=None, clamp=None, partial=None):
        seen.append(config.DEVICE)
        raise RuntimeError("shard failed")

    with pytest.raises(RuntimeError):  # a shard on a device nothing can sample on
        sharded_sample_marginals(model, 100, mesh=Mesh([CPU, torch.device("meta")]))
    assert config.DEVICE == CPU
    monkeypatch.setattr(CompiledAncestralSampler, "forward", failing_forward)
    with pytest.raises(RuntimeError, match="shard failed"):
        sharded_sample_marginals(model, 100, mesh=Mesh([torch.device("meta")]))
    assert seen == [torch.device("meta")] and config.DEVICE == CPU


# ---------------------------------------------------------------------- #
# sharded_query_batch: equal to query_batch for any shard count
# ---------------------------------------------------------------------- #
JAX_MODELS = {}


def get_jax(name):
    if name not in JAX_MODELS:
        JAX_MODELS[name] = jax_example(name)
    return JAX_MODELS[name]


def get_port(name):
    return to_port(get_jax(name))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
@pytest.mark.parametrize("case", ["student", "alarm"])
def test_sharded_query_batch_matches(case, n_shards):
    """13 or 21 rows (divisible by none of 2, 3, 8: padded) against the port's
    ``query_batch`` and the JAX package's ``sharded_query_batch``."""
    if case == "student":
        port, jax_model = student_bn(), student_bn(pgmpy_tpu)
        variables, n = ["intel", "diff"], 13
        evidence = {"grade": [i % 3 for i in range(n)], "SAT": [i % 2 for i in range(n)]}
    else:
        port, jax_model = get_port("alarm"), get_jax("alarm")
        variables, n = ["HISTORY"], 21
        evidence = {"CVP": [i % 3 for i in range(n)], "HR": [i % 3 for i in range(n)]}
    values, names = sharded_query_batch(port, variables, evidence, mesh=cpu_mesh(n_shards))
    want, want_names = VariableElimination(port).query_batch(variables, evidence)
    assert names == want_names and values.shape == tuple(want.shape)
    np.testing.assert_allclose(values, np_values(want), **QUERY_TOL)
    ref, ref_names = jax_sharded_query_batch(jax_model, variables, evidence,
                                             mesh=jax_get_mesh(n_devices=n_shards))
    assert names == ref_names
    np.testing.assert_allclose(values, np.asarray(ref), **QUERY_TOL)


def test_sharded_query_batch_rows_of_probability_zero_and_bad_codes():
    """Rows whose evidence is impossible through a CPD the contraction leaves
    out get ``query_batch``'s answer; codes outside the states raise
    ValueError on the host (the JAX package answers them unchecked)."""
    model = DiscreteBayesianNetwork([("rain", "wet"), ("rain", "dark")])
    model.add_cpds(
        TabularCPD("rain", 2, [[0.8], [0.2]]),
        TabularCPD("wet", 2, [[1.0, 0.2], [0.0, 0.8]], evidence=["rain"], evidence_card=[2]),
        TabularCPD("dark", 2, [[0.7, 0.4], [0.3, 0.6]], evidence=["rain"], evidence_card=[2]),
    )
    evidence = {"rain": [0, 0, 1, 1, 0], "wet": [1, 0, 1, 0, 1]}  # rows 0 and 4: P = 0
    want, _ = VariableElimination(model).query_batch(["dark"], evidence)
    for n_shards in (1, 2, 3):
        values, _ = sharded_query_batch(model, ["dark"], evidence, mesh=cpu_mesh(n_shards))
        np.testing.assert_allclose(values, np_values(want), **QUERY_TOL)
    with pytest.raises(ValueError, match="wet"):
        sharded_query_batch(model, ["dark"], {"rain": [0, 1], "wet": [0, 5]}, mesh=cpu_mesh(2))


# ---------------------------------------------------------------------- #
# model-parallel junction-tree calibration
# ---------------------------------------------------------------------- #
def clique_tree(program):
    tree = nx.Graph()
    tree.add_nodes_from(range(len(program.cliques)))
    for key in program.edge_ids:
        c1, c2 = tuple(key)
        tree.add_edge(program.index[c1], program.index[c2])
    return tree


@pytest.mark.parametrize("name", ["alarm", "insurance"])
def test_partition_rooted_tree_equals_jax(name):
    program = BeliefPropagation(get_port(name))._program
    tree = clique_tree(program)
    root = program.index[program.component_roots[0]]
    component = tree.subgraph(nx.node_connected_component(tree, root))
    for n_parts in (2, 3, 8, 13):
        got = partition_rooted_tree(component, root, n_parts)
        want = jax_partition(component, root, n_parts)
        assert got == want, n_parts


def compare_sharded(port, jax_model, n_shards, rtol=0.0):
    """Sharded beliefs against the port's single-device program and the JAX
    package's sharded calibration, every clique and sepset, at atol 1e-5
    (and ``rtol``)."""
    atol = BELIEF_ATOL
    cliques, sepsets = sharded_jt_calibrate(port, mesh=cpu_mesh(n_shards))
    bp = BeliefPropagation(port)
    bp.calibrate()
    ref_cliques, ref_sepsets = bp.get_clique_beliefs(), bp.get_sepset_beliefs()
    jax_cliques, jax_sepsets = jax_sharded_jt(jax_model, mesh=jax_get_mesh(n_devices=n_shards))
    assert cliques.keys() == ref_cliques.keys() == jax_cliques.keys()
    for clique, values in cliques.items():
        np.testing.assert_allclose(values, np_values(ref_cliques[clique].values), atol=atol,
                                   rtol=rtol)
        np.testing.assert_allclose(values, jax_cliques[clique], atol=atol, rtol=rtol)
    assert sepsets.keys() == jax_sepsets.keys()
    for key, values in sepsets.items():
        np.testing.assert_allclose(values, np_values(ref_sepsets[key].values), atol=atol,
                                   rtol=rtol)
        np.testing.assert_allclose(values, jax_sepsets[key], atol=atol, rtol=rtol)


@pytest.mark.parametrize("name, n_shards", [("alarm", 8), ("alarm", 2), ("alarm", 3),
                                            ("insurance", 8)])
def test_sharded_jt_matches(name, n_shards):
    compare_sharded(get_port(name), get_jax(name), n_shards)


def test_sharded_jt_on_a_merged_tree():
    """ALARM's tree with clique agglomeration forced (the merge MUNIN-class
    trees get): 4 shards against the port's single-device program and the
    JAX package's ``ShardedJunctionTreeCalibration`` on its merged tree."""
    from pgmpy_tpu.parallel.jt_mesh import ShardedJunctionTreeCalibration as JaxSharded

    bp, jax_bp = BeliefPropagation(get_port("alarm"), merge=True), JaxBP(get_jax("alarm"), merge=True)
    program = bp._program
    assert program.cliques == jax_bp._program.cliques
    assert len(program.cliques) < len(BeliefPropagation(get_port("alarm"))._program.cliques)
    arrays = [f.values for f in bp._input_factors]
    beliefs, mu = ShardedJunctionTreeCalibration(program, cpu_mesh(4)).calibrate(arrays)
    ref_beliefs, ref_mu = program.calibrate(arrays)
    jax_beliefs, jax_mu = JaxSharded(jax_bp._program, jax_get_mesh(4)).calibrate(
        [f.values for f in jax_bp._input_factors])
    for got, ref, jax_ref in zip(beliefs + mu, ref_beliefs + ref_mu, jax_beliefs + jax_mu):
        np.testing.assert_allclose(np_values(got), np_values(ref), atol=BELIEF_ATOL)
        np.testing.assert_allclose(np_values(got), np_values(jax_ref), atol=BELIEF_ATOL)


def test_markov_network_normalized_messages():
    """Arbitrary-scale Markov factors exercise normalize_messages=True.  The
    clique beliefs stay unnormalised (up to about 6e4, where one float32 ulp
    is 0.004), so they also get rtol 1e-6, about 8 ulps."""
    from pgmpy_tpu.factors import DiscreteFactor as JaxFactor
    from pgmpy_tpu.models import DiscreteMarkovNetwork as JaxMN

    rng = np.random.default_rng(0)
    edges = [("a", "b"), ("b", "c"), ("c", "d"), ("d", "e"), ("b", "d")]
    tables = [rng.random(4) * 50 + 0.1 for _ in edges]
    port, jax_model = DiscreteMarkovNetwork(edges), JaxMN(edges)
    for (u, v), table in zip(edges, tables):
        port.add_factors(DiscreteFactor([u, v], [2, 2], table))
        jax_model.add_factors(JaxFactor([u, v], [2, 2], table))
    compare_sharded(port, jax_model, 4, rtol=1e-6)


def test_partition_is_connected_and_covers():
    program = BeliefPropagation(get_port("alarm"))._program
    sharded = ShardedJunctionTreeCalibration(program, cpu_mesh(8))
    tree = clique_tree(program)
    seen = []
    for part in sharded.parts:
        assert nx.is_connected(tree.subgraph(part["cliques"]))
        seen.extend(part["cliques"])
    assert sorted(seen) == list(range(len(program.cliques)))
    assert sharded.n_parts > 1
    # the parts and their parents are the JAX package's on the same program
    jax_program = JaxBP(get_jax("alarm"))._program
    from pgmpy_tpu.parallel.jt_mesh import ShardedJunctionTreeCalibration as JaxSharded

    ref = JaxSharded(jax_program, jax_get_mesh(8))
    assert [p["cliques"] for p in sharded.parts] == [p["cliques"] for p in ref.parts]
    assert sharded.part_parent == ref.part_parent


@pytest.mark.slow
def test_pigs_362_cliques_8_shards():
    """A MUNIN-class tree (pigs: 441 variables) over 8 shards: balanced parts,
    few boundary edges, beliefs equal to the single-device program."""
    port = get_port("pigs")
    bp = BeliefPropagation(port)
    sharded = ShardedJunctionTreeCalibration(bp._program, cpu_mesh(8))
    n_cliques = len(bp._program.cliques)
    sizes = sorted(len(p["cliques"]) for p in sharded.parts)
    assert n_cliques > 200 and sum(sizes) == n_cliques
    n_boundary = sum(1 for p in sharded.parts if p["boundary_edge_id"] is not None)
    assert n_boundary < n_cliques / 10
    assert sizes[-1] <= 4 * (n_cliques / sharded.n_parts)
    compare_sharded(port, get_jax("pigs"), 8)


# ---------------------------------------------------------------------- #
# process groups
# ---------------------------------------------------------------------- #
def test_initialize_single_process_is_noop_and_idempotent():
    distributed.shutdown()
    assert distributed.initialize() == (0, 1)
    assert distributed.is_initialized() and not distributed._STATE["distributed"]
    assert distributed.initialize() == (0, 1)
    distributed.shutdown()
    assert not distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed.initialize(num_processes=4)
    assert distributed.initialize() == (0, 1)


def test_device_grid_refuses_ragged_processes():
    grid = distributed.device_grid([[CPU, CPU], [CPU, CPU]])
    assert grid.shape == (2, 2) and all(d == CPU for d in grid.reshape(-1))
    with pytest.raises(ValueError, match="device counts differ"):
        distributed.device_grid([[CPU, CPU], [CPU]])


def test_global_and_host_chain_meshes():
    mesh = distributed.global_mesh()
    assert mesh.devices.size == 1 and mesh.axis_names == ("chains",)
    host_chain = distributed.host_chain_mesh()
    assert host_chain.devices.shape == (1, 1) and host_chain.axis_names == ("hosts", "chains")
    values, _ = sharded_query_batch(student_bn(), ["grade"], {"SAT": [i % 2 for i in range(17)]},
                                    mesh=mesh)
    assert values.shape == (17, 3)
    np.testing.assert_allclose(values.sum(axis=1), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="chains"):  # no process group carries it
        distributed.axis_group("chains")


def test_host_fold_key_distinct_seeds():
    seeds = [distributed.host_fold_key(7, p) for p in range(4)]
    assert len(set(seeds)) == 4 and all(isinstance(s, int) and 0 <= s < 2**63 for s in seeds)
    assert distributed.host_fold_key(7, 1) == distributed.host_fold_key(7, 1)


def test_two_process_gloo_run():
    """Two interpreters joined through ``initialize`` over a localhost
    coordinator (gloo), 2 CPU shards each: cross-process psum, per-process
    seeds, a sharded sampler, a sharded query and NUTS adapting one step size
    (``tests/_torch_distributed_worker.py``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_distributed_worker.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [
        subprocess.Popen([sys.executable, "-u", worker, str(rank), str(port), "cpu"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
                         cwd=REPO)
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert f"WORKER {rank} OK" in out


def test_importing_parallel_leaves_jax_out():
    code = (
        "import sys\n"
        "import pgmpy_tpu_torch.parallel, pgmpy_tpu_torch.parallel.jt_mesh\n"
        "from pgmpy_tpu_torch.parallel import distributed, sharded_query_batch\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'pgmpy_tpu.'))"
        " or k == 'pgmpy_tpu']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
