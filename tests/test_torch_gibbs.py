"""MarkovChain, GibbsSampling and the sampler checkpoints of the port.

Deterministic parts are held to ``pgmpy_tpu`` on identical numpy inputs:
``CompiledGibbs._conditional_logits`` against BOTH table layouts of the JAX
package (float32 sums of a few log entries: atol 1e-5), and MarkovChain's
host code exactly.  The two packages draw from different random streams, so
chains are compared by distribution: pooled Gibbs frequencies lie within 0.02
of the port's exact VariableElimination answer (the limit of the JAX
package's own test), MarkovChain frequencies within 0.02 of the stationary
distribution."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgmpy_tpu.factors import DiscreteFactor as JaxFactor
from pgmpy_tpu.models import DiscreteMarkovNetwork as JaxMarkovNetwork
from pgmpy_tpu.models import MarkovChain as JaxMarkovChain
from pgmpy_tpu.sampling.gibbs import CompiledGibbs as JaxCompiledGibbs
from pgmpy_tpu.sampling.gibbs import GibbsSampling as JaxGibbs

from _torch_parity import np_values, random_bn_pair
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.factors import DiscreteFactor, State, TabularCPD
from pgmpy_tpu_torch.inference import VariableElimination
from pgmpy_tpu_torch.models import (DiscreteBayesianNetwork, DiscreteMarkovNetwork,
                                    MarkovChain)
from pgmpy_tpu_torch.sampling import GibbsSampling, load_sampler_state, save_sampler_state
from pgmpy_tpu_torch.utils.mathext import seeded_generator

SEEDS = [0, 1, 2]


def student_bn():
    model = DiscreteBayesianNetwork(
        [("diff", "grade"), ("intel", "grade"), ("grade", "letter"), ("intel", "SAT")]
    )
    model.add_cpds(
        TabularCPD("diff", 2, [[0.6], [0.4]]),
        TabularCPD("intel", 2, [[0.7], [0.3]]),
        TabularCPD("grade", 3,
                   [[0.3, 0.05, 0.9, 0.5], [0.4, 0.25, 0.08, 0.3], [0.3, 0.7, 0.02, 0.2]],
                   evidence=["intel", "diff"], evidence_card=[2, 2]),
        TabularCPD("letter", 2, [[0.1, 0.4, 0.99], [0.9, 0.6, 0.01]],
                   evidence=["grade"], evidence_card=[3]),
        TabularCPD("SAT", 2, [[0.95, 0.2], [0.05, 0.8]],
                   evidence=["intel"], evidence_card=[2]),
    )
    return model


def markov_network_tables(seed=0):
    """The three-variable chain a - b - c of the JAX package's layout test."""
    rng = np.random.default_rng(seed)
    return [(["a", "b"], [2, 3], rng.random((2, 3)) + 0.1),
            (["b", "c"], [3, 2], rng.random((3, 2)) + 0.1)]


def markov_network_pair(seed=0):
    tables = markov_network_tables(seed)
    port = DiscreteMarkovNetwork([("a", "b"), ("b", "c")])
    port.add_factors(*[DiscreteFactor(v, c, t) for v, c, t in tables])
    ref = JaxMarkovNetwork([("a", "b"), ("b", "c")])
    ref.add_factors(*[JaxFactor(v, c, t) for v, c, t in tables])
    return port, ref


def jax_flat_gibbs(model):
    """The JAX sampler with every factor in its shared-flat layout."""
    orig = JaxCompiledGibbs._DUP_TABLE_MAX
    try:
        JaxCompiledGibbs._DUP_TABLE_MAX = 1
        flat = JaxGibbs(model)._compiled
    finally:
        JaxCompiledGibbs._DUP_TABLE_MAX = orig
    assert all(s[0] == "flat" for specs in flat._var_specs for s in specs)
    return flat


def assert_conditionals_match(port_gibbs, jax_model, seed):
    """``_conditional_logits`` of every variable, on 64 random states, against
    both layouts of the JAX package.  The port's state is (d, n)."""
    compiled = port_gibbs._compiled
    ref = JaxGibbs(jax_model)
    assert ref.variables == port_gibbs.variables
    layouts = {"mxu": ref._compiled, "flat": jax_flat_gibbs(jax_model)}
    states = port_gibbs.random_state(64, seed)
    port_states = torch.as_tensor(states, dtype=torch.int64).T.contiguous()
    for i, var in enumerate(port_gibbs.variables):
        got = np_values(compiled._conditional_logits(port_states, i))
        assert got.shape == (64, compiled.cards[i])
        for name, layout in layouts.items():
            want = np_values(layout._conditional_logits(jnp.asarray(states), i))
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=f"{var} {name}")


# ---------------------------------------------------------------------- #
# deterministic parity
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", SEEDS)
def test_conditional_logits_match_on_a_bayesian_network(seed):
    port, ref = random_bn_pair(70 + seed, n_nodes=6 + seed)
    assert_conditionals_match(GibbsSampling(port), ref, seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_conditional_logits_match_on_a_markov_network(seed):
    port, ref = markov_network_pair(seed)
    assert_conditionals_match(GibbsSampling(port), ref, seed)


def test_conditional_logits_are_the_exact_conditional():
    """softmax of the logits is P(v | every other variable), from the joint
    enumerated with numpy in float64 (atol 1e-6)."""
    port, _ = markov_network_pair(3)
    gibbs = GibbsSampling(port)
    (_, _, ab), (_, _, bc) = markov_network_tables(3)
    joint = ab[:, :, None] * bc[None, :, :]
    grid = np.stack(np.meshgrid(range(2), range(3), range(2), indexing="ij"), -1).reshape(-1, 3)
    assert gibbs.variables == ["a", "b", "c"]
    states = torch.as_tensor(grid, dtype=torch.int64).T.contiguous()
    for i in range(3):
        logits = np_values(gibbs._compiled._conditional_logits(states, i))
        got = np.exp(logits - logits.max(axis=1, keepdims=True))
        got /= got.sum(axis=1, keepdims=True)
        for row, state in enumerate(grid):
            index = list(state)
            index[i] = slice(None)
            want = joint[tuple(index)]
            np.testing.assert_allclose(got[row], want / want.sum(), atol=1e-6)


def test_one_table_layout_whatever_the_size():
    """Each (variable, blanket factor) pair holds a (rows, card) table with
    the variable's axis last; the port has no second layout."""
    port, _ = markov_network_pair(0)
    compiled = GibbsSampling(port)._compiled
    assert not hasattr(compiled, "_DUP_TABLE_MAX")
    shapes = [[tuple(table.shape) for table, _, _ in specs] for specs in compiled._var_specs]
    assert shapes == [[(3, 2)], [(2, 3), (2, 3)], [(3, 2)]]


def chain_pair():
    ref = JaxMarkovChain(["w", "x"], [2, 3], start_state=[("w", 0), ("x", 2)])
    port = MarkovChain(["w", "x"], [2, 3], start_state=[("w", 0), ("x", 2)])
    w = {0: {0: 0.7, 1: 0.3}, 1: {0: 0.4, 1: 0.6}}
    x = np.array([[0.5, 0.25, 0.25], [0.2, 0.6, 0.2], [0.1, 0.1, 0.8]])
    for chain in (ref, port):
        chain.add_transition_model("w", w)
        chain.add_transition_model("x", x)
    return port, ref, x


def test_markov_chain_host_code_matches_exactly():
    port, ref, _ = chain_pair()
    mats, ref_mats = port._transition_matrices(), ref._transition_matrices()
    assert list(mats) == list(ref_mats)
    for var in mats:
        assert np.array_equal(mats[var], ref_mats[var])
    sample = ref.sample(size=400, seed=0)  # one shared sample
    for state in ([State("w", 0)], [State("w", 1), State("x", 2)]):
        assert port.prob_from_sample(state, sample=sample, window_size=50) == \
            ref.prob_from_sample(state, sample=sample, window_size=50)
        assert port.prob_from_sample(state, sample=sample) == \
            ref.prob_from_sample(state, sample=sample)
    assert port.is_stationarity(sample=sample) == ref.is_stationarity(sample=sample)
    assert port.is_stationarity(tolerance=1e-4, sample=sample) == \
        ref.is_stationarity(tolerance=1e-4, sample=sample)
    copy = port.copy()
    assert copy.variables == port.variables and copy.cardinalities == port.cardinalities
    assert copy.transition_models == port.transition_models
    assert copy.transition_models["w"] is not port.transition_models["w"]
    np.random.seed(5)
    a = port.random_state()
    np.random.seed(5)
    assert a == ref.random_state()


def test_markov_chain_validation_matches():
    port, ref, _ = chain_pair()
    for chain in (port, ref):
        with pytest.raises(ValueError, match="square"):
            chain.add_transition_model("w", np.ones((2, 3)))
        with pytest.raises(ValueError, match="sum to 1"):
            chain.add_transition_model("w", {0: {0: 0.5, 1: 0.1}, 1: {0: 0.5, 1: 0.5}})
        with pytest.raises(ValueError, match="invalid"):
            chain.set_start_state([State("w", 2), State("x", 0)])
        with pytest.raises(ValueError, match="non-string iterable"):
            type(chain)("w", [2])


# ---------------------------------------------------------------------- #
# by distribution
# ---------------------------------------------------------------------- #
def test_markov_chain_reaches_its_stationary_distribution():
    port, _, x = chain_pair()
    df = port.sample(size=20_000, seed=0)
    assert list(df.columns) == ["w", "x"] and len(df) == 20_000
    assert tuple(df.iloc[0]) == (0, 2)  # the first row is the start state
    assert [var for var, _ in port.state] == ["w", "x"]  # the state after the last step
    vals, vecs = np.linalg.eig(x.T)
    stationary = np.real(vecs[:, np.argmax(np.real(vals))])
    stationary /= stationary.sum()
    freq = np.bincount(df["x"], minlength=3) / len(df)
    np.testing.assert_allclose(freq, stationary, atol=0.02)
    np.testing.assert_allclose(np.bincount(df["w"], minlength=2) / len(df), [4 / 7, 3 / 7],
                               atol=0.02)
    assert port.is_stationarity()


def test_markov_chain_same_seed_same_trajectory():
    port, _, _ = chain_pair()
    start = [State("w", 1), State("x", 0)]
    a = port.sample(start_state=start, size=200, seed=3)
    b = port.sample(start_state=start, size=200, seed=3)
    c = port.sample(start_state=start, size=200, seed=4)
    assert a.equals(b) and not a.equals(c)
    states = list(port.generate_sample(start_state=start, size=3, seed=3))
    assert states[0] == start and len(states) == 3


def test_markov_chain_never_leaves_an_absorbing_state():
    chain = MarkovChain(["x"], [3], start_state=[("x", 1)])
    chain.add_transition_model("x", np.array([[0.5, 0.5, 0.0], [0.0, 1.0, 0.0], [0.3, 0.3, 0.4]]))
    assert (chain.sample(size=500, seed=0)["x"] == 1).all()


def _pooled_frequencies(traj, index, card):
    pooled = traj.reshape(-1, traj.shape[-1]).cpu().numpy()
    return np.bincount(pooled[:, index], minlength=card) / pooled.shape[0]


def test_gibbs_marginals_match_exact_answers():
    model = student_bn()
    gibbs = GibbsSampling(model)
    traj = gibbs.sample_chains(n_chains=64, size=300, seed=0)
    assert tuple(traj.shape) == (300, 64, 5) and traj.dtype == torch.int8
    ve = VariableElimination(model)
    for var in model.nodes():
        exact = np_values(ve.query([var], show_progress=False).values)
        freq = _pooled_frequencies(traj[100:], gibbs.variables.index(var), len(exact))
        np.testing.assert_allclose(freq, exact, atol=0.02, err_msg=var)


@pytest.mark.parametrize("seed", SEEDS)
def test_gibbs_marginals_on_random_networks(seed):
    port, _ = random_bn_pair(80 + seed, n_nodes=6)
    gibbs = GibbsSampling(port)
    traj = gibbs.sample_chains(n_chains=128, size=250, seed=seed)
    ve = VariableElimination(port)
    for var in port.nodes():
        exact = np_values(ve.query([var], show_progress=False).values)
        freq = _pooled_frequencies(traj[50:], gibbs.variables.index(var), len(exact))
        np.testing.assert_allclose(freq, exact, atol=0.02, err_msg=var)


def test_gibbs_marginals_on_a_markov_network():
    port, _ = markov_network_pair(1)
    gibbs = GibbsSampling(port)
    traj = gibbs.sample_chains(n_chains=128, size=200, seed=0)
    (_, _, ab), (_, _, bc) = markov_network_tables(1)
    joint = ab[:, :, None] * bc[None, :, :]
    joint /= joint.sum()
    for i, axes in enumerate([(1, 2), (0, 2), (0, 1)]):
        freq = _pooled_frequencies(traj[50:], i, joint.shape[i])
        np.testing.assert_allclose(freq, joint.sum(axis=axes), atol=0.02)


def test_gibbs_single_chain_surface():
    model = student_bn()
    model.latents = {"intel"}
    gibbs = GibbsSampling(model)
    df = gibbs.sample(size=50, seed=0)
    assert df.shape == (50, 4) and "intel" not in df.columns
    assert gibbs.sample(size=5, seed=0, include_latents=True).shape == (5, 5)
    start = [State("diff", 1), State("intel", 0), State("grade", 2), State("letter", 0),
             State("SAT", 1)]
    states = list(gibbs.generate_sample(start_state=start, size=3, seed=0))
    assert len(states) == 3 and len(states[0]) == 4
    assert len(list(gibbs.generate_sample(size=2, seed=0, include_latents=True))[0]) == 5
    codes = gibbs._init_codes(start, 3, None)
    assert codes.shape == (3, 5) and codes.dtype == np.int32
    assert dict(zip(gibbs.variables, codes[0])) == {v: s for v, s in start}
    assert gibbs.random_state(4, seed=1).shape == (4, 5)
    assert np.array_equal(gibbs.random_state(4, seed=1), gibbs.random_state(4, seed=1))
    with pytest.raises(ValueError, match="DiscreteBayesianNetwork or DiscreteMarkovNetwork"):
        GibbsSampling("model")
    assert GibbsSampling().variables == []


def test_gibbs_same_seed_same_trajectory_and_thinning():
    gibbs = GibbsSampling(student_bn())
    a = gibbs.sample_chains(16, 20, seed=7)
    assert torch.equal(a, gibbs.sample_chains(16, 20, seed=7))
    assert not torch.equal(a, gibbs.sample_chains(16, 20, seed=8))
    assert torch.equal(gibbs.sample_chains(16, 20, seed=7, thin=4), a[::4])
    assert a.device == config.DEVICE


def test_gibbs_codes_are_int32_for_a_wide_variable():
    wide = DiscreteBayesianNetwork()
    wide.add_node("w")
    wide.add_cpds(TabularCPD("w", 130, np.full((130, 1), 1 / 130)))
    traj = GibbsSampling(wide).sample_chains(8, 3, seed=0)
    assert traj.dtype == torch.int32 and int(traj.max()) < 130


def test_gibbs_never_enters_an_impossible_state():
    """A chain started where the joint is positive stays there: the clamp of
    log(0) never beats a state of real mass."""
    model = DiscreteBayesianNetwork([("a", "b")])
    model.add_cpds(TabularCPD("a", 3, [[0.5], [0.5], [0.0]]),
                   TabularCPD("b", 2, [[1.0, 0.3, 0.5], [0.0, 0.7, 0.5]],
                              evidence=["a"], evidence_card=[3]))
    gibbs = GibbsSampling(model)
    start = [State("a", 0), State("b", 0)]
    traj = gibbs.sample_chains(512, 40, start_state=start, seed=0).cpu().numpy()
    a, b = traj[..., gibbs.variables.index("a")], traj[..., gibbs.variables.index("b")]
    assert (a != 2).all() and not ((a == 0) & (b == 1)).any()


def test_checkpoint_resumes_a_gibbs_run(tmp_path):
    """Saved after 2 sweeps and resumed for 3, the run gives the last 3 sweeps
    of the uninterrupted 5."""
    gibbs = GibbsSampling(student_bn())
    init = gibbs.random_state(32, seed=1)
    whole = gibbs._compiled._run_chains(seeded_generator(11), 5, init)
    gen = seeded_generator(11)
    head = gibbs._compiled._run_chains(gen, 2, init)
    assert torch.equal(head, whole[:2])
    path = tmp_path / "gibbs.npz"
    save_sampler_state(path, {"codes": head[-1]}, gen, step=2, extra={"n_chains": 32})

    states, key, step, extra = load_sampler_state(path, treedef_like={"codes": None})
    assert step == 2 and int(extra["n_chains"]) == 32
    assert states["codes"].device == config.DEVICE and states["codes"].dtype == torch.int8
    resumed = seeded_generator(0)
    resumed.set_state(key)
    tail = gibbs._compiled._run_chains(resumed, 3, states["codes"])
    assert torch.equal(tail, whole[2:])


def test_checkpoint_file_layout_and_trees(tmp_path):
    path = tmp_path / "state.npz"
    tree = {"b": [torch.arange(3), (torch.ones(2, 2), np.float32(2.5))], "a": torch.zeros(1)}
    gen = seeded_generator(4)
    save_sampler_state(path, tree, gen.get_state(), step=9)
    data = np.load(path, allow_pickle=False)
    assert {"__n_leaves__", "__key__", "__step__", "leaf_0", "leaf_3"} <= set(data.files)
    assert int(data["__n_leaves__"]) == 4 and data["__key__"].dtype == np.uint8
    flat, key, step, extra = load_sampler_state(path)
    assert step == 9 and extra == {} and len(flat) == 4
    assert torch.equal(key, gen.get_state())
    back, _, _, _ = load_sampler_state(path, treedef_like=tree)
    assert list(back) == ["a", "b"] and isinstance(back["b"][1], tuple)
    assert torch.equal(back["a"], tree["a"]) and torch.equal(back["b"][0], tree["b"][0])
    assert float(back["b"][1][1]) == 2.5


def test_importing_the_mcmc_modules_leaves_jax_out():
    code = (
        "import sys\n"
        "import pgmpy_tpu_torch.sampling, pgmpy_tpu_torch.models, pgmpy_tpu_torch.factors\n"
        "import pgmpy_tpu_torch.sampling.gibbs, pgmpy_tpu_torch.sampling.hmc\n"
        "import pgmpy_tpu_torch.sampling.nuts, pgmpy_tpu_torch.sampling.checkpoint\n"
        "import pgmpy_tpu_torch.models.markov_chain, pgmpy_tpu_torch.models.linear_gaussian_bn\n"
        "import pgmpy_tpu_torch.factors.continuous, pgmpy_tpu_torch.utils.interop\n"
        "from pgmpy_tpu_torch.sampling import (GibbsSampling, VectorizedNUTS, HamiltonianMC,\n"
        "    HamiltonianMCDA, NoUTurnSampler, NoUTurnSamplerDA, LeapFrog, ModifiedEuler,\n"
        "    BaseGradLogPDF, GradLogPDFGaussian, BaseSimulateHamiltonianDynamics,\n"
        "    save_sampler_state, load_sampler_state)\n"
        "from pgmpy_tpu_torch.models import MarkovChain, LinearGaussianBayesianNetwork\n"
        "from pgmpy_tpu_torch.factors import LinearGaussianCPD\n"
        "from pgmpy_tpu_torch.models import DynamicBayesianNetwork, DynamicNode\n"
        "from pgmpy_tpu_torch.inference import DBNInference\n"
        "from pgmpy_tpu_torch.sampling.smc import ParticleFilter\n"
        "from pgmpy_tpu_torch.estimators import (StructureEstimator, MarginalEstimator,\n"
        "    get_scoring_method, StructureScore, K2, BDeu, BDs, LogLikeliHood, BIC, AIC,\n"
        "    LogLikelihoodGauss, BICGauss, AICGauss, LogLikelihoodCondGauss, BICCondGauss,\n"
        "    AICCondGauss, ScoreCache, ExpertKnowledge, HillClimbSearch, TreeSearch,\n"
        "    ExhaustiveSearch, PC, GES, MmhcEstimator, BaseConstraintEstimator,\n"
        "    power_divergence, chi_square, g_sq, log_likelihood, modified_log_likelihood,\n"
        "    pearsonr, pillai_trace, gcm, independence_match, get_callable_ci_test)\n"
        "from pgmpy_tpu_torch.estimators.citests import power_divergence_batch\n"
        "from pgmpy_tpu_torch.base import PDAG\n"
        "from pgmpy_tpu_torch.metrics import (correlation_score, log_likelihood_score,\n"
        "    structure_score, implied_cis, fisher_c, SHD, get_metrics, BayesianModelProbability)\n"
        "from pgmpy_tpu_torch.inference import MinFill, MinNeighbors, MinWeight, WeightedMinFill\n"
        "from pgmpy_tpu_torch.utils import State, cartesian, powerset, sample_discrete\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'pgmpy_tpu.'))"
        " or k == 'pgmpy_tpu']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
