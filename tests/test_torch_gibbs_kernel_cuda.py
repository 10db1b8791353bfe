"""K6 on the card: the Gibbs sweep kernel of ``csrc/gibbs.cu`` against its
plain PyTorch version on the same card, its launch counter, its Philox draws
by distribution, the same seed and a resumed run.  Every test here needs a
CUDA device and skips without one; on a GPU machine:
``python -m pytest tests/test_torch_gibbs_kernel_cuda.py -m cuda``.

Tolerances: on the same explicit noise the kernel's codes equal the plain
version's to the bit (both sum the blanket rows in the tables' type in factor
order and keep the first maximum).  Philox chains are held to the exact
marginals within 0.02 (the limit of ``tests/test_torch_gibbs.py``)."""

import numpy as np
import pytest
import torch

from _torch_parity import random_bn_tables
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.factors import DiscreteFactor, TabularCPD
from pgmpy_tpu_torch.inference import VariableElimination
from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
from pgmpy_tpu_torch.ops import gibbs as gibbs_ops
from pgmpy_tpu_torch.sampling import GibbsSampling, load_sampler_state, save_sampler_state
from pgmpy_tpu_torch.utils import get_example_model
from pgmpy_tpu_torch.utils.interop import bn_from_numpy, markov_network_from_numpy
from pgmpy_tpu_torch.utils.mathext import race_noise, seeded_generator


@pytest.fixture
def on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    previous, dtype = config.DEVICE, config.DTYPE
    config.set_device("cuda")
    try:
        yield
    finally:
        config.set_device(previous)
        config.set_dtype(dtype)


def _model(name):
    if name == "wide":  # a 130-state variable: int32 codes
        model = DiscreteBayesianNetwork([("a", "b"), ("b", "c")])
        rng = np.random.default_rng(0)
        model.add_cpds(TabularCPD("a", 130, rng.dirichlet(np.ones(130))[:, None]),
                       TabularCPD("b", 3, rng.dirichlet(np.ones(3), 130).T, evidence=["a"],
                                  evidence_card=[130]),
                       TabularCPD("c", 2, rng.dirichlet(np.ones(2), 3).T, evidence=["b"],
                                  evidence_card=[3]))
        return model
    if name == "random":
        names, edges, tuples = random_bn_tables(11, n_nodes=12)
        return bn_from_numpy(edges, tuples, nodes=names)
    if name == "markov":  # factors of one to three variables
        rng = np.random.default_rng(1)
        names = [f"V{i}" for i in range(8)]
        cards = {v: int(rng.integers(2, 5)) for v in names}
        scopes = [[v] for v in names[:2]] + [list(rng.choice(names, 3, replace=False))
                                             for _ in range(6)]
        scopes += [[v, names[0]] for v in names if v not in {u for s in scopes for u in s}]
        tables = [rng.random([cards[v] for v in s]) + 0.05 for s in scopes]
        return markov_network_from_numpy(scopes, cards, tables)
    if name == "alarm_markov":
        return get_example_model("alarm").to_markov_model()
    return get_example_model(name)


# MUNIN in float32, its working type; the others in both types
NETWORKS = [("random", "float32"), ("random", "float64"), ("alarm", "float32"),
            ("alarm", "float64"), ("munin", "float32"), ("hepar2", "float32"),
            ("markov", "float32"), ("markov", "float64"), ("alarm_markov", "float32"),
            ("wide", "float32"), ("wide", "float64")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", NETWORKS)
def test_explicit_noise_matches_plain_to_the_bit(on_cuda, name, dtype):
    config.set_dtype(dtype)
    gibbs = GibbsSampling(_model(name))
    tables = gibbs._compiled._tables
    n = 4096 if name == "munin" else 3001
    codes = torch.as_tensor(gibbs.random_state(n, 7), device="cuda")
    noise = race_noise((sum(tables.cards), n), seeded_generator(3), config.DTYPE)
    before = gibbs_ops.LAUNCHES
    got = gibbs_ops.sweep_cuda(tables, codes, None, noise=noise)
    assert gibbs_ops.LAUNCHES == before + 1
    want = gibbs_ops.sweep_reference(tables, codes, None, noise=noise)
    torch.cuda.synchronize()
    assert got.dtype == gibbs._compiled._out_dtype and got.shape == codes.shape
    assert torch.equal(got, want)
    # in place, from the trajectory's own type
    inplace = codes.to(tables.out_dtype)
    assert torch.equal(gibbs_ops.sweep_cuda(tables, inplace, None, noise=noise, out=inplace),
                       want)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 4, 32])
def test_the_groups_do_not_change_the_draws(on_cuda, groups, monkeypatch):
    model = get_example_model("alarm")
    want = GibbsSampling(model).sample_chains(500, 4, seed=3)
    monkeypatch.setattr(gibbs_ops, "GROUPS", groups)
    assert torch.equal(GibbsSampling(model).sample_chains(500, 4, seed=3), want)


@pytest.mark.cuda
def test_one_launch_per_sweep_same_seed_and_resume(on_cuda, tmp_path):
    gibbs = GibbsSampling(get_example_model("alarm"))
    torch.manual_seed(123)
    expected = torch.rand(3)
    torch.manual_seed(123)
    gibbs_ops.reset_launches()
    traj = gibbs.sample_chains(2048, 6, seed=4)
    assert gibbs_ops.LAUNCHES == 6 and traj.is_cuda and traj.dtype == torch.int8
    assert torch.equal(traj, gibbs.sample_chains(2048, 6, seed=4))
    assert not torch.equal(traj, gibbs.sample_chains(2048, 6, seed=5))
    assert torch.equal(torch.rand(3), expected)  # the global generator is left alone
    init = gibbs.random_state(2048, 4)
    whole = gibbs._compiled._run_chains(seeded_generator(11), 5, init)
    gen = seeded_generator(11)
    head = gibbs._compiled._run_chains(gen, 2, init)
    path = tmp_path / "gibbs.npz"
    save_sampler_state(path, {"codes": head[-1]}, gen, step=2)
    states, key, step, _ = load_sampler_state(path, treedef_like={"codes": None})
    resumed = seeded_generator(0)
    resumed.set_state(key)
    assert torch.equal(gibbs._compiled._run_chains(resumed, 3, states["codes"]), whole[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random", "cancer", "markov"])
def test_philox_chains_match_the_exact_marginals(on_cuda, name):
    model = _model(name)
    gibbs = GibbsSampling(model)
    traj = gibbs.sample_chains(2048, 120, seed=9)[20:]
    pooled = traj.reshape(-1, traj.shape[-1]).long().cpu().numpy()
    ve = VariableElimination(model)
    for j, var in enumerate(gibbs.variables):
        p = ve.query([var], show_progress=False).values.double().cpu().numpy()
        p = p / p.sum()  # a Markov network's query is not normalised
        freq = np.bincount(pooled[:, j], minlength=len(p)) / pooled.shape[0]
        assert np.abs(freq - p).max() <= 0.02, (var, freq, p)


@pytest.mark.cuda
def test_zero_probability_states_are_never_entered(on_cuda):
    model = DiscreteBayesianNetwork([("a", "b")])
    model.add_cpds(TabularCPD("a", 3, [[0.5], [0.5], [0.0]]),
                   TabularCPD("b", 2, [[1.0, 0.3, 0.5], [0.0, 0.7, 0.5]],
                              evidence=["a"], evidence_card=[3]))
    gibbs = GibbsSampling(model)
    start = [("a", 0), ("b", 0)]
    traj = gibbs.sample_chains(100_000, 20, start_state=start, seed=0).cpu().numpy()
    a, b = traj[..., gibbs.variables.index("a")], traj[..., gibbs.variables.index("b")]
    assert (a != 2).all() and not ((a == 0) & (b == 1)).any()


@pytest.mark.cuda
def test_a_variable_in_no_factor_is_drawn_uniform(on_cuda):
    table = torch.log(torch.tensor([[0.9, 0.1], [0.2, 0.8]], device="cuda"))
    var_specs = [[(table, (1,), (1,))], [(table.T.contiguous(), (0,), (1,))], []]
    tables = gibbs_ops.GibbsTables(var_specs, [2, 2, 3], torch.int8)
    codes = torch.zeros((300_000, 3), dtype=torch.int8, device="cuda")
    out = gibbs_ops.sweep_cuda(tables, codes, seeded_generator(0, "cuda"))
    freq = torch.bincount(out[:, 2].long(), minlength=3).double().cpu().numpy() / 300_000
    assert np.abs(freq - 1 / 3).max() <= 5 * np.sqrt(2 / 9 / 300_000)


@pytest.mark.cuda
def test_factor_tables_of_any_scope(on_cuda):
    """A Markov network whose factors have 1, 2 and 4 variables."""
    from pgmpy_tpu_torch.models import DiscreteMarkovNetwork

    rng = np.random.default_rng(2)
    model = DiscreteMarkovNetwork()
    model.add_nodes_from(list("abcd"))
    model.add_edges_from([("a", "b"), ("a", "c"), ("a", "d"), ("b", "c"), ("b", "d"),
                          ("c", "d")])
    model.add_factors(DiscreteFactor(["a"], [3], rng.random(3) + 0.1),
                      DiscreteFactor(["b", "c"], [2, 4], rng.random((2, 4)) + 0.1),
                      DiscreteFactor(["d", "c", "b", "a"], [2, 4, 2, 3],
                                     rng.random((2, 4, 2, 3)) + 0.1))
    tables = GibbsSampling(model)._compiled._tables
    codes = torch.as_tensor(GibbsSampling(model).random_state(5000, 1), device="cuda")
    noise = race_noise((sum(tables.cards), 5000), seeded_generator(5), config.DTYPE)
    assert torch.equal(gibbs_ops.sweep_cuda(tables, codes, None, noise=noise),
                       gibbs_ops.sweep_reference(tables, codes, None, noise=noise))
