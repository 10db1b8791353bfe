"""predict / predict_probability / get_state_probability of the port against
pgmpy_tpu on identical networks and frames.

Probabilities agree at atol 1e-5; MAP frames are equal wherever the top two
joint posteriors differ by more than 1e-5 (closer rows may flip on float32
rounding).  Stochastic predictions are compared by distribution."""

from unittest import mock

import numpy as np
import pandas as pd
import pytest

from pgmpy_tpu.inference import BeliefPropagation as JaxBP
from pgmpy_tpu.inference import VariableElimination as JaxVE
from pgmpy_tpu.utils import get_example_model as jax_example

from _golden_data import standalone_sample
from _torch_parity import np_values, random_bn_pair, to_port
from pgmpy_tpu_torch.factors import TabularCPD
from pgmpy_tpu_torch.inference import BeliefPropagation, VariableElimination
from pgmpy_tpu_torch.models import DiscreteBayesianNetwork

ATOL = 1e-5
SEEDS = [0, 1, 2]


@pytest.fixture(scope="module")
def cases():
    """seed -> (port model, JAX model, frame with the missing columns dropped,
    missing columns)."""
    out = {}
    for seed in SEEDS:
        port, ref = random_bn_pair(20 + seed, n_nodes=7 + 2 * seed)
        df = standalone_sample(ref, 300, seed=seed)
        rng = np.random.default_rng(seed)
        nodes = sorted(port.nodes())
        missing = sorted(nodes[i] for i in rng.permutation(len(nodes))[:2])
        out[seed] = (port, ref, df.drop(columns=missing), missing)
    return out


def _decided(ref, data, missing, gap=1e-5):
    """Rows whose joint MAP over ``missing`` is decided by more than ``gap``."""
    values, _ = JaxVE(ref).query_batch(missing, {c: data[c].tolist() for c in data.columns})
    flat = np.sort(np_values(values).reshape(len(data), -1), axis=1)
    return (flat[:, -1] - flat[:, -2]) > gap


@pytest.mark.parametrize("seed", SEEDS)
def test_predict_map_frames_equal(cases, seed):
    port, ref, data, missing = cases[seed]
    got, want = port.predict(data), ref.predict(data)
    assert list(got.columns) == list(want.columns) == missing
    assert got.index.equals(data.index)
    decided = _decided(ref, data, missing)
    assert decided.mean() > 0.9
    assert got[decided].equals(want[decided])


@pytest.mark.parametrize("seed", SEEDS)
def test_predict_probability(cases, seed):
    port, ref, data, missing = cases[seed]
    got, want = port.predict_probability(data), ref.predict_probability(data)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), atol=ATOL)
    np.testing.assert_allclose(
        got[[c for c in got.columns if c.startswith(missing[0] + "_")]].sum(axis=1), 1.0,
        atol=1e-5)


def test_alarm_predict():
    ref = jax_example("alarm")
    port = to_port(ref)
    df = standalone_sample(ref, 200, seed=5)
    data = df.drop(columns=["HISTORY", "CVP", "BP"])
    decided = _decided(ref, data, ["BP", "CVP", "HISTORY"])
    assert port.predict(data)[decided].equals(ref.predict(data)[decided])
    np.testing.assert_allclose(port.predict_probability(data).to_numpy(),
                               ref.predict_probability(data).to_numpy(), atol=ATOL)


def test_predict_with_another_inference_class(cases):
    port, ref, data, missing = cases[0]
    data = data.iloc[:40]
    got = port.predict(data, algo=BeliefPropagation)
    want = ref.predict(data, algo=JaxBP)
    decided = _decided(ref, data, missing)
    assert got[decided].equals(want[decided])
    assert got[decided].equals(port.predict(data)[decided])
    # VariableElimination named explicitly takes the batched path
    assert port.predict(data, algo=VariableElimination).equals(port.predict(data))
    again = port.predict(data, algo=BeliefPropagation, stochastic=True, seed=4)
    assert again.equals(port.predict(data, algo=BeliefPropagation, stochastic=True, seed=4))


def test_predict_argument_errors(cases):
    port, _, data, missing = cases[0]
    full = data.assign(**{v: port.states[v][0] for v in missing})
    with pytest.raises(ValueError, match="Nothing to predict"):
        port.predict(full)
    with pytest.raises(ValueError, match="not in the model"):
        port.predict(data.assign(extra=0))
    with pytest.raises(ValueError, match="Nothing to predict"):
        port.predict_probability(full)
    with pytest.raises(ValueError, match="not valid"):
        port.predict(data.assign(**{data.columns[0]: "no such state"}))


def _student():
    model = DiscreteBayesianNetwork(
        [("diff", "grade"), ("intel", "grade"), ("grade", "letter"), ("intel", "SAT")])
    model.add_cpds(
        TabularCPD("diff", 2, [[0.6], [0.4]]),
        TabularCPD("intel", 2, [[0.7], [0.3]]),
        TabularCPD("grade", 3, [[0.3, 0.05, 0.9, 0.5], [0.4, 0.25, 0.08, 0.3],
                                [0.3, 0.7, 0.02, 0.2]],
                   evidence=["intel", "diff"], evidence_card=[2, 2]),
        TabularCPD("letter", 2, [[0.1, 0.4, 0.99], [0.9, 0.6, 0.01]],
                   evidence=["grade"], evidence_card=[3]),
        TabularCPD("SAT", 2, [[0.95, 0.2], [0.05, 0.8]], evidence=["intel"], evidence_card=[2]),
    )
    return model


def test_batch_program_cached_across_predict_calls():
    """query_batch reuses its per-signature program instead of pruning the
    model and rebuilding the gather tables per predict call."""
    model = _student()
    data = pd.DataFrame({"grade": [0, 1, 2], "SAT": [1, 0, 1],
                         "letter": [1, 0, 1], "diff": [0, 1, 0]})
    spy_args = dict(side_effect=VariableElimination.batch_query_program, autospec=True)
    with mock.patch.object(VariableElimination, "batch_query_program", **spy_args) as spy:
        model.predict(data)
        model.predict(data)
        model.predict(data)
    assert spy.call_count == 1
    # model edits invalidate the cache
    cpd = model.get_cpds("SAT")
    model.remove_cpds(cpd)
    model.add_cpds(cpd)
    with mock.patch.object(VariableElimination, "batch_query_program", **spy_args) as spy:
        model.predict(data)
    assert spy.call_count == 1
    # and so does an in-place write to a CPD's values
    cpd.values = cpd.values.clone()
    with mock.patch.object(VariableElimination, "batch_query_program", **spy_args) as spy:
        model.predict(data)
        model.predict(data)
    assert spy.call_count == 1


def test_stochastic_predict_follows_the_posterior():
    """4,000 identical rows: the drawn states' frequencies lie within five
    standard errors of the exact posterior; the same seed repeats the frame."""
    model = _student()
    n = 4000
    data = pd.DataFrame({"grade": [1] * n, "SAT": [1] * n, "letter": [0] * n})
    drawn = model.predict(data, stochastic=True, seed=7)
    assert drawn.equals(model.predict(data, stochastic=True, seed=7))
    assert not drawn.equals(model.predict(data, stochastic=True, seed=8))
    assert model.predict(data, stochastic=True).equals(
        model.predict(data, stochastic=True, seed=0))  # seed None means 0
    posterior = np_values(VariableElimination(model).query(
        ["diff", "intel"], evidence={"grade": 1, "SAT": 1, "letter": 0}).values)
    freq = np.zeros((2, 2))
    np.add.at(freq, (drawn["diff"].to_numpy(), drawn["intel"].to_numpy()), 1.0 / n)
    sigma = np.sqrt(posterior * (1 - posterior) / n)
    assert (np.abs(freq - posterior) <= 5 * sigma + 1e-4).all()


def test_predict_survives_a_thousand_observed_factors():
    """A chain of 400 binary nodes with all but the head observed: the 398
    CPDs whose whole scope is observed multiply to less than the smallest
    float32, but each is one number per row and cancels in the row's
    normalization, so the port leaves them out of the contraction."""
    n_nodes = 400
    names = [f"c{i:03d}" for i in range(n_nodes)]
    rng = np.random.default_rng(3)
    model = DiscreteBayesianNetwork(list(zip(names[:-1], names[1:])))
    head = np.array([[0.3], [0.7]])
    link = np.array([[0.6, 0.25], [0.4, 0.75]])
    model.add_cpds(TabularCPD(names[0], 2, head), *[
        TabularCPD(v, 2, link, evidence=[p], evidence_card=[2])
        for p, v in zip(names[:-1], names[1:])])
    rows = rng.integers(0, 2, (6, n_nodes - 1))
    data = pd.DataFrame(rows, columns=names[1:])
    got = model.predict_probability(data).to_numpy()
    assert np.isfinite(got).all()
    want = head[:, 0][None, :] * link[rows[:, 0], :]
    want = want / want.sum(axis=1, keepdims=True)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert model.predict(data)[names[0]].tolist() == want.argmax(axis=1).tolist()


@pytest.mark.parametrize("seed", SEEDS)
def test_get_state_probability(cases, seed):
    port, ref, _, missing = cases[seed]
    nodes = sorted(port.nodes())
    full = {v: port.states[v][(i + seed) % len(port.states[v])] for i, v in enumerate(nodes)}
    assert port.get_state_probability(full) == pytest.approx(
        ref.get_state_probability(full), rel=1e-5)
    partial = {v: full[v] for v in missing}
    assert port.get_state_probability(partial) == pytest.approx(
        ref.get_state_probability(partial), rel=1e-5, abs=1e-7)
    with pytest.raises(ValueError, match="not define"):
        port.get_state_probability({missing[0]: "no such state"})


# ---------------------------------------------------------------------- #
# the oracle chip_smoke.py holds predict against on the GPU
# ---------------------------------------------------------------------- #
def _observed_codes(model, frame):
    return {v: pd.Categorical(frame[v], categories=model.states[v]).codes.astype(np.int64)
            for v in frame.columns}


@pytest.mark.parametrize("seed", SEEDS)
def test_markov_blanket_oracle_matches_predict_probability(seed):
    import chip_smoke

    port, ref = random_bn_pair(80 + seed, n_nodes=12, edge_prob=0.2, max_parents=2)
    targets = chip_smoke.independent_targets(port, count=2)
    for t in targets:
        assert not set(port.get_markov_blanket(t)) & (set(targets) - {t})
    frame = standalone_sample(ref, 64, seed=seed)
    data = frame.drop(columns=targets)
    got = port.predict_probability(data)
    for t in targets:
        want = chip_smoke.blanket_posterior(port, t, _observed_codes(port, data))
        np.testing.assert_allclose(
            got[[f"{t}_{s}" for s in port.states[t]]].to_numpy(), want, atol=ATOL)


@pytest.mark.slow
def test_munin_predict_against_the_oracle():
    """MUNIN at full width: 1038 observed columns, three missing.  The JAX
    package's float32 product of a thousand observed factors underflows here,
    so the port is held to the float64 Markov-blanket oracle."""
    import chip_smoke
    from pgmpy_tpu_torch.utils import get_example_model

    model = get_example_model("munin")
    frame = model.simulate(256, seed=0, show_progress=False)
    targets = chip_smoke.independent_targets(model)
    data = frame.drop(columns=targets)
    got = model.predict_probability(data)
    assert np.isfinite(got.to_numpy()).all()
    predicted = model.predict(data)
    for t in targets:
        want = chip_smoke.blanket_posterior(model, t, _observed_codes(model, data))
        np.testing.assert_allclose(
            got[[f"{t}_{s}" for s in model.states[t]]].to_numpy(), want, atol=ATOL)
        top2 = np.sort(want, axis=1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 1e-4
        names = np.asarray(model.states[t], dtype=object)[want.argmax(axis=1)]
        assert (predicted[t].to_numpy(dtype=object)[decided] == names[decided]).all()
