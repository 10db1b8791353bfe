"""The port's structure scores against pgmpy_tpu on the CPU.

Every score class gets the same seeded frame in both packages (discrete with
up to 3 parents and parent configurations that never occur, continuous, and
mixed) and must return the same ``local_score``, ``local_scores_batch`` and
``score`` to 1e-10 relative: the count tables are exact integers in both, and
the reductions are the same float64 expressions.
"""

import numpy as np
import pandas as pd
import pytest

import _torch_parity  # noqa: F401  (puts the port on the CPU)
import pgmpy_tpu.estimators as jax_est
import pgmpy_tpu_torch.estimators as port_est
from pgmpy_tpu.base import DAG as JaxDAG
from pgmpy_tpu_torch.base import DAG
from pgmpy_tpu_torch.estimators.base import _CodedData
from pgmpy_tpu_torch.estimators.scores import ScoreCache, get_scoring_method

COUNT_SCORES = ["K2", "BDeu", "BDs", "LogLikeliHood", "BIC", "AIC"]
GAUSS_SCORES = ["LogLikelihoodGauss", "BICGauss", "AICGauss"]
CONDGAUSS_SCORES = ["LogLikelihoodCondGauss", "BICCondGauss", "AICCondGauss"]
RTOL = 1e-10


def discrete_frame(seed=0, n=700):
    """Five string-valued columns; E takes 4 states and D depends on three
    parents, so many of D's 3*2*4 = 24 parent configurations never occur."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 3, n)
    b = (a + rng.integers(0, 2, n)) % 2
    e = np.where(rng.random(n) < 0.9, a, 3)
    c = rng.integers(0, 2, n)
    d = (a + b + (rng.random(n) < 0.15)) % 3
    return pd.DataFrame({"A": a, "B": b, "C": c, "D": d, "E": e}).astype(str)


def gaussian_frame(seed=1, n=400):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    y = 1.5 * x + rng.normal(size=n) * 0.5
    z = rng.normal(size=n)
    w = y - 0.7 * z + rng.normal(size=n)
    return pd.DataFrame({"x": x, "y": y, "z": z, "w": w})


def mixed_frame(seed=2, n=300):
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 2, n)
    d2 = (d1 + (rng.random(n) < 0.3)) % 3
    x = rng.normal(size=n) + d1
    y = 0.8 * x + rng.normal(size=n) * 0.6 + 0.5 * d2
    return pd.DataFrame({"d1": d1.astype(str), "d2": d2.astype(str), "x": x, "y": y})


DISCRETE_SPECS = [("A", []), ("B", ["A"]), ("D", ["A", "B"]), ("D", ["A", "B", "E"]),
                  ("C", ["D", "E"]), ("E", ["C", "B", "A"])]
GAUSS_SPECS = [("x", []), ("y", ["x"]), ("w", ["y", "z"]), ("z", ["x", "y", "w"])]
MIXED_SPECS = [("x", []), ("y", ["x"]), ("y", ["x", "d2"]), ("d2", ["d1"]), ("d1", ["x"]),
               ("d2", ["d1", "x", "y"])]

FRAMES = {"discrete": discrete_frame, "gaussian": gaussian_frame, "mixed": mixed_frame}
CASES = (
    [(name, "discrete", DISCRETE_SPECS, [("A", "B"), ("A", "D"), ("B", "D"), ("E", "D")])
     for name in COUNT_SCORES]
    + [(name, "gaussian", GAUSS_SPECS, [("x", "y"), ("y", "w"), ("z", "w")])
       for name in GAUSS_SCORES]
    + [(name, "mixed", MIXED_SPECS, [("d1", "d2"), ("x", "y"), ("d2", "y")])
       for name in CONDGAUSS_SCORES]
)


@pytest.fixture(scope="module")
def frames():
    return {kind: make() for kind, make in FRAMES.items()}


@pytest.mark.parametrize("name, kind, specs, edges", CASES, ids=[c[0] for c in CASES])
def test_scores_match_jax(frames, name, kind, specs, edges):
    df = frames[kind]
    port, jax_score = getattr(port_est, name)(df), getattr(jax_est, name)(df)
    want = [jax_score.local_score(v, ps) for v, ps in specs]
    got = [port.local_score(v, ps) for v, ps in specs]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(port.local_scores_batch(specs), want, rtol=RTOL)
    dag, jax_dag = DAG(), JaxDAG()
    for graph in (dag, jax_dag):
        graph.add_nodes_from(df.columns)
        graph.add_edges_from(edges)
    np.testing.assert_allclose(port.score(dag), jax_score.score(jax_dag), rtol=RTOL)


def test_discrete_frame_has_unobserved_parent_configurations(frames):
    counts = port_est.K2(frames["discrete"])._coded.counts("D", ["A", "B", "E"])
    assert counts.shape == (3, 24) and (counts.sum(axis=0) == 0).sum() >= 5


@pytest.mark.parametrize("ess", [1, 10, 50])
def test_bdeu_equivalent_sample_size(frames, ess):
    df = frames["discrete"]
    for cls in ("BDeu", "BDs"):
        got = getattr(port_est, cls)(df, equivalent_sample_size=ess).local_score("D", ["A", "E"])
        want = getattr(jax_est, cls)(df, equivalent_sample_size=ess).local_score("D", ["A", "E"])
        assert got == pytest.approx(want, rel=RTOL)


def test_bds_structure_prior(frames):
    df = frames["discrete"]
    port, jax_score = port_est.BDs(df), jax_est.BDs(df)
    for op in ("+", "-", "flip"):
        assert port.structure_prior_ratio(op) == jax_score.structure_prior_ratio(op)
    dag = DAG([("A", "B"), ("B", "D")])
    dag.add_nodes_from(df.columns)
    assert port.structure_prior(dag) == pytest.approx(-(2 + 10) * np.log(2.0))


def test_counts_enter_a_score_as_exact_float64(frames, monkeypatch):
    """A score gets float64 counts made from the kernel's integers, never
    through float32: a cell of more than 2**24 rows keeps its last digit."""
    from pgmpy_tpu_torch.estimators import base

    score = port_est.BIC(frames["discrete"])
    tables = score._coded.multi_counts_padded([("A", ("B",))], dtype=np.float64)
    assert tables[0].dtype == np.float64
    assert score._coded.multi_counts_padded([("A", ("B",))])[0].dtype == np.float32
    assert score._coded.counts("A", ["B"], dtype=np.float64).dtype == np.float64

    big = 2**24 + 1
    real = base.table_counts

    def inflated(*args, **kwargs):
        out = real(*args, **kwargs)
        out[0] = big  # what the kernel would return for a cell of 2**24 + 1 rows
        return out

    monkeypatch.setattr(base, "table_counts", inflated)
    seen = []
    monkeypatch.setattr(type(score), "_score_from_counts",
                        lambda self, counts: seen.append(counts) or 0.0)
    score.local_score("A", ["B"])
    score.local_scores_batch([("A", ["B"])])
    assert [c.dtype for c in seen] == [np.float64, np.float64]
    assert [int(c[0, 0]) for c in seen] == [big, big]
    assert int(np.float32(big)) != big  # float32 would have lost it


def test_score_cache_prime_dedupes_and_makes_one_dispatch(frames):
    df = frames["discrete"]
    scorer = port_est.BDeu(df)
    _, cache = get_scoring_method(scorer, df, True)
    assert isinstance(cache, ScoreCache) and cache.base_scorer is scorer
    before = scorer._coded.n_dispatches
    cache.prime([("A", ["B", "C"]), ("A", ["C", "B"]), ("A", ["B", "C"]), ("D", [])])
    assert scorer._coded.n_dispatches - before == 1
    assert len(cache._cache) == 2
    # all orderings now cached: no further dispatch
    assert cache.local_score("A", ["C", "B"]) == cache.local_score("A", ["B", "C"])
    cache.local_score("D", [])
    cache.prime([("A", ["B", "C"])])
    assert scorer._coded.n_dispatches - before == 1
    assert cache.local_score("A", ["B", "C"]) == pytest.approx(
        jax_est.BDeu(df).local_score("A", ["B", "C"]), rel=RTOL)
    # an uncached score outside prime is one dispatch of its own
    cache.local_score("B", ["D"])
    assert scorer._coded.n_dispatches - before == 2


def test_score_cache_grows_past_max_size(frames):
    df = frames["discrete"]
    cache = ScoreCache(port_est.K2(df), df, max_size=3)
    specs = [("A", []), ("B", []), ("C", []), ("D", []), ("E", []), ("A", ["B"])]
    cache.prime(specs)
    assert cache.max_size == 12 and cache._cache.max_size == 12
    before = cache.base_scorer._coded.n_dispatches
    for v, ps in specs:  # every primed entry survived
        cache.local_score(v, ps)
    assert cache.base_scorer._coded.n_dispatches == before
    with pytest.raises(TypeError):
        ScoreCache("k2", df)


def test_get_scoring_method(frames):
    df = frames["discrete"]
    for key, cls in [("k2", "K2"), ("bdeu", "BDeu"), ("bds", "BDs"), ("bic-d", "BIC"),
                     ("aic-d", "AIC"), ("ll-d", "LogLikeliHood"), ("BIC", "BIC")]:
        scorer, cache = get_scoring_method(key, df)
        assert type(scorer) is getattr(port_est, cls) and isinstance(cache, ScoreCache)
    scorer, same = get_scoring_method("k2", df, use_cache=False)
    assert same is scorer
    assert type(get_scoring_method(None, df)[0]) is port_est.BIC
    assert type(get_scoring_method(None, frames["gaussian"])[0]) is port_est.BICGauss
    assert type(get_scoring_method(None, frames["mixed"])[0]) is port_est.BICCondGauss
    with pytest.raises(ValueError, match="Unknown scoring method"):
        get_scoring_method("nope", df)
    with pytest.raises(ValueError, match="should either be a string"):
        get_scoring_method(3.5, df)


def test_names_importable_under_the_jax_packages_paths():
    names = (COUNT_SCORES + GAUSS_SCORES + CONDGAUSS_SCORES
             + ["StructureScore", "StructureEstimator", "MarginalEstimator", "ScoreCache",
                "get_scoring_method", "K2Score", "BDeuScore", "BDsScore", "BicScore", "AicScore",
                "HillClimbSearch", "TreeSearch", "ExhaustiveSearch", "ExpertKnowledge"])
    for name in names:
        assert hasattr(jax_est, name) and hasattr(port_est, name), name
    assert port_est.BicScore is port_est.BIC and port_est.K2Score is port_est.K2


def test_marginal_estimator(frames):
    from pgmpy_tpu_torch.models import DiscreteMarkovNetwork

    from pgmpy_tpu_torch.factors import DiscreteFactor

    df = frames["discrete"]
    network = DiscreteMarkovNetwork([("A", "B"), ("B", "D")])
    network.add_factors(DiscreteFactor(["A", "B"], [3, 2], np.ones(6)),
                        DiscreteFactor(["B", "D"], [2, 3], np.ones(6)))
    est = port_est.MarginalEstimator(network, df)
    assert set(map(frozenset, est.observed_marginals)) == {frozenset("AB"), frozenset("BD")}
    for factor in est.observed_marginals.values():
        assert float(factor.values.sum()) == len(df)
    with pytest.raises(ValueError):
        port_est.MarginalEstimator(DAG([("A", "B")]), df)


def test_coded_data_of_a_continuous_frame(frames):
    """A Gaussian score codes its continuous columns too (every value its
    own state), as the JAX package does: int16 codes, nothing is counted."""
    coded = _CodedData(frames["gaussian"])
    assert coded.cards["x"] == len(frames["gaussian"])
    assert coded.n_dispatches == 0
