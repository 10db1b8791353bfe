"""ExpertInLoop and the pairwise-orientation helpers of the port against
pgmpy_tpu.

The orientation oracle is an injected callable (no network), answering from a
known DAG.  On discrete data both packages run their own ``chi_square`` behind
a wrapper that returns ``(Cramér's V, p)``, the pair ExpertInLoop reads; the
port does the same by itself when handed the bare discrete test, where the
JAX package fails to unpack the test's three results."""

import builtins
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from pgmpy_tpu.estimators import ExpertInLoop as JaxExpert
from pgmpy_tpu.estimators import ExpertKnowledge as JaxKnowledge
from pgmpy_tpu.estimators.citests import chi_square as jax_chi_square
from pgmpy_tpu.utils import get_example_model as jax_example
from pgmpy_tpu.utils import llm_pairwise_orient as jax_llm_orient

import _torch_parity  # noqa: F401  (the port on the CPU)
from _golden_data import standalone_sample
from pgmpy_tpu_torch.estimators import ExpertInLoop, ExpertKnowledge
from pgmpy_tpu_torch.estimators.citests import chi_square
from pgmpy_tpu_torch.utils import llm_pairwise_orient, manual_pairwise_orient

SACHS_PART = ["Raf", "Mek", "Erk", "Akt", "PKA", "PKC", "P38"]


def cramers_v_test(test):
    """A CI test returning ``(Cramér's V, p)`` from a package's ``test``."""
    def run(X, Y, Z, data, boolean=False, **kwargs):
        statistic, p_value, _ = test(X, Y, Z, data, boolean=False)
        k = min(data[X].nunique(), data[Y].nunique()) - 1
        return float(np.sqrt(statistic / (len(data) * k))), p_value
    return run


def oracle_from(edges, calls=None):
    edges = set(edges)

    def orient(u, v, **kwargs):
        if calls is not None:
            calls.append((u, v))
        if (u, v) in edges:
            return (u, v)
        if (v, u) in edges:
            return (v, u)
        return None
    return orient


@pytest.fixture(scope="module")
def sachs():
    model = jax_example("sachs")
    frame = standalone_sample(model, 2000, seed=0)[SACHS_PART]
    true = [(u, v) for u, v in model.edges() if u in SACHS_PART and v in SACHS_PART]
    return frame, true


def test_discrete_dag_matches_jax(sachs):
    frame, true = sachs
    port_calls, jax_calls = [], []
    port = ExpertInLoop(frame).estimate(ci_test=cramers_v_test(chi_square),
                                        orientation_fn=oracle_from(true, port_calls),
                                        show_progress=False)
    ref = JaxExpert(frame).estimate(ci_test=cramers_v_test(jax_chi_square),
                                    orientation_fn=oracle_from(true, jax_calls),
                                    show_progress=False)
    assert sorted(port.edges()) == sorted(ref.edges())
    assert port_calls == jax_calls
    assert set(port.edges()) <= set(true)


def test_bare_discrete_test_is_read_as_cramers_v(sachs):
    """The JAX package cannot unpack ``chi_square``'s three results (its
    default on discrete data); the port reads them as ``(V, p)``."""
    frame, true = sachs
    with pytest.raises(ValueError, match="too many values to unpack"):
        JaxExpert(frame).estimate(orientation_fn=oracle_from(true), show_progress=False)
    default = ExpertInLoop(frame).estimate(orientation_fn=oracle_from(true),
                                           show_progress=False)
    wrapped = ExpertInLoop(frame).estimate(ci_test=cramers_v_test(chi_square),
                                           orientation_fn=oracle_from(true),
                                           show_progress=False)
    assert sorted(default.edges()) == sorted(wrapped.edges())
    table = ExpertInLoop(frame).test_all("chi_square", ExpertInLoop(frame).estimate(
        orientation_fn=oracle_from(true), show_progress=False))
    assert set(table.columns) == {"u", "v", "z", "edge_present", "effect", "p_val"}
    assert ((table.effect >= 0) & (table.effect <= 1)).all()


def continuous_frame():
    rng = np.random.default_rng(0)
    n = 3000
    a = rng.normal(size=n)
    b = 1.2 * a + rng.normal(size=n) * 0.4
    c = 0.8 * b + rng.normal(size=n) * 0.5
    d = rng.normal(size=n)
    return pd.DataFrame({"a": a, "b": b, "c": c, "d": d})


@pytest.mark.parametrize("how", ["oracle", "orientations", "tiers", "orient_fn"])
def test_continuous_dag_matches_jax(how):
    frame = continuous_frame()
    true = [("a", "b"), ("b", "c")]
    results = []
    for Expert, Knowledge in ((ExpertInLoop, ExpertKnowledge), (JaxExpert, JaxKnowledge)):
        calls = []
        kwargs = dict(orientation_fn=oracle_from(true, calls), show_progress=False)
        if how == "orientations":
            kwargs["orientations"] = {("c", "b"), ("a", "b")}
        elif how == "tiers":
            kwargs["expert_knowledge"] = Knowledge(temporal_order=[["c"], ["a", "b"]])
        elif how == "orient_fn":
            kwargs = dict(orient_fn=lambda u, v, desc: oracle_from(true)(u, v),
                          show_progress=False)
        dag = Expert(frame).estimate(**kwargs)
        results.append((sorted(dag.edges()), calls))
    assert results[0] == results[1]
    if how == "orientations":
        # the given orientations pre-empt the oracle, which is asked only
        # about the pair they do not cover
        assert ("c", "b") in results[0][0] and results[0][1] == [("a", "c")]


def test_orientation_cache_is_reused():
    """An answer is asked for once; a pair the oracle left without an edge
    (None) is not cached and is asked again."""
    frame = continuous_frame()
    est = ExpertInLoop(frame)
    calls = []
    est.estimate(orientation_fn=oracle_from([("a", "b"), ("b", "c")], calls),
                 show_progress=False)
    first = list(calls)
    est.estimate(orientation_fn=oracle_from([("a", "b"), ("b", "c")], calls),
                 show_progress=False)
    assert first == [("a", "b"), ("a", "c"), ("b", "c")]
    assert calls[len(first):] == [("a", "c")]


def test_manual_pairwise_orient(monkeypatch):
    answers = iter(["1", "2", "3", "9"])
    prompts = []

    def fake_input(prompt):
        prompts.append(prompt)
        return next(answers)

    monkeypatch.setattr(builtins, "input", fake_input)
    assert manual_pairwise_orient("x", "y") == ("x", "y")
    assert manual_pairwise_orient("x", "y") == ("y", "x")
    assert manual_pairwise_orient("x", "y") is None
    assert manual_pairwise_orient("x", "y") is None
    assert "x -> y" in prompts[0] and "x <- y" in prompts[0]


class _Reply:
    def __init__(self, text):
        message = type("Message", (), {"content": text})()
        self.choices = [type("Choice", (), {"message": message})()]


@pytest.mark.parametrize("reply, want", [("1", ("x", "y")), (" **2** ", ("y", "x")),
                                         ("A", ("x", "y")), ("b", ("y", "x"))])
def test_llm_pairwise_orient_with_an_injected_transport(reply, want):
    seen = []

    def completion(model, messages):
        seen.append((model, messages))
        return _Reply(reply)

    descriptions = {"x": "smoking", "y": "cancer"}
    got = llm_pairwise_orient("x", "y", descriptions, completion_fn=completion)
    assert got == want == jax_llm_orient("x", "y", descriptions,
                                         completion_fn=lambda **k: _Reply(reply))
    (model, messages), = seen
    assert model == "gemini/gemini-1.5-flash"
    assert "<A>: smoking" in messages[0]["content"] and "<B>: cancer" in messages[0]["content"]
    with pytest.raises(ValueError):
        llm_pairwise_orient("x", "y", descriptions, completion_fn=lambda **k: _Reply("maybe"))


def test_litellm_is_never_imported():
    code = (
        "import sys\n"
        "from pgmpy_tpu_torch.config import config\n"
        "config.set_device('cpu')\n"
        "import pgmpy_tpu_torch.estimators.expert, pgmpy_tpu_torch.utils\n"
        "from pgmpy_tpu_torch.utils import llm_pairwise_orient\n"
        "class R:\n"
        "    choices = [type('C', (), {'message': type('M', (), {'content': '1'})()})()]\n"
        "llm_pairwise_orient('a', 'b', {'a': 'x', 'b': 'y'}, completion_fn=lambda **k: R())\n"
        "sys.exit(1 if 'litellm' in sys.modules else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
