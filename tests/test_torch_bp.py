"""Junction-tree calibration and BP queries of the port against pgmpy_tpu.

Beliefs agree at atol 1e-6, rtol 1e-4; query posteriors at atol 1e-5."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pgmpy_tpu.factors import TabularCPD as JaxCPD
from pgmpy_tpu.inference import BeliefPropagation as JaxBP
from pgmpy_tpu.inference.bp import JunctionTreeProgram as JaxProgram
from pgmpy_tpu.utils import get_example_model as jax_example

from _torch_parity import aligned, np_values, to_port
from pgmpy_tpu_torch.factors import TabularCPD
from pgmpy_tpu_torch.inference import BeliefPropagation
from pgmpy_tpu_torch.inference.bp import JunctionTreeProgram
from pgmpy_tpu_torch.readwrite import BIFReader
from pgmpy_tpu_torch.utils.utils import _EXAMPLE_DIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BELIEF_TOL = dict(atol=1e-6, rtol=1e-4)
QUERY_ATOL = 1e-5

QUERIES = {
    "asia": [
        (["lung"], {"smoke": "yes"}),
        (["bronc", "either"], {"xray": "no", "dysp": "yes"}),
        (["tub"], {}),
    ],
    "alarm": [
        (["HISTORY"], {"CVP": "LOW", "HR": "HIGH"}),
        (["LVFAILURE", "STROKEVOLUME"], {"BP": "LOW"}),
        (["KINKEDTUBE"], {"VENTLUNG": "ZERO", "PRESS": "HIGH", "SAO2": "LOW"}),
    ],
}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in ("asia", "alarm"):
        jax_model = jax_example(name)
        out[name] = (to_port(jax_model), jax_model)
    return out


def _assert_beliefs_match(port_bp, jax_bp):
    port_cliques, jax_cliques = port_bp.get_clique_beliefs(), jax_bp.get_clique_beliefs()
    assert set(port_cliques) == set(jax_cliques)
    for clique, ref in jax_cliques.items():
        got = port_cliques[clique]
        np.testing.assert_allclose(aligned(got, ref.variables), np_values(ref.values), **BELIEF_TOL)
    port_seps, jax_seps = port_bp.get_sepset_beliefs(), jax_bp.get_sepset_beliefs()
    assert set(port_seps) == set(jax_seps)
    for edge, ref in jax_seps.items():
        got = port_seps[edge]
        np.testing.assert_allclose(aligned(got, ref.variables), np_values(ref.values), **BELIEF_TOL)


@pytest.mark.parametrize("name", ["asia", "alarm"])
@pytest.mark.parametrize("operation", ["calibrate", "max_calibrate"])
def test_beliefs_match(models, name, operation):
    port_model, jax_model = models[name]
    port_bp, jax_bp = BeliefPropagation(port_model), JaxBP(jax_model)
    getattr(port_bp, operation)()
    getattr(jax_bp, operation)()
    _assert_beliefs_match(port_bp, jax_bp)


def test_merged_alarm_beliefs_match(models):
    port_model, jax_model = models["alarm"]
    port_bp, jax_bp = BeliefPropagation(port_model, merge=True), JaxBP(jax_model, merge=True)
    assert len(port_bp._program.cliques) == len(jax_bp._program.cliques) < 26
    port_bp.calibrate()
    jax_bp.calibrate()
    _assert_beliefs_match(port_bp, jax_bp)


@pytest.mark.parametrize("name", ["asia", "alarm"])
def test_query_and_map_query(models, name):
    port_model, jax_model = models[name]
    port_bp, jax_bp = BeliefPropagation(port_model), JaxBP(jax_model)
    for variables, evidence in QUERIES[name]:
        got, ref = port_bp.query(variables, evidence=evidence), jax_bp.query(variables, evidence=evidence)
        assert got.variables == ref.variables
        np.testing.assert_allclose(np_values(got.values), np_values(ref.values), atol=QUERY_ATOL)
        marg = port_bp.query(variables, evidence=evidence, joint=False)
        ref_marg = jax_bp.query(variables, evidence=evidence, joint=False)
        for var in variables:
            np.testing.assert_allclose(np_values(marg[var].values), np_values(ref_marg[var].values),
                                       atol=QUERY_ATOL)
        assert port_bp.map_query(variables, evidence=evidence) == jax_bp.map_query(
            variables, evidence=evidence)


@pytest.mark.parametrize("name", ["asia", "alarm"])
def test_query_batch(models, name):
    port_model, jax_model = models[name]
    port_bp, jax_bp = BeliefPropagation(port_model), JaxBP(jax_model)
    rng = np.random.default_rng(0)
    for variables, evidence in QUERIES[name]:
        if not evidence:
            continue
        rows = {v: [port_model.states[v][i] for i in rng.integers(0, len(port_model.states[v]), 64)]
                for v in evidence}
        got, names = port_bp.query_batch(variables, rows)
        ref, ref_names = jax_bp.query_batch(variables, rows)
        assert names == ref_names
        assert tuple(got.shape) == tuple(np.shape(ref))
        np.testing.assert_allclose(np_values(got), np_values(ref), atol=QUERY_ATOL)


def test_query_batch_with_pruned_evidence(models):
    """Evidence d-separated from the query is pruned: every row has one answer."""
    port_model, jax_model = models["asia"]
    rows = {"asia": ["yes", "no", "yes"]}
    got, _ = BeliefPropagation(port_model).query_batch(["smoke"], rows)
    ref, _ = JaxBP(jax_model).query_batch(["smoke"], rows)
    np.testing.assert_allclose(np_values(got), np_values(ref), atol=QUERY_ATOL)


def test_virtual_evidence(models):
    port_model, jax_model = models["asia"]
    lik = [[0.7], [0.3]]
    names = {"xray": list(port_model.states["xray"])}
    got = BeliefPropagation(port_model).query(
        ["lung"], evidence={"smoke": "no"},
        virtual_evidence=[TabularCPD("xray", 2, lik, state_names=names)])
    ref = JaxBP(jax_model).query(
        ["lung"], evidence={"smoke": "no"},
        virtual_evidence=[JaxCPD("xray", 2, lik, state_names=names)])
    np.testing.assert_allclose(np_values(got.values), np_values(ref.values), atol=QUERY_ATOL)


def test_munin_junction_tree_structure_matches():
    """Host compile only (no tensors): MUNIN's merged clique tree and message
    schedule are the same in both packages."""
    reader = BIFReader(path=f"{_EXAMPLE_DIR}/munin.bif.gz")
    scopes = [[v] + list(reader.variable_parents.get(v, [])) for v in reader.variable_names]
    cards = dict(reader.variable_cards)
    port = JunctionTreeProgram.from_factors(scopes, cards, normalize_messages=False)
    ref = JaxProgram.from_factors(scopes, cards, normalize_messages=False)
    assert port.cliques == ref.cliques
    assert port.edge_ids == ref.edge_ids
    assert port.messages == ref.messages
    assert port.potential_specs == ref.potential_specs


MUNIN_BELIEFS = """
import json, math, os, sys
sys.path[:0] = [{repo!r}, {tests!r}]
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from _torch_parity import aligned, np_values, to_port
from pgmpy_tpu.inference import BeliefPropagation as JaxBP
from pgmpy_tpu.utils import get_example_model as jax_example
from pgmpy_tpu_torch.inference import BeliefPropagation

jax_model = jax_example("munin")
port_bp, jax_bp = BeliefPropagation(to_port(jax_model)), JaxBP(jax_model)
port_bp.calibrate()
jax_bp.calibrate()
program = port_bp._program
# first-order float32 rounding of one package, relative, summed over the
# schedule: per message ceil(log2 m) for the sum of its m entries plus 3 for
# the division by the previous message, the product into the destination and
# the sepset update; then the worst clique's own product of its factors and
# its normalisation
u = 2.0 ** -24
per_message = [math.ceil(math.log2(max(2, math.prod(
    program.clique_shapes[src][a] for a in axes)))) + 3
    for src, _, axes, *_ in program.messages]
per_clique = max(len(specs) + math.ceil(math.log2(max(2, math.prod(shape)))) + 1
                 for specs, shape in zip(program.potential_specs, program.clique_shapes))
rtol = 2 * u * (sum(per_message) + per_clique)
port_cliques, jax_cliques = port_bp.get_clique_beliefs(), jax_bp.get_clique_beliefs()
assert set(port_cliques) == set(jax_cliques)
worst = 0.0
for clique, ref in jax_cliques.items():
    got, want = aligned(port_cliques[clique], ref.variables), np_values(ref.values)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
    worst = max(worst, float((np.abs(got - want) / np.maximum(want, 1e-6)).max()))
port_seps, jax_seps = port_bp.get_sepset_beliefs(), jax_bp.get_sepset_beliefs()
assert set(port_seps) == set(jax_seps)
for edge, ref in jax_seps.items():
    got, want = aligned(port_seps[edge], ref.variables), np_values(ref.values)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
print(json.dumps({{"cliques": len(program.cliques), "messages": len(program.messages),
                  "rtol": rtol, "worst": worst}}), flush=True)
os._exit(0)  # skip the interpreter's teardown of two runtimes
"""


@pytest.mark.slow
def test_munin_beliefs_match():
    """MUNIN's calibrated beliefs in both packages, in one subprocess under a
    fixed ``PYTHONHASHSEED`` (the junction tree follows set iteration order in
    both packages), so the tree and the result do not change between runs.

    The tolerance is the float32 rounding that MUNIN's schedule allows, not a
    fixed 1e-4.  Every operand is nonnegative, so a sum of m entries has a
    relative error of at most about ceil(log2 m) units of roundoff u = 2**-24
    and never amplifies the error its inputs carry, while products and
    quotients add the relative errors of their operands.  A belief is the
    clique's factor product times every message of the schedule that reaches
    it, so to first order its relative error is at most u times the sum, over
    all messages, of ceil(log2 m) + 3 (the sum, the division by the previous
    message, the product into the destination, the sepset update), plus the
    worst clique's own factor product and normalisation; the two packages
    round independently, hence the factor 2.  On MUNIN's tree under seed 0
    (356 cliques, 710 messages) that is 9.9e-4; the packages differ by at
    most 2.5e-4 there (2.2e-4 under seed 1), which the old fixed 1e-4
    refused.  The absolute floor of 1e-6 covers entries near float32
    underflow."""
    code = MUNIN_BELIEFS.format(repo=REPO, tests=os.path.join(REPO, "tests"))
    env = dict(os.environ, PYTHONHASHSEED="0", JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["worst"] <= result["rtol"] < 2e-3
