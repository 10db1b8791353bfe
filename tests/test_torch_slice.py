"""The fit -> calibrate -> query slice end to end in both packages on ALARM,
plus the port's import hygiene and its docstring examples."""

import doctest
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

from pgmpy_tpu.estimators import BayesianEstimator as JaxBayes
from pgmpy_tpu.inference import BeliefPropagation as JaxBP
from pgmpy_tpu.models import DiscreteBayesianNetwork as JaxBN
from pgmpy_tpu.utils import get_example_model as jax_example

from _golden_data import standalone_sample
from _torch_parity import np_values
from pgmpy_tpu_torch.estimators import BayesianEstimator
from pgmpy_tpu_torch.inference import BeliefPropagation
from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
from pgmpy_tpu_torch.utils import get_example_model

ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _structure(cls, model):
    out = cls()
    out.add_nodes_from(model.nodes())
    out.add_edges_from(model.edges())
    return out


@pytest.mark.parametrize("estimator", ["mle", "bdeu"])
def test_alarm_fit_calibrate_query(estimator):
    port_src, jax_src = get_example_model("alarm"), jax_example("alarm")
    assert port_src.states == jax_src.states
    df = standalone_sample(jax_src, 5000, seed=11)
    port, ref = _structure(DiscreteBayesianNetwork, port_src), _structure(JaxBN, jax_src)
    if estimator == "mle":
        port.fit(df, state_names=port_src.states)
        ref.fit(df, state_names=jax_src.states)
    else:
        kwargs = dict(state_names=port_src.states, prior_type="BDeu", equivalent_sample_size=5)
        port.fit(df, estimator=BayesianEstimator, **kwargs)
        ref.fit(df, estimator=JaxBayes, **kwargs)
    for cpd in ref.get_cpds():
        np.testing.assert_allclose(port.get_cpds(cpd.variable).get_values(),
                                   np.asarray(cpd.get_values()), atol=1e-6)

    port_bp, jax_bp = BeliefPropagation(port), JaxBP(ref)
    port_bp.calibrate()
    jax_bp.calibrate()
    for clique, phi in jax_bp.get_clique_beliefs().items():
        got = port_bp.get_clique_beliefs()[clique]
        assert got.variables == phi.variables
        np.testing.assert_allclose(np_values(got.values), np_values(phi.values), atol=ATOL)
    evidence = {"CVP": "LOW", "HR": "HIGH"}
    np.testing.assert_allclose(
        np_values(port_bp.query(["HISTORY"], evidence=evidence).values),
        np_values(jax_bp.query(["HISTORY"], evidence=evidence).values), atol=ATOL,
    )
    rows = {"CVP": ["LOW", "NORMAL", "HIGH"] * 10, "HR": ["HIGH", "LOW"] * 15}
    np.testing.assert_allclose(np_values(port_bp.query_batch(["HISTORY"], rows)[0]),
                               np_values(jax_bp.query_batch(["HISTORY"], rows)[0]), atol=ATOL)


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None  # any import of jax now fails\n"
        "import pgmpy_tpu_torch\n"
        "import pgmpy_tpu_torch.factors, pgmpy_tpu_torch.models, pgmpy_tpu_torch.estimators\n"
        "import pgmpy_tpu_torch.inference, pgmpy_tpu_torch.utils.interop, pgmpy_tpu_torch.ops\n"
        "import pgmpy_tpu_torch.sampling, pgmpy_tpu_torch.utils.mathext\n"
        "import pgmpy_tpu_torch.models.dynamic_bn, pgmpy_tpu_torch.inference.dbn\n"
        "import pgmpy_tpu_torch.sampling.smc, pgmpy_tpu_torch.estimators.scores\n"
        "import pgmpy_tpu_torch.estimators.hill_climb, pgmpy_tpu_torch.estimators.tree_search\n"
        "import pgmpy_tpu_torch.estimators.exhaustive\n"
        "import pgmpy_tpu_torch.estimators.expert_knowledge\n"
        "import pgmpy_tpu_torch.estimators.citests, pgmpy_tpu_torch.estimators.constraint\n"
        "import pgmpy_tpu_torch.estimators.pc, pgmpy_tpu_torch.estimators.mmhc\n"
        "import pgmpy_tpu_torch.estimators.ges, pgmpy_tpu_torch.base.pdag\n"
        "import pgmpy_tpu_torch.metrics, pgmpy_tpu_torch.metrics.bn_inference, pgmpy_tpu_torch.base\n"
        "import pgmpy_tpu_torch.factors.jpd, pgmpy_tpu_torch.factors.noisy_or\n"
        "import pgmpy_tpu_torch.models.naive_bayes, pgmpy_tpu_torch.estimators.em\n"
        "import pgmpy_tpu_torch.estimators.mirror_descent, pgmpy_tpu_torch.estimators.expert\n"
        "import pgmpy_tpu_torch.inference.fg_bp, pgmpy_tpu_torch.inference.mplp\n"
        "import pgmpy_tpu_torch.ops.table_gather\n"
        "from pgmpy_tpu_torch.utils import discretize, llm_pairwise_orient, manual_pairwise_orient\n"
        "from pgmpy_tpu_torch.config import config\n"
        "config.set_device('cpu')\n"
        "m = pgmpy_tpu_torch.utils.get_example_model('asia')\n"
        "m.predict(m.simulate(20, seed=0, show_progress=False).drop(columns=['lung']))\n"
        "bad = [k for k, m in sys.modules.items() if m is not None and (k == 'jax'"
        " or k.startswith(('jax.', 'pgmpy_tpu.')) or k == 'pgmpy_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_unported_paths_raise_not_implemented():
    """What the port has not reached yet says so, and names its ROADMAP
    item; ``simulate``, ``predict``, ``is_imap`` and the Gaussian example
    networks are ported and run."""
    from pgmpy_tpu_torch.base import DAG
    from pgmpy_tpu_torch.utils.utils import get_example_model as example

    model = get_example_model("asia")
    with pytest.raises(TypeError, match="JointProbabilityDistribution"):
        model.is_imap(None)
    with pytest.raises(NotImplementedError, match="utils/parser.py"):
        DAG(dagitty_str="dag { a -> b }")
    assert len(example("ecoli70").nodes()) == 46
    frame = model.simulate(10, seed=0, show_progress=False)
    assert frame.shape == (10, 8)
    assert model.predict(frame.drop(columns=["lung"])).shape == (10, 1)


DOCTEST_MODULES = [
    "pgmpy_tpu_torch.factors.discrete",
    "pgmpy_tpu_torch.factors.cpd",
    "pgmpy_tpu_torch.factors.factor_ops",
    "pgmpy_tpu_torch.models.discrete_bn",
    "pgmpy_tpu_torch.models.markov_network",
    "pgmpy_tpu_torch.models.factor_graph",
    "pgmpy_tpu_torch.estimators.mle",
    "pgmpy_tpu_torch.estimators.bayes",
    "pgmpy_tpu_torch.inference.bp",
    "pgmpy_tpu_torch.inference.ve",
    "pgmpy_tpu_torch.inference.approx",
    "pgmpy_tpu_torch.sampling.forward",
    "pgmpy_tpu_torch.sampling.gibbs",
    "pgmpy_tpu_torch.models.markov_chain",
    "pgmpy_tpu_torch.models.linear_gaussian_bn",
    "pgmpy_tpu_torch.utils.utils",
    "pgmpy_tpu_torch.models.dynamic_bn",
    "pgmpy_tpu_torch.sampling.smc",
    "pgmpy_tpu_torch.estimators.scores",
    "pgmpy_tpu_torch.estimators.hill_climb",
    "pgmpy_tpu_torch.estimators.tree_search",
    "pgmpy_tpu_torch.estimators.citests",
    "pgmpy_tpu_torch.estimators.pc",
    "pgmpy_tpu_torch.metrics.metrics",
    "pgmpy_tpu_torch.estimators.em",
    "pgmpy_tpu_torch.factors.noisy_or",
    "pgmpy_tpu_torch.inference.fg_bp",
]


@pytest.mark.parametrize("module", DOCTEST_MODULES)
def test_docstring_examples(module):
    result = doctest.testmod(importlib.import_module(module), optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0
    assert result.failed == 0
