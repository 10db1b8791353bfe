"""The port's public names against pgmpy_tpu's.

For every module of ``pgmpy_tpu_torch`` whose counterpart in ``pgmpy_tpu``
has an ``__all__``, the port's ``__all__`` holds every name of the JAX
module's.  A name may be missing only while it waits for a module that
``ROADMAP.md`` lists as still to port: ``WAITING`` names that module, and the
test fails once the name is exported (so the entry must go) or if the
roadmap no longer mentions the module.
"""

import importlib
import importlib.util
import os
import pkgutil

import pytest

import pgmpy_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# {JAX module: {name: the module it waits for, as ROADMAP.md writes it}}
WAITING = {
    "pgmpy_tpu.base": {
        "ADMG": "base/admg.py", "MAG": "base/mag.py", "AncestralBase": "base/mag.py",
    },
    "pgmpy_tpu.estimators": {"ExpectationMaximization": "em.py"},
    "pgmpy_tpu.factors": {
        "JointProbabilityDistribution": "factors/jpd.py",
        "NoisyORCPD": "factors/noisy_or.py",
        "FunctionalCPD": "factors/hybrid.py",
        "param": "factors/hybrid.py",
        "get_param_store": "factors/hybrid.py",
        "clear_param_store": "factors/hybrid.py",
    },
    "pgmpy_tpu.models": {
        "NaiveBayes": "models/naive_bayes.py",
        "SEM": "models/sem.py", "SEMGraph": "models/sem.py", "SEMAlg": "models/sem.py",
        "FunctionalBayesianNetwork": "models/functional_bn.py",
    },
    "pgmpy_tpu.utils": {
        "discretize": "utils/utils.py:discretize",
        "llm_pairwise_orient": "utils/utils.py:llm_pairwise_orient",
        "manual_pairwise_orient": "manual_pairwise_orient",
        "optimize": "utils/optimizer.py", "pinverse": "utils/optimizer.py",
        "KernelTimer": "utils/profiling.py", "trace": "utils/profiling.py",
    },
}


def _port_modules():
    names = ["pgmpy_tpu_torch"]
    for info in pkgutil.walk_packages(pgmpy_tpu_torch.__path__, "pgmpy_tpu_torch."):
        names.append(info.name)
    return sorted(names)


PAIRS = [
    (port, "pgmpy_tpu" + port[len("pgmpy_tpu_torch"):])
    for port in _port_modules()
    if importlib.util.find_spec("pgmpy_tpu" + port[len("pgmpy_tpu_torch"):]) is not None
]


def test_every_ported_package_is_compared():
    compared = {jax for _, jax in PAIRS}
    for name in ("pgmpy_tpu.base", "pgmpy_tpu.estimators", "pgmpy_tpu.inference",
                 "pgmpy_tpu.utils", "pgmpy_tpu.metrics", "pgmpy_tpu.factors"):
        assert name in compared


@pytest.mark.parametrize("port_name, jax_name", PAIRS, ids=[p for p, _ in PAIRS])
def test_port_exports_every_jax_name(port_name, jax_name):
    jax_module = importlib.import_module(jax_name)
    port_module = importlib.import_module(port_name)
    want = getattr(jax_module, "__all__", None)
    if want is None:
        return
    got = set(getattr(port_module, "__all__", ()))
    waiting = WAITING.get(jax_name, {})
    missing = sorted(set(want) - got - set(waiting))
    assert not missing, f"{port_name}.__all__ lacks {missing}"
    for name in got:
        assert hasattr(port_module, name), f"{port_name}.__all__ names {name}, which it lacks"
    exported = sorted(set(waiting) & got)
    assert not exported, f"{exported} are exported now: drop them from WAITING"


def test_waiting_modules_are_on_the_roadmap():
    with open(os.path.join(REPO, "ROADMAP.md")) as fh:
        roadmap = fh.read()
    for names in WAITING.values():
        for module in set(names.values()):
            assert module in roadmap, f"ROADMAP.md does not list {module}"
