"""The port's public names against pgmpy_tpu's.

For every module of ``pgmpy_tpu_torch`` whose counterpart in ``pgmpy_tpu``
has an ``__all__``, the port's ``__all__`` holds every name of the JAX
module's; and every name the JAX module resolves lazily, through a module
``__getattr__``, resolves in the port's module too.  A name may be missing
only while it waits for a module that ``ROADMAP.md`` lists as still to port:
``WAITING`` names that module, and the test fails once the name is exported
(so the entry must go) or if the roadmap no longer mentions the module.
"""

import ast
import importlib
import inspect
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
    "pgmpy_tpu.estimators": {
        "SEMEstimator": "estimators/sem_estimator.py",
        "IVEstimator": "estimators/sem_estimator.py",
    },
    "pgmpy_tpu.inference": {
        "CausalInference": "inference/causal.py",
        "LinearEstimator": "inference/linear_model.py",
    },
    "pgmpy_tpu.readwrite": {
        f"{fmt}{role}": f"readwrite/{module}.py"
        for fmt, module in (("NET", "net"), ("UAI", "uai"), ("XMLBIF", "xmlbif"),
                            ("XBN", "xbn"), ("XDSL", "xdsl"), ("PomdpX", "pomdpx"))
        for role in ("Reader", "Writer")
    },
    "pgmpy_tpu.factors": {
        "FunctionalCPD": "factors/hybrid.py",
        "param": "factors/hybrid.py",
        "get_param_store": "factors/hybrid.py",
        "clear_param_store": "factors/hybrid.py",
    },
    "pgmpy_tpu.models": {
        "SEM": "models/sem.py", "SEMGraph": "models/sem.py", "SEMAlg": "models/sem.py",
        "FunctionalBayesianNetwork": "models/functional_bn.py",
    },
    "pgmpy_tpu.utils": {
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


def lazy_names(module):
    """The names ``module`` resolves through its ``__getattr__``: the string
    constants of that function, and the classes of a reader / writer
    registry it searches."""
    hook = getattr(module, "__getattr__", None)
    if not inspect.isfunction(hook):
        return set()
    names = {
        node.value for node in ast.walk(ast.parse(inspect.getsource(hook)))
        if isinstance(node, ast.Constant) and isinstance(node.value, str)
        and node.value.isidentifier()
    }
    for registry in ("_READERS", "_WRITERS"):
        names |= {cls.__name__ for cls in getattr(module, registry, {}).values()}
    return names


LAZY = [(port, jax) for port, jax in PAIRS if lazy_names(importlib.import_module(jax))]


def test_lazy_names_are_compared():
    compared = {jax for _, jax in LAZY}
    for name in ("pgmpy_tpu.inference", "pgmpy_tpu.estimators", "pgmpy_tpu.sampling",
                 "pgmpy_tpu.readwrite"):
        assert name in compared
    assert {"BeliefPropagationWithMessagePassing", "Mplp"} <= lazy_names(
        importlib.import_module("pgmpy_tpu.inference"))
    assert {"MirrorDescentEstimator", "ExpertInLoop"} <= lazy_names(
        importlib.import_module("pgmpy_tpu.estimators"))


@pytest.mark.parametrize("port_name, jax_name", LAZY, ids=[p for p, _ in LAZY])
def test_port_resolves_every_lazy_jax_name(port_name, jax_name):
    port_module = importlib.import_module(port_name)
    waiting = WAITING.get(jax_name, {})
    names = lazy_names(importlib.import_module(jax_name))
    missing = sorted(n for n in names - set(waiting) if not hasattr(port_module, n))
    assert not missing, f"{port_name} does not resolve {missing}"
    resolved = sorted(n for n in names & set(waiting) if hasattr(port_module, n))
    assert not resolved, f"{resolved} resolve now: drop them from WAITING"


def test_waiting_modules_are_on_the_roadmap():
    with open(os.path.join(REPO, "ROADMAP.md")) as fh:
        roadmap = fh.read()
    for names in WAITING.values():
        for module in set(names.values()):
            assert module in roadmap, f"ROADMAP.md does not list {module}"
