"""Shared helpers for the parity tests of pgmpy_tpu_torch against pgmpy_tpu.

Both packages get identical inputs: models are carried across as numpy CPD
tables (``pgmpy_tpu_torch.utils.interop.bn_from_numpy``), random networks come
from a numpy seed (``random_bn_pair``) and data comes from the numpy ancestral
sampler in ``_golden_data``.  The port runs on the CPU
(``config.set_device("cpu")``), where every kernel wrapper uses its plain
PyTorch version.
"""

import numpy as np

from pgmpy_tpu_torch.config import config as torch_config
from pgmpy_tpu_torch.utils.interop import bn_from_numpy, lgbn_from_numpy

torch_config.set_device("cpu")


def np_values(values):
    """Host float64 copy of a jax array or torch tensor."""
    if hasattr(values, "detach"):
        values = values.detach().cpu().numpy()
    return np.asarray(values, dtype=np.float64)


def cpd_tuples(model):
    """(variable, card, values, evidence, evidence_card, state_names) per CPD."""
    out = []
    for cpd in model.get_cpds():
        evidence = list(cpd.variables[1:])
        out.append((
            cpd.variable,
            int(cpd.variable_card),
            np.asarray(cpd.get_values()),
            evidence,
            [int(c) for c in cpd.cardinality[1:]],
            {k: list(v) for k, v in cpd.state_names.items()},
        ))
    return out


def to_port(model):
    """The port's copy of a pgmpy_tpu DiscreteBayesianNetwork."""
    return bn_from_numpy(list(model.edges()), cpd_tuples(model), nodes=list(model.nodes()))


def lgbn_tuples(model):
    """(variable, parents, beta, std) per CPD of a linear-Gaussian network of
    either package."""
    return [(cpd.variable, list(cpd.evidence), np.asarray(cpd.beta, dtype=np.float64),
             float(cpd.std)) for cpd in model.get_cpds()]


def to_port_lgbn(model):
    """The port's copy of a pgmpy_tpu LinearGaussianBayesianNetwork."""
    return lgbn_from_numpy(list(model.edges()), lgbn_tuples(model), nodes=list(model.nodes()),
                           latents=model.latents)


def aligned(factor, variables):
    """``factor``'s values (either package) transposed to ``variables``."""
    order = [list(factor.variables).index(v) for v in variables]
    return np.transpose(np_values(factor.values), order)


def assert_factor_close(port_factor, jax_factor, atol, rtol=0.0):
    assert set(port_factor.variables) == set(jax_factor.variables)
    variables = list(jax_factor.variables)
    for v in variables:
        assert list(port_factor.state_names[v]) == list(jax_factor.state_names[v])
    np.testing.assert_allclose(
        aligned(port_factor, variables), np_values(jax_factor.values), atol=atol, rtol=rtol
    )


def random_bn_tables(seed, n_nodes=8, edge_prob=0.35, max_parents=3, deterministic=False):
    """(nodes, edges, CPD tuples as ``cpd_tuples`` returns them) of one random
    network, from a numpy seed, in float64: a random DAG over ``X0..X{n-1}``
    (edges from lower to higher index, at most ``max_parents`` parents),
    cardinalities 2-4, Dirichlet CPD columns and string state names.
    ``deterministic`` makes every non-root CPD a 0/1 table."""
    rng = np.random.default_rng(seed)
    names = [f"X{i}" for i in range(n_nodes)]
    cards = {v: int(rng.integers(2, 5)) for v in names}
    states = {v: [f"{v}_s{k}" for k in range(cards[v])] for v in names}
    parents = {}
    for j, v in enumerate(names):
        picked = [names[i] for i in range(j) if rng.random() < edge_prob]
        if j and not picked:
            picked = [names[int(rng.integers(0, j))]]  # keep the graph connected
        parents[v] = picked[-max_parents:]
    tuples = []
    for v in names:
        n_cols = int(np.prod([cards[p] for p in parents[v]])) if parents[v] else 1
        if deterministic and parents[v]:
            values = np.zeros((cards[v], n_cols))
            values[rng.integers(0, cards[v], n_cols), np.arange(n_cols)] = 1.0
        else:
            values = rng.dirichlet(np.ones(cards[v]), size=n_cols).T
        tuples.append((v, cards[v], values, parents[v], [cards[p] for p in parents[v]],
                       {u: states[u] for u in [v] + parents[v]}))
    return names, [(p, v) for v in names for p in parents[v]], tuples


def random_bn_pair(seed, **kwargs):
    """(port model, pgmpy_tpu model) of the network ``random_bn_tables``
    makes from ``seed``; the port's copy carries the JAX model's float32
    tables, so both packages compute on identical numbers."""
    from pgmpy_tpu.factors import TabularCPD as JaxCPD
    from pgmpy_tpu.models import DiscreteBayesianNetwork as JaxBN

    names, edges, tuples = random_bn_tables(seed, **kwargs)
    jax_model = JaxBN()
    jax_model.add_nodes_from(names)
    jax_model.add_edges_from(edges)
    jax_model.add_cpds(*[
        JaxCPD(v, card, values, evidence=evidence or None, evidence_card=ev_card or None,
               state_names=state_names)
        for v, card, values, evidence, ev_card, state_names in tuples
    ])
    return to_port(jax_model), jax_model


def brute_force_posterior(model, variables, evidence=None):
    """P(variables | evidence) of a small network of either package, by
    enumerating the full joint with numpy in float64: an oracle independent
    of both packages' inference code.  ``evidence`` maps variables to state
    names.  Axes of the result follow ``variables``."""
    evidence = evidence or {}
    nodes = list(model.nodes())
    letters = {v: chr(ord("a") + i) for i, v in enumerate(nodes)}
    operands, subs = [], []
    for cpd in model.get_cpds():
        operands.append(np_values(cpd.values))
        subs.append("".join(letters[v] for v in cpd.variables))
    for var, state in evidence.items():
        delta = np.zeros(len(model.states[var]))
        delta[list(model.states[var]).index(state)] = 1.0
        operands.append(delta)
        subs.append(letters[var])
    out = np.einsum(",".join(subs) + "->" + "".join(letters[v] for v in variables), *operands)
    return out / out.sum()


def random_2tbn(seed, n_vars=6):
    """(edges, CPD tuples) of a random 2-TBN: a DAG inside each slice and
    edges from the previous slice, the variables' sorted order not their
    topological order."""
    rng = np.random.default_rng(seed)
    names = [f"V{k}" for k in rng.permutation(n_vars)]  # topological order
    cards = {v: int(rng.integers(2, 4)) for v in names}
    intra = {v: [u for u in names[:j] if rng.random() < 0.4][:2] for j, v in enumerate(names)}
    # every variable persists (so that each has a node in slice 1), some
    # read another variable of the previous slice too
    inter = {v: sorted({v, *(str(u) for u in rng.choice(names, int(rng.integers(0, 2))))})
             for v in names}
    edges = [((u, 0), (v, 0)) for v in names for u in intra[v]]
    edges += [((u, 0), (v, 1)) for v in names for u in inter[v]]
    tuples = []
    for t in (0, 1):
        for v in names:
            evidence = [(u, t) for u in intra[v]] + ([(u, 0) for u in inter[v]] if t else [])
            ev_card = [cards[u] for u, _ in evidence]
            values = rng.dirichlet(np.ones(cards[v]), int(np.prod(ev_card))).T
            states = {(u, s): [f"{u}_{k}" for k in range(cards[u])] for u, s in evidence}
            states[(v, t)] = [f"{v}_{k}" for k in range(cards[v])]
            tuples.append(((v, t), cards[v], values, evidence, ev_card, states))
    return edges, tuples
