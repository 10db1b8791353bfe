"""Stage-0 programs for K2's ``clique_potentials`` tests, on the CPU and on
the card (no JAX here): random cliques and factors drawn with numpy from a
seed, as :func:`pgmpy_tpu_torch.ops.jt.build_plan` reads a program."""

from types import SimpleNamespace

import numpy as np

from pgmpy_tpu_torch.inference.bp import _broadcast_spec


def random_potential_program(seed, n_cliques=10):
    """(program, float64 factor tables): a program with stage 0 only (no
    messages) of ``n_cliques`` cliques, each of 1-6 axes of 1-5 states, with
    0-4 factors over random subsets of its axes in random orders.  The first
    clique, the middle one and the one after it have no factor (two adjacent
    factorless cliques make one run of ones), and the cliques' sizes leave most
    offsets off a 4-entry boundary."""
    rng = np.random.default_rng(seed)
    cliques, shapes, scopes, factor_shapes, specs = [], [], [], [], []
    empty = {0, n_cliques // 2, n_cliques // 2 + 1}
    for c in range(n_cliques):
        shape = tuple(int(n) for n in rng.integers(1, 6, size=int(rng.integers(1, 7))))
        names = [f"C{c}_{a}" for a in range(len(shape))]
        cliques.append(tuple(names))
        shapes.append(shape)
        clique_specs = []
        for _ in range(0 if c in empty else int(rng.integers(1, 5))):
            k = int(rng.integers(1, len(shape) + 1))
            scope = [names[a] for a in rng.choice(len(shape), size=k, replace=False)]
            perm, spec = _broadcast_spec(scope, names)
            clique_specs.append((len(factor_shapes), perm, spec))
            scopes.append(scope)
            factor_shapes.append(tuple(shape[names.index(v)] for v in scope))
        specs.append(clique_specs)
    program = SimpleNamespace(cliques=cliques, clique_shapes=shapes, sepset_shapes=[],
                              factor_shapes=factor_shapes, potential_specs=specs, messages=[],
                              n_edges=0)
    arrays = [rng.uniform(0.1, 2.0, size=s) for s in factor_shapes]
    return program, arrays
