"""The particle filter's slice sweep (K9) on the CPU, and what a CPU test can
see of its CUDA route (K5's kernel, ``csrc/ancestral.cu``, reading a previous
slice): the node table with previous-slice parents, the output columns, the
per-slice modes and the column-major matrix the wrapper hands the kernel,
emulated in numpy against the plain version on the same explicit noise.

Codes and log weights are compared to the bit where both sides subtract,
compare and add in the tables' type in node order; the log weights are held
to ``pgmpy_tpu``'s ``ParticleFilter._sweep`` at rtol 1e-5 (float32 sums of a
few log entries, every variable observed so that both sweeps are
deterministic), and the draws of nodes whose parents all lie in the previous
slice to their CPD columns within 5 standard errors, as
``tests/test_torch_smc.py`` holds the filter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgmpy_tpu.factors import TabularCPD as JaxCPD
from pgmpy_tpu.models import DynamicBayesianNetwork as JaxDBN
from pgmpy_tpu.sampling.smc import ParticleFilter as JaxParticleFilter

from _torch_parity import random_2tbn
from pgmpy_tpu_torch.ops import ancestral
from pgmpy_tpu_torch.sampling.smc import ParticleFilter
from pgmpy_tpu_torch.utils.interop import dbn_from_numpy
from pgmpy_tpu_torch.utils.mathext import race_noise, seeded_generator

N = 300


def jax_dbn(edges, tuples):
    dbn = JaxDBN()
    dbn.add_nodes_from(sorted({var[0] for var, *_ in tuples}))
    dbn.add_edges_from(edges)
    dbn.add_cpds(*[
        JaxCPD(var, card, values, evidence=ev or None, evidence_card=ec or None, state_names=sn)
        for var, card, values, ev, ec, sn in tuples
    ])
    return dbn


@pytest.fixture(scope="module", params=[3, 4, 5])
def pair(request):
    edges, tuples = random_2tbn(request.param)
    return ParticleFilter(dbn_from_numpy(edges, tuples), n_particles=N), jax_dbn(edges, tuples), \
        tuples


def random_prev(pf, seed):
    rng = np.random.default_rng(seed)
    cards = [pf.cards[v] for v in pf.variables]
    return torch.as_tensor(np.stack([rng.integers(0, c, N) for c in cards]))


def test_node_tables_of_both_slices(pair):
    pf, _, tuples = pair
    d = len(pf.variables)
    cpds = {var: (ev, ec) for var, _, _, ev, ec, _ in tuples}
    start, trans = pf._start_specs, pf._trans_specs
    assert start.particle and trans.particle and not start.has_prev
    assert trans.has_prev == any(p[1] == 0 for (v, t), (ev, _) in cpds.items() if t == 1
                                 for p in ev)
    for time_slice, tables in ((0, start), (1, trans)):
        assert sorted(tables.columns.tolist()) == list(range(d))
        drawn = set()
        for i, (parents, strides, table) in enumerate(tables.node_specs):
            var = pf.variables[tables.columns[i]]
            evidence, ev_card = cpds[(var, time_slice)]
            want = [pf.var_index[u] + (d if s != time_slice else 0) for u, s in evidence]
            assert list(parents) == want and tables.nodes[i, 3] == len(want)
            assert tables.nodes[i, 4: 4 + len(want)].tolist() == want
            assert tuple(table.shape) == (int(np.prod(ev_card)), pf.cards[var])
            # a parent in this slice is drawn before its child
            assert all(p >= d or p in drawn for p in parents)
            drawn.add(int(tables.columns[i]))
        # levels: one more than the highest level of the parents in this slice
        node_of = {int(c): i for i, c in enumerate(tables.columns)}
        level = np.zeros(d, dtype=int)
        groups = (tables.starts.size - 1) // tables.n_levels
        for lv in range(tables.n_levels):
            level[tables.schedule[tables.starts[lv * groups]: tables.starts[(lv + 1) * groups]]] = lv
        for i, (parents, _, _) in enumerate(tables.node_specs):
            inside = [level[node_of[p]] for p in parents if p < d]
            assert level[i] == 1 + max(inside, default=-1)


def emulated_slice(tables, n, modes, noise, prev):
    """The kernel's arithmetic in numpy from the node table, the columns, the
    modes and the flat log tables it is handed; rows side by side, nodes in
    order, parents of index d + j read from the previous slice's column j."""
    nodes, columns = tables.nodes, tables.columns
    d, width = len(nodes), (nodes.shape[1] - 4) // 2
    flat_tables = torch.cat([t.reshape(-1) for _, _, t in tables.node_specs]).numpy()
    noise, prev = noise.numpy(), prev.numpy().astype(np.int64)
    codes = np.zeros((d, n), dtype=np.int64)
    lw = np.zeros(n, dtype=flat_tables.dtype)
    rows = np.arange(n)
    for i, (card, offset, first, n_parents) in enumerate(nodes[:, :4]):
        flat = np.zeros(n, dtype=np.int64)
        for j in range(n_parents):
            p = nodes[i, 4 + j]
            flat += (codes[p] if p < d else prev[p - d, :n]) * nodes[i, 4 + width + j]
        logits = flat_tables[offset + flat[:, None] * card + np.arange(card)]
        if modes[i] <= -2:
            lw = lw + logits[rows, -2 - modes[i]]
            codes[columns[i]] = -2 - modes[i]
        else:
            codes[columns[i]] = np.argmax(logits - noise[first: first + card].T, axis=1)
    return codes, lw


@pytest.mark.parametrize("observed", [0, 2, 4])
def test_node_table_computes_the_plain_slice(pair, observed):
    pf, _, _ = pair
    tables = pf._trans_specs
    rng = np.random.default_rng(observed)
    ev_codes = np.full(len(pf.variables), -1)
    for c in rng.choice(len(pf.variables), observed, replace=False):
        ev_codes[c] = rng.integers(0, pf.cards[pf.variables[c]])
    prev = random_prev(pf, 1)
    noise = race_noise((sum(tables.cards), N), seeded_generator(2), torch.float32)
    evidence = {i: int(ev_codes[c]) for i, c in enumerate(tables.columns) if ev_codes[c] >= 0}
    out = pf._code_matrix()
    codes, logw = ancestral.sweep_reference(tables, N, None, evidence=evidence, noise=noise,
                                            prev=prev, out=out)
    assert codes.data_ptr() == out.data_ptr() and tuple(codes.shape) == (len(pf.variables), N)
    assert (out[:, N:] == -1).all()  # the padding is left alone
    want_codes, want_lw = emulated_slice(tables, N, tables.modes(evidence=evidence), noise, prev)
    np.testing.assert_array_equal(codes.long().numpy(), want_codes)
    if evidence:
        np.testing.assert_array_equal(logw.numpy(), want_lw)
    else:
        assert logw is None


def test_explicit_noise_gives_the_generator_draw(pair):
    pf, _, _ = pair
    tables = pf._trans_specs
    ev_codes = np.full(len(pf.variables), -1)
    ev_codes[0] = 1
    prev = random_prev(pf, 3)
    want, want_lw = pf._sweep(seeded_generator(4), prev, tables, ev_codes)
    gen = seeded_generator(4)
    noise = torch.zeros(sum(tables.cards), N)
    for i, card in enumerate(tables.cards):
        if tables.columns[i] != 0:  # the observed variable draws nothing
            first = int(tables.noise_offsets[i])
            noise[first: first + card] = race_noise((N, card), gen, torch.float32).t()
    evidence = {i: 1 for i, c in enumerate(tables.columns) if c == 0}
    got, got_lw = ancestral.sweep_reference(tables, N, None, evidence=evidence, noise=noise,
                                            prev=prev, out=pf._code_matrix())
    assert torch.equal(got, want) and torch.equal(got_lw, want_lw)


def test_log_weights_match_the_jax_sweep(pair):
    """Every variable observed: both packages' sweeps are deterministic, the
    states are the evidence and the log weight is the slice's log
    probability given the previous slice."""
    pf, jax_model, _ = pair
    ref = JaxParticleFilter(jax_model, n_particles=N)
    assert ref.variables == pf.variables
    rng = np.random.default_rng(5)
    ev_codes = np.array([rng.integers(0, pf.cards[v]) for v in pf.variables])
    prev = random_prev(pf, 6)
    for port_specs, jax_specs in ((pf._start_specs, ref._start_specs),
                                  (pf._trans_specs, ref._trans_specs)):
        cur, logw = pf._sweep(seeded_generator(0), prev, port_specs, ev_codes)
        want_cur, want_lw = ref._sweep(jax.random.PRNGKey(0), jnp.asarray(prev.numpy().T),
                                       jax_specs, jnp.asarray(ev_codes, dtype=jnp.int32))
        np.testing.assert_array_equal(cur.long().numpy().T, np.asarray(want_cur))
        np.testing.assert_allclose(logw.numpy(), np.asarray(want_lw), rtol=1e-5, atol=1e-6)


def test_draws_from_the_previous_slice_follow_the_cpd(pair):
    """A node whose parents all lie in the previous slice draws from its
    CPD's columns: per state, the share of particles within 5 standard errors
    of the mean probability over the particles' columns."""
    pf, _, tuples = pair
    n = 20_000
    big = ParticleFilter(pf.model, n_particles=n)
    d = len(big.variables)
    rng = np.random.default_rng(7)
    prev = torch.as_tensor(np.stack([rng.integers(0, big.cards[v], n) for v in big.variables]))
    cur, _ = big._sweep(seeded_generator(8), prev, big._trans_specs, np.full(d, -1))
    checked = 0
    for i, (parents, strides, table) in enumerate(big._trans_specs.node_specs):
        if any(p < d for p in parents):
            continue
        flat = sum(prev[p - d].long() * s for p, s in zip(parents, strides)) if parents else \
            torch.zeros(n, dtype=torch.int64)
        probs = torch.exp(table.double())[flat]  # (n, card)
        want = probs.mean(dim=0).numpy()
        got = np.bincount(cur[big._trans_specs.columns[i]].long().numpy(),
                          minlength=len(want)) / n
        assert (np.abs(got - want) <= 5 * np.sqrt(want * (1 - want) / n) + 1e-4).all()
        checked += 1
    assert checked


def test_one_sweep_per_slice_into_the_count_matrix(pair, monkeypatch):
    pf, _, _ = pair
    calls = []
    real = ancestral.sweep
    monkeypatch.setattr(ancestral, "sweep", lambda *a, **k: calls.append(k["out"]) or
                        real(*a, **k))
    ancestral.reset_launches()
    pf.filter({(pf.variables[0], 1): 0}, n_time_slices=5, seed=0)
    assert len(calls) == 5 and all(out is calls[0] for out in calls)
    assert calls[0].dtype == torch.int8 and calls[0].shape[1] % 16 == 0
    assert ancestral.PARTICLE_LAUNCHES == 0 and ancestral.LAUNCHES == 0  # no card here


def test_the_cuda_route_refuses(pair):
    pf, _, _ = pair
    tables = pf._trans_specs
    with pytest.raises(ValueError, match="CUDA"):
        ancestral.sweep_cuda(tables, N, None, prev=random_prev(pf, 0))
    if tables.has_prev:
        with pytest.raises(ValueError, match="prev"):
            ancestral.sweep_reference(tables, N, seeded_generator(0))
    with pytest.raises(ValueError, match="out"):
        ancestral.sweep_reference(pf._start_specs, N, seeded_generator(0),
                                  out=torch.zeros((len(pf.variables), N), dtype=torch.int32))
    with pytest.raises(ValueError, match="permutation"):
        ancestral.SweepTables(tables.node_specs, tables.cards, torch.int8,
                              columns=[0] * len(tables.cards))
