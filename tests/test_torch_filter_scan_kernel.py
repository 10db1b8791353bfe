"""The exact filter's scan (K10) on the CPU, and what a CPU test can see of
its CUDA route (``filter_scan`` in ``csrc/einsum_plan.cu``): the tables of
``ops/einsum.py:ScanProgram`` walked in numpy (``tests/_torch_einsum_walk.py``:
the deltas from each slice's codes, the slice's steps, the normalisations,
the query rows, alpha carried on) against the plain ``forward_scan``, both
against ``pgmpy_tpu``'s ``forward_scan``, and the slice-0 evidence fix.

Tolerances: float32 filters against ``pgmpy_tpu`` at atol 1e-5 (normalised
marginals, a few dozen slices of float32 products); in float64 the numpy
walk against the plain version at 1e-12 and the port against a numpy
recursion over the joint slice state at 1e-10.  The kernel on a card:
``tests/test_torch_filter_scan_kernel_cuda.py``."""

import numpy as np
import pytest
import torch

from _torch_einsum_walk import walk_scan
from _torch_parity import random_2tbn
from pgmpy_tpu.factors import TabularCPD as JaxCPD
from pgmpy_tpu.inference import DBNInference as JaxDBNInference
from pgmpy_tpu.models import DynamicBayesianNetwork as JaxDBN
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.factors.factor_ops import factor_sum_product
from pgmpy_tpu_torch.inference import DBNInference
from pgmpy_tpu_torch.inference.dbn import scan_reference
from pgmpy_tpu_torch.ops import einsum as E
from pgmpy_tpu_torch.utils.interop import dbn_from_numpy

N_SLICES = 9


def rain_network():
    """(edges, CPD tuples) of the rain / umbrella 2-TBN."""
    states = {("rain", t): ["dry", "wet"] for t in (0, 1)}
    states.update({("umbrella", t): ["no", "yes"] for t in (0, 1)})
    emission = np.array([[0.8, 0.1], [0.2, 0.9]])

    def names(*keys):
        return {k: states[k] for k in keys}

    tuples = [(("rain", 0), 2, np.array([[0.5], [0.5]]), [], [], names(("rain", 0))),
              (("umbrella", 0), 2, emission, [("rain", 0)], [2],
               names(("umbrella", 0), ("rain", 0))),
              (("rain", 1), 2, np.array([[0.7, 0.3], [0.3, 0.7]]), [("rain", 0)], [2],
               names(("rain", 1), ("rain", 0))),
              (("umbrella", 1), 2, emission, [("rain", 1)], [2],
               names(("umbrella", 1), ("rain", 1)))]
    return [(("rain", 0), ("umbrella", 0)), (("rain", 0), ("rain", 1))], tuples


NETWORKS = {"rain": rain_network, **{f"random{s}": (lambda s=s: random_2tbn(s)) for s in range(4)}}


def networks(name):
    edges, tuples = NETWORKS[name]()
    jax_model = JaxDBN()
    jax_model.add_edges_from(edges)
    jax_model.add_cpds(*[
        JaxCPD(var, card, values, evidence=ev or None, evidence_card=ec or None, state_names=sn)
        for var, card, values, ev, ec, sn in tuples])
    return edges, tuples, jax_model


def names_of(tuples):
    return sorted({var[0] for var, *_ in tuples})


def later_evidence(tuples, seed):
    """Evidence at slices >= 1 on random variables (``pgmpy_tpu`` refuses
    slice-0 evidence on an interface variable, and every variable of these
    networks persists)."""
    rng = np.random.default_rng(seed)
    cards = {var[0]: card for var, card, *_ in tuples}
    names = names_of(tuples)
    return {(v, t): int(rng.integers(cards[v])) for t in range(1, N_SLICES)
            for v in names if rng.random() < 0.3}


def joint_forward(tuples, evidence, n_slices):
    """Filtered marginals {(name, t): array} by a numpy float64 forward
    recursion over the JOINT state of a slice, for any 2-TBN given as CPD
    tuples; evidence masks the slice's joint (slice 0 included).  The joint
    transition matrix is built by broadcasting every CPD over (previous,
    current) joint states."""
    names = names_of(tuples)
    cards = {var[0]: card for var, card, *_ in tuples}
    shape = [cards[v] for v in names]
    digits = np.indices(shape).reshape(len(names), -1)  # (variables, joint states)
    cpds = {var: (values.reshape([card] + list(ec)), ev)
            for var, card, values, ev, ec, _ in tuples}

    def joint(local):
        """P(current | previous) as (previous, current) (slice 0: (1, current))."""
        prob = 1.0
        for j, v in enumerate(names):
            table, parents = cpds[(v, local)]
            idx = [digits[j][None, :]] + [
                digits[names.index(u)][None, :] if s == local else digits[names.index(u)][:, None]
                for u, s in parents]
            prob = prob * table[tuple(idx)]
        return np.broadcast_to(prob, (1 if local == 0 else digits.shape[1], digits.shape[1]))

    start, step = joint(0)[0], joint(1)
    out, alpha = {}, None
    for t in range(n_slices):
        new = (start if t == 0 else alpha.reshape(-1) @ step).reshape(shape)
        for (v, et), code in evidence.items():
            if et == t:
                mask = np.zeros(cards[v])
                mask[code] = 1.0
                new = new * mask.reshape([-1 if u == v else 1 for u in names])
        alpha = new / new.sum()
        for j, v in enumerate(names):
            out[(v, t)] = alpha.sum(axis=tuple(k for k in range(len(names)) if k != j))
    return out


@pytest.fixture
def float64():
    config.set_dtype(torch.float64)
    try:
        yield
    finally:
        config.set_dtype(torch.float32)


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_table_walk_matches_plain(name, merged, float64, monkeypatch):
    """Merged: one contraction to the joint over the interface and the
    queries, a one-input step from it per output; unmerged (a joint past
    ``SCAN_JOINT``): each output's own plan."""
    if not merged:
        monkeypatch.setattr(E, "SCAN_JOINT", 1)
    edges, tuples, _ = networks(name)
    infer = DBNInference(dbn_from_numpy(edges, tuples))
    variables = names_of(tuples)
    inputs = infer._scan_inputs(variables, later_evidence(tuples, 1), N_SLICES)
    alpha = factor_sum_product(inputs["iface0"], inputs["factors0"]).normalize(
        inplace=False).values
    program = infer._scan_program(inputs)
    assert program.merged == merged
    assert program.width == sum(inputs["query_cards"])
    assert program.results[-1, 2] == -1 and program.results[-1, 0] + program.results[-1, 1] <= \
        program.arena
    want = scan_reference(inputs, alpha).numpy()
    got = walk_scan(program, alpha, inputs["trans_arrays"], inputs["codes"])
    assert got.shape == want.shape == (N_SLICES - 1, program.width)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_forward_scan_matches_jax(name):
    edges, tuples, jax_model = networks(name)
    variables = names_of(tuples)
    evidence = later_evidence(tuples, 2)
    got = DBNInference(dbn_from_numpy(edges, tuples)).forward_scan(
        variables, evidence, n_time_slices=N_SLICES)
    want = JaxDBNInference(jax_model).forward_scan(variables, evidence, n_time_slices=N_SLICES)
    assert set(got) == set(want) and len(got) == len(variables) * N_SLICES
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-5, err_msg=str(key))


@pytest.mark.parametrize("name", ["random0", "random2"])
def test_float64_against_the_joint_recursion(name, float64):
    edges, tuples, _ = networks(name)
    evidence = later_evidence(tuples, 3)
    variables = names_of(tuples)
    got = DBNInference(dbn_from_numpy(edges, tuples)).forward_scan(
        variables, evidence, n_time_slices=N_SLICES)
    oracle = joint_forward(tuples, evidence, N_SLICES)
    for key, value in got.items():
        np.testing.assert_allclose(value, oracle[key], atol=1e-10, err_msg=str(key))


def _slice0_cases():
    _, tuples = random_2tbn(0)
    return [v for v in names_of(tuples)]


@pytest.mark.parametrize("observed", _slice0_cases())
def test_slice0_evidence_on_an_interface_variable(observed):
    """``pgmpy_tpu`` reduces an observed slice-0 variable out of the start
    factors and then raises for the interface; the port keeps it in alpha as
    a one-hot mask and answers the joint recursion's marginals."""
    edges, tuples, jax_model = networks("random0")
    variables = names_of(tuples)
    jax_infer = JaxDBNInference(jax_model)
    assert set(v for v, _ in jax_infer.interface_nodes_0) == set(variables)
    evidence = {(observed, 0): 0, (variables[0], 3): 1}
    with pytest.raises(ValueError):
        jax_infer.forward_scan(variables, evidence, n_time_slices=6)
    oracle = joint_forward(tuples, evidence, 6)
    got = DBNInference(dbn_from_numpy(edges, tuples)).forward_scan(
        variables, evidence, n_time_slices=6)
    assert len(got) == 6 * len(variables)
    np.testing.assert_array_equal(got[(observed, 0)], np.eye(len(got[(observed, 0)]))[0])
    for key, value in got.items():
        np.testing.assert_allclose(value, oracle[key], atol=1e-5, err_msg=str(key))
    config.set_dtype(torch.float64)
    try:
        got = DBNInference(dbn_from_numpy(edges, tuples)).forward_scan(
            variables, evidence, n_time_slices=6)
    finally:
        config.set_dtype(torch.float32)
    for key, value in got.items():
        np.testing.assert_allclose(value, oracle[key], atol=1e-10, err_msg=str(key))


def test_slice0_evidence_is_validated():
    edges, tuples, _ = networks("random0")
    infer = DBNInference(dbn_from_numpy(edges, tuples))
    with pytest.raises(ValueError):
        infer.forward_scan(["V0"], {("V0", 0): 9}, n_time_slices=3)
    # a name that no slice-0 variable has is ignored, as before
    base = infer.forward_scan(["V0"], {}, n_time_slices=3)
    ignored = infer.forward_scan(["V0"], {("Q", 0): 0}, n_time_slices=3)
    for key in base:
        np.testing.assert_array_equal(base[key], ignored[key])


def test_one_program_per_output_signature():
    edges, tuples, _ = networks("random1")
    infer = DBNInference(dbn_from_numpy(edges, tuples))
    variables = names_of(tuples)
    first = infer._scan_program(infer._scan_inputs(variables, {}, 4))
    again = infer._scan_program(infer._scan_inputs(variables, {(variables[0], 2): 1}, 7))
    other = infer._scan_program(infer._scan_inputs(variables[:1], {}, 4))
    assert first is again and other is not first
    # the deltas: one arena entry per (slice-1 variable, state)
    assert len(first.deltas) == sum(first.deltas[:, 1] == first.deltas[:, 1]) == len(
        set(map(tuple, first.deltas[:, 1:])))
