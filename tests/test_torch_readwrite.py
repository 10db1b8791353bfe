"""The port's readers and writers against pgmpy_tpu's on the CPU.

Every writer of the port reads a CPD's values once, through
``TabularCPD.get_values`` (or ``to_numpy``), so at the default float32 its
text is BYTE FOR BYTE what the JAX package's writer produces on the same
network: asia, ALARM and the random networks ``tests/testdata/net{0,1}.bif``.
Each package reads the other's files to equal CPDs, and the port reads the
files the reference pgmpy wrote (``tests/testdata/ref*``) to the CPDs of
``net{0,1}.bif``.  UAI names variables ``var_i`` in the writer's canonical
order and keeps only cardinalities, so a UAI model is compared by that index.
The PomdpX cases are those of ``tests/test_pomdpx.py``, run through the port
and compared with the JAX package's dicts.
"""

import gzip
import os

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (puts the port on the CPU)
from test_pomdpx import POMDPX, POMDPX_DD

import pgmpy_tpu.readwrite as jax_rw
import pgmpy_tpu_torch.readwrite as port_rw
from pgmpy_tpu.utils import get_example_model as jax_example
from pgmpy_tpu_torch.factors import DiscreteFactor, TabularCPD
from pgmpy_tpu_torch.models import DiscreteBayesianNetwork, DiscreteMarkovNetwork
from pgmpy_tpu_torch.utils import get_example_model as port_example

TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")
NETWORK_FORMATS = ["xmlbif", "net", "uai", "xdsl", "xbn"]
NETWORKS = ["asia", "alarm", "net0", "net1"]


def load_pair(name):
    """(port model, JAX model) of an example network or a testdata BIF."""
    if name.startswith("net"):
        path = os.path.join(TESTDATA, f"{name}.bif")
        return port_rw.BIFReader(path).get_model(), jax_rw.BIFReader(path).get_model()
    return port_example(name), jax_example(name)


def canonical(model):
    """{variable: (evidence, float64 CPD table)} of either package's model."""
    return {
        str(node): ([str(v) for v in model.get_cpds(node).variables[1:]],
                    np.asarray(model.get_cpds(node).get_values(), dtype=np.float64))
        for node in model.nodes()
    }


def assert_same_network(got, want, atol=0.0):
    assert set(map(str, got.nodes())) == set(map(str, want.nodes()))
    assert {tuple(map(str, e)) for e in got.edges()} == {tuple(map(str, e)) for e in want.edges()}
    got_cpds, want_cpds = canonical(got), canonical(want)
    for node, (evidence, values) in want_cpds.items():
        assert got_cpds[node][0] == evidence, node
        np.testing.assert_allclose(got_cpds[node][1], values, rtol=0, atol=atol, err_msg=node)
    if hasattr(want.get_cpds(next(iter(want.nodes()))), "state_names"):
        for node in want.nodes():
            g, w = got.get_cpds(str(node)), want.get_cpds(str(node))
            assert {k: list(map(str, v)) for k, v in g.state_names.items()} == {
                k: list(map(str, v)) for k, v in w.state_names.items()}, node


@pytest.mark.parametrize("name", NETWORKS)
@pytest.mark.parametrize("fmt", NETWORK_FORMATS)
def test_writer_output_is_byte_identical(tmp_path, fmt, name):
    port_model, jax_model = load_pair(name)
    port_path, jax_path = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
    port_rw.get_writer(fmt)(port_model).write_file(str(port_path))
    jax_rw.get_writer(fmt)(jax_model).write_file(str(jax_path))
    assert port_path.read_bytes() == jax_path.read_bytes()


@pytest.mark.parametrize("name", ["asia", "net0", "net1"])
@pytest.mark.parametrize("fmt", NETWORK_FORMATS)
def test_each_package_reads_the_others_files(tmp_path, fmt, name):
    port_model, jax_model = load_pair(name)
    port_path, jax_path = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
    port_rw.get_writer(fmt)(port_model).write_file(str(port_path))
    jax_rw.get_writer(fmt)(jax_model).write_file(str(jax_path))
    port_reads_jax = port_rw.get_reader(fmt)(path=str(jax_path)).get_model()
    jax_reads_port = jax_rw.get_reader(fmt)(path=str(port_path)).get_model()
    jax_reads_jax = jax_rw.get_reader(fmt)(path=str(jax_path)).get_model()
    # the written text keeps every float32 digit: tables read back exactly
    assert_same_network(port_reads_jax, jax_reads_jax)
    assert_same_network(jax_reads_port, jax_reads_jax)
    if fmt != "uai":
        assert_same_network(port_reads_jax, port_model)
    port_reads_jax.check_model()


def uai_mapping(base):
    """{var_i: name} of the UAI writer's canonical (cardinality-string, name)
    order."""
    domain = {str(v): str(base.get_cpds(v).variable_card) for v in base.nodes()}
    order = [v for v, _ in sorted(domain.items(), key=lambda x: (x[1], x[0]))]
    return {f"var_{idx}": name for idx, name in enumerate(order)}


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("fmt", NETWORK_FORMATS)
def test_reads_reference_written_files(fmt, i):
    base = port_rw.BIFReader(os.path.join(TESTDATA, f"net{i}.bif")).get_model()
    model = port_rw.get_reader(fmt)(path=os.path.join(TESTDATA, f"ref{i}.{fmt}")).get_model()
    model.check_model()
    jax_model = jax_rw.get_reader(fmt)(path=os.path.join(TESTDATA, f"ref{i}.{fmt}")).get_model()
    assert canonical(model).keys() == canonical(jax_model).keys()
    for node, (evidence, values) in canonical(jax_model).items():
        assert canonical(model)[node][0] == evidence
        np.testing.assert_array_equal(canonical(model)[node][1], values)
    if fmt == "uai":
        mapping = uai_mapping(base)
        assert {(mapping[u], mapping[v]) for u, v in model.edges()} == {
            (str(u), str(v)) for u, v in base.edges()}
        for var, name in mapping.items():
            got, want = model.get_cpds(var), base.get_cpds(name)
            assert [mapping[x] for x in got.variables] == [str(x) for x in want.variables]
            np.testing.assert_allclose(got.get_values(), want.get_values(), atol=1e-6)
        return
    base_cpds = canonical(base)
    assert {tuple(map(str, e)) for e in model.edges()} == {tuple(map(str, e)) for e in base.edges()}
    for node, (evidence, values) in canonical(model).items():
        assert sorted(evidence) == sorted(base_cpds[node][0])
        np.testing.assert_allclose(values, base_cpds[node][1], atol=1e-6, err_msg=node)


def test_uai_markov_matches_jax(tmp_path):
    from pgmpy_tpu.factors import DiscreteFactor as JaxFactor
    from pgmpy_tpu.models import DiscreteMarkovNetwork as JaxMN

    rng = np.random.default_rng(5)
    tables = [rng.random(6) + 0.1, rng.random(6) + 0.1]
    scopes = [(["a", "b"], [2, 3]), (["b", "c"], [3, 2])]
    texts = []
    for network, factor in ((DiscreteMarkovNetwork, DiscreteFactor), (JaxMN, JaxFactor)):
        mn = network([("a", "b"), ("b", "c")])
        mn.add_factors(*[factor(v, c, t) for (v, c), t in zip(scopes, tables)])
        path = tmp_path / f"{network.__module__.split('.')[0]}.uai"
        (port_rw.UAIWriter if network is DiscreteMarkovNetwork else jax_rw.UAIWriter)(
            mn).write_file(str(path))
        texts.append(path.read_bytes())
    assert texts[0] == texts[1]
    back = port_rw.UAIReader(path=str(tmp_path / "pgmpy_tpu_torch.uai")).get_model()
    assert isinstance(back, DiscreteMarkovNetwork)
    for f, t in zip(back.get_factors(), tables):
        np.testing.assert_allclose(_torch_parity.np_values(f.values).ravel(), t.astype(np.float32))


def cancer_model():
    model = DiscreteBayesianNetwork([("Pollution", "Cancer"), ("Smoker", "Cancer")])
    model.name = "cancer"
    model.add_cpds(
        TabularCPD("Pollution", 2, [[0.9], [0.1]], state_names={"Pollution": ["low", "high"]}),
        TabularCPD("Smoker", 2, [[0.3], [0.7]], state_names={"Smoker": ["True", "False"]}),
        TabularCPD("Cancer", 2, [[0.03, 0.05, 0.001, 0.02], [0.97, 0.95, 0.999, 0.98]],
                   evidence=["Smoker", "Pollution"], evidence_card=[2, 2],
                   state_names={"Cancer": ["True", "False"], "Smoker": ["True", "False"],
                                "Pollution": ["low", "high"]}),
    )
    return model


@pytest.mark.parametrize("suffix", ["", ".gz"])
@pytest.mark.parametrize("fmt", ["bif", "xmlbif", "net", "xdsl", "xbn", "uai"])
def test_save_load_by_extension(tmp_path, fmt, suffix):
    model = cancer_model()
    path = str(tmp_path / f"model.{fmt}{suffix}")
    model.save(path)
    if suffix:
        plain = tmp_path / f"plain.{fmt}"
        port_rw.get_writer(fmt)(model).write_file(str(plain))
        with gzip.open(path, "rb") as f:
            assert f.read() == plain.read_bytes()
    back = DiscreteBayesianNetwork.load(path)
    if fmt == "uai":
        mapping = uai_mapping(model)
        assert {mapping[v] for v in back.nodes()} == set(model.nodes())
        for var, name in mapping.items():
            np.testing.assert_array_equal(back.get_cpds(var).get_values(),
                                          model.get_cpds(name).get_values())
        return
    assert_same_network(back, model)


def test_unknown_format_raises(tmp_path):
    with pytest.raises(ValueError, match="Unknown file format"):
        port_rw.get_reader("bogus")
    with pytest.raises(ValueError, match="Unknown file format"):
        port_rw.get_writer("bogus")
    with pytest.raises(ValueError, match="Unknown file format"):
        cancer_model().save(str(tmp_path / "model.bogus"))
    assert sorted(port_rw._READERS) == sorted(port_rw._WRITERS) == sorted(
        ["bif", "xmlbif", "net", "uai", "xdsl", "xbn", "pomdpx"])


def pomdpx_model_data(reader):
    return {
        "description": reader.get_description(),
        "discount": reader.get_discount(),
        "variables": reader.get_variables(),
        "initial_state_belief": reader.get_initial_beliefs(),
        "state_transition_function": reader.get_state_transition_function(),
        "obs_function": reader.get_obs_function(),
        "reward_function": reader.get_reward_function(),
    }


@pytest.mark.parametrize("text", [POMDPX, POMDPX_DD], ids=["tbl", "dd"])
def test_pomdpx_reader_matches_jax(text):
    port = pomdpx_model_data(port_rw.PomdpXReader(string=text))
    want = pomdpx_model_data(jax_rw.PomdpXReader(string=text))
    assert port == want


def test_pomdpx_reader():
    reader = port_rw.PomdpXReader(string=POMDPX)
    assert reader.get_discount() == 0.95
    variables = reader.get_variables()
    assert variables["StateVar"][0]["ValueEnum"] == ["s0", "s1", "s2"]
    assert variables["StateVar"][0]["fullyObs"] is True
    assert variables["ObsVar"][0]["vname"] == "obs_sensor"
    assert reader.get_initial_beliefs()[0]["Parameter"][0]["ProbTable"] == ["0.0", "1.0", "0.0"]
    assert reader.get_state_transition_function()[0]["Parent"] == ["action_rover", "rover_0"]
    assert reader.get_reward_function()[0]["Parameter"][0]["ValueTable"] == ["10"]


@pytest.mark.parametrize("text", [POMDPX, POMDPX_DD], ids=["tbl", "dd"])
def test_pomdpx_roundtrip_and_writer_text(tmp_path, text):
    data = pomdpx_model_data(port_rw.PomdpXReader(string=text))
    path = tmp_path / "model.pomdpx"
    port_rw.PomdpXWriter(data).write_file(str(path))
    back = pomdpx_model_data(port_rw.PomdpXReader(path=str(path)))
    assert back == data
    assert str(port_rw.PomdpXWriter(data)) == str(jax_rw.PomdpXWriter(data))


def test_pomdpx_dd_parameters():
    reader = port_rw.PomdpXReader(string=POMDPX_DD)
    assert reader.get_initial_beliefs()[0]["Parameter"] == {
        "rover_0": {"s0": "0.0", "s1": {"type": "uniform", "var": "rock_0"}, "s2": "0.0"}}
    param = reader.get_state_transition_function()[0]["Parameter"]
    assert param["id"] == "moveTemplate"
    assert param["SubDAGTemplate"] == {"rock_0": {"good": "0.9", "bad": "0.1"}}
    assert param["action_rover"]["ame"] == {"type": "deterministic", "var": "rover_1", "val": "s2"}


@pytest.mark.slow
@pytest.mark.parametrize("fmt", NETWORK_FORMATS)
def test_munin_round_trip(tmp_path, fmt):
    """MUNIN (1041 variables, 98,423 entries) through every format: the text
    equals the JAX package's and reads back to the same tables."""
    port_model, jax_model = port_example("munin"), jax_example("munin")
    port_path, jax_path = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
    port_model.save(str(port_path))
    jax_rw.get_writer(fmt)(jax_model).write_file(str(jax_path))
    assert port_path.read_bytes() == jax_path.read_bytes()
    back = DiscreteBayesianNetwork.load(str(port_path))
    if fmt == "uai":
        mapping = uai_mapping(port_model)
        for var, name in mapping.items():
            np.testing.assert_array_equal(back.get_cpds(var).get_values(),
                                          port_model.get_cpds(name).get_values())
    else:
        assert_same_network(back, port_model)
