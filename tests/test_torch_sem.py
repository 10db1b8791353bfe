"""The SEM lane of the port against pgmpy_tpu on the CPU.

``SEMGraph.to_lisrel`` / ``to_standard_lisrel``, ``SEMAlg.implied_covariance``
and ``generate_samples``, the three ``SEMEstimator`` losses and their
gradients, ``utils/optimizer.optimize`` (each of the eight optimizers of the
JAX package's table step for step, the chunked stopping rule, ``lbfgs`` to
the same optimum), a Sigma that is not positive definite, ``fit`` on a
saturated path model against OLS, ``IVEstimator`` (a rank-deficient design
included) and ``pinverse``.

JAX stays float32 in the test process, so the port runs float32 against it
(rtol 1e-5 for one evaluation; rtol 1e-4 with atol 1e-5 over 64 optimizer
steps, whose entries pass near 0); closed-form oracles run the port in
float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

import _torch_parity  # noqa: F401  (puts the port on the CPU)
from pgmpy_tpu.estimators.sem_estimator import IVEstimator as JaxIV
from pgmpy_tpu.estimators.sem_estimator import SEMEstimator as JaxSEMEstimator
from pgmpy_tpu.models.sem import SEM as JaxSEM
from pgmpy_tpu.models.sem import SEMGraph as JaxSEMGraph
from pgmpy_tpu.utils import optimizer as jax_opt
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.estimators import IVEstimator, SEMEstimator
from pgmpy_tpu_torch.models import SEM, SEMGraph
from pgmpy_tpu_torch.utils import optimize, pinverse
from pgmpy_tpu_torch.utils.interop import sem_params_from_numpy

GRAPHS = {
    "measurement": dict(
        ebunch=[("xi1", "x1"), ("xi1", "x2"), ("xi1", "x3"), ("xi1", "eta1"), ("eta1", "y1"),
                ("eta1", "y2"), ("eta1", "y3"), ("eta1", "y4"), ("eta1", "eta2"),
                ("xi1", "eta2"), ("eta2", "y5"), ("eta2", "y6"), ("eta2", "y7"),
                ("eta2", "y8")],
        latents=["xi1", "eta1", "eta2"]),
    "weighted_err_corr": dict(
        ebunch=[("xi1", "x1", 1.0), ("xi1", "x2"), ("xi1", "eta1", 0.3), ("eta1", "y1", 1.0),
                ("eta1", "y2")],
        latents=["xi1", "eta1"], err_corr=[("y1", "y2"), ("x1", "x2", 0.2)],
        err_var={"x1": 0.5}),
    "path": dict(ebunch=[("x1", "x2"), ("x1", "x3"), ("x2", "x3"), ("x3", "x4")]),
}


def both(name):
    return SEMGraph(**GRAPHS[name]), JaxSEMGraph(**GRAPHS[name])


def same_nan_array(a, b):
    np.testing.assert_array_equal(np.isnan(np.asarray(a, dtype=float)),
                                  np.isnan(np.asarray(b, dtype=float)))
    np.testing.assert_array_equal(np.nan_to_num(np.asarray(a, dtype=float)),
                                  np.nan_to_num(np.asarray(b, dtype=float)))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_to_lisrel(name):
    port, ref = (g.to_lisrel() for g in both(name))
    assert port.variables == ref.variables and port.observed == ref.observed
    for attr in ("B_mask", "B_fixed", "S_mask", "S_fixed", "F"):
        same_nan_array(getattr(port, attr), getattr(ref, attr))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_to_standard_lisrel(name):
    (p_names, p_masks, p_fixed), (j_names, j_masks, j_fixed) = (
        g.to_standard_lisrel() for g in both(name))
    assert p_names == j_names
    for key in j_masks:
        same_nan_array(p_masks[key], j_masks[key])
        same_nan_array(p_fixed[key], j_fixed[key])


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_full_graph_and_scaling_indicators(name):
    port, ref = both(name)
    assert sorted(port.full_graph_struct.edges()) == sorted(ref.full_graph_struct.edges())
    assert port.get_scaling_indicators() == ref.get_scaling_indicators()
    assert port.active_trail_nodes(sorted(port.observed)) == ref.active_trail_nodes(
        sorted(ref.observed))


def random_parameters(alg, seed):
    rng = np.random.default_rng(seed)
    n = len(alg.variables)
    B = np.where(alg.B_mask, rng.uniform(-0.8, 0.8, (n, n)), 0.0)
    S = np.where(alg.S_mask, rng.uniform(-0.2, 0.2, (n, n)), 0.0)
    S = (S + S.T) / 2 + np.diag(rng.uniform(0.5, 1.5, n))
    return B, S


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_implied_covariance(name):
    port, ref = (g.to_lisrel() for g in both(name))
    B, S = random_parameters(ref, seed=len(name))
    got = port.implied_covariance(B, S)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.implied_covariance(B, S)),
                               rtol=1e-5, atol=1e-6)
    # float64 against the closed form F (I-B)^-1 S (I-B)^-T F^T
    inv = np.linalg.inv(np.eye(len(B)) - B)
    want = ref.F @ inv @ S @ inv.T @ ref.F.T
    got64 = port.implied_covariance(torch.as_tensor(B), torch.as_tensor(S))
    np.testing.assert_allclose(got64.numpy(), want, rtol=1e-12, atol=1e-14)


def test_implied_covariance_of_a_singular_system_is_nan():
    """``I - B`` singular: ``jnp.linalg.inv`` gives inf / NaN entries and
    ``torch.linalg.inv`` would raise; the port gives NaN."""
    alg = SEMGraph(ebunch=[("a", "b"), ("b", "a")]).to_lisrel()
    B = np.array([[0.0, 1.0], [1.0, 0.0]])
    assert torch.isnan(alg.implied_covariance(B, np.eye(2))).all()


def test_generate_samples():
    """The same draw as the JAX package from Sigma built in float64 (the JAX
    package's is float32): the samples agree to float32 rounding of Sigma,
    about 1e-6 of their scale."""
    port, ref = (g.to_lisrel() for g in both("measurement"))
    B, S = random_parameters(ref, seed=3)
    port.set_params(B, S)
    ref.set_params(B, S)
    got = port.generate_samples(n_samples=500, seed=11)
    want = ref.generate_samples(n_samples=500, seed=11)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="not been specified"):
        SEMGraph(ebunch=[("x", "y")]).to_lisrel().generate_samples(n_samples=10)


def test_generate_samples_builds_sigma_on_the_configured_device(monkeypatch):
    """The implied covariance is computed in float64 on ``config.DEVICE``."""
    port, _ = (g.to_lisrel() for g in both("measurement"))
    port.set_params(*random_parameters(port, seed=3))
    seen = []
    original = port.implied_covariance

    def recorded(B, S):
        seen.append((B.device, B.dtype, S.device))
        return original(B, S)

    monkeypatch.setattr(port, "implied_covariance", recorded)
    port.generate_samples(n_samples=10, seed=0)
    assert seen == [(config.DEVICE, torch.float64, config.DEVICE)]


def test_sem_constructors():
    lavaan = "eta =~ y1 + y2 + y3\neta ~ x1 + 2*x2\nx1 ~~ x2\n# comment\n"
    port, ref = SEM.from_lavaan(lavaan), JaxSEM.from_lavaan(lavaan)
    assert sorted(port.edges()) == sorted(ref.edges()) and port.latents == ref.latents
    assert sorted(port.err_graph.edges()) == sorted(ref.err_graph.edges()) == []
    variables = ["a", "b", "c"]
    B = [[0, 0, 0], [1, 0, 0], [1, 1, 0]]
    S = np.eye(3)
    port, ref = (cls.from_RAM(variables, B, S) for cls in (SEM, JaxSEM))
    assert sorted(port.edges()) == sorted(ref.edges())


# --------------------------------------------------------------------------- #
# the losses and their gradients
# --------------------------------------------------------------------------- #
class StepCount:
    """A loss function that counts its calls under autograd: one per
    optimizer step (``fit`` takes its final loss without gradients)."""

    def __init__(self, fn):
        self.fn, self.steps = fn, 0

    def __call__(self, params, args):
        self.steps += torch.is_grad_enabled()
        return self.fn(params, args)


def sem_case(name, seed=0, n_rows=400):
    """Both estimators with their masks cached, the empirical covariance of
    ``n_rows`` samples and a parameter dict of numpy arrays."""
    graph, jax_graph = both(name)
    alg = jax_graph.to_lisrel()
    B, S = random_parameters(alg, seed)
    alg.set_params(B, S)
    data = alg.generate_samples(n_samples=n_rows, seed=seed)
    S_emp = np.cov(data.to_numpy().T, bias=True)
    port, ref = SEMEstimator(graph), JaxSEMEstimator(jax_graph)
    port._mask_cache, ref._mask_cache = port._masks(), ref._masks()
    n = len(alg.variables)
    rng = np.random.default_rng(seed + 1)
    params = {"B": rng.normal(scale=0.1, size=(n, n)), "S": rng.normal(scale=0.05, size=(n, n)),
              "S_diag": rng.normal(scale=0.3, size=n)}
    return port, ref, S_emp, params, data


@pytest.mark.parametrize("method", ["ml", "uls", "gls"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_loss_and_gradient(name, method):
    port, ref, S_emp, params, _ = sem_case(name)
    jax_loss = getattr(ref, f"{method}_loss")
    want, want_grad = jax.value_and_grad(
        lambda p: jax_loss(p, {"S": jnp.asarray(S_emp)}))({k: jnp.asarray(v) for k, v in params.items()})
    tparams = sem_params_from_numpy(params)
    for t in tparams.values():
        assert t.dtype == torch.float32
        t.requires_grad_(True)
    got = getattr(port, f"{method}_loss")(tparams, {"S": torch.as_tensor(S_emp, dtype=torch.float32)})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for key in params:
        scale = float(np.abs(np.asarray(want_grad[key])).max())
        np.testing.assert_allclose(tparams[key].grad.numpy(), np.asarray(want_grad[key]),
                                   rtol=1e-5, atol=1e-5 * scale, err_msg=key)


def test_ml_loss_of_an_indefinite_sigma_is_nan_with_nan_gradients():
    # the free error covariance y1 <-> y2 at 5 beside variances of about 0.7
    port, ref, S_emp, params, _ = sem_case("weighted_err_corr")
    params["S"] = np.full_like(params["S"], 5.0)
    want = ref.ml_loss({k: jnp.asarray(v) for k, v in params.items()}, {"S": jnp.asarray(S_emp)})
    tparams = sem_params_from_numpy(params)
    for t in tparams.values():
        t.requires_grad_(True)
    got = port.ml_loss(tparams, {"S": torch.as_tensor(S_emp, dtype=torch.float32)})
    got.backward()
    assert np.isnan(float(want)) and torch.isnan(got)
    # NaN on every free entry (and every S_diag entry, which is never masked)
    free = {"B": port._mask_cache[4], "S": port._mask_cache[5],
            "S_diag": torch.ones(len(params["S_diag"]), dtype=torch.bool)}
    for key, t in tparams.items():
        assert torch.isnan(t.grad[free[key]]).all() and not torch.isnan(t.grad[~free[key]]).any()


def test_fit_stops_where_the_jax_package_stops_on_an_indefinite_start():
    """Sigma not positive definite from the first step: the JAX package's
    losses are NaN, its free parameters NaN after the first update, and the
    loop ends with the first chunk; the port's too, with no exception."""
    port, ref, S_emp, params, _ = sem_case("weighted_err_corr")
    params["S"] = np.full_like(params["S"], 5.0)
    want = jax_opt.optimize(ref.ml_loss, {k: jnp.asarray(v) for k, v in params.items()},
                            {"S": jnp.asarray(S_emp)}, opt="adam", lr=0.05, max_iter=2000)
    loss = StepCount(port.ml_loss)
    got = optimize(loss, params, {"S": torch.as_tensor(S_emp, dtype=torch.float32)},
                   opt="adam", lr=0.05, max_iter=2000)
    assert loss.steps == 64
    for key in params:
        same_nan_array(got[key].numpy(), np.asarray(want[key]))


# --------------------------------------------------------------------------- #
# the optimizer loop
# --------------------------------------------------------------------------- #
RNG = np.random.default_rng(5)
A, TARGET = RNG.normal(size=(6, 4)), RNG.normal(size=6)
X0, Y0 = RNG.normal(size=4), RNG.normal(size=(2, 3))


def jax_quadratic(p, args):
    return jnp.sum((args["A"] @ p["x"] - args["b"]) ** 2) + jnp.sum((p["y"] - 1.5) ** 2)


def port_quadratic(p, args):
    return torch.sum((args["A"] @ p["x"] - args["b"]) ** 2) + torch.sum((p["y"] - 1.5) ** 2)


JAX_ARGS = {"A": jnp.asarray(A), "b": jnp.asarray(TARGET)}
PORT_ARGS = {"A": torch.tensor(A, dtype=torch.float32),
             "b": torch.tensor(TARGET, dtype=torch.float32)}


def flat(p):
    return np.concatenate([np.ravel(np.asarray(p[k], dtype=np.float64)) for k in ("x", "y")])


def optax_trajectory(name, lr, steps):
    """The parameters after each of ``steps`` optax updates, stepped one at a
    time exactly as ``pgmpy_tpu.utils.optimizer.optimize`` steps them."""
    tx = jax_opt._OPTIMIZERS[name](lr)
    p = {"x": jnp.asarray(X0), "y": jnp.asarray(Y0)}
    state = tx.init(p)
    out = []
    for _ in range(steps):
        _, grads = jax.value_and_grad(lambda q: jax_quadratic(q, JAX_ARGS))(p)
        updates, state = tx.update(grads, state, p)
        p = optax.apply_updates(p, updates)
        out.append(flat(p))
    return out


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "adagrad", "adadelta", "rmsprop",
                                  "nadam", "adamax"])
def test_optimizer_step_for_step(name):
    lr, steps = 0.01, 64
    want = optax_trajectory(name, lr, steps)
    jax_final = jax_opt.optimize(jax_quadratic, {"x": X0, "y": Y0}, JAX_ARGS, opt=name, lr=lr,
                                 max_iter=steps, exit_delta=0.0)
    np.testing.assert_allclose(flat(jax_final), want[-1], rtol=1e-5, atol=1e-6)
    seen = []  # the loss sees the parameters before each step

    def recording(p, args):
        seen.append(flat({k: v.detach() for k, v in p.items()}))
        return port_quadratic(p, args)

    final = optimize(recording, {"x": X0, "y": Y0}, PORT_ARGS, opt=name, lr=lr,
                     max_iter=steps, exit_delta=0.0)
    got = seen[1:] + [flat(final)]
    assert len(got) == steps
    for k in range(steps):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=f"step {k + 1}")


def test_chunked_stopping_rule():
    """``exit_delta`` is read on the last two losses of each 64-step chunk
    and ``max_iter`` rounds up to whole chunks: the JAX package and the port
    stop on the same step."""
    traj = optax_trajectory("adam", 0.05, 384)
    jax_out = flat(jax_opt.optimize(jax_quadratic, {"x": X0, "y": Y0}, JAX_ARGS, opt="adam",
                                    lr=0.05, max_iter=2000, exit_delta=1e-4))
    jax_steps = 1 + min(range(len(traj)), key=lambda k: np.abs(traj[k] - jax_out).max())
    assert jax_steps % 64 == 0 and 64 < jax_steps < 384
    loss = StepCount(port_quadratic)
    got = optimize(loss, {"x": X0, "y": Y0}, PORT_ARGS, opt="adam", lr=0.05,
                   max_iter=2000, exit_delta=1e-4)
    assert loss.steps == jax_steps
    np.testing.assert_allclose(flat(got), jax_out, rtol=1e-4, atol=1e-5)
    # max_iter=100 runs two chunks of 64 in both packages
    jax_out = flat(jax_opt.optimize(jax_quadratic, {"x": X0, "y": Y0}, JAX_ARGS, opt="adam",
                                    lr=0.05, max_iter=100, exit_delta=0.0))
    np.testing.assert_allclose(jax_out, traj[127], rtol=1e-5, atol=1e-6)
    loss = StepCount(port_quadratic)
    got = optimize(loss, {"x": X0, "y": Y0}, PORT_ARGS, opt="adam", lr=0.05,
                   max_iter=100, exit_delta=0.0)
    assert loss.steps == 128
    np.testing.assert_allclose(flat(got), traj[127], rtol=1e-4, atol=1e-5)
    # max_iter below a chunk: one chunk of max_iter steps
    loss = StepCount(port_quadratic)
    optimize(loss, {"x": X0, "y": Y0}, PORT_ARGS, opt="sgd", max_iter=5)
    assert loss.steps == 5


def test_lbfgs_reaches_the_same_optimum():
    """torch's L-BFGS (10 pairs, strong-Wolfe line search) and optax's (zoom
    line search) take different steps: both reach the least-squares optimum
    of a convex loss."""
    x_opt = np.linalg.lstsq(A, TARGET, rcond=None)[0]
    want = np.concatenate([x_opt, np.full(6, 1.5)])
    jax_out = jax_opt.optimize(jax_quadratic, {"x": X0, "y": Y0}, JAX_ARGS, opt="lbfgs",
                               lr=1.0, max_iter=200, exit_delta=1e-9)
    got = optimize(port_quadratic, {"x": X0, "y": Y0}, PORT_ARGS, opt="lbfgs", lr=1.0,
                   max_iter=200, exit_delta=1e-9)
    np.testing.assert_allclose(flat(jax_out), want, atol=1e-4)
    np.testing.assert_allclose(flat(got), want, atol=1e-4)


def test_optimize_takes_an_optimizer_factory_and_rejects_unknown_names():
    got = optimize(port_quadratic, {"x": X0, "y": Y0}, PORT_ARGS,
                   opt=lambda leaves: torch.optim.SGD(leaves, lr=0.01), max_iter=64,
                   exit_delta=0.0)
    want = optimize(port_quadratic, {"x": X0, "y": Y0}, PORT_ARGS, opt="sgd", lr=0.01,
                    max_iter=64, exit_delta=0.0)
    np.testing.assert_array_equal(flat(got), flat(want))
    with pytest.raises(ValueError, match="Unknown optimizer"):
        optimize(port_quadratic, {"x": X0}, PORT_ARGS, opt="newton")


def test_pinverse():
    m = np.random.default_rng(2).normal(size=(5, 3))
    m[:, 2] = m[:, 0] + m[:, 1]  # rank 2
    np.testing.assert_allclose(pinverse(m).numpy(), np.asarray(jax_opt.pinverse(m)),
                               rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------- #
# fits
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("method", ["ml", "uls", "gls"])
def test_fit_matches_the_jax_package_over_one_chunk(method):
    port, ref, _, _, data = sem_case("weighted_err_corr", seed=4, n_rows=2000)
    want = ref.fit(data, method=method, max_iter=64)
    loss = StepCount(getattr(port, f"{method}_loss"))
    setattr(port, f"{method}_loss", loss)
    got = port.fit(data, method=method, max_iter=64)
    assert loss.steps == 64
    assert got["variables"] == want["variables"]
    np.testing.assert_allclose(got["S_emp"], want["S_emp"], rtol=1e-6)
    np.testing.assert_allclose(got["B"], want["B"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["Sigma"], want["Sigma"], rtol=1e-4, atol=1e-5)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)


def test_fit_of_a_saturated_path_model_is_ols():
    """x1 -> x2, x1 -> x3, x2 -> x3 with free error variances is saturated:
    the ML optimum reproduces the empirical covariance, so B holds the
    per-equation OLS slopes.  float64, L-BFGS, within 1e-6."""
    rng = np.random.default_rng(3)
    n = 5000
    x1 = rng.normal(size=n)
    x2 = 0.7 * x1 + 0.5 * rng.normal(size=n)
    x3 = -0.4 * x1 + 1.2 * x2 + 0.3 * rng.normal(size=n)
    df = pd.DataFrame({"x1": x1, "x2": x2, "x3": x3})
    c = (df - df.mean()).to_numpy()
    b2 = np.linalg.lstsq(c[:, :1], c[:, 1], rcond=None)[0]
    b3 = np.linalg.lstsq(c[:, :2], c[:, 2], rcond=None)[0]
    config.set_dtype(torch.float64)
    try:
        summary = SEMEstimator(SEMGraph(ebunch=[("x1", "x2"), ("x1", "x3"), ("x2", "x3")])).fit(
            df, method="ml", opt="lbfgs", lr=1.0, max_iter=200, exit_delta=1e-14)
    finally:
        config.set_dtype(torch.float32)
    v = summary["variables"]
    B = summary["B"]
    got = [B[v.index("x2"), v.index("x1")], B[v.index("x3"), v.index("x1")],
           B[v.index("x3"), v.index("x2")]]
    np.testing.assert_allclose(got, np.r_[b2, b3], atol=1e-6)
    np.testing.assert_allclose(summary["Sigma"], summary["S_emp"], atol=1e-6)


# --------------------------------------------------------------------------- #
# instrumental variables
# --------------------------------------------------------------------------- #
def iv_frame(n=3000, seed=7, constant_instrument=False):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=n)
    z1, z2 = rng.normal(size=n), rng.normal(size=n)
    if constant_instrument:
        z2 = np.full(n, 3.0)
    x = 0.9 * z1 + 0.5 * z2 + u + 0.3 * rng.normal(size=n)
    y = 1.7 * x - 2.0 * u + 0.3 * rng.normal(size=n)
    return pd.DataFrame({"Z1": z1, "Z2": z2, "X": x, "Y": y})


def numpy_2sls(df, ivs):
    Z = np.column_stack([np.ones(len(df))] + [df[z].to_numpy() for z in ivs])
    b1 = np.linalg.lstsq(Z, df["X"].to_numpy(), rcond=None)[0]
    W = np.column_stack([np.ones(len(df)), Z @ b1])
    return np.linalg.lstsq(W, df["Y"].to_numpy(), rcond=None)[0][1], b1


IV_EDGES = [("Z1", "X"), ("Z2", "X"), ("X", "Y"), ("U", "X"), ("U", "Y")]


def test_iv_estimator():
    from pgmpy_tpu.base import DAG as JaxDAG
    from pgmpy_tpu_torch.base import DAG

    df = iv_frame()
    got, info = IVEstimator(DAG(IV_EDGES, latents={"U"})).fit("X", "Y", df)
    want, jax_info = JaxIV(JaxDAG(IV_EDGES, latents={"U"})).fit("X", "Y", df)
    assert info["ivs"] == jax_info["ivs"] == ["Z1", "Z2"]
    oracle, stage1 = numpy_2sls(df, ["Z1", "Z2"])
    assert got == pytest.approx(oracle, rel=1e-10)
    np.testing.assert_allclose(info["stage1"], stage1, rtol=1e-10)
    assert got == pytest.approx(want, rel=1e-4)
    np.testing.assert_allclose(info["stage1"], jax_info["stage1"], rtol=1e-4, atol=1e-5)
    sem = SEM.from_graph(ebunch=IV_EDGES, latents=["U"])
    assert IVEstimator(sem).fit("X", "Y", df)[0] == pytest.approx(got, rel=1e-12)
    with pytest.raises(ValueError, match="No instrumental"):
        IVEstimator(DAG([("X", "Y")])).fit("X", "Y", df)


def test_iv_estimator_rank_deficient_design():
    """A constant instrument is collinear with the intercept: ``jnp.linalg.lstsq``
    returns the minimum-norm answer and so does the port."""
    from pgmpy_tpu.base import DAG as JaxDAG
    from pgmpy_tpu_torch.base import DAG

    df = iv_frame(constant_instrument=True)
    got, info = IVEstimator(DAG(IV_EDGES, latents={"U"})).fit("X", "Y", df, ivs=["Z1", "Z2"])
    want, jax_info = JaxIV(JaxDAG(IV_EDGES, latents={"U"})).fit("X", "Y", df, ivs=["Z1", "Z2"])
    oracle, stage1 = numpy_2sls(df, ["Z1", "Z2"])
    np.testing.assert_allclose(info["stage1"], stage1, rtol=1e-9)
    # the minimum-norm split of the constant between the two collinear columns
    assert info["stage1"][2] == pytest.approx(3.0 * info["stage1"][0], rel=1e-9)
    np.testing.assert_allclose(info["stage1"], jax_info["stage1"], rtol=1e-4, atol=1e-5)
    assert got == pytest.approx(oracle, rel=1e-9)
    assert got == pytest.approx(want, rel=1e-4)
