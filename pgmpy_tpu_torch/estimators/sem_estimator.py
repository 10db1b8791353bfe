"""SEMEstimator: ML/ULS/GLS fitting of SEM covariance structure + 2SLS IV.

Port of ``pgmpy_tpu/estimators/sem_estimator.py`` (reference:
``pgmpy/estimators/SEMEstimator.py:11-466``).  The losses are torch
functions of the RAM implied covariance on ``config.DEVICE`` in
``config.DTYPE``, differentiated by autograd and minimised by the port's
``utils/optimizer.optimize`` (one host read per chunk of 64 steps).

``jnp.linalg.cholesky`` and ``jnp.linalg.inv`` return NaN for a matrix that
is not positive definite or not invertible, where ``torch.linalg.cholesky``
and ``inv`` raise (and on the card read the host each call).  The losses take
``cholesky_ex`` / ``inv_ex`` and turn a failed factorisation into a NaN loss
whose gradient is NaN too, so an indefinite Sigma stops the fit at the end of
its chunk, as in the JAX package.  ``IVEstimator``'s two stages are the
shared minimum-norm solve (``ops/lstsq.py``) in float64 on the device.
"""

import numpy as np
import torch

from pgmpy_tpu_torch.config import as_tensor, config
from pgmpy_tpu_torch.models.sem import SEM, SEMAlg, SEMGraph
from pgmpy_tpu_torch.ops.lstsq import lstsq
from pgmpy_tpu_torch.utils.optimizer import optimize


def _nan_unless_ok(*infos, dtype):
    """1 where every LAPACK ``info`` is 0, NaN otherwise: multiplied into a
    loss, it makes the loss NaN and its gradient NaN wherever it reaches a
    parameter, as a failed ``jnp.linalg`` factorisation does in JAX."""
    ok = infos[0] == 0
    for info in infos[1:]:
        ok = ok & (info == 0)
    return torch.where(ok, 1.0, torch.nan).to(dtype)


class SEMEstimator:
    def __init__(self, model):
        if isinstance(model, (SEM, SEMGraph)):
            self.model = model
            self.alg = model.to_lisrel()
        elif isinstance(model, SEMAlg):
            self.model = model
            self.alg = model
        else:
            raise ValueError(
                f"model should be an instance of SEM/SEMGraph/SEMAlg. Got: {type(model)}"
            )

    def _masks(self):
        """(B_mask, S_mask, B_fixed, S_fixed, B_free, S_free) as tensors on
        ``config.DEVICE``: the masks bool, the fixed values in
        ``config.DTYPE``."""
        B_fixed = np.where(np.isnan(self.alg.B_fixed), 0.0, self.alg.B_fixed)
        S_fixed = np.where(np.isnan(self.alg.S_fixed), 0.0, self.alg.S_fixed)
        B_free = self.alg.B_mask & np.isnan(self.alg.B_fixed)
        S_free = self.alg.S_mask & np.isnan(self.alg.S_fixed)
        return (
            as_tensor(self.alg.B_mask, dtype=torch.bool),
            as_tensor(self.alg.S_mask, dtype=torch.bool),
            as_tensor(B_fixed),
            as_tensor(S_fixed),
            as_tensor(B_free, dtype=torch.bool),
            as_tensor(S_free, dtype=torch.bool),
        )

    def get_init_values(self, data, method="random", seed=None):
        """Starting (B, zeta) matrices for the optimizer (ref
        SEMEstimator.py:173-217, Bollen Table 4C.1 'std' recipe)."""
        variables = list(self.alg.variables)
        m = len(variables)
        rng = np.random.default_rng(seed)
        B = rng.random((m, m))
        zeta = rng.random((m, m))
        if method == "random":
            return B, zeta
        if method == "std":
            a = 0.4
            scaling = {}
            if hasattr(self.model, "get_scaling_indicators"):
                scaling = dict(self.model.get_scaling_indicators())
            for var in variables:
                scaling.setdefault(var, var)
            std = {
                v: (data.loc[:, scaling[v]].std()
                    if scaling[v] in data.columns else 1.0)
                for v in variables
            }
            for i in range(m):
                for j in range(m):
                    if scaling[variables[i]] == variables[j]:
                        B[i, j] = 1.0
                    elif i != j:
                        B[i, j] = a * (std[variables[i]] / std[variables[j]])
            for i in range(m):
                zeta[i, i] = a * std[variables[i]] ** 2
            for i in range(m):
                for j in range(m):
                    if i != j:
                        zeta[i, j] = zeta[j, i] = a * np.sqrt(
                            zeta[i, i] * zeta[j, j]
                        )
            return B, zeta
        raise NotImplementedError(f"Initialization method {method} not supported.")

    def ml_loss(self, params, loss_args):
        """-2 log-likelihood (up to constants): log|Sigma| + tr(S Sigma^-1)."""
        S_emp = loss_args["S"]
        sigma = self._implied(params)
        chol, info = torch.linalg.cholesky_ex(sigma)
        inv, info_inv = torch.linalg.inv_ex(sigma)
        logdet = 2.0 * torch.sum(torch.log(torch.clamp_min(torch.diagonal(chol), 1e-12)))
        loss = logdet + torch.trace(S_emp @ inv)
        return loss * _nan_unless_ok(info, info_inv, dtype=loss.dtype)

    def uls_loss(self, params, loss_args):
        S_emp = loss_args["S"]
        sigma = self._implied(params)
        diff = S_emp - sigma
        return torch.sum(diff**2)

    def gls_loss(self, params, loss_args):
        S_emp = loss_args["S"]
        sigma = self._implied(params)
        S_inv, info = torch.linalg.inv_ex(S_emp)
        diff = (S_emp - sigma) @ S_inv
        loss = torch.trace(diff @ diff)
        return loss * _nan_unless_ok(info, dtype=loss.dtype)

    def _implied(self, params):
        (B_mask, S_mask, B_fixed, S_fixed, B_free, S_free) = self._mask_cache
        # ``where`` and not ``fixed + params * free``: a NaN gradient (an
        # indefinite Sigma) then reaches the free entries only, as it does in
        # the JAX package's compiled loop
        B = torch.where(B_free, params["B"], B_fixed)
        # S must stay symmetric PSD-ish: use symmetric parameterization with
        # softplus on the diagonal
        S_raw = torch.where(S_free, params["S"], 0.0)
        S_sym = 0.5 * (S_raw + S_raw.T)
        diag = torch.nn.functional.softplus(params["S_diag"])
        S = S_fixed + S_sym - torch.diag(torch.diagonal(S_sym)) + torch.diag(diag)
        return self.alg.implied_covariance(B, S)

    def fit(self, data, method="ml", opt="adam", lr=0.05, max_iter=2000, exit_delta=1e-6, **kwargs):
        """Fit free parameters to the empirical covariance of ``data``.

        Returns a summary dict with fitted B, S, implied covariance and the
        final loss.  The empirical covariance is formed on the device in
        float64 (``np.cov(bias=True)``'s formula) and used in
        ``config.DTYPE``.
        """
        observed = self.alg.observed
        X = data.loc[:, observed].to_numpy(dtype=np.float64)
        X = torch.as_tensor(np.ascontiguousarray(X), device=config.DEVICE)
        centered = X - X.mean(dim=0)
        S_emp = (centered.T @ centered / X.shape[0]).to(config.DTYPE)

        self._mask_cache = self._masks()
        n = len(self.alg.variables)
        rng = np.random.default_rng(0)
        params = {
            "B": as_tensor(rng.normal(scale=0.1, size=(n, n))),
            "S": as_tensor(np.zeros((n, n))),
            "S_diag": as_tensor(np.zeros(n)),
        }
        loss_fn = {
            "ml": self.ml_loss,
            "uls": self.uls_loss,
            "gls": self.gls_loss,
        }[method.lower()]

        params = optimize(
            loss_fn,
            params=params,
            loss_args={"S": S_emp},
            opt=opt,
            lr=lr,
            max_iter=max_iter,
            exit_delta=exit_delta,
        )

        (B_mask, S_mask, B_fixed, S_fixed, B_free, S_free) = self._mask_cache
        with torch.no_grad():
            B = torch.where(B_free, params["B"], B_fixed)
            sigma = self._implied(params)
            final_loss = loss_fn(params, {"S": S_emp})

        summary = {
            "variables": self.alg.variables,
            "B": B.cpu().numpy(),
            "Sigma": sigma.cpu().numpy(),
            "S_emp": S_emp.cpu().numpy(),
            "loss": float(final_loss),
            "params": params,
        }
        return summary


class IVEstimator:
    """Two-stage least squares with instrumental variables.

    Parity: ``SEMEstimator.py:390-466``.  Both stages are minimum-norm
    solves in float64 on ``config.DEVICE``; the JAX package's are
    ``jnp.linalg.lstsq`` in its default float32.
    """

    def __init__(self, model):
        self.model = model

    def fit(self, X, Y, data, ivs=None, civs=None):
        """Estimate the effect X -> Y using instruments ``ivs``."""
        if ivs is None:
            from pgmpy_tpu_torch.inference.causal import CausalInference
            from pgmpy_tpu_torch.base.dag import DAG

            if isinstance(self.model, (SEM, SEMGraph)):
                dag = DAG(list(self.model.graph.edges()))
                dag.add_nodes_from(self.model.graph.nodes())
                dag.latents = set(self.model.latents)
            else:
                dag = self.model
            ivs = sorted(CausalInference(dag).get_ivs(X, Y), key=str)
        if not ivs:
            raise ValueError("No instrumental variables found/specified.")

        values = data[[X, Y] + list(ivs)].to_numpy(dtype=np.float64)
        values = torch.as_tensor(np.ascontiguousarray(values), device=config.DEVICE)
        ones = torch.ones_like(values[:, :1])
        Z = torch.cat([ones, values[:, 2:]], dim=1)
        # stage 1: x ~ Z
        beta1 = lstsq(Z, values[:, 0])
        x_hat = Z @ beta1
        # stage 2: y ~ [1, x_hat]
        beta2 = lstsq(torch.cat([ones, x_hat[:, None]], dim=1), values[:, 1])
        host = torch.cat([beta2[1:2], beta1]).cpu().numpy()
        return float(host[0]), {"ivs": ivs, "stage1": host[1:]}
