"""LinearGaussianBayesianNetwork: Gaussian BN with closed-form joint.

Port of ``pgmpy_tpu/models/linear_gaussian_bn.py`` (reference:
``pgmpy/models/LinearGaussianBayesianNetwork.py:14-818``).  The joint
mean/covariance, the log-likelihood, the fit and the simulation are host
float64 numpy, as in the JAX package; the one device call is the linear solve
of ``predict`` (``torch.linalg.solve`` in ``config.DTYPE`` on
``config.DEVICE``).  The joint also serves as the log-density target of the
HMC/NUTS samplers (``sampling/hmc.py``, ``sampling/nuts.py``).
"""

import networkx as nx
import numpy as np
import pandas as pd

import torch

from pgmpy_tpu_torch.base.dag import DAG
from pgmpy_tpu_torch.config import as_tensor
from pgmpy_tpu_torch.factors.continuous import LinearGaussianCPD


class LinearGaussianBayesianNetwork(DAG):
    """Gaussian BN: each node = beta . [1, parents] + N(0, std^2); the
    joint is multivariate normal in closed form.

    Examples
    --------
    >>> import numpy as np
    >>> from pgmpy_tpu_torch.factors.continuous import LinearGaussianCPD
    >>> from pgmpy_tpu_torch.models import LinearGaussianBayesianNetwork
    >>> model = LinearGaussianBayesianNetwork([("x", "y")])
    >>> model.add_cpds(
    ...     LinearGaussianCPD("x", [1.0], 2.0),
    ...     LinearGaussianCPD("y", [0.5, 3.0], 1.0, evidence=["x"]))
    >>> mean, cov = model.to_joint_gaussian()
    >>> np.asarray(mean, dtype=float).round(2).tolist()
    [1.0, 3.5]
    >>> np.asarray(cov, dtype=float).round(2).tolist()
    [[4.0, 12.0], [12.0, 37.0]]
    """

    def __init__(self, ebunch=None, latents=[], lavaan_str=None, dagitty_str=None):
        super().__init__(ebunch, latents, lavaan_str, dagitty_str)
        self.cpds = []

    def add_cpds(self, *cpds):
        for cpd in cpds:
            if not isinstance(cpd, LinearGaussianCPD):
                raise ValueError("Only LinearGaussianCPD can be added.")
            if set(cpd.scope()) - set(cpd.scope()).intersection(set(self.nodes())):
                raise ValueError(f"CPD defined on variable not in the model: {cpd}")
            for prev_cpd_index in range(len(self.cpds)):
                if self.cpds[prev_cpd_index].variable == cpd.variable:
                    self.cpds[prev_cpd_index] = cpd
                    break
            else:
                self.cpds.append(cpd)

    def get_cpds(self, node=None):
        if node is not None:
            if node not in self.nodes():
                raise ValueError("Node not present in the Directed Graph")
            for cpd in self.cpds:
                if cpd.variable == node:
                    return cpd
            return None
        return self.cpds

    def remove_cpds(self, *cpds):
        for cpd in cpds:
            if isinstance(cpd, (str, int)):
                cpd = self.get_cpds(cpd)
            self.cpds.remove(cpd)

    def check_model(self):
        for node in self.nodes():
            cpd = self.get_cpds(node=node)
            if cpd is None:
                raise ValueError(f"No CPD associated with {node}")
            if set(cpd.evidence) != set(self.get_parents(node)):
                raise ValueError(
                    f"CPD associated with {node} doesn't have proper parents associated with it."
                )
        return True

    def get_random_cpds(self, loc=0.0, scale=1.0, inplace=False, seed=None):
        gen = np.random.default_rng(seed)
        cpds = [
            LinearGaussianCPD.get_random(
                var, evidence=self.get_parents(var), loc=loc, scale=scale,
                seed=int(gen.integers(2**31)),
            )
            for var in self.nodes()
        ]
        if inplace:
            self.add_cpds(*cpds)
            return self
        return cpds

    @staticmethod
    def get_random(n_nodes=5, edge_prob=0.5, node_names=None, latents=False, loc=0.0, scale=1.0, seed=None):
        dag = DAG.get_random(
            n_nodes=n_nodes, edge_prob=edge_prob, node_names=node_names,
            latents=latents, seed=seed,
        )
        lgbn = LinearGaussianBayesianNetwork(dag.edges(), latents=dag.latents)
        lgbn.add_nodes_from(dag.nodes())
        lgbn.get_random_cpds(loc=loc, scale=scale, inplace=True, seed=seed)
        return lgbn

    def joint_gaussian(self):
        """(variables, mu, Sigma) over a topological order, unrounded.

        mu = (I-B)^-T applied to intercepts; Sigma = (I-B)^-T Omega (I-B)^-1
        with B the (topologically ordered) coefficient matrix and Omega the
        diagonal of noise variances.
        """
        self.check_model()
        variables = list(nx.topological_sort(self))
        var_to_index = {var: i for i, var in enumerate(variables)}
        n = len(variables)
        B = np.zeros((n, n))
        omega = np.zeros(n)
        b0 = np.zeros(n)
        for cpd in self.cpds:
            i = var_to_index[cpd.variable]
            b0[i] = cpd.beta[0]
            omega[i] = cpd.std**2
            for coef, parent in zip(cpd.beta[1:], cpd.evidence):
                B[var_to_index[parent], i] = coef

        # tiny n-by-n solve, done once per model version: host float64
        # (float32 on the device would lose about 7 digits)
        inv = np.linalg.inv(np.eye(n) - B)
        mean = b0 @ inv
        cov = inv.T @ np.diag(omega) @ inv
        return variables, mean, cov

    def to_joint_gaussian(self):
        """Implied joint Gaussian (mean, cov), rounded to 8 decimals, in
        topological variable order — the reference's public contract
        (``LinearGaussianBayesianNetwork.py:207-264``).  Use
        :meth:`joint_gaussian` for the unrounded triple with the order."""
        _, mean, cov = self.joint_gaussian()
        return mean.round(decimals=8), cov.round(decimals=8)

    def log_likelihood(self, data):
        """Sum over rows of log N(x; mu, Sigma) at the PUBLIC (8-decimal
        rounded) joint parameters — the reference evaluates scipy's
        ``multivariate_normal.logpdf`` on ``to_joint_gaussian()`` output
        (``LinearGaussianBayesianNetwork.py:265-302``), so parity requires
        the same rounding.  Host float64; a one-shot n-by-n factorization.
        """
        variables = list(nx.topological_sort(self))
        mean, cov = self.to_joint_gaussian()
        x = data.loc[:, variables].to_numpy(dtype=np.float64)
        n = len(variables)
        diff = x - mean
        chol = np.linalg.cholesky(cov)
        sol = np.linalg.solve(chol, diff.T)
        logdet = 2.0 * np.sum(np.log(np.diag(chol)))
        ll = -0.5 * (
            n * np.log(2 * np.pi) + logdet + np.sum(sol**2, axis=0)
        )
        return float(np.sum(ll))

    def _do_surgery(self, do):
        """Hard intervention: cut incoming edges of each do-node, fold its
        fixed value into every child's intercept, and drop the node.  Returns
        the mutilated copy (reference semantics,
        ``LinearGaussianBayesianNetwork.py:449-483``)."""
        model = self.copy()
        for var, val in do.items():
            for parent in list(model.get_parents(var)):
                model.remove_edge(parent, var)
            model.remove_cpds(model.get_cpds(var))
            for child in model.get_children(var):
                cpd = model.get_cpds(child)
                ev = list(cpd.evidence)
                beta = list(cpd.beta)
                idx = ev.index(var)
                beta[0] += beta[idx + 1] * val
                del ev[idx]
                del beta[idx + 1]
                model.remove_cpds(cpd)
                model.add_cpds(
                    LinearGaussianCPD(cpd.variable, beta, cpd.std, evidence=ev)
                )
            model.remove_node(var)
        return model

    def simulate(
        self,
        n_samples=1000,
        do=None,
        evidence=None,
        virtual_intervention=None,
        include_latents=False,
        seed=None,
    ):
        """Draw joint-normal samples, optionally under hard (``do``) / soft
        (``virtual_intervention``) interventions and Gaussian conditioning on
        ``evidence``.  Returns a DataFrame.  Parity:
        ``LinearGaussianBayesianNetwork.py:342-538`` — do-surgery mutilates
        the graph, evidence conditions the implied joint, do-columns come
        back as constants, latents are dropped unless requested.
        """
        do = {} if do is None else do
        evidence = {} if evidence is None else evidence
        virtual_intervention = virtual_intervention or []

        bad = set(do) - set(self.nodes())
        if bad:
            raise ValueError(
                f"The following do-nodes are not present in the model: {bad}"
            )
        bad = set(evidence) - set(self.nodes())
        if bad:
            raise ValueError(
                f"The following evidence-nodes are not present in the model: {bad}"
            )
        common = set(do) & set(evidence)
        if common:
            raise ValueError(
                f"Variable(s) can't be in both do and evidence: {', '.join(common)}"
            )
        for cpd in virtual_intervention:
            if cpd.variable not in self.nodes():
                raise ValueError(
                    "Virtual intervention provided for variable which is not "
                    f"in the model: {cpd.variable}"
                )

        self.check_model()
        model = self._do_surgery(do) if do else self.copy()
        for cpd in virtual_intervention:
            model.remove_cpds(model.get_cpds(cpd.variable))
            model.add_cpds(cpd)
            for parent in list(model.get_parents(cpd.variable)):
                model.remove_edge(parent, cpd.variable)

        variables, mean, cov = model.joint_gaussian()
        rng = np.random.default_rng(seed)

        if not evidence:
            df = pd.DataFrame(
                rng.multivariate_normal(mean, cov, size=int(n_samples)),
                columns=variables,
            )
        else:
            missing, cond_mean, cond_cov = model.predict(
                pd.DataFrame([evidence])
            )
            order = np.argsort(missing)
            missing = [missing[i] for i in order]
            cond_mean = cond_mean[:, order]
            cond_cov = cond_cov[np.ix_(order, order)]
            draws = rng.multivariate_normal(
                cond_mean[0], cond_cov, size=int(n_samples)
            )
            df = pd.DataFrame(index=range(int(n_samples)), columns=variables)
            for ev_var, ev_val in evidence.items():
                df[ev_var] = ev_val
            for j, mv in enumerate(missing):
                df[mv] = draws[:, j]
            df = df[variables].astype(np.float64)

        for do_var, do_val in do.items():
            df[do_var] = do_val
        if not include_latents:
            df = df.drop(columns=[c for c in self.latents if c in df.columns])
        return df

    def fit(self, data, estimator="mle", std_estimator="unbiased", method=None):
        """Node-wise OLS: per-node linear regression of the variable on its
        parents.  Matches the reference contract
        (``LinearGaussianBayesianNetwork.py:569-659``): ``std_estimator``
        "mle" divides residual variance by n, "unbiased" (default) by
        ``n - (1 + len(parents))``.  The regressions are tiny host-side
        problems solved in float64 numpy — per-node device dispatch would
        dominate and f32 would cost ~7 significant digits of parity.
        """
        if method is not None:  # backwards-compat alias
            estimator = method
        if estimator not in ("mle",):
            raise ValueError("estimator must be one of {'mle'}")
        if std_estimator not in ("mle", "unbiased"):
            raise ValueError("std_estimator must be one of {'mle', 'unbiased'}")
        missing = set(self.nodes()) - set(data.columns)
        if missing:
            raise ValueError(f"Following variables are missing in the data: {missing}")
        cpds = []
        for var in self.nodes():
            parents = self.get_parents(var)
            y = data[var].to_numpy(dtype=np.float64)
            n = y.shape[0]
            if parents:
                X = np.column_stack(
                    [np.ones(n), data.loc[:, parents].to_numpy(dtype=np.float64)]
                )
                beta, _, _, _ = np.linalg.lstsq(X, y, rcond=None)
                resid = y - X @ beta
                ddof = 0 if std_estimator == "mle" else 1 + len(parents)
                resid = resid - resid.mean()  # pandas .std() centers first
                std = float(np.sqrt(np.sum(resid**2) / max(n - ddof, 1)))
                cpds.append(
                    LinearGaussianCPD(var, beta, max(std, 1e-9), evidence=parents)
                )
            else:
                ddof = 0 if std_estimator == "mle" else 1
                mu = float(y.mean())
                std = float(np.sqrt(np.sum((y - mu) ** 2) / max(n - ddof, 1)))
                cpds.append(LinearGaussianCPD(var, [mu], max(std, 1e-9)))
        self.add_cpds(*cpds)
        return self

    def predict(self, data, distribution="joint"):
        """Gaussian conditioning: for missing variables a, observed b:
        mu_a + Sigma_ab Sigma_bb^-1 (x_b - mu_b).

        Returns (variable list, mean matrix, covariance) like the reference.
        """
        variables, mean, cov = self.joint_gaussian()
        missing = [v for v in variables if v not in data.columns]
        if not missing:
            raise ValueError("No variable missing in data. Nothing to predict")
        observed = [v for v in variables if v in data.columns]
        idx_a = [variables.index(v) for v in missing]
        idx_b = [variables.index(v) for v in observed]
        mu_a = mean[idx_a]
        mu_b = mean[idx_b]
        sigma_aa = cov[np.ix_(idx_a, idx_a)]
        sigma_ab = cov[np.ix_(idx_a, idx_b)]
        sigma_bb = cov[np.ix_(idx_b, idx_b)]

        x_b = data.loc[:, observed].to_numpy(dtype=np.float64)
        K = torch.linalg.solve(as_tensor(sigma_bb), as_tensor(sigma_ab.T))
        K = K.cpu().numpy().astype(np.float64)
        cond_mean = mu_a + (x_b - mu_b) @ K
        cond_cov = sigma_aa - sigma_ab @ K
        return missing, cond_mean, cond_cov

    def copy(self):
        model = LinearGaussianBayesianNetwork()
        model.add_nodes_from(self.nodes())
        model.add_edges_from(self.edges())
        if self.cpds:
            model.add_cpds(*[cpd.copy() for cpd in self.cpds])
        model.latents = set(self.latents)
        return model

    def get_cardinality(self, node=None):
        raise ValueError("Cardinality is not defined for continuous variables.")

    def to_markov_model(self):
        raise NotImplementedError(
            "to_markov_model method has not been implemented for LinearGaussianBayesianNetwork."
        )

    def is_imap(self, JPD):
        raise NotImplementedError(
            "is_imap method has not been implemented for LinearGaussianBayesianNetwork."
        )
