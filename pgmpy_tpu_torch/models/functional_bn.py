"""FunctionalBayesianNetwork: BN whose CPDs are arbitrary distribution
functions.

Port of ``pgmpy_tpu/models/functional_bn.py``.  CPD functions return
:mod:`pgmpy_tpu_torch.factors.distributions` objects and are called once per
node on whole columns (tensors on ``config.DEVICE``):

* ``simulate`` is topological ancestral sampling, one draw of ``(n,)`` per
  node from a generator seeded per node, read back once at the end;
* the SVI fit minimises the negative log-likelihood with autograd and a
  ``torch.optim`` optimizer (Adam at lr 1e-2 by default, optax's rule); the
  unconstrained parameters are ONE flat leaf with a view per name;
* the MCMC fit runs the port's host NUTS (``sampling/hmc.py``) on the
  log-posterior, differentiated by ``torch.func``;
* the point fit runs ``utils/optimizer.optimize``.
"""

import logging

import networkx as nx
import numpy as np
import pandas as pd
import torch
from torch.distributions import constraints

from pgmpy_tpu_torch.config import as_tensor, config, logger
from pgmpy_tpu_torch.factors.hybrid import FunctionalCPD
from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork


def _columns(data, nodes):
    """{node: the data column as a ``config.DTYPE`` tensor on
    ``config.DEVICE``}."""
    return {node: as_tensor(data[node].to_numpy(dtype=np.float64, copy=True)) for node in nodes}


def _frame(columns):
    """The DataFrame of ``columns`` ({name: (n,) tensor}) from ONE read of
    the device: the columns are stacked as float64 (exact for float32 values
    and integer codes) and integer columns cast back."""
    names = list(columns)
    if not names:
        return pd.DataFrame()
    host = torch.stack([columns[v].to(torch.float64) for v in names], dim=1).cpu().numpy()
    frame = pd.DataFrame(host, columns=names)
    for v in names:
        if not columns[v].is_floating_point():
            frame[v] = frame[v].astype(np.int64)
    return frame


def _ravel_pytree(tree):
    """``(flat, unravel)`` of a pytree of dicts, lists, tuples and array
    leaves, with ``jax.flatten_util.ravel_pytree``'s leaf order: a dict's
    values by sorted key, a list's in order, each leaf raveled C-order.
    ``flat`` is a host float64 array; ``unravel(vector)`` rebuilds the tree
    with tensor leaves on ``config.DEVICE`` (``vector`` a tensor or an
    array), each of its leaf's shape."""
    leaves = []

    def flatten(node):
        if isinstance(node, dict):
            keys = sorted(node)
            subs = [flatten(node[k]) for k in keys]
            return lambda it: {k: s(it) for k, s in zip(keys, subs)}
        if isinstance(node, (list, tuple)):
            subs = [flatten(v) for v in node]
            kind = type(node)
            return lambda it: kind(s(it) for s in subs)
        if node is None:
            return lambda it: None
        if isinstance(node, torch.Tensor):
            node = node.detach().cpu().numpy()
        leaf = np.asarray(node, dtype=np.float64)
        leaves.append(leaf)
        return lambda it: next(it).reshape(leaf.shape)

    build = flatten(tree)
    sizes = [leaf.size for leaf in leaves]
    flat = np.concatenate([leaf.ravel() for leaf in leaves]) if leaves else np.zeros(0)

    def unravel(vector):
        vector = vector if isinstance(vector, torch.Tensor) else as_tensor(vector)
        return build(iter(torch.split(vector, sizes)))

    return flat, unravel


def _constrain_support(u, support):
    """(value, log |Jacobian|) of the unconstrained ``u`` mapped onto a
    prior's ``support`` tag."""
    if support == "positive":
        return torch.exp(u), torch.sum(u)
    if isinstance(support, tuple) and support[0] == "interval":
        low, high = support[1], support[2]
        s = torch.sigmoid(u)
        logdet = torch.sum(np.log(high - low) + torch.log(s) + torch.log1p(-s))
        return low + (high - low) * s, logdet
    return u, 0.0


def _unconstrain_support(draw, support):
    """The inverse of :func:`_constrain_support` at a prior draw, clipped away
    from the support's edges."""
    if support == "positive":
        return torch.log(torch.clamp_min(draw, 1e-6))
    if isinstance(support, tuple) and support[0] == "interval":
        low, high = support[1], support[2]
        p = torch.clamp((draw - low) / (high - low), 1e-4, 1 - 1e-4)
        return torch.log(p) - torch.log1p(-p)
    return draw


def _make_optimizer(optimizer, leaves):
    """The SVI fit's optimizer over ``leaves``: see ``fit``'s ``optimizer``."""
    from pgmpy_tpu_torch.utils.optimizer import _OPTIMIZERS

    if optimizer is None:
        return _OPTIMIZERS["adam"](leaves, 1e-2)
    if isinstance(optimizer, dict):
        return _OPTIMIZERS["adam"](leaves, optimizer.get("lr", 1e-2))
    if callable(optimizer):
        return optimizer(leaves)
    raise ValueError(
        "optimizer must be None, a dict, a torch.optim.Optimizer subclass or a "
        f"callable from the parameter list to an optimizer. Got: {type(optimizer)}"
    )


class FunctionalBayesianNetwork(DiscreteBayesianNetwork):
    # Inherits the DiscreteBayesianNetwork surface (predict, to_junction_tree,
    # save/load, ...) exactly as the reference does
    # (FunctionalBayesianNetwork.py:17); methods that require tabular CPDs
    # fail on functional CPDs there too.
    def __init__(self, ebunch=None, latents=[], lavaan_str=None, dagitty_str=None):
        super().__init__(ebunch, latents, lavaan_str, dagitty_str)

    def add_cpds(self, *cpds):
        self._bump_version()
        for cpd in cpds:
            if not isinstance(cpd, FunctionalCPD):
                raise ValueError(f"Only FunctionalCPD can be added. Got: {type(cpd)}")
            if cpd.variable not in self.nodes():
                raise ValueError(f"CPD defined on variable not in the model: {cpd.variable}")
            for prev in list(self.cpds):
                if prev.variable == cpd.variable:
                    self.cpds.remove(prev)
            self.cpds.append(cpd)

    def get_cpds(self, node=None):
        if node is not None:
            for cpd in self.cpds:
                if cpd.variable == node:
                    return cpd
            return None
        return self.cpds

    def remove_cpds(self, *cpds):
        self._bump_version()
        for cpd in cpds:
            if isinstance(cpd, (str, int)):
                cpd = self.get_cpds(cpd)
            self.cpds.remove(cpd)

    def check_model(self):
        for node in self.nodes():
            cpd = self.get_cpds(node)
            if cpd is None:
                raise ValueError(f"No CPD associated with {node}")
            if set(cpd.parents) != set(self.get_parents(node)):
                raise ValueError(
                    f"CPD associated with {node} doesn't have proper parents associated with it."
                )
        return True

    def simulate(self, n_samples=100, do=None, virtual_intervention=None, seed=None):
        """Topological ancestral sampling through the functional CPDs.

        ``do`` pins variables to constants (incoming edges severed by
        construction of the topological sweep); ``virtual_intervention`` is a
        list of unconditional FunctionalCPDs replacing nodes' mechanisms.
        Reference contract ``FunctionalBayesianNetwork.py:204-322``.  Each
        node's draw seeds its own generator from one integer of
        ``np.random.default_rng(seed)``, as in the JAX package; the columns
        stay on ``config.DEVICE`` and are read back once.
        """
        do = do or {}
        virtual_intervention = virtual_intervention or []
        extra_do = set(do) - set(self.nodes())
        if extra_do:
            raise ValueError(
                f"`do` contains nodes not in the model: {sorted(map(str, extra_do))}"
            )
        vi_map = {}
        for cpd in virtual_intervention:
            if not isinstance(cpd, FunctionalCPD):
                raise ValueError(
                    "`virtual_intervention` must be a list of FunctionalCPD "
                    f"objects. Got {type(cpd)}"
                )
            if cpd.variable not in self.nodes():
                raise ValueError(
                    f"Virtual intervention CPD variable not in the model: {cpd.variable}"
                )
            if cpd.parents:
                raise ValueError(
                    f"Virtual intervention CPD for {cpd.variable} must be "
                    "unconditional (no parents)."
                )
            vi_map[cpd.variable] = cpd
        overlap = set(do) & set(vi_map)
        if overlap:
            raise ValueError(
                "Cannot specify both `do` and `virtual_intervention` for the "
                f"same node(s): {sorted(map(str, overlap))}"
            )

        self.check_model()
        n_samples = int(n_samples)
        rng = np.random.default_rng(seed)
        columns = {}
        for node in nx.topological_sort(self):
            if node in do:
                columns[node] = torch.full(
                    (n_samples,), float(do[node]), dtype=torch.float64, device=config.DEVICE
                )
                continue
            cpd = vi_map.get(node) or self.get_cpds(node)
            columns[node] = cpd._draw(n_samples, columns, int(rng.integers(2**31)))
        return _frame(columns)

    def log_likelihood(self, data):
        """Sum over rows and nodes of log p(node | parents): ``fn`` once per
        node on whole columns, each node's sum in float64, one host read."""
        self.check_model()
        arrays = _columns(data, self.nodes())
        totals = []
        for node in self.nodes():
            cpd = self.get_cpds(node)
            log_prob = cpd.fn({p: arrays[p] for p in cpd.parents}).log_prob(arrays[node])
            totals.append(log_prob.to(torch.float64).sum())
        return float(torch.stack(totals).sum()) if totals else 0.0

    def fit(
        self,
        data,
        estimator="SVI",
        optimizer=None,
        prior_fn=None,
        num_steps=1000,
        seed=None,
        nuts_kwargs=None,
        mcmc_kwargs=None,
        init_params=None,
        lr=0.05,
        max_iter=None,
        exit_delta=1e-6,
    ):
        """Fit the model's FunctionalCPDs to data.

        Reference contract (``FunctionalBayesianNetwork.py:323-528``):

        - ``estimator="SVI"``: the CPD functions declare learnable sites via
          :func:`pgmpy_tpu_torch.factors.hybrid.param` (pyro.param shape,
          with positivity constraints honored through a softplus
          parametrization); the empty-guide ELBO reduces to the negative
          log-likelihood, minimised for ``num_steps`` steps.  ``optimizer``
          is None (``torch.optim.Adam``, lr 1e-2), a dict (Adam at
          ``optimizer["lr"]``), or a ``torch.optim.Optimizer`` subclass or
          any callable taking the list of parameter tensors and returning an
          optimizer (the JAX package takes an optax transformation here).
          Returns {param_name: fitted tensor} and leaves the fitted values in
          the global param store so subsequent ``simulate()`` uses them.
        - ``estimator="MCMC"``: CPD functions take ``(priors, parents)``;
          ``prior_fn()`` returns {param_name: Distribution}; NUTS draws
          ``num_steps`` posterior samples (reparametrized per the priors'
          ``support`` tags).  Returns {param_name: sample array}.
        - legacy shape: ``fit(data, make_cpds, init_params=...)`` with a
          callable second argument does point-MLE over a dict of parameters
          (Python floats or tensors).
        """
        if callable(estimator):
            return self._fit_make_cpds(
                data, estimator, init_params, lr, max_iter or 2000, exit_delta
            )
        if not isinstance(data, pd.DataFrame):
            raise ValueError(
                f"data should be a pandas.DataFrame object. Got: {type(data)}."
            )
        if not isinstance(num_steps, int):
            raise ValueError(
                f"num_steps should be an integer. Got: {type(num_steps)}."
            )
        if estimator.lower() not in ("svi", "mcmc"):
            raise ValueError(
                "`estimator` argument needs to be either 'SVI' or 'MCMC'. "
                f"Got: {estimator}."
            )
        missing = [n for n in self.nodes() if n not in data.columns]
        if missing:
            raise ValueError(
                f"data doesn't contain column for the node: {missing[0]}."
            )
        self.check_model()
        arrays = _columns(data, self.nodes())
        sort_nodes = list(nx.topological_sort(self))
        if estimator.lower() == "svi":
            return self._fit_svi(arrays, sort_nodes, optimizer, num_steps)
        return self._fit_mcmc_reference(
            arrays, sort_nodes, prior_fn, num_steps, seed, mcmc_kwargs or {}
        )

    @staticmethod
    def _is_positive_constraint(constraint):
        """The softplus parametrisation's selector: a constraint whose string
        form names "positive" (the JAX package's test), or torch's
        ``constraints.positive`` / any ``constraints.greater_than(0.0)``,
        whose string form is ``GreaterThan(lower_bound=0.0)``."""
        if constraint is None:
            return False
        if isinstance(constraint, constraints.greater_than):
            return float(constraint.lower_bound) == 0.0
        return "positive" in str(constraint).lower()

    def _fit_svi(self, arrays, sort_nodes, optimizer, num_steps):
        from pgmpy_tpu_torch.factors import hybrid

        st = hybrid._PARAM_STORE
        cpds = {node: self.get_cpds(node) for node in sort_nodes}
        parent_arrays = {node: {p: arrays[p] for p in cpds[node].parents} for node in sort_nodes}

        # pass 1: trace each CPD once to collect param names/inits/constraints
        st.mode, st.inits, st.constraints = "collect", {}, {}
        try:
            for node in sort_nodes:
                cpds[node].fn(parent_arrays[node])
        finally:
            st.mode = None
        names = list(st.inits)
        if not names:
            raise ValueError(
                "No learnable parameters found: CPD functions must declare "
                "them with pgmpy_tpu_torch.factors.hybrid.param(name, init, ...)"
            )
        shapes = {n: st.inits[n].shape for n in names}
        sizes = [st.inits[n].numel() for n in names]
        positive = torch.as_tensor(
            np.repeat([self._is_positive_constraint(st.constraints[n]) for n in names], sizes),
            device=config.DEVICE,
        )
        init = torch.cat([st.inits[n].reshape(-1) for n in names])
        # softplus inverse at the positive inits
        init = torch.where(positive, torch.log(torch.expm1(torch.clamp_min(init, 1e-6))), init)
        flat = init.detach().clone().requires_grad_(True)

        def constrain(u):
            values = torch.where(positive, torch.nn.functional.softplus(u), u)
            return {
                n: piece.view(shapes[n]) for n, piece in zip(names, torch.split(values, sizes))
            }

        def nll():
            st.mode, st.values = "apply", constrain(flat)
            try:
                total = 0.0
                for node in sort_nodes:
                    dist = cpds[node].fn(parent_arrays[node])
                    total = total - torch.sum(dist.log_prob(arrays[node]))
            finally:
                st.mode, st.values = None, {}
            return total

        opt = _make_optimizer(optimizer, [flat])

        def closure():
            opt.zero_grad()
            loss = nll()
            loss.backward()
            return loss

        log_loss = logger.isEnabledFor(logging.INFO)
        for i in range(int(num_steps)):
            loss = opt.step(closure)
            if log_loss and i % 50 == 0:
                logger.info(f"Step {i} | Loss: {float(loss):.4f}")
        with torch.no_grad():
            fitted = {n: v.clone() for n, v in constrain(flat).items()}
        st.values = dict(fitted)  # simulate() after fit uses these
        return fitted

    def _fit_mcmc_reference(self, arrays, sort_nodes, prior_fn, num_steps, seed, mcmc_kwargs):
        from pgmpy_tpu_torch.sampling.hmc import NoUTurnSamplerDA
        from pgmpy_tpu_torch.utils.mathext import seeded_generator

        if prior_fn is None:
            raise ValueError("estimator='MCMC' requires prior_fn")
        priors = prior_fn()
        names = list(priors)
        cpds = {node: self.get_cpds(node) for node in sort_nodes}
        supports = {n: getattr(priors[n], "support", "real") for n in names}

        # shapes from one prior draw, then the unconstrained start at the
        # transform of a second draw per parameter
        gen = seeded_generator(0 if seed is None else seed)
        shapes = {n: tuple(priors[n].sample(gen).shape) for n in names}
        sizes = [int(np.prod(shapes[n])) for n in names]
        flat0 = torch.cat([
            _unconstrain_support(as_tensor(priors[n].sample(gen)).reshape(-1), supports[n])
            for n in names
        ]).cpu().numpy()

        def log_post(flat):
            total = 0.0
            vals = {}
            for n, u in zip(names, torch.split(flat, sizes)):
                vals[n], logdet = _constrain_support(u.reshape(shapes[n]), supports[n])
                total = total + logdet + torch.sum(priors[n].log_prob(vals[n]))
            for node in sort_nodes:
                dist = cpds[node].fn(vals, {p: arrays[p] for p in cpds[node].parents})
                total = total + torch.sum(dist.log_prob(arrays[node]))
            return total

        num_adapt = int(mcmc_kwargs.get("warmup_steps", max(200, num_steps // 2)))
        samples = NoUTurnSamplerDA(log_post).sample(
            flat0, num_adapt=num_adapt, num_samples=int(num_steps),
            seed=0 if seed is None else seed, return_type="array",
        )
        samples = np.asarray(samples)
        out = {}
        for n, seg in zip(names, np.split(samples, np.cumsum(sizes)[:-1], axis=1)):
            sup = supports[n]
            if sup == "positive":
                seg = np.exp(seg)
            elif isinstance(sup, tuple) and sup[0] == "interval":
                low, high = sup[1], sup[2]
                seg = low + (high - low) / (1.0 + np.exp(-seg))
            out[n] = seg.reshape((samples.shape[0],) + shapes[n])
        return out

    def _fit_make_cpds(self, data, make_cpds, init_params, lr, max_iter, exit_delta):
        """Legacy point-MLE over a user-supplied dict of parameters."""
        from pgmpy_tpu_torch.utils.optimizer import optimize

        arrays = _columns(data, self.nodes())
        parents = {node: self.get_parents(node) for node in self.nodes()}
        n_rows = len(data)

        def loss_fn(params, _):
            fns = make_cpds(params)
            total = 0.0
            for node in self.nodes():
                dist = fns[node]({p: arrays[p] for p in parents[node]})
                total = total - torch.sum(dist.log_prob(arrays[node]))
            return total / n_rows

        params = optimize(
            loss_fn, params=init_params, loss_args={}, lr=lr,
            max_iter=max_iter, exit_delta=exit_delta,
        )
        fns = make_cpds(params)

        def on_tensors(f):
            return lambda pv: f({k: as_tensor(v) for k, v in pv.items()})

        self.add_cpds(*[
            FunctionalCPD(node, on_tensors(fns[node]), parents[node]) for node in self.nodes()
        ])
        return params

    def fit_mcmc(self, data, make_cpds, init_params, log_prior=None, num_samples=500,
                 num_adapt=200, seed=0):
        """NUTS posterior over the parameter vector (the pytree
        ``init_params`` flattened as ``jax.flatten_util.ravel_pytree`` does).
        Returns ``(samples, unravel)``: ``unravel`` maps a row of samples to
        the parameter tree."""
        from pgmpy_tpu_torch.sampling.hmc import NoUTurnSamplerDA

        arrays = _columns(data, self.nodes())
        parents = {node: self.get_parents(node) for node in self.nodes()}
        flat0, unravel = _ravel_pytree(init_params)

        def log_pdf(flat):
            params = unravel(flat)
            fns = make_cpds(params)
            total = 0.0
            for node in self.nodes():
                dist = fns[node]({p: arrays[p] for p in parents[node]})
                total = total + torch.sum(dist.log_prob(arrays[node]))
            if log_prior is not None:
                total = total + log_prior(params)
            return total

        samples = NoUTurnSamplerDA(log_pdf).sample(
            flat0, num_adapt=num_adapt, num_samples=num_samples,
            seed=seed, return_type="array",
        )
        return samples, unravel

    def copy(self):
        model = FunctionalBayesianNetwork()
        model.add_nodes_from(self.nodes())
        model.add_edges_from(self.edges())
        for cpd in self.cpds:
            model.add_cpds(FunctionalCPD(cpd.variable, cpd.fn, cpd.parents))
        model.latents = set(self.latents)
        return model

