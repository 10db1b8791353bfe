"""DiscreteBayesianNetwork: DAG + TabularCPDs.

Port of ``pgmpy_tpu/models/discrete_bn.py``.  The model object is host-side
symbolic structure; ``fit`` runs the device count kernel, inference
(``pgmpy_tpu_torch/inference``) compiles it into a calibration schedule or a
planned contraction, and ``simulate`` into an ancestral sampling program
(``pgmpy_tpu_torch/sampling``).
"""

from collections import defaultdict

import numpy as np
import pandas as pd
import torch

from pgmpy_tpu_torch.base.dag import DAG
from pgmpy_tpu_torch.config import TINY, logger, to_numpy
from pgmpy_tpu_torch.factors.cpd import TabularCPD


class DiscreteBayesianNetwork(DAG):
    """A Bayesian network: DAG + one TabularCPD per node.

    Parameters
    ----------
    ebunch : iterable of (u, v) edges, optional
    latents : iterable, optional
    lavaan_str / dagitty_str : str, optional

    Examples
    --------
    >>> import numpy as np
    >>> from pgmpy_tpu_torch.factors import TabularCPD
    >>> from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
    >>> model = DiscreteBayesianNetwork([("rain", "wet"), ("sprinkler", "wet")])
    >>> model.add_cpds(
    ...     TabularCPD("rain", 2, [[0.8], [0.2]]),
    ...     TabularCPD("sprinkler", 2, [[0.6], [0.4]]),
    ...     TabularCPD("wet", 2,
    ...                [[1.0, 0.1, 0.2, 0.01], [0.0, 0.9, 0.8, 0.99]],
    ...                evidence=["rain", "sprinkler"], evidence_card=[2, 2]))
    >>> model.check_model()
    True
    >>> import pandas as pd
    >>> df = pd.DataFrame({"rain": [0, 1, 0, 0], "sprinkler": [1, 0, 0, 1],
    ...                    "wet": [1, 1, 0, 1]})
    >>> fit = DiscreteBayesianNetwork(model.edges())
    >>> _ = fit.fit(df)  # MLE by default; returns the model
    >>> fit.get_cpds("rain").get_values().shape
    (2, 1)
    """

    def __init__(self, ebunch=None, latents=[], lavaan_str=None, dagitty_str=None):
        super().__init__(ebunch, latents, lavaan_str, dagitty_str)
        self.cpds = []
        self._version = 0

    def _bump_version(self):
        self._version = getattr(self, "_version", 0) + 1

    def _cache_token(self):
        """Key for compiled-program / validity caches: changes on any model
        edit (``_version``) AND on any in-place CPD value mutation (the
        per-factor ``_mutation`` counter bumped by the ``values`` setter)."""
        return (
            getattr(self, "_version", 0),
            tuple((id(c), c.__dict__.get("_mutation", 0)) for c in self.cpds),
        )

    def add_edge(self, u, v, weight=None, **kwargs):
        self._bump_version()
        if u == v:
            raise ValueError("Self loops are not allowed.")
        super().add_edge(u, v, weight=weight)

    def remove_node(self, node):
        """Remove node; children's CPDs are marginalized over it."""
        self._bump_version()
        affected_nodes = [v for u, v in self.edges() if u == node]
        for affected_node in affected_nodes:
            node_cpd = self.get_cpds(node=affected_node)
            if node_cpd:
                node_cpd.marginalize([node], inplace=True)
        if self.get_cpds(node=node):
            self.remove_cpds(node)
        super(DAG, self).remove_node(node)

    def remove_nodes_from(self, nodes):
        for node in nodes:
            self.remove_node(node)

    def remove_edge(self, u, v):
        self._bump_version()
        super().remove_edge(u, v)

    def add_cpds(self, *cpds):
        self._bump_version()
        nodes = set(self.nodes())
        position = {c.variable: i for i, c in enumerate(self.cpds)}
        for cpd in cpds:
            if not isinstance(cpd, (TabularCPD,)):
                raise ValueError("Only TabularCPD can be added.")
            if set(cpd.scope()) - nodes:
                raise ValueError(f"CPD defined on variable not in the model: {cpd}")
            prev = position.get(cpd.variable)
            if prev is not None:
                logger.warning(f"Replacing existing CPD for {cpd.variable}")
                self.cpds[prev] = cpd
            else:
                position[cpd.variable] = len(self.cpds)
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
        self._bump_version()
        for cpd in cpds:
            if isinstance(cpd, (str, int)):
                cpd = self.get_cpds(cpd)
            self.cpds.remove(cpd)

    def get_cardinality(self, node=None):
        if node is not None:
            cpd = self.get_cpds(node)
            if cpd is None:
                raise ValueError(f"CPD not added for the node: {node}")
            return cpd.variable_card
        cardinalities = defaultdict(int)
        for cpd in self.cpds:
            cardinalities[cpd.variable] = cpd.variable_card
        return cardinalities

    @property
    def states(self):
        """{variable: list of state names}"""
        return {cpd.variable: cpd.state_names[cpd.variable] for cpd in self.cpds}

    def check_model(self):
        """Verify CPDs exist, parent sets match, columns normalize, and
        state names agree across CPDs.

        CPD validity is decided host-side when a CPD is built, so the check
        makes no device round-trip per CPD.
        """
        if self.__dict__.get("_checked_version") == self._cache_token():
            return True
        nodes_to_check = []
        for node in self.nodes():
            cpd = self.get_cpds(node=node)
            if cpd is None:
                raise ValueError(f"No CPD associated with {node}")
            if isinstance(cpd, TabularCPD):
                evidence = cpd.get_evidence()
                parents = self.get_parents(node)
                if set(evidence) != set(parents):
                    raise ValueError(
                        f"CPD associated with {node} doesn't have proper parents associated with it."
                    )
                for var in cpd.variables:
                    other = self.get_cpds(var)
                    if other is not None:
                        if cpd.state_names[var] != other.state_names[var]:
                            raise ValueError(
                                f"The state names of {var} do not match across CPDs"
                            )
                nodes_to_check.append(node)

        # is_valid_cpd is cached at CPD construction (host-side numpy), so
        # this loop costs no device round-trips
        for node in nodes_to_check:
            if not self.get_cpds(node).is_valid_cpd():
                raise ValueError(
                    f"Sum or integral of conditional probabilities for node {node} is not equal to 1."
                )
        self._checked_version = self._cache_token()
        return True

    def to_markov_model(self):
        """Moralize; CPDs become clique factors."""
        from pgmpy_tpu_torch.models.markov_network import DiscreteMarkovNetwork

        moral_graph = self.moralize()
        mm = DiscreteMarkovNetwork(moral_graph.edges())
        mm.add_nodes_from(moral_graph.nodes())
        mm.add_factors(*[cpd.to_factor() for cpd in self.cpds])
        mm.latents = self.latents
        return mm

    def to_junction_tree(self):
        return self.to_markov_model().to_junction_tree()

    def fit(self, data, estimator=None, state_names=[], n_jobs=1, **kwargs):
        """Learn CPDs from data (default: MaximumLikelihoodEstimator)."""
        from pgmpy_tpu_torch.estimators import BaseEstimator, MaximumLikelihoodEstimator

        if estimator is None:
            estimator = MaximumLikelihoodEstimator
        elif not issubclass(estimator, BaseEstimator):
            raise TypeError("Estimator object should be a valid pgmpy_tpu_torch estimator.")
        _estimator = estimator(self, data, state_names=state_names)
        cpds_list = _estimator.get_parameters(n_jobs=n_jobs, **kwargs)
        self.add_cpds(*cpds_list)
        return self

    def fit_update(self, data, n_prev_samples=None, n_jobs=1):
        """Bayesian update of CPDs with new data, using current CPDs (scaled
        by ``n_prev_samples``) as Dirichlet pseudo-counts."""
        from pgmpy_tpu_torch.estimators import BayesianEstimator

        if n_prev_samples is None:
            n_prev_samples = data.shape[0]
        pseudo_counts = {}
        for var in self.nodes():
            cpd = self.get_cpds(var)
            pseudo_counts[var] = n_prev_samples * cpd.get_values()
        _estimator = BayesianEstimator(self, data, state_names=self.states)
        cpds_list = _estimator.get_parameters(
            prior_type="dirichlet", pseudo_counts=pseudo_counts, n_jobs=n_jobs
        )
        self.add_cpds(*cpds_list)
        return self

    def _missing_variables(self, data):
        if set(data.columns) == set(self.nodes()):
            raise ValueError("No variable missing in data. Nothing to predict")
        elif set(data.columns) - set(self.nodes()):
            raise ValueError("Data has variables which are not in the model")
        return sorted(set(self.nodes()) - set(data.columns), key=str)

    def predict(self, data, algo=None, stochastic=False, n_jobs=1, seed=None, **kwargs):
        """Impute the missing columns of ``data``: the joint posterior over
        the missing variables is computed for ALL rows in one batched
        contraction (``VariableElimination.query_batch``), then argmax
        (MAP) or categorical sampling per row.

        ``algo`` picks the inference class; the default VariableElimination
        rides the batched device path, any other class queries per unique
        row with ``**kwargs`` forwarded.
        """
        from pgmpy_tpu_torch.inference.ve import VariableElimination

        missing_variables = self._missing_variables(data)

        if algo is not None and algo is not VariableElimination:
            return self._predict_with_algo(
                data, algo, missing_variables, stochastic, seed, **kwargs
            )

        infer = VariableElimination(self)
        evidence = {col: data[col].tolist() for col in data.columns}
        values, state_names = infer.query_batch(missing_variables, evidence)
        flat = values.reshape(values.shape[0], -1)
        if stochastic:
            # one batched categorical draw over the joint posteriors, from an
            # explicit generator on the posteriors' device
            from pgmpy_tpu_torch.utils.mathext import categorical_draw, seeded_generator

            gen = seeded_generator(0 if seed is None else seed, flat.device)
            picks = categorical_draw(torch.log(torch.clamp_min(flat, TINY)), gen)
        else:
            picks = flat.argmax(dim=1)
        picks = picks.cpu().numpy()
        cards = [len(state_names[v]) for v in missing_variables]
        codes = np.stack(np.unravel_index(picks, cards), axis=1)
        out = {}
        for j, var in enumerate(missing_variables):
            out[var] = [state_names[var][c] for c in codes[:, j]]
        return pd.DataFrame(out, index=data.index)

    def _predict_with_algo(self, data, algo, missing_variables, stochastic, seed, **kwargs):
        """Per-unique-row prediction through a user-chosen inference class
        (BeliefPropagation, ApproxInference, ...): each unique row is one
        query against the chosen engine, memoized across duplicate rows."""
        infer = algo(self)
        rng = np.random.default_rng(seed)
        unique = data.drop_duplicates()
        row_to_pred = {}
        for _, row in unique.iterrows():
            evidence = row.to_dict()
            joint = infer.query(
                missing_variables, evidence=evidence, show_progress=False, **kwargs
            )
            order = [joint.variables.index(v) for v in missing_variables]
            values = to_numpy(joint.values).astype(np.float64).transpose(order)
            flat = values.reshape(-1)
            if stochastic:
                pick = rng.choice(flat.size, p=flat / flat.sum())
            else:
                pick = int(flat.argmax())
            codes = np.unravel_index(pick, values.shape)
            row_to_pred[tuple(row)] = {
                v: joint.state_names[v][c]
                for v, c in zip(missing_variables, codes)
            }
        out = {v: [] for v in missing_variables}
        for _, row in data.iterrows():
            pred = row_to_pred[tuple(row)]
            for v in missing_variables:
                out[v].append(pred[v])
        return pd.DataFrame(out, index=data.index)

    def predict_probability(self, data):
        """Posterior probability of each missing variable state per row:
        one batched contraction per missing variable."""
        from pgmpy_tpu_torch.inference.ve import VariableElimination

        missing_variables = self._missing_variables(data)

        infer = VariableElimination(self)
        evidence = {col: data[col].tolist() for col in data.columns}
        out = {}
        for var in missing_variables:
            values, state_names = infer.query_batch([var], evidence)
            values = to_numpy(values).astype(np.float64)
            for no, state in enumerate(state_names[var]):
                out[f"{var}_{state}"] = values[:, no]
        return pd.DataFrame(out, index=data.index)

    def get_state_probability(self, states):
        """P(assignment) for a full or partial joint assignment via the chain
        rule over CPT lookups."""
        self.check_model()
        missing = set(states.keys()) - set(self.nodes())
        if missing:
            raise ValueError(f"Unknown variables: {missing}")
        for var, state in states.items():
            cpd = self.get_cpds(var)
            if state not in cpd.state_names[var]:
                raise ValueError(f"State: {state} not define for variable: {var}")
        if set(states.keys()) != set(self.nodes()):
            # marginal of a partial assignment via inference
            from pgmpy_tpu_torch.inference.ve import VariableElimination

            infer = VariableElimination(self)
            phi = infer.query(
                list(states.keys()), evidence=None, joint=True, show_progress=False
            )
            return float(phi.get_value(**states))
        prob = 1.0
        for cpd in self.cpds:
            prob *= cpd.get_value(
                **{var: states[var] for var in cpd.variables}
            )
        return prob

    def get_factorized_product(self, latex=False):
        terms = []
        for node in sorted(self.nodes(), key=str):
            parents = sorted(self.get_parents(node), key=str)
            if parents:
                terms.append(f"P({node} | {', '.join(map(str, parents))})")
            else:
                terms.append(f"P({node})")
        out = "".join(terms)
        return f"$ {out} $" if latex else out

    def is_imap(self, JPD):
        from pgmpy_tpu_torch.factors.jpd import JointProbabilityDistribution, model_joint_factor

        if not isinstance(JPD, JointProbabilityDistribution):
            raise TypeError("JPD must be an instance of JointProbabilityDistribution")
        return JPD.to_factor() == model_joint_factor(self)

    def copy(self):
        model_copy = DiscreteBayesianNetwork()
        model_copy.add_nodes_from(self.nodes())
        model_copy.add_edges_from(self.edges())
        if self.cpds:
            model_copy.add_cpds(*[cpd.copy() for cpd in self.cpds])
        model_copy.latents = set(self.latents)
        return model_copy

    def get_markov_blanket(self, node):
        return super().get_markov_blanket(node)

    @staticmethod
    def get_random(
        n_nodes=5,
        edge_prob=0.5,
        n_states=None,
        latents=False,
        node_names=None,
        seed=None,
    ):
        """Random model: random DAG + random CPDs."""
        dag = DAG.get_random(
            n_nodes=n_nodes,
            edge_prob=edge_prob,
            node_names=node_names,
            latents=latents,
            seed=seed,
        )
        bn = DiscreteBayesianNetwork(dag.edges(), latents=dag.latents)
        bn.add_nodes_from(dag.nodes())
        bn.get_random_cpds(n_states=n_states, inplace=True, seed=seed)
        return bn

    def get_random_cpds(self, n_states=None, inplace=False, seed=None):
        """Random CPDs matching this structure."""
        if n_states is None:
            n_states = {var: 2 for var in self.nodes()}
        elif isinstance(n_states, int):
            n_states = {var: n_states for var in self.nodes()}
        gen = np.random.default_rng(seed)
        cpds = []
        for var in self.nodes():
            parents = self.get_parents(var)
            cpds.append(
                TabularCPD.get_random(
                    variable=var,
                    evidence=parents,
                    cardinality={v: n_states[v] for v in [var] + parents},
                    seed=int(gen.integers(0, 2**31)),
                )
            )
        if inplace:
            self.add_cpds(*cpds)
            return self
        return cpds

    def do(self, nodes, inplace=False):
        """Intervene: sever in-edges and replace CPDs with marginal CPDs."""
        if isinstance(nodes, (str, int)):
            nodes = [nodes]
        for node in nodes:
            if node not in self.nodes():
                raise ValueError(f"Node: {node} is not in the graph.")
        model = self if inplace else self.copy()
        for node in nodes:
            parents = list(model.predecessors(node))
            for parent in parents:
                model.remove_edge(parent, node)
            cpd = model.get_cpds(node=node)
            if cpd:
                model.remove_cpds(cpd)
                states = cpd.state_names[node]
                marginal_cpd = TabularCPD(
                    node,
                    cpd.variable_card,
                    to_numpy(
                        cpd.to_factor()
                        .marginalize(cpd.get_evidence(), inplace=False)
                        .normalize(inplace=False)
                        .values
                    ).reshape(-1, 1),
                    state_names={node: states},
                )
                model.add_cpds(marginal_cpd)
        return model

    def simulate(
        self,
        n_samples=10,
        do=None,
        evidence=None,
        virtual_evidence=None,
        virtual_intervention=None,
        missing_prob=None,
        include_latents=False,
        partial_samples=None,
        seed=None,
        show_progress=True,
        return_full=False,
    ):
        """Simulate data from the model (see
        :func:`pgmpy_tpu_torch.sampling.simulate.simulate_model`)."""
        from pgmpy_tpu_torch.sampling.simulate import simulate_model

        return simulate_model(
            self,
            n_samples=n_samples,
            do=do,
            evidence=evidence,
            virtual_evidence=virtual_evidence,
            virtual_intervention=virtual_intervention,
            missing_prob=missing_prob,
            include_latents=include_latents,
            partial_samples=partial_samples,
            seed=seed,
            show_progress=show_progress,
            return_full=return_full,
        )

    def save(self, filename, filetype=None):
        """Write the model in bif / xmlbif / xdsl / net / uai / xbn format
        (inferred from the extension when ``filetype`` is None); a name
        ending in ``.gz`` is written through gzip."""
        from pgmpy_tpu_torch.readwrite import filetype_of, get_writer

        writer = get_writer(filetype or filetype_of(filename))(model=self)
        writer.write_file(filename)

    @classmethod
    def load(cls, filename, filetype=None, **kwargs):
        """Read a model written in any format ``save`` writes, gzipped or
        not."""
        from pgmpy_tpu_torch.readwrite import filetype_of, get_reader

        reader = get_reader(filetype or filetype_of(filename))(path=filename, **kwargs)
        return reader.get_model()
