"""CausalInference: do-calculus identification + interventional queries.

Port of ``pgmpy_tpu/inference/causal.py`` (reference:
``pgmpy/inference/CausalInference.py:23-1143``).  Identification
(backdoor/frontdoor/IV/adjustment-set search) is host-side graph algebra,
copied as it is, power-set enumerations included.  The interventional
``query`` is an adjustment sum: the JAX package runs one inference query per
state combination of the adjustment set and sums on the host; the port
answers every combination of positive weight in ONE ``query_batch`` of the
inference engine and sums on the device, with one host read (the weights).
An engine without ``query_batch`` (``query_batch = None`` on a subclass
forces it) runs the JAX package's loop.
"""

import itertools
from itertools import chain, combinations

import networkx as nx
import numpy as np
import torch

from pgmpy_tpu_torch.config import logger
from pgmpy_tpu_torch.factors.discrete import DiscreteFactor
from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork


def _powerset(iterable):
    s = list(iterable)
    return chain.from_iterable(combinations(s, r) for r in range(len(s) + 1))


class CausalInference:
    """Causal identification + interventional queries on a causal graph.

    Examples
    --------
    >>> import numpy as np
    >>> from pgmpy_tpu_torch.factors import TabularCPD
    >>> from pgmpy_tpu_torch.inference import CausalInference
    >>> from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
    >>> # confounder Z -> X, Z -> Y; X -> Y
    >>> model = DiscreteBayesianNetwork(
    ...     [("Z", "X"), ("Z", "Y"), ("X", "Y")])
    >>> model.add_cpds(
    ...     TabularCPD("Z", 2, [[0.5], [0.5]]),
    ...     TabularCPD("X", 2, [[0.9, 0.3], [0.1, 0.7]],
    ...                evidence=["Z"], evidence_card=[2]),
    ...     TabularCPD("Y", 2, [[0.8, 0.5, 0.6, 0.1], [0.2, 0.5, 0.4, 0.9]],
    ...                evidence=["Z", "X"], evidence_card=[2, 2]))
    >>> ci = CausalInference(model)
    >>> sorted(ci.get_all_backdoor_adjustment_sets("X", "Y"))
    [frozenset({'Z'})]
    >>> phi = ci.query(["Y"], do={"X": 1}, show_progress=False)
    >>> np.asarray(phi.values, dtype=float).round(3).tolist()
    [0.3, 0.7]
    """

    def __init__(self, model):
        from pgmpy_tpu_torch.base.dag import DAG
        from pgmpy_tpu_torch.models.sem import SEMGraph

        if isinstance(model, SEMGraph):
            # identification runs on the FULL graph structure: error nodes
            # `.v` and correlated-error common causes `..uv` are latent
            # (ref CausalInference.py:80-95)
            self.model = model
            self.observed_variables = frozenset(model.observed)
            self.latent_variables = set(model.latents)
            full = model.full_graph_struct
            dot_nodes = {n for n in full.nodes() if str(n).startswith(".")}
            self.dag = DAG(latents=set(model.latents) | dot_nodes)
            self.dag.add_nodes_from(full.nodes())
            self.dag.add_edges_from(full.edges())
        elif isinstance(model, DAG):
            self.model = model
            self.observed_variables = frozenset(model.nodes()) - model.latents
            self.latent_variables = set(model.latents)
            self.dag = model
        else:
            raise NotImplementedError(
                "Causal Inference is only implemented for DAGs, Bayesian-network "
                "models, and SEMGraphs."
            )
        self.set_nodes = frozenset()

    def __repr__(self):
        variables = ", ".join(map(str, sorted(self.observed_variables, key=str)))
        return f"{self.__class__.__name__}({variables})"

    # ------------------------------------------------------------------ #
    # backdoor / frontdoor criteria
    # ------------------------------------------------------------------ #
    def is_valid_backdoor_adjustment_set(self, X, Y, Z=[]):
        """Z blocks all backdoor paths from X to Y and contains no
        descendant of X."""
        if isinstance(Z, (str, int)):
            Z = [Z]
        Z = set(Z)
        if Z & set(nx.descendants(self.dag, X) | {X}):
            return False
        backdoor_graph = self.dag.copy()
        for child in list(backdoor_graph.successors(X)):
            backdoor_graph.remove_edge(X, child)
        return not backdoor_graph.is_dconnected(X, Y, observed=list(Z))

    def get_all_backdoor_adjustment_sets(self, X, Y):
        """All minimal valid backdoor sets (frozenset of frozensets)."""
        try:
            self.is_valid_backdoor_adjustment_set(X, Y)
        except KeyError:
            raise KeyError("X or Y not in model")
        # reference contract (CausalInference.py:146-210): the empty set
        # being valid short-circuits to an EMPTY outer frozenset, and
        # finding no valid set at all raises
        if self.is_valid_backdoor_adjustment_set(X, Y, Z=frozenset()):
            return frozenset()
        possible = (
            self.observed_variables
            - {X, Y}
            - set(nx.descendants(self.dag, X))
        )
        valid = []
        for size in range(len(possible) + 1):
            for Z in combinations(sorted(possible, key=str), size):
                if any(set(v) <= set(Z) for v in valid):
                    continue
                if self.is_valid_backdoor_adjustment_set(X, Y, Z):
                    valid.append(frozenset(Z))
        if not valid:
            raise ValueError(f"No valid adjustment set found for {X} -> {Y}")
        return frozenset(valid)

    def is_valid_frontdoor_adjustment_set(self, X, Y, Z=None):
        """Z intercepts all X->Y paths; no unblocked backdoor X->Z; all
        Z->Y backdoors blocked by X."""
        if isinstance(Z, (str, int)):
            Z = [Z]
        Z = set(Z or [])
        # 1. Z intercepts all directed paths X -> Y
        for path in nx.all_simple_paths(self.dag, X, Y):
            if not set(path[1:-1]) & Z:
                return False
        # 2. no unblocked backdoor path X -> z
        backdoor_graph = self.dag.copy()
        for child in list(backdoor_graph.successors(X)):
            backdoor_graph.remove_edge(X, child)
        for z in Z:
            if backdoor_graph.is_dconnected(X, z, observed=[]):
                return False
        # 3. every backdoor path from each z to Y is blocked by X
        for z in Z:
            if not self.is_valid_backdoor_adjustment_set(z, Y, Z=[X]):
                return False
        return True

    def get_all_frontdoor_adjustment_sets(self, X, Y):
        possible = self.observed_variables - {X, Y}
        valid = frozenset(
            [
                frozenset(Z)
                for Z in _powerset(sorted(possible, key=str))
                if self.is_valid_frontdoor_adjustment_set(X, Y, Z)
            ]
        )
        return valid

    # ------------------------------------------------------------------ #
    # adjustment-set machinery (generalized criterion)
    # ------------------------------------------------------------------ #
    def get_proper_backdoor_graph(self, X, Y, inplace=False):
        """Remove the first edge of every proper causal path from X to Y."""
        for var in chain(X, Y):
            if var not in self.dag.nodes():
                raise ValueError(f"{var} not found in the model.")
        model = self.dag if inplace else self.dag.copy()
        edges_to_remove = []
        for x in X:
            for child in model.successors(x):
                # edge lies on a proper causal path if child can reach Y
                if child in Y or (set(nx.descendants(model, child)) & set(Y)):
                    edges_to_remove.append((x, child))
        model.remove_edges_from(edges_to_remove)
        return model

    def is_valid_adjustment_set(self, X, Y, adjustment_set):
        """Generalized adjustment criterion via the proper backdoor graph."""
        if isinstance(X, (str, int)):
            X = [X]
        if isinstance(Y, (str, int)):
            Y = [Y]
        if isinstance(adjustment_set, (str, int)):
            adjustment_set = [adjustment_set]
        backdoor_graph = self.get_proper_backdoor_graph(X, Y)
        for x, y in itertools.product(X, Y):
            if backdoor_graph.is_dconnected(x, y, observed=list(adjustment_set)):
                return False
        return True

    def get_minimal_adjustment_set(self, X, Y):
        """Minimal adjustment set via minimal d-separator on the proper
        backdoor graph."""
        if isinstance(X, (str, int)):
            X = [X]
        if isinstance(Y, (str, int)):
            Y = [Y]
        backdoor_graph = self.get_proper_backdoor_graph(X, Y)
        if len(X) == 1 and len(Y) == 1:
            try:
                return backdoor_graph.minimal_dseparator(X[0], Y[0])
            except ValueError:
                return None
        return nx.find_minimal_d_separator(backdoor_graph, set(X), set(Y))

    # ------------------------------------------------------------------ #
    # instrumental variables (MIIV machinery, ref CausalInference.py:308-577)
    # ------------------------------------------------------------------ #
    def get_scaling_indicators(self):
        """One observed measurement variable per latent, used to fix the
        latent's scale (first observed successor, deterministic order)."""
        scaling_indicators = {}
        for node in self.latent_variables:
            for neighbor in sorted(self.dag.successors(node), key=str):
                if neighbor in self.observed_variables:
                    scaling_indicators[node] = neighbor
                    break
        return scaling_indicators

    def _iv_transformations(self, X, Y, scaling_indicators={}):
        """Rewrite the full graph so plain d-separation finds the model-
        implied IVs for estimating X -> Y: sever Y from its structural
        parents and reroute latent influences through scaling indicators.
        Returns (transformed graph, dependent variable)."""
        full_graph = self.dag.copy()

        if (X, Y) not in full_graph.edges():
            raise ValueError(f"The edge from {X} -> {Y} doesn't exist in the graph")

        if (X in self.observed_variables) and (Y in self.observed_variables):
            full_graph.remove_edge(X, Y)
            return full_graph, Y

        if Y in self.latent_variables:
            dependent_var = scaling_indicators[Y]
            full_graph.add_edge("." + str(Y), dependent_var)
        else:
            dependent_var = Y

        # sever Y from its structural parents (error-term edges stay)
        structural_parents = [
            var for var in self.dag.predecessors(Y) if not str(var).startswith(".")
        ]
        for parent_y in structural_parents:
            full_graph.remove_edge(parent_y, Y)
            if parent_y in self.latent_variables:
                full_graph.add_edge(
                    "." + str(scaling_indicators[parent_y]), dependent_var
                )

        return full_graph, dependent_var

    def get_ivs(self, X, Y, scaling_indicators={}):
        """Model-implied instrumental variables for the relation X -> Y:
        observed variables d-connected to X but not to Y in the transformed
        graph with Y's structural equation severed."""
        if not scaling_indicators:
            scaling_indicators = self.get_scaling_indicators()
        if X in scaling_indicators and scaling_indicators[X] == Y:
            logger.warning(
                f"{Y} is the scaling indicator of {X}. Please specify `scaling_indicators`"
            )

        transformed_graph, dependent_var = self._iv_transformations(
            X, Y, scaling_indicators=scaling_indicators
        )
        explanatory_var = scaling_indicators[X] if X in self.latent_variables else X

        d_connected_x = transformed_graph.active_trail_nodes([explanatory_var])[
            explanatory_var
        ]
        # d-connected to the dependent var except through the explanatory var
        graph_no_x = transformed_graph.copy()
        graph_no_x.remove_edges_from(list(graph_no_x.in_edges(explanatory_var)))
        d_connected_y = graph_no_x.active_trail_nodes([dependent_var])[dependent_var]

        return (
            (d_connected_x - d_connected_y - {dependent_var, explanatory_var})
            & self.observed_variables
        )

    def _nearest_separator(self, G, Y, Z):
        """Observed set W separating Y from Z in ``G`` found by a moralized-
        ancestral-graph blanket search; None if no such set exists
        (Van der Zander et al. 2015)."""
        from pgmpy_tpu_torch.base.undirected import UndirectedGraph
        from pgmpy_tpu_torch.models.sem import SEMGraph

        W = set()
        ancestral_nodes = (
            nx.ancestors(G, Y) | nx.ancestors(G, Z) | {Y, Z}
        )
        ancestral_G = G.subgraph(ancestral_nodes).copy()

        if isinstance(self.model, SEMGraph):
            # uncorrelated error nodes add no paths; dropping them keeps the
            # moral graph small
            uncorrelated = set(self.model.err_graph.nodes()) - {
                node for edge in self.model.err_graph.edges() for node in edge
            }
            ancestral_G.remove_nodes_from(
                ["." + str(node) for node in uncorrelated if "." + str(node) in ancestral_G]
            )

        moral = UndirectedGraph()
        moral.add_nodes_from(ancestral_G.nodes())
        moral.add_edges_from(ancestral_G.to_undirected().edges())
        for node in ancestral_G.nodes():
            moral.add_edges_from(
                itertools.combinations(list(ancestral_G.predecessors(node)), 2)
            )

        visited = {Y}
        to_visit = list(moral.neighbors(Y))
        while to_visit:
            node = to_visit.pop()
            if node == Z:
                return None
            visited.add(node)
            if node in self.observed_variables:
                W.add(node)
            else:
                to_visit.extend(
                    n for n in moral.neighbors(node) if n not in visited
                )
        if Y not in G.active_trail_nodes([Z], observed=W, include_latents=True)[Z]:
            return W
        return None

    def get_conditional_ivs(self, X, Y, scaling_indicators={}):
        """Conditional instruments for X -> Y: (Z, W) pairs where Z is an IV
        for X -> Y after conditioning on W (Van der Zander et al. 2015)."""
        if not scaling_indicators:
            scaling_indicators = self.get_scaling_indicators()
        if X in scaling_indicators and scaling_indicators[X] == Y:
            logger.warning(
                f"{Y} is the scaling indicator of {X}. Please specify `scaling_indicators`"
            )

        transformed_graph, dependent_var = self._iv_transformations(
            X, Y, scaling_indicators=scaling_indicators
        )
        if (X, Y) in transformed_graph.edges():
            transformed_graph.remove_edge(X, Y)

        instruments = []
        for Z in sorted(self.observed_variables - {X, Y}, key=str):
            W = self._nearest_separator(transformed_graph, Y, Z)
            if (not W) or (W & set(nx.descendants(transformed_graph, Y))) or (X in W):
                continue
            if X in self.dag.active_trail_nodes([Z], observed=W)[Z]:
                instruments.append((Z, W))
        return instruments

    def get_total_conditional_ivs(self, X, Y, scaling_indicators={}):
        """Conditional instruments valid for the TOTAL effect of X on Y: a
        conditioning set may not contain nodes on any causal path X -> Y."""
        if not scaling_indicators:
            scaling_indicators = self.get_scaling_indicators()
        all_paths = list(nx.all_simple_paths(self.dag, X, Y))
        nodes_on_paths = {node for path in all_paths for node in path} - {X, Y}

        transformed_graph, dependent_var = self._iv_transformations(
            X, Y, scaling_indicators=scaling_indicators
        )
        if (X, Y) in transformed_graph.edges():
            transformed_graph.remove_edge(X, Y)

        instruments = []
        for Z in sorted(self.observed_variables - {X, Y}, key=str):
            W = self._nearest_separator(transformed_graph, Y, Z)
            if W and W & nodes_on_paths:
                continue
            if (not W) or (W & set(nx.descendants(transformed_graph, Y))) or (X in W):
                continue
            if X in self.dag.active_trail_nodes([Z], observed=W)[Z]:
                instruments.append((Z, W))
        return instruments

    # ------------------------------------------------------------------ #
    # identification dispatch & ATE
    # ------------------------------------------------------------------ #
    def identification_method(self, X, Y):
        """Every identification strategy that applies for the effect of X on
        Y, keyed by method name (ref CausalInference.py:578-633)."""
        result = {}
        strategies = [
            ("backdoor set", lambda: self.get_all_backdoor_adjustment_sets(X, Y)),
            ("frontdoor set", lambda: self.get_all_frontdoor_adjustment_sets(X, Y)),
            ("instrumental variables", lambda: self.get_ivs(X, Y)),
            ("conditional instrumental variables",
             lambda: self.get_conditional_ivs(X, Y)),
            ("total conditional instrumental variables",
             lambda: self.get_total_conditional_ivs(X, Y)),
        ]
        for name, strategy in strategies:
            try:
                found = strategy()
            except Exception:
                continue
            if len(found) > 0:
                result[name] = found
        return result

    def _simple_decision(self, adjustment_sets=[]):
        """Smallest adjustment set of the provided ones."""
        adjustment_list = list(adjustment_sets)
        if not adjustment_list:
            return frozenset([])
        return min(adjustment_list, key=lambda s: (len(s), sorted(map(str, s))))

    def estimate_ate(
        self,
        X,
        Y,
        data,
        estimand_strategy="smallest",
        estimator_type="linear",
        **kwargs,
    ):
        """Average treatment effect of X on Y: for every directed path
        X -> ... -> Y, the product of per-edge effects (each estimated by
        backdoor-adjusted regression), summed over paths (path-tracing,
        ref CausalInference.py:717-810).

        estimand_strategy: "smallest" (smallest backdoor set per edge),
        "all" (average the estimate over every valid backdoor set), or a
        frozenset naming an explicit adjustment set.
        """
        from pgmpy_tpu_torch.inference.linear_model import LinearEstimator

        if estimator_type != "linear":
            raise ValueError(
                f"estimator_type must be 'linear'. Got: {estimator_type!r}"
            )
        if not (
            isinstance(estimand_strategy, frozenset)
            or estimand_strategy in ("smallest", "all")
        ):
            raise ValueError(
                "estimand_strategy must be 'smallest', 'all', or a frozenset "
                f"adjustment set. Got: {estimand_strategy!r}"
            )

        all_path_effects = []
        for path in nx.all_simple_paths(self.dag, X, Y):
            causal_effect = []
            for x1, x2 in zip(path, path[1:]):
                if isinstance(estimand_strategy, frozenset):
                    adjustment_sets = frozenset({estimand_strategy})
                    if not self.is_valid_backdoor_adjustment_set(
                        x1, x2, Z=estimand_strategy
                    ):
                        raise ValueError(
                            f"{set(estimand_strategy)} is not a valid backdoor "
                            f"adjustment set for {x1} -> {x2}"
                        )
                else:
                    adjustment_sets = self.get_all_backdoor_adjustment_sets(x1, x2)
                    if estimand_strategy == "smallest":
                        adjustment_sets = frozenset(
                            {self._simple_decision(adjustment_sets)}
                        )
                    elif not adjustment_sets:
                        adjustment_sets = frozenset({frozenset()})

                self.estimator = LinearEstimator(self.model)
                ate = [
                    self.estimator.fit(X=x1, Y=x2, Z=s, data=data, **kwargs)._get_ate()
                    for s in adjustment_sets
                ]
                causal_effect.append(np.mean(ate))
            all_path_effects.append(np.prod(causal_effect))
        return float(np.sum(all_path_effects))

    # ------------------------------------------------------------------ #
    # interventional query
    # ------------------------------------------------------------------ #
    def query(
        self,
        variables,
        do=None,
        evidence=None,
        adjustment_set=None,
        inference_algo="ve",
        show_progress=False,
        **kwargs,
    ):
        """P(variables | do(do), evidence) = sum_z P(variables | do, z,
        evidence) P(z | evidence) over the adjustment set z."""
        from pgmpy_tpu_torch.inference.bp import BeliefPropagation
        from pgmpy_tpu_torch.inference.ve import VariableElimination

        if not isinstance(self.model, DiscreteBayesianNetwork):
            raise ValueError(
                "A model with CPDs is required for causal queries."
            )
        if isinstance(variables, (str, int)):
            raise ValueError(f"variables must be a list of strings. Got: {type(variables)}")
        do = do or {}
        evidence = evidence or {}

        if inference_algo == "ve":
            infer_cls = VariableElimination
        elif inference_algo == "bp":
            infer_cls = BeliefPropagation
        elif callable(inference_algo) or isinstance(inference_algo, type):
            infer_cls = inference_algo
        else:
            raise ValueError(f"inference_algo must be 've', 'bp', or an Inference class. Got: {inference_algo}")
        infer = infer_cls(self.model)

        if not do:
            return infer.query(variables, evidence=evidence, show_progress=show_progress)

        if adjustment_set is None:
            do_vars = list(do.keys())
            adjustment_set = set(
                chain(*[self.model.predecessors(var) for var in do_vars])
            )
            if adjustment_set & self.model.latents:
                raise ValueError(
                    "Not all parents of do variables are observed. Please specify "
                    "an adjustment set."
                )
        adjustment_set = sorted(adjustment_set, key=str)

        if not adjustment_set:
            return infer.query(
                variables, evidence={**evidence, **do}, show_progress=show_progress
            )

        # Adjustment weights.  Reference semantics
        # (ref CausalInference.py:1086-1143): evidence variables inside the
        # adjustment set are PINNED to their observed state and the weight
        # factor is the (unnormalized) reduced marginal; evidence outside
        # the adjustment set conditions only the weights, and the inner
        # queries use {do, z} alone — the trailing normalize fixes scale.
        evidence_adj_inter = {
            v: s for v, s in evidence.items() if v in set(adjustment_set)
        }
        if evidence_adj_inter:
            p_z = infer.query(
                adjustment_set, show_progress=show_progress
            ).reduce(list(evidence_adj_inter.items()), inplace=False)
        else:
            p_z = infer.query(
                adjustment_set, evidence=evidence, show_progress=show_progress
            )

        adj_states = []
        for var in adjustment_set:
            if var in evidence_adj_inter:
                adj_states.append([evidence_adj_inter[var]])
            else:
                adj_states.append(list(self.model.get_cpds(var).state_names[var]))

        # the weight of every combination, gathered from p_z's table on the
        # device and read to the host once: zero weights are skipped, as the
        # JAX package skips them
        combos = list(itertools.product(*adj_states))
        p_z_vars = list(p_z.variables)
        flat = np.zeros(len(combos), dtype=np.int64)
        for var, card in zip(p_z_vars, p_z.cardinality):
            k = adjustment_set.index(var)
            flat = flat * int(card) + np.array(
                [p_z.get_state_no(var, combo[k]) for combo in combos], dtype=np.int64)
        weights = p_z.values.reshape(-1)[torch.as_tensor(flat, device=p_z.values.device)]
        keep = np.flatnonzero(weights.cpu().numpy() != 0.0)
        if not keep.size:
            raise ValueError("Every combination of the adjustment set has weight 0.")
        inner = [{**do, **dict(zip(adjustment_set, combos[i]))} for i in keep]
        weights = weights[torch.as_tensor(keep, device=weights.device)]

        if getattr(infer, "query_batch", None) is None:
            # the JAX package's loop: one query per combination
            answers = [infer.query(variables, evidence=ev, show_progress=show_progress)
                       for ev in inner]
            state_names = answers[0].state_names
            values = torch.stack([q.values for q in answers])
        else:
            common = set(variables) & set(inner[0])
            if common:
                raise ValueError(
                    "Can't have the same variables in both `variables` and `evidence`. "
                    f"Found in both: {common}"
                )
            batch_evidence = {v: [ev[v] for ev in inner] for v in inner[0]}
            masked = getattr(infer, "_query_batch_masked", None)
            if masked is None:
                # BP's calibrated tree holds every CPD: an impossible row is
                # NaN already
                values, state_names = infer.query_batch(list(variables), batch_evidence)
            else:
                # VE's batch leaves fully observed CPDs out: a combination
                # whose inner evidence has probability 0 gives NaN, as the
                # per-combination query does
                values, state_names, impossible = masked(list(variables), batch_evidence)
                if impossible is not None:
                    values = torch.where(
                        impossible.reshape((-1,) + (1,) * (values.dim() - 1)),
                        torch.nan, values)
        weights = weights.to(values.dtype).reshape((-1,) + (1,) * (values.dim() - 1))
        result = DiscreteFactor(
            list(variables), list(values.shape[1:]), (weights * values).sum(dim=0),
            state_names={v: state_names[v] for v in variables},
        )
        return result.normalize(inplace=False)
