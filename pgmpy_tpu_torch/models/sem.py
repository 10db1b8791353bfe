"""Structural equation models: SEMGraph / SEMAlg / SEM facade.

Port of ``pgmpy_tpu/models/sem.py`` (reference:
``pgmpy/models/SEM.py:13-1212``).  The graph layer is host-side; fitting
happens on ``config.DEVICE`` through the RAM matrix form
(``estimators/sem_estimator.py``): implied covariance
``F (I-B)^{-1} S (I-B)^{-T} F^T`` with F selecting observed variables.
``implied_covariance`` takes ``torch.linalg.inv_ex``: a singular ``I - B``
gives a NaN matrix, as ``jnp.linalg.inv`` does, and no host read.
"""

import networkx as nx
import numpy as np
import torch

from pgmpy_tpu_torch.config import as_tensor, config


class SEMGraph:
    """Causal graph + error-correlation graph + latent set."""

    def __init__(self, ebunch=[], latents=[], err_corr=[], err_var={}):
        self.graph = nx.DiGraph()
        self.err_graph = nx.Graph()
        self.latents = set(latents)

        for edge in ebunch:
            if len(edge) == 2:
                self.graph.add_edge(edge[0], edge[1], weight=np.nan)
            elif len(edge) == 3:
                self.graph.add_edge(edge[0], edge[1], weight=edge[2])
            else:
                raise ValueError(f"Edges must be tuples of length 2 or 3. Got: {edge}")
        self.err_graph.add_nodes_from(self.graph.nodes())
        for edge in err_corr:
            if len(edge) == 2:
                self.err_graph.add_edge(edge[0], edge[1], weight=np.nan)
            elif len(edge) == 3:
                self.err_graph.add_edge(edge[0], edge[1], weight=edge[2])
            else:
                raise ValueError(f"err_corr must be tuples of length 2 or 3. Got: {edge}")
        for node in self.graph.nodes():
            self.err_graph.nodes[node]["weight"] = err_var.get(node, np.nan)

        self.observed = set(self.graph.nodes()) - self.latents

    @property
    def nodes(self):
        return self.graph.nodes

    @property
    def edges(self):
        return self.graph.edges

    def get_params(self):
        """(fixed edge weights, free edge masks) for the RAM form."""
        return {
            "edges": dict(nx.get_edge_attributes(self.graph, "weight")),
            "err_corr": dict(nx.get_edge_attributes(self.err_graph, "weight")),
            "err_var": dict(nx.get_node_attributes(self.err_graph, "weight")),
        }

    def to_lisrel(self):
        """RAM representation: (variables, B mask/fixed, S mask/fixed,
        observed list)."""
        variables = sorted(self.graph.nodes(), key=str)
        idx = {v: i for i, v in enumerate(variables)}
        n = len(variables)
        B_mask = np.zeros((n, n), dtype=bool)
        B_fixed = np.full((n, n), np.nan)
        for u, v, data in self.graph.edges(data=True):
            B_mask[idx[v], idx[u]] = True  # row = target, col = source
            B_fixed[idx[v], idx[u]] = data.get("weight", np.nan)
        S_mask = np.zeros((n, n), dtype=bool)
        S_fixed = np.full((n, n), np.nan)
        for v in variables:
            S_mask[idx[v], idx[v]] = True
            S_fixed[idx[v], idx[v]] = self.err_graph.nodes[v].get("weight", np.nan)
        for u, v, data in self.err_graph.edges(data=True):
            S_mask[idx[u], idx[v]] = S_mask[idx[v], idx[u]] = True
            w = data.get("weight", np.nan)
            S_fixed[idx[u], idx[v]] = S_fixed[idx[v], idx[u]] = w
        observed = sorted(self.observed, key=str)
        return SEMAlg(
            variables=variables,
            B_mask=B_mask,
            B_fixed=B_fixed,
            S_mask=S_mask,
            S_fixed=S_fixed,
            observed=observed,
        )

    @property
    def full_graph_struct(self):
        """Directed graph joining the causal graph with the error structure:
        an error node ``.v`` per variable and a common-cause node ``..uv``
        per correlated error pair (ref ``models/SEM.py:159-196``)."""
        full_graph = self.graph.copy()
        full_graph.add_edges_from(
            [("." + str(node), node) for node in self.err_graph.nodes]
        )
        for u, v in self.err_graph.edges:
            cov_node = ".." + "".join(sorted([str(u), str(v)]))
            full_graph.add_edges_from(
                [(cov_node, "." + str(u)), (cov_node, "." + str(v))]
            )
        return full_graph

    def active_trail_nodes(self, variables, observed=[], avoid_nodes=[], struct="full"):
        """Observed variables d-connected to ``variables`` in the chosen
        graph structure, ignoring paths through ``avoid_nodes``.  BFS on
        (node, direction) states over the full graph (error/common-cause
        nodes included) exactly as the reference
        (``models/SEM.py:233-337``); error nodes (``.``-prefixed) and
        latents are excluded from the result."""
        if struct == "full":
            graph_struct = self.full_graph_struct
        elif struct == "non_error":
            graph_struct = self.graph
        elif isinstance(struct, nx.DiGraph):
            graph_struct = struct
        else:
            raise ValueError(
                f"Expected struct to be str or nx.DiGraph. Got {type(struct)}"
            )
        observed = list(observed) if observed else []
        avoid_nodes = set(avoid_nodes) if avoid_nodes else set()

        ancestors_list = set()
        for node in observed:
            ancestors_list |= nx.algorithms.dag.ancestors(graph_struct, node)

        active_trails = {}
        for start in (
            variables if isinstance(variables, (list, tuple)) else [variables]
        ):
            visit_list = {(start, "up")}
            traversed = set()
            active_nodes = set()
            while visit_list:
                node, direction = visit_list.pop()
                if node in avoid_nodes:
                    continue
                if (node, direction) in traversed:
                    continue
                if (
                    node not in observed
                    and not str(node).startswith(".")
                    and node not in self.latents
                ):
                    active_nodes.add(node)
                traversed.add((node, direction))
                if direction == "up" and node not in observed:
                    for parent in graph_struct.predecessors(node):
                        visit_list.add((parent, "up"))
                    for child in graph_struct.successors(node):
                        visit_list.add((child, "down"))
                elif direction == "down":
                    if node not in observed:
                        for child in graph_struct.successors(node):
                            visit_list.add((child, "down"))
                    if node in ancestors_list:
                        for parent in graph_struct.predecessors(node):
                            visit_list.add((parent, "up"))
            active_trails[start] = active_nodes
        return active_trails

    def get_scaling_indicators(self):
        """First observed child of each latent (for scale fixing)."""
        indicators = {}
        for latent in self.latents:
            for child in sorted(self.graph.successors(latent), key=str):
                if child in self.observed:
                    indicators[latent] = child
                    break
        return indicators

    def to_standard_lisrel(self):
        """Standard (restricted) LISREL form: eta = B eta + Gamma xi + zeta,
        y = wedge_y eta + eps, x = wedge_x xi + delta.

        Observed nodes with outgoing structural edges violate the standard
        form, so each gets a proxy latent ``_l_<name>`` with a fixed unit
        loading (ref ``models/SEM.py:581-685``).  Returns
        ``(var_names, edges_masks, fixed_masks)`` where the masks dicts hold
        the B/gamma/wedge_y/wedge_x/phi/psi/theta_e/theta_del matrices.
        """
        graph = self.graph.copy()
        err_graph = self.err_graph.copy()
        latents = set(self.latents)

        def _promote(nodes):
            """Give each observed node in ``nodes`` a proxy latent parent
            carrying its structural role."""
            mapping = {v: "_l_" + str(v) for v in nodes}
            nonlocal graph
            graph = nx.relabel_nodes(graph, mapping, copy=True)
            for old, proxy in mapping.items():
                graph.add_edge(proxy, old, weight=1.0)
            err_graph.add_nodes_from(mapping.values())
            latents.update(mapping.values())
            return set(mapping.values())

        # any observed node that is a structural source must become latent
        sources = {u for u, v in graph.edges() if u not in latents}
        if sources:
            _promote(sources)

        latent_sub = graph.subgraph(latents)
        in_deg = graph.in_degree()
        eta = [v for v in latent_sub.nodes() if in_deg[v]]
        xi = [v for v in latent_sub.nodes() if not in_deg[v]]

        x_vars, y_vars = set(), set()
        for exo in xi:
            x_vars.update(c for c in graph.neighbors(exo) if c not in latents)
        for endo in eta:
            y_vars.update(c for c in graph.neighbors(endo) if c not in latents)

        # indicators loaded by both an eta and a xi would be dropped from
        # wedge_x/wedge_y; promote them so they land in y only
        shared = x_vars & y_vars
        if shared:
            proxies = _promote(shared)
            eta.extend(sorted(proxies, key=str))
            x_vars -= shared

        var_names = {
            "eta": eta,
            "xi": xi,
            "y": sorted(y_vars, key=str),
            "x": sorted(x_vars, key=str),
        }

        def masks(weight):
            ordering = (var_names["y"] + var_names["x"]
                        + var_names["eta"] + var_names["xi"])
            p, q, m = (len(var_names["y"]), len(var_names["x"]),
                       len(var_names["eta"]))
            # transpose: rows = targets (incoming edges)
            adj = nx.to_numpy_array(graph, nodelist=ordering,
                                    weight=weight).T
            err = nx.to_numpy_array(err_graph, nodelist=ordering,
                                    weight=weight)
            if weight is None:
                np.fill_diagonal(err, 1.0)
            s = p + q
            return {
                "B": adj[s:s + m, s:s + m],
                "gamma": adj[s:s + m, s + m:],
                "wedge_y": adj[:p, s:s + m],
                "wedge_x": adj[p:s, s + m:],
                "phi": err[s + m:, s + m:],
                "psi": err[s:s + m, s:s + m],
                "theta_e": err[:p, :p],
                "theta_del": err[p:s, p:s],
            }

        return var_names, masks(None), masks("weight")

    def moralize(self, graph="graph"):
        g = self.graph if graph == "graph" else self.err_graph
        moral = nx.moral_graph(g) if g.is_directed() else g.copy()
        return moral

    def copy(self):
        copy = SEMGraph(
            ebunch=[
                (u, v, d.get("weight", np.nan))
                for u, v, d in self.graph.edges(data=True)
            ],
            latents=set(self.latents),
            err_corr=[
                (u, v, d.get("weight", np.nan))
                for u, v, d in self.err_graph.edges(data=True)
            ],
            err_var=dict(nx.get_node_attributes(self.err_graph, "weight")),
        )
        return copy


class SEMAlg:
    """RAM matrix form: x = B x + e, cov(e) = S, observed = F x."""

    def __init__(self, variables, B_mask, B_fixed, S_mask, S_fixed, observed):
        self.variables = variables
        self.B_mask = B_mask
        self.B_fixed = B_fixed
        self.S_mask = S_mask
        self.S_fixed = S_fixed
        self.observed = observed
        # Parameter values assigned via set_params live in dedicated
        # attributes so the NaN=free masks in B_fixed/S_fixed (used by
        # SEMEstimator) are never clobbered (reference keeps these apart as
        # B_fixed_mask/zeta_fixed_mask, ``models/SEM.py:752-820``).
        self.B_set = None
        self.S_set = None
        idx = {v: i for i, v in enumerate(variables)}
        self.F = np.zeros((len(observed), len(variables)))
        for i, v in enumerate(observed):
            self.F[i, idx[v]] = 1.0

    def implied_covariance(self, B, S):
        """F (I-B)^-1 S (I-B)^-T F^T for parameter matrices B, S.

        Tensors keep their dtype and device; anything else goes to
        ``config.DTYPE`` on ``config.DEVICE``.  F selects rows and columns, so
        it is applied as an index.  A singular ``I - B`` gives NaN (no
        exception, no host read)."""
        B = B if isinstance(B, torch.Tensor) else as_tensor(B)
        S = torch.as_tensor(S, dtype=B.dtype, device=B.device)
        n = len(self.variables)
        eye = torch.eye(n, dtype=B.dtype, device=B.device)
        inv, info = torch.linalg.inv_ex(eye - B)
        inv = inv * torch.where(info == 0, 1.0, torch.nan).to(B.dtype)
        full = inv @ S @ inv.T
        rows = self._observed_rows(B.device)
        return full.index_select(0, rows).index_select(1, rows)

    def _observed_rows(self, device):
        """The observed variables' indices (F's nonzero columns) as a long
        tensor on ``device``, built once per device."""
        cache = self.__dict__.setdefault("_rows_by_device", {})
        if device not in cache:
            cache[device] = torch.as_tensor(np.argmax(self.F, axis=1), dtype=torch.long,
                                            device=device)
        return cache[device]

    def set_params(self, B, zeta):
        """Set the model's parameter values (reference ``SEM.py:805``).

        Values go to ``B_set``/``S_set``; the ``B_fixed``/``S_fixed``
        NaN=free masks consumed by SEMEstimator stay untouched.
        """
        self.B_set = np.asarray(B)
        self.S_set = np.asarray(zeta)

    def generate_samples(self, n_samples=100, seed=None):
        """Draw samples of the observed variables from the implied Gaussian.

        Requires ``set_params`` (or fixed parameters at construction); the
        implied covariance is F (I-B)^-1 S (I-B)^-T F^T.  Parity: reference
        ``models/SEM.py:820-858``.
        """
        import pandas as pd

        if self.B_set is not None and self.S_set is not None:
            B_vals = np.asarray(self.B_set, dtype=float)
            S_vals = np.asarray(self.S_set, dtype=float)
        else:
            B_vals = np.asarray(self.B_fixed, dtype=float)
            S_vals = np.asarray(self.S_fixed, dtype=float)
            # A free (masked, still-NaN) parameter means the model was never
            # given values: raise the reference's error instead of silently
            # sampling a zero-coefficient model (ref SEM.py:825-827).
            if np.any(np.asarray(self.B_mask, bool) & np.isnan(B_vals)) or np.any(
                np.asarray(self.S_mask, bool) & np.isnan(S_vals)
            ):
                raise ValueError("Parameters for the model has not been specified.")
        # float64 on config.DEVICE; the JAX package's float32 Sigma differs in
        # rounding only
        B = torch.as_tensor(np.nan_to_num(B_vals), dtype=torch.float64, device=config.DEVICE)
        S = torch.as_tensor(np.nan_to_num(S_vals), dtype=torch.float64, device=config.DEVICE)
        implied_cov = self.implied_covariance(B, S).cpu().numpy()
        if not np.all(np.linalg.eigvalsh((implied_cov + implied_cov.T) / 2) > 0):
            raise ValueError(
                "The implied covariance matrix is not positive definite."
                + "Please check model parameters."
            )
        rng = np.random.default_rng(seed)
        samples = rng.multivariate_normal(
            mean=np.zeros(implied_cov.shape[0]), cov=implied_cov, size=n_samples
        )
        return pd.DataFrame(samples, columns=list(self.observed))

    def to_SEMGraph(self):
        ebunch = []
        n = len(self.variables)
        B_vals = self.B_set if self.B_set is not None else self.B_fixed
        for i in range(n):
            for j in range(n):
                if self.B_mask[i, j]:
                    ebunch.append(
                        (self.variables[j], self.variables[i], B_vals[i, j])
                    )
        latents = set(self.variables) - set(self.observed)
        return SEMGraph(ebunch=ebunch, latents=latents)


class SEM(SEMGraph):
    """User facade with alternate constructors."""

    def __init__(self, syntax, **kwargs):
        if syntax == "graph":
            super().__init__(
                ebunch=kwargs.get("ebunch", []),
                latents=kwargs.get("latents", []),
                err_corr=kwargs.get("err_corr", []),
                err_var=kwargs.get("err_var", {}),
            )
        elif syntax == "lavaan":
            from pgmpy_tpu_torch.utils.parser import parse_lavaan

            edges, latents = parse_lavaan(kwargs.get("string") or kwargs.get("lavaan_str"))
            super().__init__(ebunch=edges, latents=latents)
        elif syntax == "ram" or syntax == "lisrel":
            alg = SEMAlg(
                variables=kwargs["variables"],
                B_mask=np.asarray(kwargs["B"]) != 0,
                B_fixed=np.where(np.asarray(kwargs["B"]) != 0, np.nan, np.nan),
                S_mask=np.asarray(kwargs["S"]) != 0,
                S_fixed=np.where(np.asarray(kwargs["S"]) != 0, np.nan, np.nan),
                observed=kwargs["observed"],
            )
            graph = alg.to_SEMGraph()
            super().__init__(
                ebunch=[(u, v) for u, v, _ in graph.graph.edges(data="weight")],
                latents=graph.latents,
            )
        else:
            raise ValueError(
                f"syntax must be 'graph', 'lavaan', 'ram' or 'lisrel'. Got: {syntax}"
            )

    @classmethod
    def from_graph(cls, ebunch, latents=[], err_corr=[], err_var={}):
        return cls(
            "graph", ebunch=ebunch, latents=latents, err_corr=err_corr, err_var=err_var
        )

    @classmethod
    def from_lavaan(cls, string=None, filename=None):
        if filename:
            with open(filename) as f:
                string = f.read()
        return cls("lavaan", string=string)

    @classmethod
    def from_RAM(cls, variables, B, S, observed=None, **kwargs):
        return cls(
            "ram",
            variables=variables,
            B=B,
            S=S,
            observed=observed or variables,
        )

    @classmethod
    def from_lisrel(cls, **kwargs):
        return cls.from_RAM(**kwargs)

    def fit(self, data, method="ml", **kwargs):
        from pgmpy_tpu_torch.estimators.sem_estimator import SEMEstimator

        return SEMEstimator(self).fit(data, method=method, **kwargs)
