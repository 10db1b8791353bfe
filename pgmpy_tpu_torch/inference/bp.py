"""BeliefPropagation: junction-tree calibration over a static schedule.

Port of ``pgmpy_tpu/inference/bp.py`` (reference behavior:
Lauritzen-Spiegelhalter belief update, Koller & Friedman Alg. 10.3).  The
host compiles the clique tree into a *static program*:

  stage 0: clique potentials = broadcast-products of the assigned CPT/factor
           tensors,
  stage 1: two-pass message schedule (leaves->root, root->leaves — exact in
           one sweep, no convergence checks),

and calibration runs it through ``ops/jt.py`` (K2) on the factors' device:
the messages grouped into independent waves, the cliques and sepsets in two
flat arenas, stage 0 as one launch of a hand-written CUDA kernel and each
wave as two (per message a sum or max down to the sepset, an
optional normalization, the ratio against the edge's previous message with a
``TINY`` clamp (0/0 = 0), and a broadcast product into the receiving
clique); a CPU tensor takes the kernels' plain torch version.  Disconnected
clique forests (from pruned models) are supported throughout.

Left out from the JAX package: the chunked XLA programs, the background
"monolithic upgrade" compile (PyTorch has no compile step to hide), and the
small-query CPU routing of ``_CompiledBPQuery``.
"""

import itertools

import networkx as nx
import numpy as np
import torch

from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.factors.discrete import DiscreteFactor
from pgmpy_tpu_torch.inference.base import Inference, evidence_code, evidence_codes
from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork
from pgmpy_tpu_torch.models.factor_graph import FactorGraph
from pgmpy_tpu_torch.models.junction_tree import JunctionTree
from pgmpy_tpu_torch.models.markov_network import DiscreteMarkovNetwork, greedy_elimination_order
from pgmpy_tpu_torch.ops import jt
from pgmpy_tpu_torch.ops.jt import _expand
from pgmpy_tpu_torch.ops.einsum import make_axis_map, sum_product_planned


def _safe_div(a, b):
    out = a / b
    return torch.where(torch.isnan(out) | torch.isinf(out), torch.zeros_like(out), out)


def _broadcast_spec(src_vars, dst_vars):
    """(perm, shape_spec) to expand an array over ``src_vars`` into the axis
    layout of ``dst_vars`` (src_vars ⊆ dst_vars)."""
    in_dst_order = [v for v in dst_vars if v in src_vars]
    perm = tuple(src_vars.index(v) for v in in_dst_order)
    shape_spec = tuple(
        in_dst_order.index(v) if v in src_vars else None for v in dst_vars
    )
    return perm, shape_spec


def _merge_cliques(cliques, edges, cards, max_table=1 << 14, budget_ratio=1.5):
    """Greedy clique agglomeration on the junction tree.

    Contracting a tree edge (c1, c2) into one clique over c1 ∪ c2
    preserves the junction-tree property (running intersection holds for
    the union node), removes two messages from the schedule, and costs
    ``|T(c1∪c2)| - |T(c1)| - |T(c2)|`` extra table elements.  On
    MUNIN-class trees ~60% of messages touch only tiny (≤4k-element)
    cliques whose per-message cost is launch overhead, not bytes —
    merging them trades a bounded byte increase for a large op-count
    decrease, which is the right trade on an overhead-dominated program.

    Greedy order: smallest union table first; stop growing a union past
    ``max_table`` elements and stop overall once total table elements
    exceed ``budget_ratio`` × the original.  Returns (cliques, edges)
    with the same tuple-of-sorted-vars node representation.
    """
    import heapq

    scopes = [frozenset(c) for c in cliques]
    sizes = [int(np.prod([cards[v] for v in c])) for c in cliques]
    total0 = sum(sizes)
    budget = int(budget_ratio * total0)
    parent = list(range(len(cliques)))  # union-find

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    adj = {i: set() for i in range(len(cliques))}
    index = {c: i for i, c in enumerate(cliques)}
    for u, v in edges:
        adj[index[u]].add(index[v])
        adj[index[v]].add(index[u])

    def union_size(a, b):
        return int(np.prod([cards[v] for v in scopes[a] | scopes[b]]))

    heap = []
    for u, v in edges:
        a, b = index[u], index[v]
        heap.append((union_size(a, b), a, b))
    heapq.heapify(heap)

    total = total0
    while heap:
        usize, a, b = heapq.heappop(heap)
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        # stale entry (scopes grew since it was pushed): re-queue at the
        # current union size and re-examine later
        cur = union_size(ra, rb)
        if cur != usize:
            if rb in adj[ra]:
                heapq.heappush(heap, (cur, ra, rb))
            continue
        if cur > max_table:
            continue
        grown = total + cur - sizes[ra] - sizes[rb]
        if grown > budget:
            continue
        # contract rb into ra
        parent[rb] = ra
        scopes[ra] = scopes[ra] | scopes[rb]
        sizes[ra] = cur
        total = grown
        adj[ra] = (adj[ra] | adj[rb]) - {ra, rb}
        for n in adj[rb]:
            adj[n].discard(rb)
            if n != ra:
                adj[n].add(ra)
        adj[rb] = set()
        for n in adj[ra]:
            heapq.heappush(heap, (union_size(ra, find(n)), ra, find(n)))

    roots = sorted({find(i) for i in range(len(cliques))})
    new_cliques = [tuple(sorted(scopes[r], key=str)) for r in roots]
    root_pos = {r: i for i, r in enumerate(roots)}
    new_edges = set()
    for u, v in edges:
        ra, rb = find(index[u]), find(index[v])
        if ra != rb:
            key = (min(root_pos[ra], root_pos[rb]), max(root_pos[ra], root_pos[rb]))
            new_edges.add(key)
    return new_cliques, [
        (new_cliques[i], new_cliques[j]) for i, j in sorted(new_edges)
    ]


class JunctionTreeProgram:
    """Host compile artifact: clique structure, factor assignment, message
    schedule — plus the device executor (the wave plan of ``ops/jt.py``)."""

    def __init__(
        self, cliques, edges, cards, factor_scopes, assignment,
        normalize_messages=True,
    ):
        """
        cliques : list of tuples of variable names
        edges : list of (clique, clique) tree/forest edges
        cards : {var: cardinality}
        factor_scopes : list of factor variable lists (program inputs)
        assignment : list of clique indices, aligned with factor_scopes
        normalize_messages : bool — sum-normalize messages in flight.
            Required for arbitrary-scale Markov factors (f32 overflow);
            skipped for CPD-built trees, where every message is already a
            true probability marginal (sum ~= 1) and the three extra ops per
            message only cost kernel launches.
        """
        self.normalize_messages = bool(normalize_messages)
        self.cliques = list(cliques)
        self.index = {c: i for i, c in enumerate(self.cliques)}
        self.cards = dict(cards)
        self.clique_shapes = [
            tuple(int(cards[v]) for v in c) for c in self.cliques
        ]
        self.factor_shapes = [
            tuple(int(cards[v]) for v in scope) for scope in factor_scopes
        ]

        # stage 0 specs: factor -> clique broadcast
        self.potential_specs = [[] for _ in self.cliques]
        for f_idx, (scope, c_idx) in enumerate(zip(factor_scopes, assignment)):
            perm, shape_spec = _broadcast_spec(list(scope), list(self.cliques[c_idx]))
            self.potential_specs[c_idx].append((f_idx, perm, shape_spec))

        # stage 1: two-pass schedule per connected component
        tree = nx.Graph()
        tree.add_nodes_from(self.cliques)
        tree.add_edges_from(edges)
        upward, downward, ordered_edges = [], [], []
        # roots recorded so distributed calibration (parallel/jt_mesh.py)
        # can partition around the SAME roots: with in-flight message
        # normalization the per-clique belief scale depends on the rooted
        # schedule, so root parity is required for bitwise-comparable output
        self.component_roots = []
        for component in nx.connected_components(tree):
            root = next(iter(component))
            self.component_roots.append(root)
            comp_edges = list(nx.bfs_edges(tree, root))
            ordered_edges.extend(comp_edges)
            upward.extend((child, parent) for parent, child in reversed(comp_edges))
            downward.extend((parent, child) for parent, child in comp_edges)

        self.edge_ids = {}
        for parent, child in ordered_edges:
            self.edge_ids[frozenset((parent, child))] = len(self.edge_ids)
        self.n_edges = len(self.edge_ids)

        self.messages = []
        seen_edges = set()
        for src, dst in upward + downward:
            sepset = sorted(set(src) & set(dst), key=str)
            src_vars, dst_vars = list(src), list(dst)
            reduce_axes = tuple(i for i, v in enumerate(src_vars) if v not in sepset)
            kept = [v for v in src_vars if v in sepset]
            perm_to_canon = tuple(kept.index(v) for v in sepset)
            bperm, bspec = _broadcast_spec(sepset, dst_vars)
            edge = self.edge_ids[frozenset((src, dst))]
            # `fresh` is static: the first (upward) message over an edge has
            # no previous sepset belief to divide by
            fresh = edge not in seen_edges
            seen_edges.add(edge)
            self.messages.append(
                (
                    self.index[src],
                    self.index[dst],
                    reduce_axes,
                    perm_to_canon,
                    (bperm, bspec),
                    edge,
                    fresh,
                )
            )
        # sepset shapes aligned with edge ids (for the mu running beliefs)
        self.sepset_shapes = [None] * self.n_edges
        for edge_key, edge_id in self.edge_ids.items():
            c1, c2 = tuple(edge_key)
            sepset = sorted(set(c1) & set(c2), key=str)
            self.sepset_shapes[edge_id] = tuple(int(cards[v]) for v in sepset)
        self._wave_plan = None

    # Clique agglomeration (``_merge_cliques``) kicks in automatically on
    # trees this large: it trades a bounded growth in table bytes for fewer
    # messages, i.e. fewer kernel launches.  The values are the JAX
    # package's, so both packages build the same tree; they have not been
    # re-tuned for the GPU.
    MERGE_MIN_CLIQUES = 501
    MERGE_MAX_TABLE = 1 << 20

    # -- factory ------------------------------------------------------- #
    @classmethod
    def from_factors(cls, factor_scopes, cards, heuristic="weight",
                     normalize_messages=True, merge="auto"):
        """Compile clique structure from factor scopes: moral graph ->
        greedy triangulation -> max cliques -> MST on sepset weights ->
        clique agglomeration (big trees) -> factor-to-clique assignment.

        ``merge``: "auto" agglomerates small adjacent cliques only on
        MUNIN-class trees (>= MERGE_MIN_CLIQUES cliques), where per-op
        overhead on thousands of tiny messages dominates the calibration
        wall time; True/False force it."""
        graph = nx.Graph()
        for scope in factor_scopes:
            graph.add_nodes_from(scope)
            graph.add_edges_from(itertools.combinations(scope, 2))

        adj = {n: set(graph.neighbors(n)) for n in graph.nodes()}
        weights = {n: float(np.log(max(int(cards[n]), 1))) for n in graph.nodes()}
        _, fill = greedy_elimination_order(adj, weights, heuristic=heuristic)
        graph.add_edges_from(fill)

        cliques = [tuple(sorted(c, key=str)) for c in nx.find_cliques(graph)]

        # MST on sepset sizes
        cg = nx.Graph()
        cg.add_nodes_from(cliques)
        for c1, c2 in itertools.combinations(cliques, 2):
            w = len(set(c1) & set(c2))
            if w:
                cg.add_edge(c1, c2, weight=-w)
        edges = [
            (u, v) for u, v, _ in nx.minimum_spanning_edges(cg, data=True)
        ]

        if merge is True or (merge == "auto" and len(cliques) >= cls.MERGE_MIN_CLIQUES):
            cliques, edges = _merge_cliques(
                cliques, edges, cards, max_table=cls.MERGE_MAX_TABLE
            )

        # assign each factor to the first clique containing its scope
        var_to_cliques = {}
        for i, clique in enumerate(cliques):
            for v in clique:
                var_to_cliques.setdefault(v, []).append(i)
        assignment = []
        for scope in factor_scopes:
            scope_set = set(scope)
            for c_idx in var_to_cliques[scope[0]]:
                if scope_set <= set(cliques[c_idx]):
                    assignment.append(c_idx)
                    break
            else:
                raise ValueError(
                    f"Factor scope {scope} not covered by any clique"
                )
        return cls(
            cliques, edges, cards, factor_scopes, assignment,
            normalize_messages=normalize_messages,
        )

    # -- device executor ----------------------------------------------- #
    def wave_plan(self):
        """The program's :class:`pgmpy_tpu_torch.ops.jt.WavePlan`, built on
        first use and kept (its device copies too)."""
        if self._wave_plan is None:
            self._wave_plan = jt.build_plan(self)
        return self._wave_plan

    def executor(self, operation, one_shot=False):
        """A calibrate function ``factor_arrays -> (beliefs, mu)`` bound to
        the program's wave plan: on CUDA tensors the K2 kernels, on CPU
        tensors their plain version.  Each call fills a fresh pair of arenas;
        the beliefs (one tensor per clique, ``clique_shapes[i]``) and mu (one
        per edge, canonical sepset order) are views into them.

        ``one_shot`` is the JAX package's hint that a program calibrates once
        (there, stage 0 and the segments then compile as separate programs);
        nothing is compiled per program here, so it changes nothing."""
        if operation not in ("marginalize", "maximize"):
            raise ValueError(f"Unknown operation: {operation}")
        plan = self.wave_plan()
        normalize = self.normalize_messages

        def calibrate(factor_arrays):
            arena, sepsets = jt.calibrate_waves(plan, factor_arrays, operation, normalize)
            return jt.arena_views(plan, arena, sepsets)

        return calibrate

    def wait_for_upgrade(self, operation="marginalize", timeout=None):
        """No-op kept for callers of the JAX package's API: there is no
        background compile to wait for."""

    def calibrate(self, factor_arrays, operation="marginalize"):
        """Run stage 0 and the two-pass schedule.  Returns (beliefs, mu):
        one tensor per clique and one per edge."""
        return self.executor(operation)(factor_arrays)


class _CompiledBPQuery:
    """One post-calibration query program per (query vars, evidence vars)
    signature.

    Built once per signature: prune the model, calibrate the pruned
    junction tree (raw tensors, never materialized factors), and extract
    the minimal covering subtree's potentials (root belief + child/sepset
    ratios, Koller & Friedman Alg. 10.4).  A query is then one planned
    contraction of those tensors with one-hot evidence operands; a batch of
    evidence rows adds a batch label to the one-hot operands and to the
    output, so N rows are one contraction.
    """

    def __init__(self, bp, variables, ev_vars):
        model, kept_evidence = bp._prune_bayesian_model(
            list(variables), {v: 0 for v in ev_vars}
        )
        self.query_vars = list(variables)
        self.kept = [v for v in ev_vars if v in kept_evidence]

        # merge=False: the covering-subtree contraction below runs over
        # evidence rows — smaller unmerged cliques mean fewer FLOPs/bytes
        # per row
        inner = BeliefPropagation(model, merge=False)
        inner._calibrate_junction_tree(operation="marginalize")
        program = inner._program
        beliefs, mu = inner._raw_beliefs
        inner._raw_beliefs = None  # keep the big factor dicts unmaterialized

        cards = program.cards
        missing = [v for v in self.query_vars if v not in cards]
        if missing:
            raise ValueError(f"Query variables not in reduced model: {missing}")

        # minimal covering subtree per connected component over
        # query + evidence variables (bp._query semantics)
        tree = inner.junction_tree
        target_vars = set(self.query_vars) | set(self.kept)
        covering_all = {
            c for c in tree.nodes() if target_vars & set(c)
        }
        arrays, scopes = [], []
        for component in nx.connected_components(tree):
            covering = [c for c in covering_all if c in component]
            if not covering:
                continue
            subtree_nodes = set(covering)
            for i in range(len(covering) - 1):
                subtree_nodes.update(
                    nx.shortest_path(tree, covering[i], covering[i + 1])
                )
            sub = tree.subgraph(subtree_nodes)
            root = next(iter(subtree_nodes))
            arrays.append(beliefs[program.index[root]])
            scopes.append(list(root))
            parent_nodes = {root}
            traversed = set()
            while parent_nodes:
                parent = parent_nodes.pop()
                for child in set(sub.neighbors(parent)) - traversed:
                    edge_id = program.edge_ids[frozenset((parent, child))]
                    sepset = sorted(set(parent) & set(child), key=str)
                    bperm, bspec = _broadcast_spec(sepset, list(child))
                    ratio = _safe_div(
                        beliefs[program.index[child]],
                        _expand(mu[edge_id], bperm, bspec),
                    )
                    arrays.append(ratio)
                    scopes.append(list(child))
                    parent_nodes.add(child)
                traversed.add(parent)

        state_names = inner._state_names
        self.cards = [int(cards[v]) for v in self.query_vars]
        self.state_names = {
            v: list(state_names[v]) for v in self.query_vars if v in state_names
        }
        self._code_maps = [
            {s: i for i, s in enumerate(state_names[v])} for v in self.kept
        ]
        self._kept_cards = [int(cards[v]) for v in self.kept]

        var_to_int, operand_axes = make_axis_map(
            scopes + [[v] for v in self.kept]
        )
        self._arrays = arrays
        self._factor_axes = operand_axes[: len(arrays)]
        self._evidence_axes = operand_axes[len(arrays):]
        self._out_axes = tuple(var_to_int[v] for v in self.query_vars)
        # a label no variable uses, for the batch axis of query_batch
        self._batch_axis = len(var_to_int)

    def _one_hot(self, codes, k):
        return torch.nn.functional.one_hot(codes, self._kept_cards[k]).to(config.DTYPE)

    def run(self, codes):
        """Normalized P(query | evidence) for one row of evidence codes
        (a long tensor of shape (len(kept),) on the device)."""
        evidence = [self._one_hot(codes[k], k) for k in range(len(self.kept))]
        values = sum_product_planned(
            list(self._factor_axes) + list(self._evidence_axes),
            self._out_axes,
            list(self._arrays) + evidence,
        )
        return values / torch.sum(values)

    def run_batch(self, codes):
        """Normalized P(query | evidence_row) for every row of ``codes``
        (shape (n, len(kept))): one contraction with a batch label on the
        one-hot evidence operands and on the output."""
        n = codes.shape[0]
        if not self.kept:
            # all evidence was pruned away: every row has the same answer
            return self.run(codes[0]).expand(n, *self.cards)
        b = self._batch_axis
        evidence = [self._one_hot(codes[:, k], k) for k in range(len(self.kept))]
        values = sum_product_planned(
            list(self._factor_axes) + [(b,) + tuple(ax) for ax in self._evidence_axes],
            (b,) + self._out_axes,
            list(self._arrays) + evidence,
        )
        flat = values.reshape(n, -1)
        return (flat / torch.sum(flat, dim=1, keepdim=True)).reshape(values.shape)

    def batch(self, evidence):
        """P(query | evidence_row) for every row of ``evidence`` ({var:
        sequence of states}); rows along the leading axis."""
        n = len(next(iter(evidence.values())))
        codes = np.empty((n, len(self.kept)), dtype=np.int64)
        for k, var in enumerate(self.kept):
            # validated on the host: an out-of-range code would one-hot to
            # all zeros and produce NaN rows
            codes[:, k] = evidence_codes(
                var, evidence[var], self._code_maps[k], self._kept_cards[k]
            )
        return self.run_batch(torch.from_numpy(codes).to(config.DEVICE))

    def encode(self, evidence):
        codes = np.empty(len(self.kept), dtype=np.int64)
        for k, var in enumerate(self.kept):
            codes[k] = evidence_code(
                var, evidence[var], self._code_maps[k], self._kept_cards[k]
            )
        return codes

    def __call__(self, evidence):
        codes = torch.from_numpy(self.encode(evidence)).to(config.DEVICE)
        return DiscreteFactor(
            list(self.query_vars), self.cards, self.run(codes), state_names=self.state_names
        )


class BeliefPropagation(Inference):
    """Exact inference by junction-tree calibration over a static two-pass
    message schedule (see module docstring).

    Examples
    --------
    >>> import numpy as np
    >>> from pgmpy_tpu_torch.factors import TabularCPD
    >>> from pgmpy_tpu_torch.inference import BeliefPropagation
    >>> from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
    >>> model = DiscreteBayesianNetwork([("rain", "wet"), ("rain", "dark")])
    >>> model.add_cpds(
    ...     TabularCPD("rain", 2, [[0.8], [0.2]]),
    ...     TabularCPD("wet", 2, [[0.9, 0.2], [0.1, 0.8]],
    ...                evidence=["rain"], evidence_card=[2]),
    ...     TabularCPD("dark", 2, [[0.7, 0.4], [0.3, 0.6]],
    ...                evidence=["rain"], evidence_card=[2]))
    >>> bp = BeliefPropagation(model)
    >>> bp.calibrate()
    >>> sorted(len(c) for c in bp.get_cliques())
    [2, 2]
    >>> phi = bp.query(["dark"], evidence={"wet": 1})
    >>> phi.values.double().cpu().numpy().round(3).tolist()
    [0.5, 0.5]
    """

    def __init__(self, model, merge="auto"):
        """``merge``: clique-agglomeration policy forwarded to
        ``JunctionTreeProgram.from_factors``.  "auto" (default) merges on
        MUNIN-class trees — the right call for repeated calibrations; the
        per-signature query builds pass ``False`` because their one-shot
        covering-subtree contraction is cheaper over the smaller unmerged
        cliques."""
        super().__init__(model)
        self.clique_beliefs = {}
        self.sepset_beliefs = {}
        self._calibrated_operation = None
        self._merge = merge

        if isinstance(model, JunctionTree):
            self.junction_tree = model.copy()
            factors = self.junction_tree.factors
            self._input_factors = factors
            cards = self.junction_tree.get_cardinality()
            cliques = list(self.junction_tree.nodes())
            clique_of = {frozenset(c): i for i, c in enumerate(cliques)}
            assignment = [clique_of[frozenset(f.scope())] for f in factors]
            self._program = JunctionTreeProgram(
                cliques,
                list(self.junction_tree.edges()),
                cards,
                [list(f.variables) for f in factors],
                assignment,
            )
        else:
            if isinstance(model, DiscreteBayesianNetwork):
                factors = [cpd.to_factor() for cpd in model.get_cpds()]
            elif isinstance(model, (DiscreteMarkovNetwork, FactorGraph)):
                factors = list(model.get_factors())
            else:
                raise TypeError(f"Unsupported model type: {type(model)}")
            self._input_factors = factors
            cards = {}
            for f in factors:
                for v, c in zip(f.variables, f.cardinality):
                    cards[v] = int(c)
            self._program = JunctionTreeProgram.from_factors(
                [list(f.variables) for f in factors],
                cards,
                # CPD-built trees carry true probability marginals as
                # messages — in-flight normalization is numerically inert
                # and only adds kernel launches
                normalize_messages=not isinstance(model, DiscreteBayesianNetwork),
                merge=merge,
            )
            # materialize the clique-tree graph (without eager potentials)
            self.junction_tree = JunctionTree()
            self.junction_tree.add_nodes_from(self._program.cliques)
            for edge_key in self._program.edge_ids:
                u, v = tuple(edge_key)
                self.junction_tree.add_edge(u, v)

        self._state_names = {}
        for f in self._input_factors:
            self._state_names.update(f.state_names)

    def _get_compiled_query(self, variables, ev_vars):
        """Per-signature compiled query cache on the model, token-checked
        and LRU-bounded (mirrors ``ve._get_compiled_query``)."""
        from pgmpy_tpu_torch.utils.cache import LRUDict

        token = self.model._cache_token()
        cache = self.model.__dict__.get("_bp_program_cache")
        if cache is None or cache[0] != token:
            cache = (token, LRUDict(max_size=128))
            self.model.__dict__["_bp_program_cache"] = cache
        key = (tuple(variables), tuple(ev_vars))
        prog = cache[1].get(key)
        if prog is None:
            prog = _CompiledBPQuery(self, variables, ev_vars)
            cache[1][key] = prog
        return prog

    def get_cliques(self):
        return self.junction_tree.nodes()

    def get_clique_beliefs(self):
        return self.clique_beliefs

    def get_sepset_beliefs(self):
        return self.sepset_beliefs

    # Calibration yields raw belief tensors; wrapping MUNIN's ~1000 of them
    # into DiscreteFactor objects costs host time, so materialization is
    # lazy: calibrate stores the raw tensors and the factor dicts build on
    # first access.
    @property
    def clique_beliefs(self):
        if self._raw_beliefs is not None:
            self._materialize_beliefs()
        return self._clique_beliefs

    @clique_beliefs.setter
    def clique_beliefs(self, value):
        self._clique_beliefs = value
        self._raw_beliefs = None

    @property
    def sepset_beliefs(self):
        if self._raw_beliefs is not None:
            self._materialize_beliefs()
        return self._sepset_beliefs

    @sepset_beliefs.setter
    def sepset_beliefs(self, value):
        self._sepset_beliefs = value

    def _materialize_beliefs(self):
        program = self._program
        beliefs, mu = self._raw_beliefs
        self._raw_beliefs = None
        cards = program.cards
        states = self._state_names
        self._clique_beliefs = {}
        for clique, values in zip(program.cliques, beliefs):
            self._clique_beliefs[clique] = DiscreteFactor(
                list(clique),
                [cards[v] for v in clique],
                values,
                state_names={v: states[v] for v in clique if v in states},
            )
        self._sepset_beliefs = {}
        for edge_key, edge_id in program.edge_ids.items():
            c1, c2 = tuple(edge_key)
            sepset = sorted(set(c1) & set(c2), key=str)
            self._sepset_beliefs[edge_key] = (
                DiscreteFactor(
                    sepset,
                    [cards[v] for v in sepset],
                    mu[edge_id],
                    state_names={v: states[v] for v in sepset if v in states},
                )
                if mu[edge_id] is not None
                else None
            )

    def _calibrate_junction_tree(self, operation):
        arrays = [f.values for f in self._input_factors]
        beliefs, mu = self._program.calibrate(arrays, operation)
        self._raw_beliefs = (beliefs, mu)
        self._calibrated_operation = operation

    def calibrate(self):
        """Exact two-pass Lauritzen-Spiegelhalter calibration."""
        self._calibrate_junction_tree(operation="marginalize")

    def max_calibrate(self):
        self._calibrate_junction_tree(operation="maximize")

    def _query(self, variables, operation, evidence=None, joint=True, show_progress=False):
        """Query of a non-Bayesian-network model: VariableElimination over
        the potentials of the minimal subtree that covers the query and
        evidence variables."""
        from pgmpy_tpu_torch.inference.ve import VariableElimination
        from pgmpy_tpu_torch.models.cluster_graph import ClusterGraph

        if self._calibrated_operation != operation:
            self._calibrate_junction_tree(operation=operation)

        if not isinstance(variables, (list, tuple, set)):
            query_variables = [variables]
        else:
            query_variables = list(variables)
        query_variables.extend(evidence.keys() if evidence else [])

        # minimal covering subtree per connected component (pruned models can
        # yield clique forests; independent components just multiply)
        nodes_with_query_variables = set()
        for var in query_variables:
            nodes_with_query_variables.update(
                c for c in self.junction_tree.nodes() if var in c
            )
        clique_potential_list = []
        all_subtree_nodes = set()
        all_subtree_edges = []
        for component in nx.connected_components(self.junction_tree):
            covering = [c for c in nodes_with_query_variables if c in component]
            if not covering:
                continue
            subtree_nodes = set(covering)
            for i in range(len(covering) - 1):
                subtree_nodes.update(
                    nx.shortest_path(self.junction_tree, covering[i], covering[i + 1])
                )
            sub = self.junction_tree.subgraph(subtree_nodes)
            all_subtree_nodes |= subtree_nodes
            all_subtree_edges.extend(sub.edges())
            # clique potentials: root belief, then child beliefs divided by
            # their sepset beliefs (Koller & Friedman Alg. 10.4)
            root_node = next(iter(subtree_nodes))
            clique_potential_list.append(self.clique_beliefs[root_node])
            parent_nodes = {root_node}
            traversed = set()
            while parent_nodes:
                parent_node = parent_nodes.pop()
                for child_node in set(sub.neighbors(parent_node)) - traversed:
                    sepset_belief = self.sepset_beliefs[
                        frozenset((parent_node, child_node))
                    ]
                    clique_potential_list.append(
                        self.clique_beliefs[child_node] / sepset_belief
                    )
                    parent_nodes.add(child_node)
                traversed.add(parent_node)

        # a ClusterGraph tolerates clique forests (JunctionTree insists on
        # connectedness); VE only needs the factor list
        subtree = ClusterGraph()
        subtree.add_nodes_from(all_subtree_nodes)
        for u, v in all_subtree_edges:
            subtree.add_edge(u, v)
        subtree.add_factors(*clique_potential_list)

        variable_elimination = VariableElimination(subtree)
        if operation == "marginalize":
            return variable_elimination.query(
                variables=variables, evidence=evidence, joint=joint,
                show_progress=show_progress,
            )
        return variable_elimination.map_query(
            variables=variables, evidence=evidence, show_progress=show_progress
        )

    def query(
        self,
        variables,
        evidence=None,
        virtual_evidence=None,
        joint=True,
        show_progress=False,
    ):
        """Posterior P(variables | evidence) from the calibrated tree."""
        evidence = evidence if evidence is not None else dict()
        common_vars = set(evidence).intersection(set(variables))
        if common_vars:
            raise ValueError(f"Can't have the same variables in both `variables` and `evidence`. Found in both: {common_vars}")

        if isinstance(self.model, DiscreteBayesianNetwork) and virtual_evidence is not None:
            original = self.model
            try:
                self._virtual_evidence(virtual_evidence)
                virt_evidence = {"__" + str(cpd.variables[0]): 0 for cpd in virtual_evidence}
                return self.query(
                    variables=variables,
                    evidence={**evidence, **virt_evidence},
                    virtual_evidence=None,
                    joint=joint,
                    show_progress=show_progress,
                )
            finally:
                self.__init__(original)

        if isinstance(self.model, DiscreteBayesianNetwork):
            # per-signature program (prune + calibrate + subtree extraction
            # happen ONCE per (query vars, evidence vars) signature; repeat
            # queries are one contraction with evidence entering as device
            # codes)
            prog = self._get_compiled_query(
                tuple(variables), tuple(sorted(evidence.keys(), key=str))
            )
            result = prog(evidence)
            if joint:
                return result
            return {
                var: result.marginalize(
                    [v for v in variables if v != var], inplace=False
                )
                for var in variables
            }
        result = self._query(
            variables=variables, operation="marginalize", evidence=evidence,
            joint=joint, show_progress=show_progress,
        )
        if joint:
            return result.normalize(inplace=False)
        return result

    def query_batch(self, variables, evidence):
        """Posterior P(variables | evidence_row) for EVERY row of a batch
        of evidence assignments through the calibrated tree: the
        per-signature covering-subtree contraction (Koller & Friedman
        Alg. 10.4) carries a batch label on the one-hot evidence operands,
        so N rows are one contraction.

        Parameters
        ----------
        variables : list of query variables
        evidence : dict {var: sequence of state names/indices}, all the
            same length n

        Returns
        -------
        (values, state_names): values has shape (n, card_q1, ...) with
        each row normalized; state_names covers the query variables.
        """
        if not evidence:
            raise ValueError("query_batch requires evidence; use query() otherwise")
        if not isinstance(self.model, DiscreteBayesianNetwork):
            raise NotImplementedError(
                "query_batch is implemented for DiscreteBayesianNetwork models"
            )
        prog = self._get_compiled_query(
            tuple(variables), tuple(sorted(evidence.keys(), key=str))
        )
        values = prog.batch(evidence)
        return values, dict(prog.state_names)

    def map_query(
        self, variables=None, evidence=None, virtual_evidence=None, show_progress=False
    ):
        """MAP assignment of ``variables`` given evidence (argmax of the
        sum-posterior joint, matching reference semantics).
        ``variables=None`` means all non-evidence variables."""
        if not variables:
            variables = sorted(
                set(self.variables) - set(evidence or {}), key=str
            )
        variables = list(variables)
        common_vars = set(evidence if evidence is not None else []) & set(variables)
        if common_vars:
            raise ValueError(f"Can't have the same variables in both `variables` and `evidence`. Found in both: {common_vars}")

        if isinstance(self.model, DiscreteBayesianNetwork) and virtual_evidence is not None:
            original = self.model
            try:
                self._virtual_evidence(virtual_evidence)
                virt_evidence = {"__" + str(cpd.variables[0]): 0 for cpd in virtual_evidence}
                return self.map_query(
                    variables=variables,
                    evidence={**(evidence or {}), **virt_evidence},
                    virtual_evidence=None,
                    show_progress=show_progress,
                )
            finally:
                self.__init__(original)

        final_distribution = self.query(
            variables=variables, evidence=evidence, joint=True,
            show_progress=show_progress,
        )
        argmax = int(torch.argmax(final_distribution.values))
        assignment = final_distribution.assignment([argmax])[0]
        return {var: value for var, value in assignment}
