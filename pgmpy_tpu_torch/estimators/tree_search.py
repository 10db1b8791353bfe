"""TreeSearch: Chow-Liu and TAN tree structure learning.

Port of ``pgmpy_tpu/estimators/tree_search.py``.  All ``d (d - 1) / 2`` pair
tables (for TAN: pair x class tables) are counted in ONE ``table_counts``
launch; the specs are built as index arrays (no Python loop over pairs) and
the flat int32 count tensor comes back in one copy.

Divergence from the JAX package, on purpose: the mutual information of every
pair is computed from that flat tensor at once, with numpy in float64 on the
host (segment sums by ``np.bincount``), instead of one ``_mutual_info`` call
per pair table.  The counts are exact integers, so both routes compute the
same terms and differ only in the order of float64 sums (1e-15 relative;
the tests hold them to 1e-12).  The spanning tree is networkx's, as in the
JAX package, so ties between equal weights break the same way.
"""

import itertools
import time

import networkx as nx
import numpy as np

from pgmpy_tpu_torch.base.dag import DAG
from pgmpy_tpu_torch.config import to_numpy
from pgmpy_tpu_torch.estimators.base import StructureEstimator
from pgmpy_tpu_torch.ops.bincount import table_specs


def _mutual_info(counts):
    """MI in nats from a 2-D contingency table."""
    n = counts.sum()
    if n == 0:
        return 0.0
    pxy = counts / n
    px = pxy.sum(axis=1, keepdims=True)
    py = pxy.sum(axis=0, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(pxy > 0, pxy * (np.log(pxy) - np.log(px) - np.log(py)), 0.0)
    return float(terms.sum())


def _segments(lengths):
    """For segments of ``lengths`` laid end to end: each element's segment
    number and its position inside the segment."""
    segment = np.repeat(np.arange(len(lengths)), lengths)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return segment, np.arange(int(lengths.sum())) - starts[segment]


def pairwise_mutual_info(counts, cx, cy, cz=1):
    """Mutual information of many contingency tables laid end to end.

    ``counts``: the concatenated tables as one float64 vector, table ``p``
    of shape ``(cx[p], cy[p], cz)`` in row-major order.  Returns per table
    ``sum_k n_k / n * MI(table[:, :, k])``: the mutual information of x and y
    for ``cz == 1``, else the conditional mutual information given the last
    axis.  A slice without rows contributes 0.
    """
    cx, cy = np.asarray(cx, dtype=np.int64), np.asarray(cy, dtype=np.int64)
    pair, pos = _segments(cx * cy * cz)
    k = pos % cz
    y = (pos // cz) % cy[pair]
    x = pos // (cz * cy[pair])
    # one group per (table, slice k); its rows and columns numbered densely
    group = pair * cz + k
    row_start = np.concatenate([[0], np.cumsum(cx * cz)[:-1]])
    col_start = np.concatenate([[0], np.cumsum(cy * cz)[:-1]])
    row = row_start[pair] + x * cz + k
    col = col_start[pair] + y * cz + k
    n_group = np.bincount(group, weights=counts, minlength=len(cx) * cz)
    n_row = np.bincount(row, weights=counts, minlength=int((cx * cz).sum()))
    n_col = np.bincount(col, weights=counts, minlength=int((cy * cz).sum()))
    with np.errstate(divide="ignore", invalid="ignore"):
        n = n_group[group]
        pxy = counts / n
        terms = np.where(
            counts > 0,
            pxy * (np.log(pxy) - np.log(n_row[row] / n) - np.log(n_col[col] / n)),
            0.0,
        )
    mi_group = np.bincount(group, weights=terms, minlength=len(cx) * cz).reshape(len(cx), cz)
    if cz == 1:
        return mi_group[:, 0]
    n_group = n_group.reshape(len(cx), cz)
    total = n_group.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        share = np.where(total > 0, n_group / total, 0.0)
    return (share * mi_group).sum(axis=1)


class TreeSearch(StructureEstimator):
    """Chow-Liu / TAN tree learning; the pairwise mutual-information
    matrix is computed from one batched table-count launch.

    ``timings`` holds the host seconds of the last ``estimate`` call by
    step: building the specs (``specs_s``), enqueueing the launch
    (``launch_s``), the readback, which waits for the kernel
    (``readback_s``), the mutual information (``mutual_info_s``) and the
    spanning tree (``spanning_tree_s``).

    Examples
    --------
    >>> import numpy as np
    >>> import pandas as pd
    >>> from pgmpy_tpu_torch.estimators import TreeSearch
    >>> rng = np.random.default_rng(1)
    >>> a = rng.integers(0, 2, 500)
    >>> b = np.where(rng.random(500) < 0.9, a, 1 - a)
    >>> c = np.where(rng.random(500) < 0.9, b, 1 - b)  # chain a-b-c
    >>> df = pd.DataFrame({"a": a, "b": b, "c": c})
    >>> dag = TreeSearch(df, root_node="a").estimate(
    ...     estimator_type="chow-liu", show_progress=False)
    >>> sorted(dag.edges())
    [('a', 'b'), ('b', 'c')]
    """

    def __init__(self, data, root_node=None, n_jobs=-1, **kwargs):
        super().__init__(data, **kwargs)
        if root_node is not None and root_node not in self.variables:
            raise ValueError(f"Root node: {root_node} not found in data")
        self.root_node = root_node
        self.timings = {}

    def _pair_tables(self, variables, condition=None):
        """Every pair table of ``variables`` (with ``condition`` as a third,
        fastest axis) from one count call: the flat counts on the codes'
        device, the :class:`TableSpecs` that lays them out, and the two
        variable positions of each pair."""
        t0 = time.perf_counter()
        coded = self._coded
        index = np.array([coded.var_index[v] for v in variables], dtype=np.int64)
        cards = np.array([coded.cards[v] for v in variables], dtype=np.int64)
        i, j = np.triu_indices(len(variables), k=1)
        cols, spec_cards = [index[i], index[j]], [cards[i], cards[j]]
        if condition is not None:
            cols.append(np.full(len(i), coded.var_index[condition], dtype=np.int64))
            spec_cards.append(np.full(len(i), coded.cards[condition], dtype=np.int64))
        table = table_specs(np.stack(cols, axis=1), np.stack(spec_cards, axis=1))
        self.timings["specs_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        flat = coded._count_specs(table)
        self.timings["launch_s"] = time.perf_counter() - t0
        return flat, table, i, j

    def _mi_matrix(self, variables, condition=None):
        flat, _, i, j = self._pair_tables(variables, condition)
        t0 = time.perf_counter()
        counts = to_numpy(flat).astype(np.float64)
        self.timings["readback_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cards = np.array([self._coded.cards[v] for v in variables], dtype=np.int64)
        cz = 1 if condition is None else self._coded.cards[condition]
        mi = np.zeros((len(variables), len(variables)))
        mi[i, j] = mi[j, i] = pairwise_mutual_info(counts, cards[i], cards[j], cz)
        self.timings["mutual_info_s"] = time.perf_counter() - t0
        return mi

    def _tree_edges(self, variables, mi):
        """Directed edges of the maximum spanning tree of ``mi``, away from
        the root."""
        t0 = time.perf_counter()
        graph = nx.Graph()
        graph.add_nodes_from(variables)
        for i, j in itertools.combinations(range(len(variables)), 2):
            graph.add_edge(variables[i], variables[j], weight=-mi[i, j])
        tree = nx.minimum_spanning_tree(graph)
        edges = list(nx.bfs_edges(tree, self.root_node or variables[0]))
        self.timings["spanning_tree_s"] = time.perf_counter() - t0
        return edges

    def estimate(
        self, estimator_type="chow-liu", class_node=None, edge_weights_fn="mutual_info",
        n_jobs=-1, weight_fn=None, show_progress=True,
    ):
        if estimator_type not in ("chow-liu", "tan"):
            raise ValueError(f"estimator_type must be chow-liu or tan. Got: {estimator_type}")
        self.timings = {}

        if estimator_type == "chow-liu":
            variables = list(self.variables)
            dag = DAG()
            dag.add_nodes_from(variables)
            dag.add_edges_from(self._tree_edges(variables, self._mi_matrix(variables)))
            return dag

        # TAN: class node + Chow-Liu tree over features with conditional MI
        if class_node is None:
            raise ValueError("class_node must be specified for estimator_type='tan'")
        if class_node not in self.variables:
            raise ValueError(f"Class node: {class_node} not found in data")
        features = [v for v in self.variables if v != class_node]
        if self.root_node is not None and self.root_node == class_node:
            raise ValueError("Root node must be different from class node")
        mi = self._mi_matrix(features, condition=class_node)
        dag = DAG()
        dag.add_nodes_from(features + [class_node])
        dag.add_edges_from(self._tree_edges(features, mi))
        dag.add_edges_from((class_node, f) for f in features)
        return dag
