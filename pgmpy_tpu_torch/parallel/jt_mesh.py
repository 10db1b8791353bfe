"""Model-parallel junction-tree calibration across the devices of a mesh.

Port of ``pgmpy_tpu/parallel/jt_mesh.py``: the design for "MUNIN-class
calibration across cards".

The clique tree is partitioned on the host into balanced CONNECTED subtrees
(one part per device, carved bottom-up from a rooted DFS).  Each part runs its
stage-0 potentials and its local two-pass message schedule on its device, and
the parts exchange only the sepset messages on the (few) tree edges that
cross part boundaries:

  upward phase   parts run children-before-parents; each part multiplies
                 the boundary sepset messages from its child parts into the
                 receiving cliques, runs its internal upward sweep, and
                 emits one sepset message toward its parent part,
  downward phase parts run parents-before-children; each part absorbs the
                 ratio message from its parent part, runs its internal
                 downward sweep, and emits sepset beliefs to its children.

Each part is a junction-tree program of its own, run by the calibration
kernels of ``ops/jt.py`` (K2; their plain version on a CPU part): its cliques,
plus one factorless **boundary clique** per boundary edge that spans the
edge's sepset.  A part with a parent part is rooted at the boundary clique of
that edge, so its last upward wave is the message from its top to that clique
(the sigma the JAX package sends up) and its first downward wave the message
back.  A part's calibration runs in two halves split at its plan's
``n_up_waves``:

  first half     stage 0; each child part's sigma (the child's sepset slot of
                 the edge) copied into the matching boundary clique, whose
                 fresh message multiplies it into the receiving clique; the
                 upward waves,
  second half    the parent part's sepset slot of the edge (its final sepset
                 belief) copied into the parent boundary clique, whose message
                 divides it by the part's own sigma (clamped at ``TINY``) and
                 multiplies the ratio into the top; the downward waves.

Only sepset-sized tensors cross devices (``copy_(..., non_blocking=True)``,
which torch orders against both cards' current streams); clique beliefs are
born and stay in their part's arena.  Parts are enqueued in depth order from
one host thread; on one card holding several parts they run one after another.

The per-message arithmetic is that of the single-device program over the same
roots.  A boundary clique's message reduces nothing; with
``normalize_messages`` it normalises the already normalised sigma once more
(a rounding of an ulp or two that the JAX package does not make).  Within a
part the messages run in its own waves, so products round in another order
and the beliefs agree with the single-device program to float tolerance, for
any device count and partition.
"""

import collections
import functools
from types import SimpleNamespace

import networkx as nx
import torch

from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.inference.bp import _broadcast_spec
from pgmpy_tpu_torch.ops import jt


def partition_rooted_tree(tree, root, n_parts):
    """Carve a rooted tree into balanced CONNECTED parts, targeting
    ``n_parts`` of them.

    Bottom-up DFS accumulation: a node absorbs its children's pending
    buckets and seals a part once the bucket reaches the target size (the
    subtree root seals whatever remains).  Because absorbing several child
    buckets at once overshoots the target, a first carve often yields
    FEWER than ``n_parts`` parts (pigs/362 gave 6 of 8) — so a refinement
    loop re-carves the largest part in two until the requested count is
    reached (or the largest part is a single node / unsplittable star).
    Returns (parts, tops, parent) where ``parts[i]`` is the node list of
    part i and ``tops[i]`` its highest node (adjacent to the parent part).
    Host networkx code, the same as the JAX package's (equal output).
    """
    nodes = list(nx.dfs_postorder_nodes(tree, root))
    parent = {c: p for p, c in nx.bfs_edges(tree, root)}

    def carve(node_list, sub_root, target):
        sub = tree.subgraph(node_list)
        pending = collections.defaultdict(list)
        parts, tops = [], []
        for node in nx.dfs_postorder_nodes(sub, sub_root):
            bucket = [node]
            for child in sub.neighbors(node):
                if parent.get(child) is node and child in pending:
                    bucket.extend(pending.pop(child))
            if len(bucket) >= target or node == sub_root:
                parts.append(bucket)
                tops.append(node)
            else:
                pending[node] = bucket
        return parts, tops

    def split2(node_list, sub_root):
        """Best-edge 2-way split: cut the edge whose lower subtree is
        closest to half the part (always succeeds for >= 2 nodes, unlike
        a threshold carve, which can't split e.g. a root whose child
        subtrees are all below target)."""
        sub = tree.subgraph(node_list)
        size = {}
        for node in nx.dfs_postorder_nodes(sub, sub_root):
            size[node] = 1 + sum(
                size[c]
                for c in sub.neighbors(node)
                if parent.get(c) == node and c in size
            )
        n = len(node_list)
        best = min(
            (x for x in node_list if x != sub_root),
            key=lambda x: abs(size[x] - n / 2),
        )
        lower = set()
        stack = [best]
        while stack:
            x = stack.pop()
            lower.add(x)
            for c in sub.neighbors(x):
                if parent.get(c) == x:
                    stack.append(c)
        upper = [x for x in node_list if x not in lower]
        return [list(lower), upper], [best, sub_root]

    target = max(1, -(-len(nodes) // int(n_parts)))
    parts, tops = carve(nodes, root, target)
    while len(parts) < int(n_parts):
        i = max(range(len(parts)), key=lambda j: len(parts[j]))
        if len(parts[i]) < 2:
            break
        sub_parts, sub_tops = split2(parts[i], tops[i])
        parts[i : i + 1] = sub_parts
        tops[i : i + 1] = sub_tops
    return parts, tops, parent


def _sepset_message(clique, sepset):
    """(reduce axes, permutation to sepset order) of the message from the
    clique with variables ``clique`` down to ``sepset``."""
    reduce_axes = tuple(i for i, v in enumerate(clique) if v not in sepset)
    kept = [v for v in clique if v in sepset]
    return reduce_axes, tuple(kept.index(v) for v in sepset)


def part_program(program, part, edges, boundaries, root):
    """The junction-tree program of one part, in the form ``jt.build_plan``
    takes: the part's cliques (local ids in ``part`` order), then one
    factorless boundary clique per entry of ``boundaries`` ((receiving clique,
    sepset variables)), its internal ``edges`` (pairs of clique ids) and an
    edge from each receiving clique to its boundary clique; rooted at the
    local clique ``root``.  Edges are numbered in BFS order from the root,
    messages are upward (deepest first, each fresh) then downward."""
    local_of = {c: i for i, c in enumerate(part)}
    variables = [list(program.cliques[c]) for c in part] + [list(s) for _, s in boundaries]
    graph = nx.Graph()
    graph.add_nodes_from(range(len(variables)))
    graph.add_edges_from((local_of[a], local_of[b]) for a, b in edges)
    graph.add_edges_from((local_of[recv], len(part) + k) for k, (recv, _) in enumerate(boundaries))
    bfs = list(nx.bfs_edges(graph, root))
    edge_of = {frozenset(pair): e for e, pair in enumerate(bfs)}
    sepsets = [sorted(set(variables[a]) & set(variables[b]), key=str) for a, b in bfs]
    messages = []
    for (src, dst), fresh in ([((c, p), True) for p, c in reversed(bfs)]
                              + [((p, c), False) for p, c in bfs]):
        edge = edge_of[frozenset((src, dst))]
        messages.append((src, dst, *_sepset_message(variables[src], sepsets[edge]),
                         _broadcast_spec(sepsets[edge], variables[dst]), edge, fresh))
    factor_ids, specs = [], []
    for c in part:
        specs.append([])
        for f_idx, perm, spec in program.potential_specs[c]:
            if f_idx not in factor_ids:
                factor_ids.append(f_idx)
            specs[-1].append((factor_ids.index(f_idx), perm, spec))
    cards = program.cards
    return SimpleNamespace(
        cliques=[tuple(v) for v in variables],
        clique_shapes=[tuple(int(cards[v]) for v in vs) for vs in variables],
        sepset_shapes=[tuple(int(cards[v]) for v in s) for s in sepsets],
        factor_shapes=[program.factor_shapes[f] for f in factor_ids],
        potential_specs=specs + [[] for _ in boundaries],
        messages=messages,
        n_edges=len(bfs),
        factor_ids=factor_ids,
        edge_of=edge_of,
    )


class ShardedJunctionTreeCalibration:
    """Per-part calibration programs over the devices of a mesh.

    Parameters
    ----------
    program : JunctionTreeProgram (the single-device compile artifact; its
        clique structure, factor assignment and cards are reused)
    mesh : pgmpy_tpu_torch.parallel.mesh.Mesh (this process's shards carry
        the parts, round-robin when there are more parts than shards)
    """

    def __init__(self, program, mesh):
        self.program = program
        devices = [device for _, device in mesh.local_shards]
        self.devices = devices
        cliques = program.cliques

        # ---- host: partition every tree component ---------------------- #
        tree = nx.Graph()
        tree.add_nodes_from(range(len(cliques)))
        index = program.index
        for edge_key in program.edge_ids:
            c1, c2 = tuple(edge_key)
            tree.add_edge(index[c1], index[c2])

        # root each component at the SAME clique the single-device program
        # used: with normalized messages the per-clique scale depends on
        # the rooted schedule, and parity with the program requires parity
        # of roots
        roots_by_clique = {index[r] for r in program.component_roots}
        all_parts, all_tops, parent_of = [], [], {}
        for component in nx.connected_components(tree):
            sub = tree.subgraph(component)
            in_comp = [c for c in component if c in roots_by_clique]
            root = in_comp[0] if in_comp else min(component)
            n_here = max(1, round(len(devices) * len(component) / len(cliques)))
            parts, tops, parent = partition_rooted_tree(sub, root, n_here)
            all_parts.extend(parts)
            all_tops.extend(tops)
            parent_of.update(parent)

        self.n_parts = len(all_parts)
        part_of = {c: p_idx for p_idx, part in enumerate(all_parts) for c in part}

        # part tree: parent part of part i holds parent_of[tops[i]]
        self.part_parent = []
        for top in all_tops:
            up = parent_of.get(top)
            self.part_parent.append(part_of[up] if up is not None else None)
        self.part_children = [[] for _ in all_parts]
        for p_idx, pp in enumerate(self.part_parent):
            if pp is not None:
                self.part_children[pp].append(p_idx)

        # depth of each part (for phase scheduling)
        self.part_depth = [0] * self.n_parts
        changed = True
        while changed:
            changed = False
            for p_idx, pp in enumerate(self.part_parent):
                if pp is not None and self.part_depth[p_idx] != self.part_depth[pp] + 1:
                    self.part_depth[p_idx] = self.part_depth[pp] + 1
                    changed = True

        self.device_of_part = [devices[i % len(devices)] for i in range(self.n_parts)]

        # ---- host: each part's program and wave plan -------------------- #
        def sepset_of(c1, c2):
            return sorted(set(cliques[c1]) & set(cliques[c2]), key=str)

        def edge_id(c1, c2):
            return program.edge_ids[frozenset((cliques[c1], cliques[c2]))]

        self.parts = []
        for p_idx, (part, top) in enumerate(zip(all_parts, all_tops)):
            local_of = {c: i for i, c in enumerate(part)}
            # a boundary clique per child part (under the clique its top hangs
            # off), then one for the edge to the parent part, the root
            children = [(ch, parent_of[all_tops[ch]]) for ch in self.part_children[p_idx]]
            boundaries = [(recv, sepset_of(all_tops[ch], recv)) for ch, recv in children]
            boundary_edge_id = None
            root = local_of[top]
            if self.part_parent[p_idx] is not None:
                boundary_edge_id = edge_id(top, parent_of[top])
                root = len(part) + len(boundaries)
                boundaries.append((top, sepset_of(top, parent_of[top])))
            internal = list(tree.subgraph(part).edges())
            local = part_program(program, part, internal, boundaries, root)
            # (child part, receiving local clique, boundary clique, local edge,
            # global edge id) per child part
            in_up = [(ch, local_of[recv], len(part) + k,
                      local.edge_of[frozenset((local_of[recv], len(part) + k))],
                      edge_id(all_tops[ch], recv))
                     for k, (ch, recv) in enumerate(children)]
            # global edge id of each local edge (None: the edge to the parent
            # part, whose sepset belief the parent part holds)
            edge_ids = [None] * local.n_edges
            for a, b in internal:
                edge_ids[local.edge_of[frozenset((local_of[a], local_of[b]))]] = edge_id(a, b)
            for *_, e, global_id in in_up:
                edge_ids[e] = global_id
            self.parts.append({
                "cliques": part,
                "top": top,
                "local_of": local_of,
                "factor_ids": local.factor_ids,
                "program": local,
                "plan": jt.build_plan(local),
                "edge_ids": edge_ids,
                "in_up": in_up,
                # (boundary clique, local edge) of the edge to the parent part
                "out_up": (root, local.edge_of[frozenset((local_of[top], root))])
                if boundary_edge_id is not None else None,
                "boundary_edge_id": boundary_edge_id,
            })
        # the parent part's local edge of each part's edge to it
        for part in self.parts:
            for ch, _, _, e, _ in part["in_up"]:
                self.parts[ch]["in_down"] = e

    # ------------------------------------------------------------------ #
    def launches(self):
        """K2 launches of one calibration on the card: per part, stage 0 and
        two per wave of its plan."""
        return sum(1 + 2 * part["plan"].n_waves for part in self.parts)

    def calibrate(self, factor_arrays, kernel=None):
        """Distributed two-pass calibration; returns (beliefs, mu) in the
        single-device ``JunctionTreeProgram`` layout (beliefs indexed by
        clique id, mu by edge id), views into each part's arenas on its
        device.  A part on a CUDA device runs K2's kernels (a build or launch
        failure raises), one on the CPU their plain version; ``kernel=False``
        runs the plain version on every device (a check of the kernels)."""
        program = self.program
        dtype = (functools.reduce(torch.promote_types, [a.dtype for a in factor_arrays])
                 if factor_arrays else config.DTYPE)
        normalize = program.normalize_messages
        beliefs_out = [None] * len(program.cliques)
        mu_out = [None] * program.n_edges
        state = [None] * self.n_parts  # (arena, sepsets, beliefs, mu, kernel)

        def runs_kernel(dev):
            if dev.type not in ("cuda", "cpu"):
                raise ValueError(f"calibrate: unsupported device {dev}")
            return dev.type == "cuda" if kernel is None else kernel

        # ---- upward phase: deepest parts first -------------------------- #
        for depth in sorted(set(self.part_depth), reverse=True):
            for p_idx in [i for i, d in enumerate(self.part_depth) if d == depth]:
                part, plan = self.parts[p_idx], self.parts[p_idx]["plan"]
                dev = self.device_of_part[p_idx]
                use = runs_kernel(dev)
                inputs = [factor_arrays[i].to(dev, non_blocking=True) for i in part["factor_ids"]]
                arena, sepsets = jt.stage0(plan, inputs, use, device=dev, dtype=dtype)
                beliefs, mu = jt.arena_views(plan, arena, sepsets)
                for ch, _, bc, _, _ in part["in_up"]:
                    _, sigma_edge = self.parts[ch]["out_up"]
                    beliefs[bc].copy_(state[ch][3][sigma_edge], non_blocking=True)
                jt.run_waves(plan, arena, sepsets, range(plan.n_up_waves), "marginalize",
                             normalize, use)
                state[p_idx] = (arena, sepsets, beliefs, mu, use)

        # ---- downward phase: shallowest parts first --------------------- #
        for depth in sorted(set(self.part_depth)):
            for p_idx in [i for i, d in enumerate(self.part_depth) if d == depth]:
                part, plan = self.parts[p_idx], self.parts[p_idx]["plan"]
                arena, sepsets, beliefs, mu, use = state[p_idx]
                if part["out_up"] is not None:
                    parent_mu = state[self.part_parent[p_idx]][3]
                    beliefs[part["out_up"][0]].copy_(parent_mu[part["in_down"]],
                                                     non_blocking=True)
                jt.run_waves(plan, arena, sepsets, range(plan.n_up_waves, plan.n_waves),
                             "marginalize", normalize, use)
                for c, b in zip(part["cliques"], beliefs):
                    beliefs_out[c] = b
                for e, m in zip(part["edge_ids"], mu):
                    if e is not None:
                        mu_out[e] = m
        return beliefs_out, mu_out


def sharded_jt_calibrate(model, mesh=None):
    """Calibrate ``model``'s junction tree with clique tensors partitioned
    across the mesh's devices; returns ``(clique_beliefs, sepset_beliefs)``
    dicts of numpy arrays keyed like ``BeliefPropagation``'s (clique tuple /
    frozenset edge)."""
    from pgmpy_tpu_torch.inference.bp import BeliefPropagation
    from pgmpy_tpu_torch.parallel.mesh import get_mesh

    if mesh is None:
        mesh = get_mesh()
    bp = BeliefPropagation(model)
    program = bp._program
    sharded = ShardedJunctionTreeCalibration(program, mesh)
    beliefs, mu = sharded.calibrate([f.values for f in bp._input_factors])
    clique_beliefs = {
        clique: b.cpu().numpy() for clique, b in zip(program.cliques, beliefs)
    }
    sepset_beliefs = {
        edge_key: None if mu[edge_id] is None else mu[edge_id].cpu().numpy()
        for edge_key, edge_id in program.edge_ids.items()
    }
    return clique_beliefs, sepset_beliefs
