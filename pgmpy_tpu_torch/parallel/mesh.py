"""Device-mesh parallelism for samplers and batched queries: chains, draws
and evidence rows sharded over devices.

Port of ``pgmpy_tpu/parallel/mesh.py``.  The JAX package runs one program
per device under ``shard_map`` and reduces with ``psum`` / ``pmax`` /
``pmean``; this module computes the same results with explicit shards:

* a :class:`Mesh` is a grid of torch devices, one per shard.  Devices may
  repeat: ``Mesh([torch.device("cpu")] * 8)`` is eight shards on the CPU,
  ``[cuda:0] * 4`` four shards on one card, which then run one after another;
* each shard computes its local result on its own device, from its own
  random stream (a ``torch.Generator`` seeded from
  ``SeedSequence([seed, process index, shard index])``: equal in
  distribution to the JAX package's folded keys, not draw for draw);
* :func:`psum` / :func:`pmax` / :func:`pmean` move the shards' tensors to
  the first shard's device and combine them in shard order (a fixed order,
  so results are deterministic), then, when the mesh spans processes, run
  one ``torch.distributed.all_reduce`` over its group.  Only moment vectors
  and scalars cross: a few KB.

The samplers' per-shard moments (``w @ one_hot(codes[:, j])`` per variable in
the JAX package) are one launch of the hand-written count kernel per shard:
:func:`pgmpy_tpu_torch.ops.bincount.table_counts` over ``d`` one-column specs.

Compiled samplers and programs hold their tables on one device, so each is
built once per distinct device of the mesh, with ``config.DEVICE`` set to that
device for the duration (:func:`_on_device`, which always restores it).
"""

import contextlib

import numpy as np
import torch

from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.ops.bincount import column_major_codes, table_counts, table_specs
from pgmpy_tpu_torch.utils.mathext import seeded_generator


def _device(device):
    """``device`` as a ``torch.device`` with an explicit CUDA index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """The shards of a sharded computation: a grid of torch devices with one
    name per axis, and the ``torch.distributed`` process group it spans
    (``None`` for a mesh inside one process).

    ``devices`` lists every shard of every process, host-major: with a group
    of ``p`` processes, process ``r`` owns the ``r``-th of ``p`` equal
    contiguous blocks of the flattened grid (``local_shards``).  ``with
    mesh:`` is accepted as for ``jax.sharding.Mesh``; nothing reads an
    ambient mesh."""

    def __init__(self, devices, axis_names=("chains",), group=None):
        given = np.asarray(devices, dtype=object)
        self.devices = np.empty(given.shape, dtype=object)
        self.devices.reshape(-1)[:] = [_device(d) for d in given.reshape(-1)]
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names) or self.devices.size == 0:
            raise ValueError(
                f"a mesh of shape {self.devices.shape} needs one name per axis, got "
                f"{self.axis_names}"
            )
        self.group = group
        if group is None:
            self.process_index, self.process_count = 0, 1
        else:
            import torch.distributed as dist

            self.process_index = dist.get_rank(group)
            self.process_count = dist.get_world_size(group)
        if self.devices.size % self.process_count:
            raise ValueError(
                f"{self.devices.size} shards do not split evenly over {self.process_count} processes"
            )
        per = self.devices.size // self.process_count
        first = self.process_index * per
        flat = self.devices.reshape(-1)
        # (global shard index, device) of the shards this process runs
        self.local_shards = [(g, flat[g]) for g in range(first, first + per)]

    @property
    def size(self):
        return int(self.devices.size)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return f"Mesh(shape={self.devices.shape}, axis_names={self.axis_names})"


def get_mesh(n_devices=None, axis_name="chains", devices=None):
    """A 1-D mesh over the given devices, by default every device of
    ``config.DEVICE``'s type in this process (``cuda:0 … cuda:{n-1}``, or one
    ``cpu``); ``n_devices`` keeps the first ``n``."""
    if devices is None:
        if config.DEVICE.type == "cuda":
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [config.DEVICE]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (axis_name,))


@contextlib.contextmanager
def _on_device(device):
    """``config.DEVICE`` set to ``device`` for the duration, restored after
    (also when the body raises)."""
    previous = config.DEVICE
    config.set_device(device)
    try:
        yield
    finally:
        config.set_device(previous)


def _per_device(mesh, build):
    """{device: build()} for each distinct device among this process's shards,
    each built on its device: shards on one device share one object."""
    built = {}
    for _, device in mesh.local_shards:
        if device not in built:
            with _on_device(device):
                built[device] = build()
    return built


def _shard_seed(seed, mesh, shard):
    """The seed of one shard's stream: ``SeedSequence([seed, process index,
    shard index])``."""
    if seed is None:
        seed = np.random.randint(0, 2**31)
    words = np.random.SeedSequence([int(seed), mesh.process_index, int(shard)])
    return int(words.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


# --------------------------------------------------------------------------- #
# collectives over the shards
# --------------------------------------------------------------------------- #
def _all_reduce(total, group, op):
    """``total`` reduced over ``group``'s processes.  Gloo reduces host
    tensors: the few bytes go through the host."""
    import torch.distributed as dist

    if dist.get_backend(group) == "gloo":
        host = total.detach().cpu().clone()
        dist.all_reduce(host, op=op, group=group)
        return host.to(total.device)
    total = total.detach().clone()
    dist.all_reduce(total, op=op, group=group)
    return total


def _reduce(mesh, parts, combine, op_name):
    total = parts[0]
    for part in parts[1:]:
        total = combine(total, part.to(total.device))
    if mesh.group is not None:
        import torch.distributed as dist

        total = _all_reduce(total, mesh.group, getattr(dist.ReduceOp, op_name))
    return total


def psum(mesh, parts):
    """The sum of the local shards' tensors ``parts`` (one per entry of
    ``mesh.local_shards``, in that order) over every shard of the mesh, on
    the first local shard's device."""
    return _reduce(mesh, parts, torch.add, "SUM")


def pmax(mesh, parts):
    """The elementwise maximum of ``parts`` over every shard of the mesh."""
    return _reduce(mesh, parts, torch.maximum, "MAX")


def pmean(mesh, parts):
    """The mean of ``parts`` over every shard of the mesh."""
    return psum(mesh, parts) / mesh.size


# --------------------------------------------------------------------------- #
# per-shard moments on the count kernel
# --------------------------------------------------------------------------- #
def _marginal_specs(cards):
    """One one-column count spec per variable."""
    return table_specs([[j] for j in range(len(cards))], [[c] for c in cards])


def _one_hot_moments(codes, weights, cards, specs):
    """Per-variable weighted state counts of the ``(n, d)`` codes, the
    tables concatenated (``specs`` from :func:`_marginal_specs`): ONE
    ``table_counts`` launch on a CUDA tensor.  ``int32`` counts without
    weights, else in the weights' type."""
    cm = column_major_codes(codes, max(cards))
    return table_counts(cm, codes.shape[0], specs, weights)


def _marginals(variables, cards, specs, total):
    """{variable: normalised marginal} from the reduced moment vector."""
    host = total.double().cpu().numpy()
    out = {}
    for v, card, offset in zip(variables, cards, specs.offsets):
        block = host[offset : offset + card]
        out[v] = block / block.sum()
    return out


def _state_index(sampler, var, state):
    """The index of an evidence state given by name or by index."""
    from pgmpy_tpu_torch.inference.base import evidence_code

    names = sampler.state_names[var]
    return evidence_code(var, state, {s: i for i, s in enumerate(names)}, len(names))


def sharded_sample_marginals(
    model, n_samples, mesh=None, evidence=None, seed=0, axis_name="chains"
):
    """Empirical (evidence-weighted) marginals of every variable from
    ``n_samples`` draws, sharded over the mesh.

    Each shard draws ``ceil(n_samples / shards)`` likelihood-weighted samples
    (plain forward draws without evidence) and counts its weighted states in
    one ``table_counts`` launch; ``psum`` reduces the counts.  Weights are
    ``exp(logw - pmax(max logw))``, so the normalisation on the reduced sums
    does not depend on the shard count.  Evidence states are names or indices;
    anything else raises ``ValueError``."""
    from pgmpy_tpu_torch.sampling.core import CompiledAncestralSampler

    if mesh is None:
        mesh = get_mesh(axis_name=axis_name)
    per_shard = -(-int(n_samples) // mesh.size)
    samplers = _per_device(mesh, lambda: CompiledAncestralSampler(model))
    first = next(iter(samplers.values()))
    cards = list(first.cards)
    specs = _marginal_specs(cards)
    ev = {v: _state_index(first, v, s) for v, s in (evidence or {}).items()}

    draws = []
    for shard, device in mesh.local_shards:
        sampler = samplers[device]
        with _on_device(device):
            if ev:
                draws.append(sampler.likelihood_weighted(
                    per_shard, ev, seed=_shard_seed(seed, mesh, shard)))
            else:
                draws.append((sampler.forward(per_shard, seed=_shard_seed(seed, mesh, shard)), None))
    if ev:
        top = pmax(mesh, [logw.max() for _, logw in draws])
        moments = [_one_hot_moments(codes, torch.exp(logw - top.to(logw.device)), cards, specs)
                   for codes, logw in draws]
    else:
        moments = [_one_hot_moments(codes, None, cards, specs).long() for codes, _ in draws]
    return _marginals(first.variables, cards, specs, psum(mesh, moments))


def sharded_nuts_moments(
    model, n_chains, num_samples, num_adapt=100, stepsize=0.1, mesh=None,
    max_depth=5, seed=0, axis_name="chains",
):
    """Posterior mean and standard deviation from NUTS chains sharded over
    the mesh: {variable: (mean, std)}.

    Each shard runs ``ceil(n_chains / shards)`` chains; every iteration each
    shard takes one NUTS step, the shards' mean acceptance statistics are
    ``pmean``'d and ONE dual-averaging state adapts the shared step size on
    it; the first and second moment sums (float64) reduce with ``psum``."""
    from pgmpy_tpu_torch.sampling.nuts import VectorizedNUTS

    if mesh is None:
        mesh = get_mesh(axis_name=axis_name)
    per_shard = -(-int(n_chains) // mesh.size)
    samplers = _per_device(mesh, lambda: VectorizedNUTS(model, max_depth=max_depth))
    variables, mean0, _ = model.joint_gaussian()
    trajectory = _nuts_chains_local(samplers, mesh, seed, np.asarray(mean0), per_shard,
                                    num_samples, num_adapt, stepsize)
    s1 = psum(mesh, [t.double().sum(dim=0) for t in trajectory]).cpu().numpy()
    s2 = psum(mesh, [(t.double() ** 2).sum(dim=0) for t in trajectory]).cpu().numpy()
    n = float(int(num_samples) * per_shard * mesh.size)
    mean = s1 / n
    std = np.sqrt(np.maximum(s2 / n - mean**2, 0.0))
    return dict(zip(variables, zip(mean, std)))


def _nuts_chains_local(samplers, mesh, seed, start, per_shard, num_samples, num_adapt,
                       stepsize):
    """Per shard, the ``(num_samples * per_shard, dim)`` kept draws of NUTS
    chains started at ``start``, the step size adapted on the mesh-wide
    (``pmean``'d) mean acceptance."""
    from pgmpy_tpu_torch.config import as_tensor
    from pgmpy_tpu_torch.sampling.nuts import _StepSize

    shards = []
    for shard, device in mesh.local_shards:
        with _on_device(device):
            shards.append((samplers[device], seeded_generator(_shard_seed(seed, mesh, shard)),
                           as_tensor(np.tile(start, (per_shard, 1)))))
    positions = [z for _, _, z in shards]
    kept = [[] for _ in shards]
    adapt = _StepSize(stepsize, num_adapt, next(iter(samplers.values())).delta)
    for m in range(int(num_adapt) + int(num_samples)):
        eps = adapt.eps
        accepts = []
        for i, (nuts, gen, _) in enumerate(shards):
            positions[i], accept_stats = nuts._nuts_step(gen, positions[i], eps)
            accepts.append(accept_stats.mean())
        adapt.update(m, float(pmean(mesh, accepts)))
        if m >= num_adapt:
            for i, z in enumerate(positions):
                kept[i].append(z)
    return [torch.cat(k, dim=0) if k else positions[i][:0] for i, k in enumerate(kept)]


def sharded_gibbs_marginals(
    model, n_chains, n_sweeps, mesh=None, burn_in=0, seed=0, axis_name="chains"
):
    """Pooled posterior marginals from ``n_chains`` Gibbs chains sharded over
    the mesh: each shard starts ``ceil(n_chains / shards)`` chains from
    uniform random states, runs ``n_sweeps`` sweeps, and counts the states
    after ``burn_in`` in one ``table_counts`` launch; ``psum`` reduces the
    counts."""
    from pgmpy_tpu_torch.sampling.gibbs import GibbsSampling

    if mesh is None:
        mesh = get_mesh(axis_name=axis_name)
    per_shard = -(-int(n_chains) // mesh.size)
    programs = _per_device(mesh, lambda: GibbsSampling(model)._compiled)
    first = next(iter(programs.values()))
    cards = list(first.cards)
    specs = _marginal_specs(cards)

    moments = []
    for shard, device in mesh.local_shards:
        with _on_device(device):
            gen = seeded_generator(_shard_seed(seed, mesh, shard))
            init = torch.stack([torch.randint(0, c, (per_shard,), generator=gen, device=device)
                                for c in cards], dim=1)
            traj = programs[device]._run_chains(gen, n_sweeps, init)  # (T, chains, d)
            flat = traj[burn_in:].reshape(-1, len(cards))
            moments.append(_one_hot_moments(flat, None, cards, specs).long())
    return _marginals(first.variables, cards, specs, psum(mesh, moments))


def sharded_query_batch(model, variables, evidence, mesh=None, axis_name="chains"):
    """Batched exact posteriors with the ROW axis sharded over the mesh.

    Every shard runs ``VariableElimination.batch_query_program`` (its tables
    on the shard's device) on its block of evidence rows; the rows are padded
    to a multiple of the shard count with copies of row 0 and the padding is
    dropped after.  Codes are validated on the host as ``query_batch``
    validates them, and the rows whose evidence has probability 0 through a
    CPD the contraction leaves out get the same answer as from
    ``query_batch``.  Across processes, every process receives every row.

    Returns (values[n, *query cards] as numpy, state_names): equal to
    ``VariableElimination.query_batch`` for any shard count."""
    from pgmpy_tpu_torch.inference.base import evidence_codes
    from pgmpy_tpu_torch.inference.ve import VariableElimination

    if mesh is None:
        mesh = get_mesh(axis_name=axis_name)
    ev_vars = sorted(evidence.keys(), key=str)
    infer = VariableElimination(model)
    programs = _per_device(mesh, lambda: infer.batch_query_program(list(variables), ev_vars))
    _, state_names, code_maps, _ = next(iter(programs.values()))

    n = len(next(iter(evidence.values())))
    codes = np.empty((n, len(ev_vars)), dtype=np.int64)
    for k, var in enumerate(ev_vars):
        codes[:, k] = evidence_codes(var, evidence[var], code_maps[k], len(code_maps[k]))
    n_pad = (-n) % mesh.size
    if n_pad:
        codes = np.concatenate([codes, np.tile(codes[:1], (n_pad, 1))], axis=0)
    per_shard = codes.shape[0] // mesh.size

    blocks = []
    for shard, device in mesh.local_shards:
        run = programs[device][0]
        rows = torch.from_numpy(codes[shard * per_shard : (shard + 1) * per_shard]).to(device)
        blocks.append(run(rows))
    local = torch.cat([b.to(blocks[0].device) for b in blocks], dim=0)
    if mesh.group is not None:
        local = _all_gather_rows(local, mesh.group)
    return local.cpu().numpy()[:n], state_names


def _all_gather_rows(local, group):
    """Every process's ``local`` rows, concatenated in process order."""
    import torch.distributed as dist

    if dist.get_backend(group) == "gloo":
        local = local.cpu()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, dim=0)
