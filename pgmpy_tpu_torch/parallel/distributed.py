"""Multi-process execution entry point: process group init and the meshes
that span processes.

Port of ``pgmpy_tpu/parallel/distributed.py``, on ``torch.distributed``.  A
run over several processes (one per host, or several on one host) is:

    from pgmpy_tpu_torch.parallel import distributed as dist

    dist.initialize(coordinator_address="10.0.0.1:8476",
                    num_processes=4, process_id=int(os.environ["RANK"]))
    mesh = dist.global_mesh()            # every process's shards, host-major
    seed = dist.host_fold_key(0)         # per-process streams
    sharded_gibbs_marginals(model, n_chains=65536, mesh=mesh, seed=seed)

The samplers of :mod:`pgmpy_tpu_torch.parallel.mesh` take the mesh as an
argument and reduce over its group, so the same code runs on one card, on
several cards of one process, or across processes; only the constructors
here know about processes.

Single-process calls degrade gracefully: ``initialize()`` with no coordinator
(or ``num_processes=1``) is a recorded no-op, so library code can call it
unconditionally.

Divergences from the JAX package, on purpose: ``initialize`` takes a
``backend`` (torch needs one, JAX does not); ``host_fold_key`` takes and
returns an int seed (torch has no key arrays); the per-process devices are
torch devices (``local_device_ids`` picks this process's cards), gathered
from every process with ``all_gather_object``.

Examples
--------
>>> from pgmpy_tpu_torch.parallel import distributed as dist
>>> dist.initialize()  # no coordinator: single-process mode
(0, 1)
>>> dist.is_initialized()
True
>>> mesh = dist.global_mesh()
>>> mesh.axis_names
('chains',)
>>> dist.host_fold_key(0, process_index=2) != dist.host_fold_key(0, process_index=1)
True
"""

import numpy as np
import torch

from pgmpy_tpu_torch.config import config, logger
from pgmpy_tpu_torch.parallel.mesh import Mesh

# module-level state: initialize() is idempotent and records what it did so
# is_initialized() and the process metadata work in the degenerate case too;
# "axes" maps the axis names of the process-spanning meshes built here to
# their process group (what ``VectorizedNUTS.sample(axis_name=...)`` reads)
_STATE = {"initialized": False, "distributed": False, "local_device_ids": None, "axes": {}}


def is_initialized():
    """True once :func:`initialize` has run (in either mode)."""
    return _STATE["initialized"]


def _process_index():
    """This process's rank (0 in single-process mode)."""
    if _STATE["distributed"]:
        return torch.distributed.get_rank()
    return 0


def _process_count():
    """The number of processes (1 in single-process mode)."""
    if _STATE["distributed"]:
        return torch.distributed.get_world_size()
    return 1


def initialize(
    coordinator_address=None,
    num_processes=None,
    process_id=None,
    local_device_ids=None,
    backend=None,
):
    """Join (or create) the process group.

    Thin, idempotent wrapper over ``torch.distributed.init_process_group``:

    - With a ``coordinator_address`` (``host:port``, rank 0 listens there)
      and ``num_processes``, every process calls this with its
      ``process_id``; afterwards :func:`global_mesh` builds a mesh over every
      process's devices.  ``backend`` is ``"nccl"`` when ``config.DEVICE``
      is CUDA and ``"gloo"`` otherwise unless given (NCCL refuses two ranks
      on one card: pass ``"gloo"`` for that).
    - With no coordinator and ``num_processes in (None, 1)`` this records
      single-process mode and touches nothing.

    ``local_device_ids`` picks this process's cards (``cuda:i`` for each id;
    on the CPU, one ``cpu`` shard per id); by default every card, or one CPU.

    Returns the (process_index, process_count) pair in effect.
    """
    if _STATE["initialized"]:
        return _process_index(), _process_count()

    single = coordinator_address is None and (num_processes or 1) <= 1
    if not single:
        if coordinator_address is None:
            raise ValueError("coordinator_address is required when num_processes > 1")
        if num_processes is None or process_id is None:
            raise ValueError("num_processes and process_id are required with a coordinator_address")
        if backend is None:
            backend = "nccl" if config.DEVICE.type == "cuda" else "gloo"
        if backend == "nccl" and local_device_ids:
            torch.cuda.set_device(int(local_device_ids[0]))
        torch.distributed.init_process_group(
            backend=backend,
            init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes),
            rank=int(process_id),
        )
        _STATE["distributed"] = True
    _STATE["local_device_ids"] = None if local_device_ids is None else list(local_device_ids)
    _STATE["initialized"] = True
    logger.info(
        "pgmpy_tpu_torch.distributed: process %d/%d, %d local device(s)",
        _process_index(), _process_count(), len(_local_devices()),
    )
    return _process_index(), _process_count()


def shutdown():
    """Leave the process group (no-op in single-process mode)."""
    if _STATE["distributed"]:
        torch.distributed.destroy_process_group()
    _STATE.update(initialized=False, distributed=False, local_device_ids=None, axes={})


def _local_devices():
    ids = _STATE["local_device_ids"]
    if config.DEVICE.type == "cuda":
        if ids is None:
            ids = range(torch.cuda.device_count())
        return [torch.device("cuda", int(i)) for i in ids]
    return [torch.device(config.DEVICE.type)] * (1 if ids is None else len(ids))


def device_grid(devices=None):
    """Every process's devices as an (n_processes, devices_per_process) grid
    of torch devices: row ``p`` holds process ``p``'s devices, gathered from
    every process (``devices``, a list of per-process device lists, replaces
    the gathered rows).

    Raises on ragged per-process device counts: silently truncating to the
    minimum would drop devices from the mesh while callers believe it spans
    every process."""
    if devices is None:
        rows = [[str(d) for d in _local_devices()]]
        if _STATE["distributed"]:
            rows = [None] * _process_count()
            torch.distributed.all_gather_object(rows, [str(d) for d in _local_devices()])
    else:
        rows = [list(row) for row in devices]
    counts = {p: len(row) for p, row in enumerate(rows)}
    if len(set(counts.values())) > 1:
        raise ValueError(
            "Per-process device counts differ "
            f"({counts}); a rectangular mesh needs every process to expose the same "
            "number of devices — restrict with local_device_ids or pass an explicit "
            "`devices` list."
        )
    grid = np.empty((len(rows), len(rows[0])), dtype=object)
    for p, row in enumerate(rows):
        grid[p, :] = [torch.device(d) for d in row]
    return grid


def _group():
    return torch.distributed.group.WORLD if _STATE["distributed"] else None


def global_mesh(axis_name="chains", devices=None):
    """1-D mesh over every process's devices, ordered host-major: each
    process's shards are contiguous on the axis.  In single-process mode
    this is a mesh over the local devices."""
    grid = device_grid(devices)
    mesh = Mesh(grid.reshape(-1), (axis_name,), group=_group())
    if mesh.group is not None:
        _STATE["axes"][axis_name] = mesh.group
    return mesh


def host_chain_mesh(host_axis="hosts", chain_axis="chains", devices=None):
    """2-D (hosts, chains) mesh: one row per process.  The host axis spans
    the processes (its reductions run over the process group), the chain
    axis a process's own shards."""
    grid = device_grid(devices)
    mesh = Mesh(grid, (host_axis, chain_axis), group=_group())
    if mesh.group is not None:
        _STATE["axes"][host_axis] = mesh.group
    return mesh


def axis_group(axis_name):
    """The process group of a process-spanning mesh axis built by
    :func:`global_mesh` or :func:`host_chain_mesh`; ``ValueError`` when no
    initialized group carries ``axis_name``."""
    group = _STATE["axes"].get(axis_name) if _STATE["distributed"] else None
    if group is None:
        raise ValueError(
            f"no process group carries the axis {axis_name!r}: call initialize() with "
            "several processes and build the mesh with global_mesh() or host_chain_mesh()"
        )
    return group


def host_fold_key(key, process_index=None):
    """Per-process seed: ``key`` (an int seed) with the process index folded
    in, as an int.  The samplers of :mod:`pgmpy_tpu_torch.parallel.mesh`
    also fold in each shard's index, so streams never collide."""
    if process_index is None:
        process_index = _process_index()
    words = np.random.SeedSequence([int(key), int(process_index)])
    return int(words.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))
