"""Worker of the two-process run of ``pgmpy_tpu_torch.parallel.distributed``
(not a test module): the counterpart of ``distributed_worker.py``.

Two interpreters join one process group through ``distributed.initialize``
over a localhost coordinator; each runs 2 shards, so the process-spanning mesh
has 4 shards over 2 processes.  The checks exercise the cross-process
collectives, the per-process streams, a sharded likelihood-weighted sampler, a
sharded batched query and ``VectorizedNUTS.sample(axis_name=...)``.

    python tests/_torch_distributed_worker.py RANK PORT [DEVICE [BACKEND]]

``DEVICE`` is ``cpu`` (the default) or ``cuda``.  With ``BACKEND`` ``gloo``
(the default) both ranks compute on ``DEVICE`` (``cuda:0`` for ``cuda``) and
the few reduced bytes cross through the host; with ``nccl`` rank ``r``
computes on ``cuda:r``.  Prints ``WORKER <rank> OK`` at the end.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.factors import LinearGaussianCPD, TabularCPD
    from pgmpy_tpu_torch.inference import VariableElimination
    from pgmpy_tpu_torch.models import DiscreteBayesianNetwork, LinearGaussianBayesianNetwork
    from pgmpy_tpu_torch.parallel import distributed as dist
    from pgmpy_tpu_torch.parallel import sharded_query_batch, sharded_sample_marginals
    from pgmpy_tpu_torch.parallel.mesh import psum
    from pgmpy_tpu_torch.sampling import VectorizedNUTS

    rank, port = int(sys.argv[1]), sys.argv[2]
    device = sys.argv[3] if len(sys.argv) > 3 else "cpu"
    backend = sys.argv[4] if len(sys.argv) > 4 else "gloo"
    card = rank if backend == "nccl" else 0
    config.set_device(f"cuda:{card}" if device == "cuda" else device)
    pair = dist.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                           process_id=rank, local_device_ids=[card, card], backend=backend)
    assert pair == (rank, 2), pair
    assert dist.is_initialized() and dist.initialize() == (rank, 2)

    mesh = dist.global_mesh()
    assert mesh.devices.size == 4, mesh.devices.shape
    assert [g for g, _ in mesh.local_shards] == [2 * rank, 2 * rank + 1]
    assert all(d.type == config.DEVICE.type for _, d in mesh.local_shards)
    assert dist.host_chain_mesh().devices.shape == (2, 2)

    # cross-process collective: each shard holds two entries of arange(8)
    x = torch.arange(8.0, device=config.DEVICE)
    total = psum(mesh, [x[2 * g: 2 * g + 2].sum() for g, _ in mesh.local_shards])
    assert float(total) == 28.0, float(total)

    # per-process streams differ
    assert dist.host_fold_key(0, 0) != dist.host_fold_key(0, 1)

    # a sharded sampler over the process-spanning mesh: P(rain | wet=1)
    model = DiscreteBayesianNetwork([("rain", "wet")])
    model.add_cpds(
        TabularCPD("rain", 2, [[0.8], [0.2]]),
        TabularCPD("wet", 2, [[0.9, 0.2], [0.1, 0.8]], evidence=["rain"], evidence_card=[2]),
    )
    marginals = sharded_sample_marginals(model, n_samples=40_000, mesh=mesh,
                                         evidence={"wet": 1}, seed=0)
    np.testing.assert_allclose(marginals["rain"], [1 / 3, 2 / 3], atol=0.02)

    # a sharded batched query: every process gets every row
    rows = {"wet": [i % 2 for i in range(7)]}
    values, _ = sharded_query_batch(model, ["rain"], rows, mesh=mesh)
    want, _ = VariableElimination(model).query_batch(["rain"], rows)
    np.testing.assert_allclose(values, want.cpu().numpy(), rtol=1e-6)

    # NUTS with the acceptance pmean'd over the processes: one step size
    lg = LinearGaussianBayesianNetwork([("x1", "x2")])
    lg.add_cpds(LinearGaussianCPD("x1", [1], 2),
                LinearGaussianCPD("x2", [0, 1.0], 1, evidence=["x1"]))
    nuts = VectorizedNUTS(lg, max_depth=4)
    nuts.sample(np.zeros(2), num_samples=5, num_adapt=15, stepsize=0.3, n_chains=16,
                seed=rank, axis_name="chains")
    steps = [None, None]
    torch.distributed.all_gather_object(steps, nuts.final_stepsize)
    assert steps[0] == steps[1], steps

    dist.shutdown()
    assert not dist.is_initialized()
    print(f"WORKER {rank} OK", flush=True)


if __name__ == "__main__":
    main()
