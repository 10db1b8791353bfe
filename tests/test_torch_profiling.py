"""The port's profiling harness against pgmpy_tpu's on the CPU.

``KernelTimer`` keeps the JAX package's records and summary; on the CPU there
is no device queue to drain (on a CUDA device it synchronises
``config.DEVICE``).  ``trace`` writes a ``torch.profiler`` Chrome trace into
its directory.
"""

import json
import os

import torch

import _torch_parity  # noqa: F401  (puts the port on the CPU)
from pgmpy_tpu.utils import KernelTimer as JaxKernelTimer
from pgmpy_tpu_torch.utils import KernelTimer, trace


def test_summary_has_the_jax_keys():
    port, jax_timer = KernelTimer(), JaxKernelTimer()
    for timer in (port, jax_timer):
        with timer.time("a"):
            sum(range(1000))
        with timer.time("a"):
            pass
        with timer.time("b"):
            pass
    assert port.summary().keys() == jax_timer.summary().keys() == {"a", "b"}
    for name in ("a", "b"):
        assert port.summary()[name].keys() == jax_timer.summary()[name].keys()
    assert port.summary()["a"]["calls"] == 2
    assert port.summary()["a"]["total_s"] == sum(port.records["a"])


def test_timeit_returns_min_and_result():
    timer = KernelTimer()
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        return torch.ones(4) * x * scale

    best, result = timer.timeit("f", fn, 3.0, repeat=5, warmup=2, scale=2.0)
    assert len(calls) == 7 and len(timer.records["f"]) == 5
    assert best == min(timer.records["f"]) and best >= 0.0
    assert torch.equal(result, torch.full((4,), 6.0))
    timer.timeit("f", fn, 1.0, repeat=3)
    assert len(timer.records["f"]) == 8


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)) as out:
        assert out == str(log_dir)
        (torch.arange(1000.0) ** 2).sum()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("pow" in str(e.get("name", "")) for e in events)
