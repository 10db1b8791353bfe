"""Profiling & timing harness.

Port of ``pgmpy_tpu/utils/profiling.py``: wall-clock timing that drains the
device before it reads the clock (``torch.cuda.synchronize`` on
``config.DEVICE`` when that is a CUDA device; the CPU has nothing to drain),
plus a thin wrapper over ``torch.profiler`` that writes a Chrome trace.
"""

import contextlib
import os
import tempfile
import time
from collections import defaultdict

import torch

from pgmpy_tpu_torch.config import config


def _drain():
    """Wait for the work queued on ``config.DEVICE``."""
    if config.DEVICE.type == "cuda":
        torch.cuda.synchronize(config.DEVICE)


class KernelTimer:
    """Accumulating wall-clock timer that waits for the device so
    asynchronous launches don't hide kernel time."""

    def __init__(self):
        self.records = defaultdict(list)

    @contextlib.contextmanager
    def time(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            # drain the device queue so the measurement covers the kernels
            _drain()
            self.records[name].append(time.perf_counter() - start)

    def timeit(self, name, fn, *args, repeat=10, warmup=1, **kwargs):
        """Run fn repeatedly (after warmup) and record per-call seconds.
        Returns (min_seconds, result)."""
        result = None
        for _ in range(warmup):
            result = fn(*args, **kwargs)
            _drain()
        for _ in range(repeat):
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            _drain()
            self.records[name].append(time.perf_counter() - t0)
        return min(self.records[name][-repeat:]), result

    def summary(self):
        return {
            name: {
                "calls": len(times),
                "total_s": sum(times),
                "min_s": min(times),
                "mean_s": sum(times) / len(times),
            }
            for name, times in self.records.items()
        }


@contextlib.contextmanager
def trace(log_dir=os.path.join(tempfile.gettempdir(), "pgmpy_tpu_torch_trace")):
    """``torch.profiler`` trace context (CPU activity, and CUDA activity when
    a card is present); on exit it writes a Chrome trace
    (``trace_<pid>_<ns>.json``) into ``log_dir``, viewable in
    ``chrome://tracing`` or Perfetto.  Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        _drain()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        )
