"""Build the CUDA sources under ``csrc/`` into shared libraries at first use.

Each library is compiled with ``nvcc`` for ``sm_90a`` (Hopper) into
``pgmpy_tpu_torch/_build/`` (git-ignored), under a name keyed on a hash of
its sources and flags, so a stale library is never loaded.  The sources
expose plain ``extern "C"`` launchers that ``ctypes`` calls with raw device
pointers and the current CUDA stream; nothing includes PyTorch's headers, so
a build takes seconds.  Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()  # guards the two dicts below
_building = {}  # name -> the lock its build holds, so that two sources build at once
_loaded = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: building the CUDA kernels needs the CUDA toolkit "
        "(nvcc on PATH, or CUDA_HOME)"
    )


def load_library(name, sources):
    """Compile ``sources`` (file names under ``csrc/``) into one shared
    library, once per process, and return it as a ``ctypes.CDLL``.  Builds of
    different libraries may run at once, from different threads."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        building = _building.setdefault(name, threading.Lock())
    with building:
        if name in _loaded:
            return _loaded[name]
        paths = [os.path.join(CSRC, s) for s in sources]
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in paths:
            with open(path, "rb") as fh:
                digest.update(fh.read())
        target = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
        if not os.path.exists(target):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{target}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {name} ({' '.join(cmd)}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, target)
        lib = ctypes.CDLL(target)
        with _lock:
            _loaded[name] = lib
        return lib
