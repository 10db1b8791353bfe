"""Build the CUDA sources under ``csrc/`` into shared libraries at first use.

Each library is compiled with ``nvcc`` for ``sm_90a`` (Hopper) into
``pgmpy_tpu_torch/_build/`` (git-ignored), under a name keyed on a hash of
its sources and flags, so a stale library is never loaded.  The sources
expose plain ``extern "C"`` launchers that ``ctypes`` calls with raw device
pointers and the current CUDA stream; nothing includes PyTorch's headers, so
a build takes seconds.  Nothing here runs at import time.  ``BUILDS`` keeps
each library built in this process: its build's seconds and what ``ptxas -v``
said of every kernel (registers, shared memory, spills).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()  # one build or load at a time
_loaded = {}
BUILDS = {}  # name -> {"seconds": ..., "ptxas": ...} of each library built in this process


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


def _target(name, sources):
    """(the library's path, keyed on its sources and flags; the source paths)."""
    paths = [os.path.join(CSRC, s) for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in paths:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so"), paths


def build_libraries(libraries):
    """Compile every library of ``libraries`` ({name: source file names under
    ``csrc/``}) that is not built yet: one ``nvcc`` each, all started
    together.  Records each build's seconds and ptxas report in ``BUILDS``."""
    with _lock:
        running = {}
        for name, sources in libraries.items():
            if name in _loaded:
                continue
            target, paths = _target(name, sources)
            if os.path.exists(target):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{target}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
            log = open(f"{tmp}.log", "w+")
            running[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                             cmd, log, tmp, target)
        started = time.time()
        while any(proc.poll() is None for proc, *_ in running.values()):
            for name, (proc, *_) in running.items():
                if proc.poll() is not None and name not in BUILDS:
                    BUILDS[name] = {"seconds": time.time() - started}
            time.sleep(0.02)
        failed = []
        for name, (proc, cmd, log, tmp, target) in running.items():
            log.seek(0)
            out = log.read().strip()
            log.close()
            os.remove(f"{tmp}.log")
            BUILDS.setdefault(name, {"seconds": time.time() - started})["ptxas"] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed building {name} ({' '.join(cmd)}):\n{out}")
            else:
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("\n".join(failed))


def load_library(name, sources):
    """Compile ``sources`` (file names under ``csrc/``) into one shared
    library if it is not built yet, once per process, and return it as a
    ``ctypes.CDLL``."""
    with _lock:
        if name in _loaded:  # every launch comes here: no hashing of the sources
            return _loaded[name]
    build_libraries({name: sources})
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(_target(name, sources)[0])
        return _loaded[name]
