"""Build an earlier commit's kernels beside this tree's, to time both
versions on one card in one call.

On a machine with git (in the repository), unpack a commit's kernel
sources and wrappers into the git-ignored ``.chip_scratch/parent/``:

    python3 tools/parent_kernels.py unpack [REV]     # default 846aee6

On the card, ``chip_smoke.py`` (and any script) then calls
:func:`start_builds` and :func:`load` with the wrappers it wants (any of
``WRAPPERS``: a module of ``pgmpy_tpu_torch/ops/`` and the ``csrc/`` source
it builds, e.g. ``{"ancestral": "ancestral.cu", "einsum": "einsum_plan.cu"}``;
by default all of them).  They compile that commit's sources with this
tree's ``nvcc`` flags into ``pgmpy_tpu_torch/_build/`` (one ``nvcc`` each,
started together, named ``parent_<rev>_<wrapper>``) and import the commit's
wrappers as modules of their own whose library loader returns those builds:
their ``sweep_cuda``, ``launch_plan``, ``nuts_step_cuda`` and the rest
launch the commit's kernels, with their own launch counters.  What those
modules import from this tree's package (``ops._build``, ``config``, the
level schedule's helpers in ``ops.ancestral``, ``utils.mathext``) is this
tree's.  ``tools/stamp_kernels.py`` builds stamped copies of either
version through the same two calls.
"""

import ctypes
import hashlib
import importlib.util
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARENT = os.path.join(ROOT, ".chip_scratch", "parent")
DEFAULT_REV = "846aee6"
# wrapper module of pgmpy_tpu_torch/ops/ -> the csrc/ source it builds
WRAPPERS = {"bincount": "bincount.cu", "jt": "jt_calibrate.cu",
            "table_gather": "table_gather.cu", "ancestral": "ancestral.cu",
            "gibbs": "gibbs.cu", "einsum": "einsum_plan.cu", "hmc": "hmc.cu",
            "loopy": "loopy_bp.cu"}


def unpack(rev=DEFAULT_REV, dest=PARENT):
    """``git archive`` of the commit's ``ops/`` and ``csrc/`` into ``dest``,
    with the commit's name in ``dest/REV``."""
    os.makedirs(dest, exist_ok=True)
    paths = ["pgmpy_tpu_torch/ops", "pgmpy_tpu_torch/csrc"]
    archive = subprocess.run(["git", "archive", rev, *paths], cwd=ROOT, check=True,
                             capture_output=True).stdout
    subprocess.run(["tar", "-x", "-C", dest], input=archive, check=True)
    with open(os.path.join(dest, "REV"), "w") as fh:
        fh.write(rev + "\n")
    return dest


def available(root=PARENT):
    return os.path.exists(os.path.join(root, "REV"))


def revision(root=PARENT):
    with open(os.path.join(root, "REV")) as fh:
        return fh.read().strip()


def start_builds(root=PARENT, wrappers=None):
    """Start one ``nvcc`` per kernel source of the tree at ``root`` for
    ``wrappers`` ({wrapper module: csrc source}; default ``WRAPPERS``, those
    the tree has); returns what :func:`load` waits for."""
    sys.path.insert(0, ROOT)
    from pgmpy_tpu_torch.ops import _build

    csrc = os.path.join(root, "pgmpy_tpu_torch", "csrc")
    ops = os.path.join(root, "pgmpy_tpu_torch", "ops")
    if wrappers is None:
        wrappers = {name: source for name, source in WRAPPERS.items()
                    if os.path.exists(os.path.join(csrc, source))
                    and os.path.exists(os.path.join(ops, f"{name}.py"))}
    headers = sorted(os.path.join(csrc, h) for h in os.listdir(csrc) if h.endswith(".cuh"))
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    running = {}
    for name, source in wrappers.items():
        path = os.path.join(csrc, source)
        digest = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
        for part in [path] + headers:
            with open(part, "rb") as fh:
                digest.update(fh.read())
        target = os.path.join(_build.BUILD_DIR, f"libparent_{revision(root)}_{name}_"
                                                f"{digest.hexdigest()[:16]}.so")
        proc = None
        if not os.path.exists(target):
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", target + ".tmp", path]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
        running[name] = (proc, target)
    return {"root": root, "running": running, "started": time.time()}


def _bind(module, lib):
    """Make ``module``'s library loader return ``lib``: the name it imported
    at its top (``load_library``) and, for a wrapper that imports the loader
    inside its ``_library``, ``ops._build.load_library`` while that runs."""
    from pgmpy_tpu_torch.ops import _build

    module.load_library = lambda *_: lib
    original = getattr(module, "_library", None)
    if original is None:
        return

    def _library():
        saved = _build.load_library
        _build.load_library = lambda *_: lib
        try:
            return original()
        finally:
            _build.load_library = saved

    module._library = _library


def load(builds):
    """Wait for the builds of :func:`start_builds`, then import the tree's
    wrappers over them: returns ({wrapper: module}, {wrapper: (build
    seconds, ptxas report)})."""
    root = builds["root"]
    modules, report = {}, {}
    for name, (proc, target) in builds["running"].items():
        out = ""
        if proc is not None:
            out = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {revision(root)}'s {name}:\n{out}")
            os.replace(target + ".tmp", target)
        report[name] = (time.time() - builds["started"], out)
        lib = ctypes.CDLL(target)
        spec = importlib.util.spec_from_file_location(
            f"parent_{name}", os.path.join(root, "pgmpy_tpu_torch", "ops", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _bind(module, lib)
        modules[name] = module
    return modules, report


def main():
    args = sys.argv[1:]
    if not args or args[0] != "unpack":
        print(__doc__)
        return 2
    dest = unpack(*(args[1:2] or [DEFAULT_REV]))
    print(f"unpacked {revision(dest)} into {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
