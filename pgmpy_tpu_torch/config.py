"""Global configuration for pgmpy_tpu_torch.

PyTorch counterpart of ``pgmpy_tpu.config``.  The config controls

* ``DTYPE``  — the default floating dtype for factor values: float32, with
  float64 as an opt-in for parity testing.
* ``DEVICE`` — the torch device every factor table lives on.  It defaults to
  ``"cuda"``; ``set_device("cpu")`` selects the CPU on purpose.  Nothing
  switches to the CPU on its own when no GPU is found: a factor built for
  ``"cuda"`` without a card raises.
* ``MESH`` — a :class:`pgmpy_tpu_torch.parallel.mesh.Mesh` kept for the
  caller (store only: the sharded entry points take their mesh as an
  argument).
* ``SHOW_PROGRESS`` — progress bars for long host-side loops.

Float32 matrix products are pinned to full f32 (no TF32), the counterpart of
``Precision.HIGHEST`` in the JAX package: TF32 keeps about three decimal
digits, which costs posterior accuracy.
"""

import logging

import torch

# Smallest NORMAL float32.  Kept identical to the JAX package: every clamp in
# a zero-division guard uses it, and CUDA's flush-to-zero modes would turn a
# subnormal literal into 0.0 just as XLA does.
TINY = 1.1754944e-38

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


class _DuplicateFilter(logging.Filter):
    """Suppress consecutive duplicate log records."""

    def __init__(self):
        super().__init__()
        self._last = None

    def filter(self, record):
        current = record.getMessage()
        if current != self._last:
            self._last = current
            return True
        return False


logger = logging.getLogger("pgmpy_tpu_torch")
logger.addFilter(_DuplicateFilter())


class Config:
    def __init__(self):
        self._dtype = torch.float32
        self._int_dtype = torch.int32
        self._device = torch.device("cuda")
        self._show_progress = True
        self._default_einsum_optimize = "greedy"
        self._mesh = None

    # -- dtype ------------------------------------------------------------
    @property
    def DTYPE(self):
        return self._dtype

    def set_dtype(self, dtype):
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        elif not isinstance(dtype, torch.dtype):
            # numpy dtypes and scalar types (np.float64, "float64", ...)
            import numpy as np

            dtype = getattr(torch, np.dtype(dtype).name)
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64. Got: {dtype}")
        self._dtype = dtype

    def get_dtype(self):
        return self._dtype

    @property
    def INT_DTYPE(self):
        return self._int_dtype

    # -- compute backend (API parity shim) --------------------------------
    @property
    def BACKEND(self):
        return "torch"

    def set_backend(self, backend, device=None, dtype=None):
        if backend not in ("jax", "numpy", "torch"):
            raise ValueError(f"backend must be one of jax/numpy/torch. Got: {backend}")
        if backend != "torch":
            logger.warning(
                f"pgmpy_tpu_torch has a single PyTorch backend; ignoring backend={backend!r}."
            )
        if device is not None:
            self.set_device(device)
        if dtype is not None:
            self.set_dtype(dtype)

    # -- device -----------------------------------------------------------
    @property
    def DEVICE(self):
        return self._device

    def set_device(self, device):
        """Select the device factor tables live on.  ``"cuda"`` raises when
        no CUDA device is present instead of quietly using the CPU."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("config.set_device('cuda'): no CUDA device is available")
        self._device = device

    # -- mesh -------------------------------------------------------------
    @property
    def MESH(self):
        """The mesh stored by :meth:`set_mesh`.  Nothing in the package reads
        it: every sharded entry point takes its mesh as an argument."""
        return self._mesh

    def set_mesh(self, mesh):
        self._mesh = mesh

    # -- progress ---------------------------------------------------------
    @property
    def SHOW_PROGRESS(self):
        return self._show_progress

    def set_show_progress(self, show: bool):
        self._show_progress = bool(show)

    def get_show_progress(self):
        return self._show_progress


config = Config()


def not_ported(feature, roadmap_item):
    """Raise for a part of pgmpy_tpu that this package has not ported yet;
    ``roadmap_item`` names the ROADMAP.md entry that will port it."""
    raise NotImplementedError(
        f"{feature} is not ported to pgmpy_tpu_torch yet (ROADMAP.md: {roadmap_item})"
    )


def as_tensor(values, dtype=None):
    """``values`` (array-like or tensor) as a tensor on ``config.DEVICE``,
    in ``dtype`` (default ``config.DTYPE``)."""
    return torch.as_tensor(
        values, dtype=config.DTYPE if dtype is None else dtype, device=config.DEVICE
    )


def to_numpy(values):
    """A read-only host numpy array of a tensor (or the array itself if it is
    not one).  For a CPU tensor the array shares its memory, so it is marked
    read-only: writing to it would change a factor behind the ``values``
    setter's back."""
    if isinstance(values, torch.Tensor):
        out = values.detach().cpu().numpy()
        out.flags.writeable = False
        return out
    import numpy as np

    return np.asarray(values)
