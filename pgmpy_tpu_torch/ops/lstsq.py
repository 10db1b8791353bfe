"""Minimum-norm least squares on the device: the one solve that
``LinearEstimator``, ``NaiveAdjustmentRegressor``'s default regressor and
``IVEstimator`` share.

The JAX package solves with ``jnp.linalg.lstsq`` (``IVEstimator``) and host
``np.linalg.lstsq`` (the other two): both an SVD that drops the singular
values below ``eps * max(M, N)`` times the largest and return the
minimum-norm answer of a rank-deficient design.  On CUDA
``torch.linalg.lstsq`` offers only the ``gels`` method, which assumes full
column rank, so this solve is written out: a reduced QR of the tall design
(``M >= N``), an SVD of its ``N x N`` factor (of the design itself when it is
wide), and the same cut-off, in float64 on ``config.DEVICE``.
"""

import numpy as np
import torch

from pgmpy_tpu_torch.config import config


def lstsq(a, b):
    """The minimum-norm ``x`` minimising ``||a @ x - b||``.

    ``a`` is ``(M, N)`` and ``b`` is ``(M,)`` or ``(M, K)``, each array-like
    or a tensor; both are taken to float64 on ``config.DEVICE`` and so is
    the answer.  Singular values below ``finfo(float64).eps * max(M, N)``
    times the largest count as zero, the rule of ``jnp.linalg.lstsq`` and of
    ``np.linalg.lstsq(rcond=None)``."""
    a, b = (x.to(config.DEVICE, torch.float64) if isinstance(x, torch.Tensor)
            else torch.from_numpy(np.array(x, dtype=np.float64)).to(config.DEVICE)
            for x in (a, b))
    m, n = a.shape
    if m >= n:
        q, r = torch.linalg.qr(a, mode="reduced")
        u, s, vh = torch.linalg.svd(r, full_matrices=False)
        u = q @ u
    else:
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
    cutoff = torch.finfo(torch.float64).eps * max(m, n) * s[:1]
    keep = s >= cutoff
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    rhs = u.T @ b
    if rhs.dim() == 1:
        return vh.T @ (s_inv * rhs)
    return vh.T @ (s_inv[:, None] * rhs)
