"""LinearEstimator: minimal OLS effect estimator.

Port of ``pgmpy_tpu/inference/linear_model.py`` (reference:
``pgmpy/inference/LinearModel.py:5-33``, statsmodels OLS there).  The JAX
package solves on the host with ``np.linalg.lstsq`` in float64; the port
solves in float64 on ``config.DEVICE`` through the shared minimum-norm solve
(``ops/lstsq.py``) and reads the coefficients back once.
"""

import numpy as np
import torch

from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.ops.lstsq import lstsq


class LinearEstimator:
    def __init__(self, model):
        self.model = model

    def fit(self, X, Y, Z=None, data=None, missing="none", **kwargs):
        """Regress Y on [1, X, Z]; the X coefficient estimates the effect.
        ``missing``: "none" (use all rows), "drop" (drop NaN rows), or
        "raise" (error on NaNs) — reference statsmodels semantics."""
        Z = sorted(Z, key=str) if Z else []
        cols = [Y, X] + Z
        sub = data[cols]
        if missing == "drop":
            sub = sub.dropna()
        elif missing == "raise" and sub.isna().any().any():
            raise ValueError("data contains missing values")
        values = torch.as_tensor(np.ascontiguousarray(sub.to_numpy(dtype=np.float64)),
                                 device=config.DEVICE)
        y = values[:, 0]
        mat = torch.cat([torch.ones_like(y)[:, None], values[:, 1:]], dim=1)
        beta = lstsq(mat, y)
        resid_std = torch.std(y - mat @ beta, correction=0)
        host = torch.cat([beta, resid_std[None]]).cpu().numpy()
        self.coef_ = host[:-1]
        self.ate = float(host[1])
        self.resid_std = float(host[-1])
        return self

    def _get_ate(self):
        return self.ate

    def summary(self):
        return {"ate": self.ate, "coef": self.coef_, "resid_std": self.resid_std}
