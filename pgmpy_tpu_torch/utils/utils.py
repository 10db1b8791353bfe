"""Example-model zoo and data preprocessing helpers.

Port of the discrete part of ``pgmpy_tpu/utils/utils.py``.  The bundled
networks are read from this package's own data directory,
``pgmpy_tpu_torch/utils/example_models/*.bif.gz`` (byte-identical copies of
the JAX package's files).
The Gaussian networks, the dagitty teaching DAGs, ``discretize`` and the
pairwise-orientation helpers wait for later slices.

Examples
--------
>>> from pgmpy_tpu_torch.utils import get_example_model
>>> asia = get_example_model("asia")
>>> len(asia.nodes()), len(asia.get_cpds())
(8, 8)
"""

import os

import numpy as np
import pandas as pd

from pgmpy_tpu_torch.config import not_ported

_EXAMPLE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "example_models")

DISCRETE_MODELS = {
    "asia", "cancer", "earthquake", "sachs", "survey",
    "alarm", "barley", "child", "insurance", "mildew", "water",
    "hailfinder", "hepar2", "win95pts",
    "andes", "diabetes", "link", "munin1", "munin2", "munin3", "munin4",
    "pathfinder", "pigs", "munin",
}
GAUSSIAN_MODELS = {"ecoli70", "magic-niab", "magic-irri", "arth150"}


def get_example_model(model):
    """Load a bundled discrete example network by name."""
    if model in DISCRETE_MODELS:
        from pgmpy_tpu_torch.readwrite.bif import BIFReader

        path = os.path.join(_EXAMPLE_DIR, f"{model}.bif.gz")
        return BIFReader(path=path).get_model()
    if model in GAUSSIAN_MODELS:
        not_ported(f"get_example_model({model!r})", "Gaussian models, slice 4")
    raise ValueError(f"Unknown example model: {model}")


def get_dataset_type(data):
    """Classify a DataFrame as 'discrete', 'continuous' or 'mixed'."""
    dtypes = set()
    for col in data.columns:
        if pd.api.types.is_float_dtype(data[col]):
            dtypes.add("continuous")
        else:
            dtypes.add("discrete")
    if dtypes == {"continuous"}:
        return "continuous"
    if dtypes == {"discrete"}:
        return "discrete"
    return "mixed"


def preprocess_data(df, state_names=None):
    """Integer-code a DataFrame of discrete observations.

    Returns (codes ndarray [n, d] int32, variables list, state_names dict).
    This is the pandas -> device boundary codec: everything downstream
    works on the integer array.
    """
    variables = list(df.columns)
    if state_names is None:
        state_names = {}
    state_names = dict(state_names)
    codes = np.empty((df.shape[0], len(variables)), dtype=np.int32)
    for j, var in enumerate(variables):
        col = df[var]
        if var not in state_names:
            state_names[var] = sorted(col.dropna().unique().tolist(), key=lambda x: str(x))
        mapping = {s: i for i, s in enumerate(state_names[var])}
        codes[:, j] = col.map(mapping).fillna(-1).astype(np.int32)
    return codes, variables, state_names
