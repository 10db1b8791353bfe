"""Example-model zoo and data preprocessing helpers.

Port of the discrete and Gaussian parts of ``pgmpy_tpu/utils/utils.py``.  The
bundled networks are read from this package's own data directory,
``pgmpy_tpu_torch/utils/example_models/`` (``*.bif.gz`` discrete, ``*.json``
linear-Gaussian; byte-identical copies of the JAX package's files).
The dagitty teaching DAGs, ``discretize`` and the pairwise-orientation
helpers wait for later slices.

Examples
--------
>>> from pgmpy_tpu_torch.utils import get_example_model
>>> asia = get_example_model("asia")
>>> len(asia.nodes()), len(asia.get_cpds())
(8, 8)
"""

import json
import os

import numpy as np
import pandas as pd

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
    """Load a bundled example network by name: discrete networks from
    ``.bif.gz``, linear-Gaussian networks from ``.json``."""
    if model in DISCRETE_MODELS:
        from pgmpy_tpu_torch.readwrite.bif import BIFReader

        path = os.path.join(_EXAMPLE_DIR, f"{model}.bif.gz")
        return BIFReader(path=path).get_model()
    if model in GAUSSIAN_MODELS:
        from pgmpy_tpu_torch.factors.continuous import LinearGaussianCPD
        from pgmpy_tpu_torch.models.linear_gaussian_bn import LinearGaussianBayesianNetwork

        with open(os.path.join(_EXAMPLE_DIR, f"{model}.json")) as f:
            spec = json.load(f)
        lgbn = LinearGaussianBayesianNetwork()
        lgbn.add_nodes_from(spec["nodes"])
        lgbn.add_edges_from([tuple(arc) for arc in spec["arcs"]])
        cpds = []
        for var, cpd_spec in spec["cpds"].items():
            parents = cpd_spec.get("parents", [])
            coeffs = cpd_spec["coefficients"]
            beta = [float(coeffs["(Intercept)"][0])] + [
                float(coeffs[p][0]) for p in parents
            ]
            std = float(np.sqrt(cpd_spec["variance"][0]))
            cpds.append(LinearGaussianCPD(var, beta, std, evidence=parents))
        lgbn.add_cpds(*cpds)
        return lgbn
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
