"""Example-model zoo, discretization, data preprocessing and the
pairwise-orientation helpers.

Port of ``pgmpy_tpu/utils/utils.py`` but its dagitty teaching DAGs.  The
bundled networks are read from this package's own data directory,
``pgmpy_tpu_torch/utils/example_models/`` (``*.bif.gz`` discrete, ``*.json``
linear-Gaussian; byte-identical copies of the JAX package's files).
``llm_pairwise_orient`` imports ``litellm`` only when it is called without a
``completion_fn``.

Examples
--------
>>> import pandas as pd
>>> from pgmpy_tpu_torch.utils import discretize, get_example_model
>>> asia = get_example_model("asia")
>>> len(asia.nodes()), len(asia.get_cpds())
(8, 8)
>>> df = pd.DataFrame({"x": [0.1, 0.4, 0.6, 0.9]})
>>> binned = discretize(df, cardinality={"x": 2},
...                     labels={"x": ["lo", "hi"]})
>>> binned["x"].tolist()
['lo', 'lo', 'hi', 'hi']
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


def discretize(data, cardinality, labels=None, method="rounding"):
    """Discretize continuous columns into ``cardinality`` bins.

    method: "rounding" (equal-width ``pd.cut`` with ``include_lowest``) or
    "quantile" (``pd.qcut``); ``labels`` maps column -> bin label list.
    """
    labels = labels or {}
    out = {}
    for col in data.columns:
        card = cardinality[col] if isinstance(cardinality, dict) else cardinality
        col_labels = labels.get(col) if isinstance(labels, dict) else labels
        if method == "quantile":
            out[col] = pd.qcut(data[col], q=card, labels=col_labels)
        else:
            out[col] = pd.cut(data[col], bins=card, include_lowest=True, labels=col_labels)
    return pd.DataFrame(out)


def llm_pairwise_orient(
    x,
    y,
    descriptions,
    system_prompt=None,
    llm_model="gemini/gemini-1.5-flash",
    completion_fn=None,
    **kwargs,
):
    """Ask an LLM for the orientation of an edge between ``x`` and ``y``.

    The prompt and the parsing of its 1/2 answer are the reference's.  The
    transport is injectable: ``completion_fn(model=..., messages=[...])`` must
    return an object with ``.choices[0].message.content`` (the litellm /
    OpenAI response shape).  Without ``completion_fn`` it imports litellm.
    """
    if completion_fn is None:
        try:
            from litellm import completion as completion_fn
        except ImportError as e:
            raise ImportError(
                f"{e}. litellm is required for using LLM based pairwise "
                "orientation. Please install using: pip install litellm "
                "(or pass completion_fn=... to inject a transport)."
            ) from None

    if system_prompt is None:
        system_prompt = "You are an expert in Causal Inference"
    prompt = f""" {system_prompt}. You are
      given two variables with the following descriptions:
        <A>: {descriptions[x]}
        <B>: {descriptions[y]}

        Which of the following two options is the most likely causal direction between them:
        1. <A> causes <B>
        2. <B> causes <A>

        Return a single number (1 or 2) as your answer. I do not need the reasoning behind it.
        Do not add any formatting in the answer.
        """
    response = completion_fn(model=llm_model, messages=[{"role": "user", "content": prompt}])
    response_txt = response.choices[0].message.content.strip().lower().replace("*", "")
    if response_txt in ("a", "1"):
        return (x, y)
    if response_txt in ("b", "2"):
        return (y, x)
    raise ValueError("Results from the LLM are unclear. Try calling the function again.")


def manual_pairwise_orient(x, y):
    """Ask the user on the terminal for the direction between ``x`` and
    ``y``: ``(source, target)``, or ``None`` for "no edge"."""
    user_input = input(
        f"Select the edge direction between"
        f" {x} and {y}. \n 1. {x} -> {y} \n 2. {x} <- {y} \n"
        "3. No edge \n Please enter 1, 2 or 3: "
    )
    if user_input == "1":
        return (x, y)
    if user_input == "2":
        return (y, x)
    if user_input == "3":
        return None
