"""Sampler-state checkpoint/resume.

Port of ``pgmpy_tpu/sampling/checkpoint.py``.  Long-running chain samplers
can save and resume: chain states + the random generator's state + a step
counter round-trip through one ``.npz`` file with the JAX package's keys
(``__n_leaves__``, ``__key__``, ``__step__``, ``leaf_i``, ``extra_*``).  The
place of the PRNG key is taken by the state of the run's ``torch.Generator``
(``get_state()``, a uint8 tensor whose layout belongs to the generator's
device type): a run resumed on the same kind of device continues with the
draws the uninterrupted run would have made.
"""

import numpy as np
import torch

from pgmpy_tpu_torch.config import config, to_numpy


def _flatten(tree):
    """(leaves, structure) of nested lists / tuples / dicts (keys in sorted
    order); anything else is a leaf."""
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(t) for t in tree]
        return [leaf for leaves, _ in parts for leaf in leaves], (type(tree), [s for _, s in parts])
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return [leaf for leaves, _ in parts for leaf in leaves], (dict, keys, [s for _, s in parts])
    return [tree], None


def _unflatten(structure, leaves):
    """Rebuild a tree of ``structure`` from an iterator over ``leaves``."""
    if structure is None:
        return next(leaves)
    if structure[0] is dict:
        _, keys, parts = structure
        return {k: _unflatten(s, leaves) for k, s in zip(keys, parts)}
    kind, parts = structure
    return kind(_unflatten(s, leaves) for s in parts)


def save_sampler_state(path, chain_states, key, step=0, extra=None):
    """Persist chain states (a tensor or nested lists / tuples / dicts of
    tensors), the generator ``key`` (a ``torch.Generator`` or the tensor its
    ``get_state()`` returned) and the step."""
    leaves, structure = _flatten(chain_states)
    if isinstance(key, torch.Generator):
        key = key.get_state()
    payload = {
        "__n_leaves__": np.asarray(len(leaves)),
        "__key__": to_numpy(key),
        "__step__": np.asarray(step),
        "__treedef__": np.frombuffer(repr(structure).encode(), dtype=np.uint8),
    }
    for i, leaf in enumerate(leaves):
        payload[f"leaf_{i}"] = to_numpy(leaf)
    if extra:
        for k, v in extra.items():
            payload[f"extra_{k}"] = to_numpy(v)
    np.savez(path, **payload)


def load_sampler_state(path, treedef_like=None):
    """Load (chain_states, key, step, extra).  The leaves come back as
    tensors on ``config.DEVICE``; ``key`` is the uint8 state tensor to hand
    to ``torch.Generator.set_state``.  ``treedef_like``: an example tree with
    the structure used at save time (lists/dicts of tensors); when None, a
    flat list of leaves is returned."""
    data = np.load(path, allow_pickle=False)
    n = int(data["__n_leaves__"])
    leaves = [torch.as_tensor(data[f"leaf_{i}"], device=config.DEVICE) for i in range(n)]
    key = torch.as_tensor(data["__key__"])
    step = int(data["__step__"])
    extra = {
        k[len("extra_"):]: data[k] for k in data.files if k.startswith("extra_")
    }
    if treedef_like is not None:
        states = _unflatten(_flatten(treedef_like)[1], iter(leaves))
    else:
        states = leaves
    return states, key, step, extra
