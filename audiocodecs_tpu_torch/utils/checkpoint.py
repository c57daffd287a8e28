"""Param trees as ``.npz`` files, in the reference package's format.

Counterpart of the npz half of ``audiocodecs_tpu/utils/checkpoint.py``: a
nested dict/list tree of arrays is flattened to ``{"a::b::#0::w": array}``
(``::`` between levels, ``#i`` for a list index) and empty containers
survive as sentinel keys. A file written here loads with the reference's
``load_params`` and the other way round. Save a port model with
:func:`audiocodecs_tpu_torch.params.to_jax_params` first, to get the
reference's tree and layouts.
"""

from __future__ import annotations

import numpy as np

__all__ = ["save_params", "load_params", "flatten_pytree", "unflatten_pytree"]

_SEP = "::"
_EMPTY_DICT = "__empty_dict__"
_EMPTY_LIST = "__empty_list__"


def flatten_pytree(tree, prefix: str = "") -> dict:
    """Nested dict/list tree → flat ``{path: ndarray}``. Empty containers
    are kept as sentinel keys; tuples are stored as lists."""
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[f"{prefix}{_SEP}{_EMPTY_DICT}" if prefix else _EMPTY_DICT] = (
                np.zeros((), np.int8))
        for k, v in tree.items():
            out.update(flatten_pytree(
                v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out[f"{prefix}{_SEP}{_EMPTY_LIST}" if prefix else _EMPTY_LIST] = (
                np.zeros((), np.int8))
        for i, v in enumerate(tree):
            out.update(flatten_pytree(
                v, f"{prefix}{_SEP}#{i}" if prefix else f"#{i}"))
    else:
        out[prefix] = np.asarray(tree)
    return out


def unflatten_pytree(flat: dict):
    """Inverse of :func:`flatten_pytree` (lists recovered from ``#i``
    keys)."""
    root: dict = {}
    for path, value in flat.items():
        keys = path.split(_SEP)
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def fix(node):
        if isinstance(node, dict):
            if _EMPTY_DICT in node:
                return {}
            if _EMPTY_LIST in node:
                return []
            if node and all(k.startswith("#") for k in node):
                return [fix(node[f"#{i}"]) for i in range(len(node))]
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def save_params(path: str, params) -> None:
    """Write a tree of arrays to ``path`` (``np.savez``)."""
    np.savez(path, **flatten_pytree(params))


def load_params(path: str):
    """Read a tree written by :func:`save_params`."""
    with np.load(path) as data:
        return unflatten_pytree({k: data[k] for k in data.files})
