"""Param trees as ``.npz`` files, in the reference package's format, and
training state as ``torch.save`` files.

Counterpart of ``audiocodecs_tpu/utils/checkpoint.py``. The npz half: a
nested dict/list tree of arrays is flattened to ``{"a::b::#0::w": array}``
(``::`` between levels, ``#i`` for a list index) and empty containers
survive as sentinel keys. A file written here loads with the reference's
``load_params`` and the other way round. Save a port model with
:func:`audiocodecs_tpu_torch.params.to_jax_params` first, to get the
reference's tree and layouts.

The training-state half takes the place of the reference's Orbax
checkpointer: the model's and the optimizer's state dicts and the
quantizer's EMA state with its step counter
(:func:`..parallel.train.init_codec_opt_state`), written with
``torch.save`` and read back with ``weights_only=True``. A run resumed from
such a file continues bit for bit.
"""

from __future__ import annotations

import numpy as np

import torch

__all__ = ["save_params", "load_params", "flatten_pytree", "unflatten_pytree",
           "load_model_state", "save_train_state", "load_train_state"]

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


def load_model_state(path: str, model: torch.nn.Module) -> dict:
    """The weights of ``path`` as ``model``'s state dict: a ``.npz`` param
    tree in the reference's format (:func:`load_params`, then
    :func:`..params.from_jax_params`) or a ``torch.save`` state dict
    (``weights_only``), as the port's conversion tool writes."""
    if str(path).endswith(".npz"):
        from audiocodecs_tpu_torch.params import from_jax_params

        return from_jax_params(load_params(path), model)
    return torch.load(path, map_location="cpu", weights_only=True)


def _split_opt_state(opt_state):
    """``(optimizer, qstate or None)`` of either form of
    :func:`..parallel.train.make_codec_train_step`'s ``opt_state``."""
    if isinstance(opt_state, tuple):
        return opt_state
    return opt_state, None


def save_train_state(path: str, model: torch.nn.Module, opt_state) -> None:
    """Write ``model``'s state dict, the optimizer's and, under the EMA rule,
    the quantizer's state (``cluster_size``, ``embed_sum``, ``steps``) to
    ``path``. ``opt_state`` is the optimizer or ``(optimizer, qstate)``."""
    optimizer, qstate = _split_opt_state(opt_state)
    state = {"model": model.state_dict(),
             "optimizer": optimizer.state_dict()}
    if qstate is not None:
        state["qstate"] = dict(qstate)
    torch.save(state, path)


def load_train_state(path: str, model: torch.nn.Module, opt_state) -> None:
    """Restore a :func:`save_train_state` file in place into ``model`` and
    ``opt_state`` (built as for a fresh run, on the device to resume on).
    Raises if the file's keys do not match them."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    optimizer, qstate = _split_opt_state(opt_state)
    if ("qstate" in state) != (qstate is not None):
        raise ValueError(f"{path}: the file and the run to resume disagree "
                         f"on the EMA quantizer state (file: "
                         f"{'qstate' in state}, run: {qstate is not None})")
    model.load_state_dict(state["model"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    if qstate is not None:
        saved = state["qstate"]
        if sorted(saved) != sorted(qstate):
            raise ValueError(f"{path}: quantizer state keys {sorted(saved)} "
                             f"!= {sorted(qstate)}")
        for k, v in saved.items():
            qstate[k] = (v.to(qstate[k].device) if isinstance(v, torch.Tensor)
                         else v)
