"""Legacy monolithic hparams bridge (reference ``hparams/_legacy/*``).

The port's copy of ``audiocodecs_tpu/downstream/legacy.py``; it resolves a
legacy ``codec:`` block against the port's registry
(:mod:`audiocodecs_tpu_torch.models`), whose names are the reference's.

The reference keeps one pre-3-axis hyperpyyaml file per task x dataset x
codec (e.g. the reference's ``downstream/hparams/_legacy/asr/LibriSpeech/
encodec.yaml``): flat scalars carry the run configuration, ``!ref <key>``
interpolates/copies other keys, ``!PLACEHOLDER`` marks values the user
must override, and tagged blocks (``!new:``/``!name:``/``!apply:``)
construct torch modules *inside the config*.

This module is a DATA-LEVEL bridge. It parses the hyperpyyaml tag surface
WITHOUT executing any code (the whole point of this config system — see
``config.py`` module docstring), resolves ``!ref`` interpolation and
arithmetic, keeps ``!PLACEHOLDER`` keys visible for CLI override,
translates the keys our recipes consume onto the 3-axis surface (codec
block, augmentation knobs, run-opt renames), and records every dropped
code-constructing block under ``legacy_dropped`` so nothing disappears
silently.  ``config.load_config`` routes here automatically when a YAML
file uses hyperpyyaml tags, so a reference-layout legacy file loads
directly (``parse_cli([legacy.yaml, "--data_folder", ...])``).

Out of scope (documented, not silent): torch module hyper-blocks beyond
the knobs our recipes read (the recipes build their own modules from the
flat keys), and SpeechBrain-only keys (``__set_seed``, ``cache_folder``).
"""

from __future__ import annotations

import ast
import operator
import re
from typing import Any

import yaml

__all__ = ["is_legacy_yaml", "load_legacy_config", "translate_legacy"]

_TAG_RE = re.compile(r"!(ref|copy|PLACEHOLDER|new:|name:|apply:)")
_REF_TOKEN = re.compile(r"<([^<>]+)>")


def is_legacy_yaml(text: str) -> bool:
    """True if the YAML text uses hyperpyyaml tags (legacy format)."""
    return _TAG_RE.search(text) is not None


class _Ref:
    """Unresolved ``!ref``/``!copy`` expression, e.g. ``results/<task>/<seed>``."""

    def __init__(self, expr: str):
        self.expr = expr

    def __repr__(self):  # pragma: no cover - debug aid
        return f"_Ref({self.expr!r})"


class _Placeholder:
    """``!PLACEHOLDER`` — a value the user must supply via CLI override."""

    def __repr__(self):  # pragma: no cover - debug aid
        return "!PLACEHOLDER"


_PLACEHOLDER = _Placeholder()


class _LegacyLoader(yaml.SafeLoader):
    pass


def _ref_constructor(loader, node):
    return _Ref(loader.construct_scalar(node))


def _placeholder_constructor(loader, node):
    return _PLACEHOLDER


def _module_constructor(kind):
    """``!new:pkg.Cls``/``!name:pkg.fn``/``!apply:pkg.fn`` → inert dict.

    The target is recorded, kwargs/args are parsed as data, nothing is
    imported or called.
    """

    def construct(loader, suffix, node):
        out = {"_legacy_tag": kind, "_legacy_target": suffix}
        if isinstance(node, yaml.MappingNode):
            out.update(loader.construct_mapping(node, deep=True))
        elif isinstance(node, yaml.SequenceNode):
            out["_legacy_args"] = loader.construct_sequence(node, deep=True)
        elif isinstance(node, yaml.ScalarNode) and node.value:
            out["_legacy_args"] = [loader.construct_scalar(node)]
        return out

    return construct


_LegacyLoader.add_constructor("!ref", _ref_constructor)
_LegacyLoader.add_constructor("!copy", _ref_constructor)
_LegacyLoader.add_constructor("!PLACEHOLDER", _placeholder_constructor)
for _kind in ("new", "name", "apply"):
    _LegacyLoader.add_multi_constructor(f"!{_kind}:", _module_constructor(_kind))


_ARITH_OPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv,
    ast.Pow: operator.pow, ast.Mod: operator.mod,
    ast.USub: operator.neg, ast.UAdd: operator.pos,
}


def _eval_arith(expr: str):
    """Safely evaluate a pure-arithmetic expression (hyperpyyaml allows
    ``!ref <a> * <b>``); returns None if the expression is not arithmetic."""
    try:
        tree = ast.parse(expr.strip(), mode="eval")
    except SyntaxError:
        return None

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return node.value
        if isinstance(node, ast.BinOp) and type(node.op) in _ARITH_OPS:
            return _ARITH_OPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _ARITH_OPS:
            return _ARITH_OPS[type(node.op)](ev(node.operand))
        raise ValueError

    try:
        return ev(tree)
    except (ValueError, ZeroDivisionError, OverflowError):
        return None


def _is_resolved(v) -> bool:
    if isinstance(v, _Ref):
        return False
    if isinstance(v, dict):
        return all(_is_resolved(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return all(_is_resolved(x) for x in v)
    return True


def _resolve_ref(ref: _Ref, top: dict):
    """Resolve one ``!ref`` against the (partially resolved) top-level map.

    Returns the value, or the ref itself if a dependency is not resolved
    yet (the caller iterates to a fixpoint)."""
    expr = ref.expr
    tokens = _REF_TOKEN.findall(expr)
    if not tokens:
        return expr
    vals = {}
    for t in tokens:
        if t not in top:
            raise KeyError(f"!ref <{t}>: no such top-level key")
        v = top[t]
        if isinstance(v, _Ref) or not _is_resolved(v):
            return ref  # dependency not ready
        vals[t] = v
    # exactly one token and nothing else → type-preserving copy
    if expr.strip() == f"<{tokens[0]}>":
        return vals[tokens[0]]
    if any(isinstance(vals[t], _Placeholder) for t in tokens):
        return _PLACEHOLDER
    sub = _REF_TOKEN.sub(lambda m: str(vals[m.group(1)]), expr)
    arith = _eval_arith(sub)
    return sub if arith is None else arith


def _resolve_tree(v, top: dict):
    if isinstance(v, _Ref):
        return _resolve_ref(v, top)
    if isinstance(v, dict):
        return {k: _resolve_tree(x, top) for k, x in v.items()}
    if isinstance(v, list):
        return [_resolve_tree(x, top) for x in v]
    return v


def load_legacy_config(path: str) -> dict:
    """Parse a hyperpyyaml legacy file into plain data (no code execution),
    with ``!ref`` resolved to a fixpoint and ``!PLACEHOLDER`` kept as a
    sentinel for :func:`translate_legacy` to surface."""
    with open(path) as f:
        cfg = yaml.load(f, Loader=_LegacyLoader) or {}
    if not isinstance(cfg, dict):
        raise ValueError(f"{path}: top level must be a mapping")
    for _ in range(len(cfg) + 8):  # fixpoint: each pass resolves ≥1 ref
        cfg = {k: _resolve_tree(v, cfg) for k, v in cfg.items()}
        if _is_resolved(cfg):
            break
    else:
        stuck = [k for k, v in cfg.items() if not _is_resolved(v)]
        raise ValueError(f"{path}: unresolvable !ref cycle in keys {stuck}")
    return cfg


# SpeechBrain-only keys with no recipe meaning here.
_DROP_KEYS = {"__set_seed", "cache_folder", "tokenizer_cls", "blank_id"}

# Legacy run-opt name → our recipe key (same semantics).
_RENAMES = {
    "num_epochs": "epochs",
    "train_batch_size": "batch_size",
    "hidden_size": "probe_hidden",
    # legacy files feed this into their MultiHeadEmbedding block — our
    # recipes' probe embedding table (the codec-axis `embedding_dim` of the
    # 3-axis yamls never passes through this translator)
    "embedding_dim": "embedding_dim_probe",
    "patient": "lr_patience",
    "annealing_factor": "lr_annealing_factor",
    "improvement_threshold": "lr_improvement_threshold",
}

# Knobs lifted out of the DropFreq / DropChunk module blocks
# (same names + semantics as our task-yaml augmentation surface).
_AUG_KNOBS = (
    "drop_freq_low", "drop_freq_high", "drop_freq_count_low",
    "drop_freq_count_high", "drop_freq_width",
    "drop_length_low", "drop_length_high", "drop_count_low",
    "drop_count_high",
)


def _is_module_block(v) -> bool:
    return isinstance(v, dict) and "_legacy_tag" in v


def _contains_module_block(v) -> bool:
    if _is_module_block(v):
        return True
    if isinstance(v, dict):
        return any(_contains_module_block(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return any(_contains_module_block(x) for x in v)
    return False


def translate_legacy(cfg: dict) -> dict:
    """Map a resolved legacy dict onto the 3-axis recipe surface.

    Scalars pass through (renamed where the run-opt name differs), the
    ``codec:`` module block becomes our declarative ``codec:`` block,
    augmentation knobs are lifted out of their module blocks, remaining
    module blocks are dropped and listed in ``legacy_dropped``, and
    ``!PLACEHOLDER`` keys become ``None`` + a ``legacy_placeholders``
    list (override them with ``--key value`` like the reference does)."""
    out: dict[str, Any] = {}
    dropped: list[str] = []
    placeholders: list[str] = []

    # codec module block → declarative codec block (registry name keyed
    # off the reference class name, which our registry mirrors 1:1).
    codec = cfg.get("codec")
    if _is_module_block(codec) and codec["_legacy_target"].startswith("audiocodecs."):
        from audiocodecs_tpu_torch.models import _CODEC_REGISTRY

        cls_name = codec["_legacy_target"].rsplit(".", 1)[1]
        by_class = {cls: name for name, (_, cls) in _CODEC_REGISTRY.items()}
        if cls_name not in by_class:
            raise ValueError(f"legacy codec class {cls_name!r} not in registry")
        spec = {k: v for k, v in codec.items()
                if not k.startswith("_legacy") and k not in ("sample_rate", "mode")}
        out["codec"] = {"name": by_class[cls_name], **spec}

    # augmentation knobs out of their module blocks
    for block_key in ("drop_freq", "drop_chunk"):
        block = cfg.get(block_key)
        if _is_module_block(block):
            for k in _AUG_KNOBS:
                if k in block:
                    out[k] = block[k]
    aug = cfg.get("augmentation")
    if _is_module_block(aug) and "augment_prob" in aug and "augment_prob" not in cfg:
        out["augment_prob"] = aug["augment_prob"]

    for k, v in cfg.items():
        if k == "codec":
            if "codec" not in out:
                dropped.append(k)
            continue
        if k in _DROP_KEYS:
            dropped.append(k)
            continue
        if _contains_module_block(v):
            dropped.append(k)
            continue
        k = _RENAMES.get(k, k)
        if isinstance(v, _Placeholder):
            placeholders.append(k)
            v = None
        if isinstance(v, str) and k == "dataset":
            v = v.lower()
        out.setdefault(k, v)

    if dropped:
        out["legacy_dropped"] = sorted(dropped)
    if placeholders:
        out["legacy_placeholders"] = sorted(placeholders)
    return out
