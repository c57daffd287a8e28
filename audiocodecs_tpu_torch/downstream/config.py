"""3-axis composable config system (task × codec × dataset).

The port's copy of ``audiocodecs_tpu/downstream/config.py``: the same YAML
surface, merge rule and overrides; :func:`build_codec` builds the port's
codecs, on the card unless the caller passes ``device="cpu"``.

Capability parity with the reference's multi-YAML CLI (reference
``downstream/utils.py:37-70`` concatenates task+codec+dataset YAMLs and lets
``--key value`` override), re-designed without hyperpyyaml's
arbitrary-constructor execution: configs are plain data (YAML → dict),
merging enforces globally-unique keys, overrides are typed, and object
construction happens through explicit registries (codec registry, recipe
entry points) — no code execution from config files.

The merged config is dumped to the experiment directory for exact
reproduction (mirrors reference ``train_asr.py:224-227``).
"""

from __future__ import annotations

import ast
import json
import os
from typing import Any, Sequence

import yaml

__all__ = ["load_config", "merge_configs", "apply_overrides", "parse_cli",
           "dump_config", "build_codec"]


def load_config(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    from audiocodecs_tpu_torch.downstream import legacy

    if legacy.is_legacy_yaml(text):
        # reference hparams/_legacy monolithic hyperpyyaml file: parse the
        # tag surface as data (no code execution) and translate onto the
        # 3-axis key surface — see legacy.py.
        return legacy.translate_legacy(legacy.load_legacy_config(path))
    cfg = yaml.safe_load(text) or {}
    if not isinstance(cfg, dict):
        raise ValueError(f"{path}: top level must be a mapping")
    return cfg


def merge_configs(configs: Sequence[dict], sources: Sequence[str] = ()) -> dict:
    """Merge with globally-unique keys (reference requires the same,
    ``downstream/README.md:176-186``)."""
    out: dict = {}
    origin: dict = {}
    for i, cfg in enumerate(configs):
        src = sources[i] if i < len(sources) else f"config[{i}]"
        for k, v in cfg.items():
            if k in out:
                raise ValueError(
                    f"duplicate config key {k!r} from {src} "
                    f"(first defined in {origin[k]})"
                )
            out[k] = v
            origin[k] = src
    return out


def _parse_value(s: str) -> Any:
    # YAML-style booleans/null first: "--flag false" must not survive as
    # the (truthy) string "false"
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none"):
        return None
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def apply_overrides(cfg: dict, overrides: dict[str, Any]) -> dict:
    """Apply dotted-path overrides (``a.b=3``)."""
    cfg = json.loads(json.dumps(cfg))  # deep copy (config is plain data)
    for path, value in overrides.items():
        node = cfg
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
            if not isinstance(node, dict):
                raise ValueError(
                    f"cannot apply override {path!r}: {k!r} holds a "
                    f"scalar ({node!r}), not a mapping")
        node[keys[-1]] = value
    return cfg


def parse_cli(argv: Sequence[str]):
    """``[task.yaml codec.yaml dataset.yaml --key value ...]`` →
    (merged config, positional yaml paths)."""
    paths, overrides = [], {}
    i = 0
    argv = list(argv)
    while i < len(argv):
        a = argv[i]
        if a.startswith("--"):
            key = a[2:]
            if "=" in key:
                key, val = key.split("=", 1)
            else:
                i += 1
                if i >= len(argv):
                    raise ValueError(f"missing value for --{key}")
                val = argv[i]
            overrides[key] = _parse_value(val)
        else:
            paths.append(a)
        i += 1
    cfg = merge_configs([load_config(p) for p in paths], paths)
    return apply_overrides(cfg, overrides), paths


def dump_config(cfg: dict, out_dir: str, name: str = "config.yaml") -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=True)
    return path


def build_codec(cfg: dict, sample_rate: int, mode: str = "reconstruct",
                device=None):
    """Instantiate a codec of the port from the config's ``codec:`` block,
    on ``device`` (the card when ``None``).

    Uniform parameter surface across codec configs (mirrors reference
    ``hparams/codecs/*.yaml``): ``name``, ``num_codebooks``,
    ``orig_sample_rate``, optional ``checkpoint`` (an ``.npz`` param tree
    in the reference package's layout, read with :func:`..utils.checkpoint.
    load_params` and mapped onto the model by :func:`..params.
    from_jax_params`), optional ``model_overrides`` (field overrides on the
    class's ``default_model_config`` dataclass, the reference's field
    names), plus free-form ``kwargs``.
    """
    import dataclasses

    from audiocodecs_tpu_torch.models import get_codec_class

    spec = dict(cfg["codec"])
    name = spec.pop("name")
    checkpoint = spec.pop("checkpoint", None)
    overrides = spec.pop("model_overrides", None)
    kwargs = dict(spec.pop("kwargs", {}))
    cls = get_codec_class(name)
    if overrides:
        base = cls.default_model_config(
            spec.get("orig_sample_rate", sample_rate)
        )

        def _coerce(field_val, v):
            if dataclasses.is_dataclass(field_val) and isinstance(v, dict):
                # nested architecture config (e.g. DyCAST's wavlm block)
                return dataclasses.replace(
                    field_val,
                    **{kk: tuple(vv) if isinstance(vv, list) else vv
                       for kk, vv in v.items()},
                )
            return tuple(v) if isinstance(v, list) else v

        overrides = {k: _coerce(getattr(base, k), v)
                     for k, v in overrides.items()}
        kwargs["model_config"] = dataclasses.replace(base, **overrides)
    codec = cls(sample_rate=sample_rate, mode=mode, device=device, **spec,
                **kwargs)
    if checkpoint:
        from audiocodecs_tpu_torch.params import flatten_tree, from_jax_params
        from audiocodecs_tpu_torch.utils.checkpoint import load_params

        # a full checkpoint in a mode that builds half the codec (encode:
        # no decoder): the parts the mode dropped are dropped here too
        built = {k.split(".")[0] for k in codec.state_dict()}
        tree = {k: v for k, v in flatten_tree(load_params(checkpoint)).items()
                if k.split(".")[0] in built}
        codec.load_state_dict(from_jax_params(tree, codec), strict=True)
    return codec
