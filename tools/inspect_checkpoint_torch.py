"""Checkpoint inspector for the PyTorch port: a checkpoint's module tree,
and its diff against a family's documented schema.

The port's twin of ``tools/inspect_checkpoint.py``, on the port's schemas
(``audiocodecs_tpu_torch.convert.zoo``, ``.ldm``) and without JAX:

    python tools/inspect_checkpoint_torch.py <ckpt.pt | hf_dir> \\
        [--depth 3] [--json out.json] [--family <name>] \\
        [--emit-key-map key_map.json]

It groups a state dict (or a dict of state dicts) into a module tree with
parameter counts and example shapes, flags weight-norm pairs, LSTM layers
and EMA codebooks, and with ``--family`` diffs the keys against the
family's schema at its codec's ``default_model_config()``: the missing,
the unexpected and the mismatched keys. ``--emit-key-map`` drafts a rename
overlay from that diff by matching shapes (``audiocodecs_tpu_torch/
convert/overlay.py``'s ``propose_key_map``): finish its ``_unresolved``
entries by hand, then convert with ``tools/convert_checkpoints_torch.py
convert <family> ... --key-map key_map.json``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# family → (the codec's module, its class)
_MODELS = {
    "speechtokenizer": ("speechtokenizer", "SpeechTokenizer"),
    "past": ("past", "PAST"),
    "wavtokenizer": ("wavtokenizer", "WavTokenizer"),
    "bigcodec": ("bigcodec", "BigCodec"),
    "xcodec2": ("xcodec2", "XCodec2"),
    "stablecodec": ("stablecodec", "StableCodec"),
    "nanocodec": ("nanocodec", "NanoCodec"),
    "audiodec": ("audiodec", "AudioDec"),
    "focalcodec": ("focalcodec", "FocalCodec"),
    "magicodec": ("magicodec", "MagiCodec"),
    "bicodec": ("bicodec", "BiCodec"),
    "hilcodec": ("hilcodec", "HILCodec"),
    "dycast": ("dycast", "DyCAST"),
}
_LDM = ("semanticodec-ldm", "hifigan")


def load_state_dicts(path: str) -> dict:
    """A checkpoint → ``{part: {key: shape}}``: one part ``""``, or one a
    state dict where the file holds several (BigCodec's)."""
    from audiocodecs_tpu_torch.convert.checkpoint_files import (
        load_checkpoint)

    obj = load_checkpoint(path)
    if obj and all(isinstance(v, dict) for v in obj.values()):
        return {k: {kk: tuple(vv.shape) for kk, vv in v.items()
                    if hasattr(vv, "shape")} for k, v in obj.items()}
    return {"": {k: tuple(v.shape) for k, v in obj.items()
                 if hasattr(v, "shape")}}


def summarize(shapes: dict, depth: int = 3) -> dict:
    tree: dict = defaultdict(lambda: {"params": 0, "leaves": 0,
                                      "examples": []})
    for key, shape in shapes.items():
        node = tree[".".join(key.split(".")[:depth])]
        node["params"] += math.prod(shape)
        node["leaves"] += 1
        if len(node["examples"]) < 3:
            node["examples"].append(f"{key} {list(shape)}")
    return dict(tree)


def annotate(shapes: dict) -> list:
    notes = []
    for root in sorted({k.rsplit(".", 1)[0] for k in shapes}):
        if f"{root}.weight_g" in shapes and f"{root}.weight_v" in shapes:
            notes.append(f"weight-norm conv: {root} "
                         f"{list(shapes[f'{root}.weight_v'])}")
        if f"{root}.weight_ih_l0" in shapes:
            notes.append(f"LSTM at {root} (bidirectional="
                         f"{f'{root}.weight_ih_l0_reverse' in shapes})")
        if root.endswith("_codebook") and f"{root}.embed" in shapes:
            notes.append(f"EMA-VQ codebook: {root}.embed "
                         f"{list(shapes[f'{root}.embed'])}")
    return notes


def resolve_schema(shapes: dict, family: str, cfg=None):
    """(the family's schema, the observed keys) → ``{key: shape}`` each, at
    ``cfg`` (by default the codec's ``default_model_config()``, the shapes
    a released checkpoint has). BigCodec's are two parts."""
    from audiocodecs_tpu_torch.convert import ldm, zoo

    obs = shapes.get("", {}) or next(iter(shapes.values()))
    if family in _LDM:
        from audiocodecs_tpu_torch.models.semanticodec import SemantiCodec

        c = dataclasses.replace(cfg or SemantiCodec.default_model_config(),
                                decoder_variant="ldm")
        if family == "hifigan":
            return ldm.hifigan_schema(c.vocoder_cfg), obs
        schema = {f"first_stage_model.{k}": v
                  for k, v in ldm.vae_schema(c.vae_cfg).items()}
        schema.update({f"model.diffusion_model.{k}": v
                       for k, v in ldm.unet_schema(c.unet()).items()})
        schema["scale_factor"] = ()
        return schema, obs
    if family not in _MODELS:
        raise SystemExit(f"unknown --family {family!r}; choose from "
                         f"{sorted(_MODELS) + list(_LDM)}")
    module, cls = _MODELS[family]
    c = cfg if cfg is not None else getattr(importlib.import_module(
        f"audiocodecs_tpu_torch.models.{module}"), cls).default_model_config()
    schema = getattr(zoo, f"{family}_schema")(c)
    if family == "bigcodec":
        return schema, {part: shapes.get(part, {}) for part in schema}
    return schema, obs


def _diff(schema: dict, obs: dict) -> dict:
    return {"missing": sorted(set(schema) - set(obs)),
            "unexpected": sorted(set(obs) - set(schema)),
            "shape_mismatch": sorted(
                k for k in set(schema) & set(obs)
                if tuple(schema[k]) != tuple(obs[k]))}


def diff_vs_schema(shapes: dict, family: str, cfg=None) -> dict:
    schema, obs = resolve_schema(shapes, family, cfg)
    if family == "bigcodec":
        return {part: _diff(schema[part], obs[part]) for part in schema}
    return _diff(schema, obs)


def emit_key_map(shapes: dict, family: str, path: str, cfg=None) -> dict:
    """Draft an overlay for ``family`` from the diff and write it to
    ``path``."""
    from audiocodecs_tpu_torch.convert.overlay import propose_key_map

    schema, obs = resolve_schema(shapes, family, cfg)
    key_map = propose_key_map(schema, obs)
    with open(path, "w") as f:
        json.dump(key_map, f, indent=1, sort_keys=True)
    print(f"wrote {path}: {len(key_map.get('rename', {}))} renames, "
          f"{len(key_map.get('prefix', {}))} prefix rules, "
          f"{len(key_map.get('_unresolved', {}))} unresolved (finish those "
          f"by hand, then convert with --key-map {path})")
    return key_map


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    if not argv:
        print(__doc__)
        return 2

    def arg(name, default=None, cast=str):
        return cast(argv[argv.index(name) + 1]) if name in argv else default

    path, family = argv[0], arg("--family")
    shapes = load_state_dicts(path)
    report = {part or "(root)": {"num_keys": len(sd),
                                 "tree": summarize(sd, arg("--depth", 3,
                                                           int)),
                                 "notes": annotate(sd)}
              for part, sd in shapes.items()}
    if family:
        report["schema_diff"] = diff_vs_schema(shapes, family)
    emit = arg("--emit-key-map")
    if emit:
        if not family:
            print("--emit-key-map requires --family")
            return 2
        if family == "bigcodec":
            print("--emit-key-map: bigcodec is a two-part checkpoint; draft "
                  "each part's map from schema_diff by hand")
            return 2
        emit_key_map(shapes, family, emit)
    text = json.dumps(report, indent=2)
    out = arg("--json")
    if out:
        with open(out, "w") as f:
            f.write(text)
        print(f"wrote {out}")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
