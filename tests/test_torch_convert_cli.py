"""The port's key-map overlay and its convert and inspect tools
(``tools/convert_checkpoints_torch.py``, ``tools/inspect_checkpoint_torch.
py``), run in-process through ``main([...])``.

The overlay's three functions give the JAX module's results on the cases
of ``tests/test_key_map_overlay.py``. ``convert`` reads an HF directory
that ``transformers``' ``save_pretrained`` wrote (its ``config.json`` and
safetensors or ``pytorch_model.bin``) without ``transformers`` and gives
what the family's converter gives on the model's own state dict; it reads
a vendor file (HILCodec's, with and without ``--allow-partial``), and
``inspect`` diffs a file against a schema and drafts the key map that
``convert --key-map`` repairs it with.
"""

import json
import re
import warnings

import pytest
import torch

from audiocodecs_tpu.convert import overlay as jax_overlay  # noqa: E402
from audiocodecs_tpu_torch.convert import overlay, zoo  # noqa: E402
from audiocodecs_tpu_torch.convert.checkpoint_files import (  # noqa: E402
    read_safetensors,
)
from audiocodecs_tpu_torch.convert.dac import (  # noqa: E402
    convert_dac_state_dict,
    dac_config_from_hf,
)
from audiocodecs_tpu_torch.convert.encodec import (  # noqa: E402
    convert_encodec_state_dict,
    encodec_config_from_hf,
)
from audiocodecs_tpu_torch.convert.mimi import (  # noqa: E402
    convert_mimi_state_dict,
    mimi_config_from_hf,
)
from audiocodecs_tpu_torch.convert.torch_utils import (  # noqa: E402
    synth_state_dict,
)
from audiocodecs_tpu_torch.convert.wavlm import (  # noqa: E402
    convert_wavlm_state_dict,
)
from audiocodecs_tpu_torch.models import available_codecs  # noqa: E402
from audiocodecs_tpu_torch.models.hilcodec import HILCodec  # noqa: E402
from test_torch_convert import (  # noqa: E402
    _hf_dac,
    _hf_encodec,
    _hf_mimi,
    _hf_tower,
)
from tools import convert_checkpoints_torch as convert_cli  # noqa: E402
from tools import inspect_checkpoint_torch as inspect_cli  # noqa: E402
from zoo_pairs import assert_same_state  # noqa: E402

# ----------------------------------------------------------------------- #
# The overlay against the JAX package's
# ----------------------------------------------------------------------- #

_APPLY = {
    "none": ({"a.b": 1}, None),
    "rename_beats_prefix": (
        {"enc.x": 1, "enc.y": 2, "enc.deep.z": 3},
        {"rename": {"enc.x": "special.x"},
         "prefix": {"enc.": "encoder.", "enc.deep.": "decoder.deep."}}),
    "regex_and_drop": (
        {"blocks_0.w": 1, "blocks_3.w": 2, "opt.step": 3, "opt.lr": 4,
         "epoch": 5},
        {"drop": ["opt.*", "epoch"],
         "regex": [[r"^blocks_(\d+)\.", r"blocks.\1."]]}),
    "collision": ({"a": 1, "b": 2}, {"rename": {"a": "c", "b": "c"}}),
    "typo_rename": ({"a": 1}, {"rename": {"a_typo": "b"}}),
    "typo_drop": ({"a": 1}, {"drop": ["nope"]}),
}


def _outcome(fn, *args):
    """The result, or the exception's type and message."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 (compared across packages)
        return type(e), str(e)


@pytest.mark.parametrize("case", list(_APPLY))
def test_apply_key_map_is_the_jax_modules(case):
    sd, km = _APPLY[case]
    got = _outcome(overlay.apply_key_map, sd, km)
    assert got == _outcome(jax_overlay.apply_key_map, sd, km)
    if km is None:
        assert got == sd and got is not sd


@pytest.mark.parametrize("content", [
    {"rename": {}, "_unresolved": {"x": {}}, "_note": "hi"},
    {"renmae": {}}, ["not", "an", "object"], {"prefix": {"v.": "s."}}])
def test_load_key_map_is_the_jax_modules(content, tmp_path):
    path = tmp_path / "km.json"
    path.write_text(json.dumps(content))
    got = _outcome(overlay.load_key_map, str(path))
    assert got == _outcome(jax_overlay.load_key_map, str(path))
    if content == {"prefix": {"v.": "s."}}:
        assert overlay.apply_key_map({"v.w": 7}, str(path)) == {"s.w": 7}


def _stable_cfg():
    import dataclasses

    from audiocodecs_tpu_torch.models.stablecodec import StableCodec

    return dataclasses.replace(
        StableCodec.default_model_config(bottleneck=(2, 15625)),
        patch=8, dim=16, depth_outer=2, depth_inner=1, num_heads=2)


def _renamed(sd, prefixes):
    out = {}
    for k, v in sd.items():
        for src, dst in prefixes.items():
            if k.startswith(src):
                k = dst + k[len(src):]
                break
        out[k] = v
    return out


@pytest.mark.parametrize("case", ["prefix_rename", "ambiguous"])
def test_propose_key_map_is_the_jax_modules(case):
    """A pure prefix rename of StableCodec's towers is drafted in full
    (shape matches told apart by their longest common suffix); two keys of
    one shape with nothing else to go on stay unresolved."""
    if case == "ambiguous":
        schema = {"a.w": (4, 4), "b.w": (4, 4)}
        observed = {"x.w": (4, 4), "y.w": (4, 4)}
    else:
        cfg = _stable_cfg()
        schema = zoo.stablecodec_schema(cfg)
        sd = synth_state_dict(schema)
        vendor = _renamed(sd, {"encoder.": "model.enc.",
                               "decoder.": "model.dec."})
        observed = {k: v.shape for k, v in vendor.items()}
    km = overlay.propose_key_map(schema, observed)
    assert km == jax_overlay.propose_key_map(schema, observed)
    if case == "ambiguous":
        assert not km.get("rename") and len(km["_unresolved"]) == 2
    else:
        assert not km.get("_unresolved")
        assert_same_state(
            zoo.convert_stablecodec_state_dict(vendor, cfg, key_map=km),
            zoo.convert_stablecodec_state_dict(sd, cfg))


# ----------------------------------------------------------------------- #
# convert: HF directories without transformers
# ----------------------------------------------------------------------- #

def _hf_family(family):
    """(the HF model, the port's converter of its state dict)."""
    if family == "encodec":
        model, hf = _hf_encodec()
        cfg = encodec_config_from_hf(hf)
        return model, lambda sd: convert_encodec_state_dict(sd, cfg)
    if family == "dac":
        model, hf = _hf_dac()
        cfg = dac_config_from_hf(hf)
        return model, lambda sd: convert_dac_state_dict(sd, cfg)
    if family == "mimi":
        model, hf = _hf_mimi()
        cfg = mimi_config_from_hf(hf)
        return model, lambda sd: convert_mimi_state_dict(sd, cfg)
    model, _, cfg = _hf_tower("wavlm", "large")
    return model, lambda sd: convert_wavlm_state_dict(sd, cfg)


@pytest.mark.parametrize("safe", [True, False],
                         ids=["safetensors", "pytorch_model.bin"])
@pytest.mark.parametrize("family", ["encodec", "dac", "mimi", "wavlm"])
def test_convert_reads_an_hf_directory(family, safe, tmp_path):
    model, direct = _hf_family(family)
    model.save_pretrained(tmp_path / "hf", safe_serialization=safe)
    out = tmp_path / "out.pt"
    assert convert_cli.main(["convert", family, str(tmp_path / "hf"),
                             str(out)]) == 0
    got = torch.load(out, weights_only=True)
    assert_same_state(got, direct(model.state_dict()))


def test_read_safetensors_is_the_formats_reader(tmp_path):
    """Each dtype, a 0-d and an empty tensor, as ``safetensors`` writes
    them."""
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 4, generator=g),
               "f16": torch.randn(5, generator=g).half(),
               "bf16": torch.randn(2, 3, generator=g).bfloat16(),
               "f64": torch.randn(2, generator=g).double(),
               "i64": torch.arange(6).reshape(2, 3),
               "u8": torch.arange(4, dtype=torch.uint8),
               "bool": torch.tensor([True, False]),
               "scalar": torch.tensor(0.5), "empty": torch.zeros(0, 3)}
    path = tmp_path / "t.safetensors"
    save_file(tensors, str(path), metadata={"format": "pt"})
    got = read_safetensors(str(path))
    assert sorted(got) == sorted(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k


# ----------------------------------------------------------------------- #
# convert and inspect: a vendor file (HILCodec's, at its published config)
# ----------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def hilcodec_file(tmp_path_factory):
    cfg = HILCodec.default_model_config()
    sd = {k: torch.from_numpy(v) for k, v in
          synth_state_dict(zoo.hilcodec_schema(cfg)).items()}
    path = tmp_path_factory.mktemp("hil") / "hilcodec.ckpt"
    torch.save({"state_dict": sd, "epoch": 3}, path)
    return cfg, sd, path


def test_convert_a_vendor_file(hilcodec_file, tmp_path):
    cfg, sd, path = hilcodec_file
    out = tmp_path / "out.pt"
    assert convert_cli.main(["convert", "hilcodec", str(path),
                             str(out)]) == 0
    got = torch.load(out, weights_only=True)
    assert_same_state(got, zoo.convert_hilcodec_full_state_dict(sd, cfg))
    HILCodec(cfg.sampling_rate, model_config=cfg, state_dict=got,
             device="cpu")


def test_hilcodec_towers_that_do_not_convert(hilcodec_file, tmp_path,
                                             capsys):
    """Renamed towers: exit 1 naming the inspect tool, or with
    ``--allow-partial`` a warning and the codebooks alone."""
    cfg, sd, _ = hilcodec_file
    path = tmp_path / "renamed.pt"
    torch.save(_renamed(sd, {"encoder.": "enc."}), path)
    out = tmp_path / "out.pt"
    assert convert_cli.main(["convert", "hilcodec", str(path),
                             str(out)]) == 1
    assert "inspect_checkpoint_torch" in capsys.readouterr().err
    assert not out.exists()
    with pytest.warns(UserWarning, match="did not convert"):
        assert convert_cli.main(["convert", "hilcodec", str(path), str(out),
                                 "--allow-partial"]) == 0
    got = torch.load(out, weights_only=True)
    assert torch.equal(got["codebooks"], torch.stack(
        [sd[f"quantizer.layers.{k}.embed"]
         for k in range(cfg.num_quantizers)]))
    assert convert_cli.main(["convert", "stablecodec", str(path), str(out),
                             "--allow-partial"]) == 2


def test_inspect_diffs_and_drafts_the_key_map(hilcodec_file, tmp_path,
                                              capsys):
    """A clean file diffs empty; a renamed one shows the renames, and
    the drafted key map converts it to the clean file's state dict."""
    cfg, sd, path = hilcodec_file
    report = tmp_path / "report.json"
    assert inspect_cli.main([str(path), "--family", "hilcodec", "--json",
                             str(report)]) == 0
    diff = json.loads(report.read_text())["schema_diff"]
    assert diff == {"missing": [], "unexpected": [], "shape_mismatch": []}

    renamed = tmp_path / "renamed.pt"
    torch.save(_renamed(sd, {"decoder.blocks.": "decoder.units."}), renamed)
    km = tmp_path / "km.json"
    assert inspect_cli.main([str(renamed), "--family", "hilcodec",
                             "--emit-key-map", str(km)]) == 0
    text = capsys.readouterr().out
    assert re.search(r"wrote .*km\.json: \d+ renames, \d+ prefix", text)
    report = json.loads(text[text.index("{"):])
    assert report["schema_diff"]["unexpected"] and \
        report["(root)"]["num_keys"] == len(sd)
    out = tmp_path / "out.pt"
    assert convert_cli.main(["convert", "hilcodec", str(renamed), str(out),
                             "--key-map", str(km)]) == 0
    assert_same_state(torch.load(out, weights_only=True),
                      zoo.convert_hilcodec_full_state_dict(sd, cfg))


def test_inspect_reads_two_part_files_and_the_ldm(tmp_path):
    """BigCodec's ``{"CodecEnc", "generator"}`` diffs part by part;
    ``semanticodec-ldm``'s schema is the LDM's under its prefixes."""
    shapes = {"CodecEnc": {"conv_blocks.0.weight_g": (48, 1, 1)},
              "generator": {}}
    diff = inspect_cli.diff_vs_schema(shapes, "bigcodec")
    assert set(diff) == {"CodecEnc", "generator"}
    assert "conv_blocks.0.weight_v" in diff["CodecEnc"]["missing"]
    schema, _ = inspect_cli.resolve_schema({"": {}}, "semanticodec-ldm")
    assert schema["scale_factor"] == () and any(
        k.startswith("model.diffusion_model.") for k in schema)
    with pytest.raises(SystemExit, match="unknown --family"):
        inspect_cli.resolve_schema({"": {}}, "utmos")


def test_warmup_fails_loudly_without_a_card(monkeypatch, capsys):
    """Every codec is built on the card: without one each fails, each is
    reported, and the exit code is not 0."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert convert_cli.main(["warmup"]) == 1
    out = capsys.readouterr().out
    n = len(available_codecs())
    assert f"warmup: 0/{n} families built" in out
    assert out.count("FAILED") == n


def test_usage_errors():
    assert convert_cli.main([]) == 2
    assert convert_cli.main(["convert", "encodec", "a"]) == 2
    assert convert_cli.main(["convert", "nope", "a", "b"]) == 2
    assert convert_cli.main(["convert", "encodec", "a", "b",
                             "--key-map", "k.json"]) == 2
