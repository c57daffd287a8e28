"""The port stands alone: no module of ``audiocodecs_tpu_torch`` (nor
``chip_smoke.py``, nor ``tools/certify_torch.py``) imports ``jax``,
``audiocodecs_tpu`` or ``transformers``, and its entry points run on the
card unless the caller asks for the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "audiocodecs_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def _is_reference(name: str) -> bool:
    """``audiocodecs_tpu`` or below it; ``audiocodecs_tpu_torch`` is not."""
    return name == "jax" or name.startswith("jax.") or \
        name == "audiocodecs_tpu" or name.startswith("audiocodecs_tpu.")


def _is_transformers(name: str) -> bool:
    """``transformers``, which the card's machine does not install."""
    return name == "transformers" or name.startswith("transformers.")


def test_module_list_covers_the_slice():
    mods = _port_modules()
    for m in ("audiocodecs_tpu_torch.models.encodec",
              "audiocodecs_tpu_torch.models.dac",
              "audiocodecs_tpu_torch.models.mimi",
              "audiocodecs_tpu_torch.models.past",
              "audiocodecs_tpu_torch.models.seanet_rvq",
              "audiocodecs_tpu_torch.models.speechtokenizer",
              "audiocodecs_tpu_torch.models.wavtokenizer",
              "audiocodecs_tpu_torch.nn.streaming",
              "audiocodecs_tpu_torch.nn.transformer",
              "audiocodecs_tpu_torch.nn.vocos",
              "audiocodecs_tpu_torch.ops.dac_resunit",
              "audiocodecs_tpu_torch.ops.lstm_recurrence",
              "audiocodecs_tpu_torch.ops.seanet_resblock",
              "audiocodecs_tpu_torch.params",
              "audiocodecs_tpu_torch.quant.rvq",
              "audiocodecs_tpu_torch.ops._autograd",
              "audiocodecs_tpu_torch.parallel.train",
              "audiocodecs_tpu_torch.downstream.metrics.dsp",
              "audiocodecs_tpu_torch.utils.audio",
              "audiocodecs_tpu_torch.utils.checkpoint",
              "audiocodecs_tpu_torch.examples.train_codec",
              "audiocodecs_tpu_torch.models",
              "audiocodecs_tpu_torch.models.bigcodec",
              "audiocodecs_tpu_torch.examples.serve",
              "audiocodecs_tpu_torch.serving",
              "audiocodecs_tpu_torch.quant.certify",
              "audiocodecs_tpu_torch.quant.fsq",
              "audiocodecs_tpu_torch.models.audiodec",
              "audiocodecs_tpu_torch.models.hilcodec",
              "audiocodecs_tpu_torch.models.nanocodec",
              "audiocodecs_tpu_torch.nn.roformer",
              "audiocodecs_tpu_torch.nn.kaldi_fbank",
              "audiocodecs_tpu_torch.nn.w2vbert",
              "audiocodecs_tpu_torch.models.xcodec2",
              "audiocodecs_tpu_torch.models.stablecodec",
              "audiocodecs_tpu_torch.models.magicodec",
              "audiocodecs_tpu_torch.nn.wavlm",
              "audiocodecs_tpu_torch.nn.focalnet",
              "audiocodecs_tpu_torch.nn.ecapa",
              "audiocodecs_tpu_torch.nn.perceiver",
              "audiocodecs_tpu_torch.utils.melbank",
              "audiocodecs_tpu_torch.models.wavlm_kmeans",
              "audiocodecs_tpu_torch.models.dycast",
              "audiocodecs_tpu_torch.models.focalcodec",
              "audiocodecs_tpu_torch.models.bicodec",
              "audiocodecs_tpu_torch.nn.audiomae",
              "audiocodecs_tpu_torch.nn.ldm_unet",
              "audiocodecs_tpu_torch.nn.ldm_vae",
              "audiocodecs_tpu_torch.nn.hifigan",
              "audiocodecs_tpu_torch.models.semanticodec",
              "audiocodecs_tpu_torch.convert",
              "audiocodecs_tpu_torch.convert.torch_utils",
              "audiocodecs_tpu_torch.convert.encodec",
              "audiocodecs_tpu_torch.convert.dac",
              "audiocodecs_tpu_torch.convert.vendor_seanet",
              "audiocodecs_tpu_torch.convert.zoo",
              "audiocodecs_tpu_torch.convert.mimi",
              "audiocodecs_tpu_torch.convert.wavlm",
              "audiocodecs_tpu_torch.convert.w2vbert"):
        assert m in mods


def test_importing_every_module_pulls_in_neither_jax_nor_reference():
    """A fresh interpreter with only the repository on the path (no ambient
    site customisation, which may itself import jax)."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import audiocodecs_tpu_torch as p; p.Encodec; p.DAC; p.CodecConfig\n"
        "p.Mimi; p.SpeechTokenizer; p.WavTokenizer\n"
        "p.WavTokenizerModelConfig; p.SEANetRVQCodec; p.SEANetRVQConfig\n"
        "p.PAST; p.BigCodec; p.BigCodecModelConfig\n"
        "p.AudioDec; p.HILCodec; p.NanoCodec; p.XCodec2; p.StableCodec\n"
        "p.MagiCodec; p.XCodec2ModelConfig\n"
        "p.WavLMKmeans; p.DyCAST; p.FocalCodec; p.BiCodec\n"
        "p.SemantiCodec; p.SemantiCodecModelConfig\n"
        "from audiocodecs_tpu_torch.models import get_codec_class\n"
        "get_codec_class('bigcodec')\n"
        "from audiocodecs_tpu_torch.serving import apply_serving_preset\n"
        "apply_serving_preset('dac', 'fast')\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {"PATH": os.environ.get("PATH", ""), "PYTHONPATH": str(REPO),
           "HOME": os.environ.get("HOME", str(REPO)),
           "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=str(REPO), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "audiocodecs_tpu_torch.models.encodec" in loaded
    assert "audiocodecs_tpu_torch.models.dac" in loaded
    assert "audiocodecs_tpu_torch.models.mimi" in loaded
    assert "audiocodecs_tpu_torch.models.wavtokenizer" in loaded
    assert "audiocodecs_tpu_torch.models.past" in loaded
    assert "audiocodecs_tpu_torch.parallel.train" in loaded
    assert "audiocodecs_tpu_torch.examples.train_codec" in loaded
    assert "audiocodecs_tpu_torch.models.bigcodec" in loaded
    assert "audiocodecs_tpu_torch.examples.serve" in loaded
    assert "audiocodecs_tpu_torch.serving" in loaded
    assert "audiocodecs_tpu_torch.quant.certify" in loaded
    assert "audiocodecs_tpu_torch.models.xcodec2" in loaded
    assert "audiocodecs_tpu_torch.nn.w2vbert" in loaded
    assert "audiocodecs_tpu_torch.models.bicodec" in loaded
    assert "audiocodecs_tpu_torch.nn.wavlm" in loaded
    assert "audiocodecs_tpu_torch.models.semanticodec" in loaded
    assert "audiocodecs_tpu_torch.nn.ldm_unet" in loaded
    assert "audiocodecs_tpu_torch.convert.zoo" in loaded
    assert not [m for m in loaded if _is_reference(m)]
    assert not [m for m in loaded if _is_transformers(m)]


@pytest.mark.parametrize("path", ["audiocodecs_tpu_torch", "chip_smoke.py",
                                  "tools/certify_torch.py"])
def test_no_import_statement_names_jax_or_reference(path):
    files = [REPO / path] if path.endswith(".py") else sorted(
        (REPO / path).rglob("*.py"))
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.name}: {n}" for n in names
                    if _is_reference(n) or _is_transformers(n)]
    assert not bad


def test_default_device_is_the_card(monkeypatch):
    from audiocodecs_tpu_torch.codec import resolve_device
    from audiocodecs_tpu_torch.examples import serve
    from audiocodecs_tpu_torch.models import get_codec_class
    from audiocodecs_tpu_torch.models.bigcodec import BigCodec
    from audiocodecs_tpu_torch.models.dac import DAC
    from audiocodecs_tpu_torch.models.encodec import Encodec
    from audiocodecs_tpu_torch.models.mimi import Mimi
    from audiocodecs_tpu_torch.models.past import PAST
    from audiocodecs_tpu_torch.models.seanet_rvq import SEANetRVQCodec
    from audiocodecs_tpu_torch.models.speechtokenizer import SpeechTokenizer
    from audiocodecs_tpu_torch.models.wavtokenizer import WavTokenizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Encodec(24000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DAC(44100, 44100)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpeechTokenizer(16000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Mimi(24000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WavTokenizer(24000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SEANetRVQCodec(16000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PAST(16000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BigCodec(16000)
    for name in ("audiodec", "hilcodec", "nanocodec", "xcodec2",
                 "stablecodec", "magicodec", "wavlm_kmeans", "dycast",
                 "focalcodec", "bicodec", "semanticodec"):
        cls = get_codec_class(name)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(cls.default_model_config().sampling_rate)
    # the server's entry point asks for the card too (before any request),
    # in every serving tier
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--codec", "bigcodec", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--codec", "encodec", "--requests", "1"])
    for quality in ("exact", "balanced", "fast"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--codec", "dac", "--quality", quality,
                        "--requests", "1"])
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


def test_certify_tool_stands_alone_and_defaults_to_the_card():
    """``tools/certify_torch.py`` in a fresh interpreter without CUDA: it
    asks for the card and raises, having imported neither jax nor the
    reference package."""
    code = (
        "import json, sys\n"
        "sys.path.insert(0, 'tools')\n"
        "import certify_torch\n"
        "try:\n"
        "    certify_torch.main(['--batch', '1', '--seconds', '0.1'])\n"
        "except RuntimeError as e:\n"
        "    print('raised', e)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {"PATH": os.environ.get("PATH", ""), "PYTHONPATH": str(REPO),
           "HOME": os.environ.get("HOME", str(REPO)),
           "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=str(REPO), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("raised") and "CUDA" in lines[0]
    loaded = json.loads(lines[-1])
    assert "audiocodecs_tpu_torch.quant.certify" in loaded
    assert not [m for m in loaded if _is_reference(m)]


def test_train_entry_point_defaults_to_the_card(monkeypatch, tmp_path):
    """Without ``--device`` the trainer asks for the card and raises where
    there is none; it does not fall back to the CPU."""
    from audiocodecs_tpu_torch.examples import train_codec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_codec.main(["--steps", "1", "--out",
                          str(tmp_path / "ckpt.npz")])
    assert not (tmp_path / "ckpt.npz").exists()


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, or on a machine without CUDA, it exits non-zero
    and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    env = {"PATH": os.environ.get("PATH", ""), "HOME": str(tmp_path),
           "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(lone)], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
