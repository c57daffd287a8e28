"""The port stands alone: no module of ``audiocodecs_tpu_torch`` (nor
``chip_smoke.py``) imports ``jax`` or ``audiocodecs_tpu``, and its entry
points run on the card unless the caller asks for the CPU."""

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
              "audiocodecs_tpu_torch.examples.train_codec"):
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
        "p.PAST\n"
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
    assert not [m for m in loaded if _is_reference(m)]


@pytest.mark.parametrize("path", ["audiocodecs_tpu_torch", "chip_smoke.py"])
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
            bad += [f"{f.name}: {n}" for n in names if _is_reference(n)]
    assert not bad


def test_default_device_is_the_card(monkeypatch):
    from audiocodecs_tpu_torch.codec import resolve_device
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
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


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
