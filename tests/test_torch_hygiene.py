"""The port stands alone: no module of ``audiocodecs_tpu_torch`` (nor
``chip_smoke.py``, nor the port's tools ``tools/certify_torch.py``,
``tools/convert_checkpoints_torch.py`` and ``tools/inspect_checkpoint_
torch.py``) imports ``jax``, ``audiocodecs_tpu`` or ``transformers``, its
entry points run on the card unless the caller asks for the CPU, and its
converters read no environment."""

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


# long audio, native WAV I/O, train state and the SR evaluation path
SLICE_16 = (
    "audiocodecs_tpu_torch.utils",
    "audiocodecs_tpu_torch.utils.windowed",
    "audiocodecs_tpu_torch.utils.masking",
    "audiocodecs_tpu_torch.native",
    "audiocodecs_tpu_torch.native.wavio",
    "audiocodecs_tpu_torch.examples.reconstruct",
    "audiocodecs_tpu_torch.examples.stream",
    "audiocodecs_tpu_torch.examples.sweep_sr",
    "audiocodecs_tpu_torch.downstream.config",
    "audiocodecs_tpu_torch.downstream.legacy",
    "audiocodecs_tpu_torch.downstream.datasets",
    "audiocodecs_tpu_torch.downstream.datasets.manifest",
    "audiocodecs_tpu_torch.downstream.datasets.synthetic",
    "audiocodecs_tpu_torch.downstream.datasets.librispeech",
    "audiocodecs_tpu_torch.downstream.datasets.corpora",
    "audiocodecs_tpu_torch.downstream.datasets.loader",
    "audiocodecs_tpu_torch.downstream.metrics.base",
    "audiocodecs_tpu_torch.downstream.metrics.codebook_util",
    "audiocodecs_tpu_torch.downstream.metrics.stoi",
    "audiocodecs_tpu_torch.downstream.metrics.pesq",
    "audiocodecs_tpu_torch.downstream.metrics.dnsmos",
    "audiocodecs_tpu_torch.downstream.recipes",
    "audiocodecs_tpu_torch.downstream.recipes.common",
    "audiocodecs_tpu_torch.downstream.recipes.quality",
    "audiocodecs_tpu_torch.downstream.recipes.sr",
)


# the SR evaluation's profiler and its model-backed metrics
SLICE_17 = (
    "audiocodecs_tpu_torch.downstream.profiler",
    "audiocodecs_tpu_torch.downstream.metrics.utmos",
    "audiocodecs_tpu_torch.downstream.metrics.external",
    "audiocodecs_tpu_torch.downstream.metrics.dwer",
    "audiocodecs_tpu_torch.downstream.metrics.ppl",
    "audiocodecs_tpu_torch.downstream.metrics.text_norm",
    "audiocodecs_tpu_torch.downstream.models",
    "audiocodecs_tpu_torch.downstream.models.speaker_encoder",
    "audiocodecs_tpu_torch.nn.whisper",
    "audiocodecs_tpu_torch.nn.gpt2",
    "audiocodecs_tpu_torch.convert.whisper",
    "audiocodecs_tpu_torch.convert.gpt2",
    "audiocodecs_tpu_torch.convert.dnsmos",
    "audiocodecs_tpu_torch.convert.onnx_lite",
    "audiocodecs_tpu_torch.utils.bytebpe",
)


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
              "audiocodecs_tpu_torch.convert.w2vbert",
              "audiocodecs_tpu_torch.convert.overlay",
              "audiocodecs_tpu_torch.convert.audiomae",
              "audiocodecs_tpu_torch.convert.ldm",
              "audiocodecs_tpu_torch.convert.checkpoint_files",
              *SLICE_16, *SLICE_17):
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
                                  "tools/certify_torch.py",
                                  "tools/convert_checkpoints_torch.py",
                                  "tools/inspect_checkpoint_torch.py"])
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


def test_no_converter_reads_the_environment():
    """The converters take every choice as an argument (HILCodec's partial
    conversion is ``allow_partial=``): no module of the port's
    ``convert/`` names ``os.environ`` or ``os.getenv``."""
    files = sorted((PORT / "convert").glob("*.py"))
    assert len(files) >= 10
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Attribute) and node.attr in (
                    "environ", "getenv", "putenv"):
                bad.append(f"{f.name}: {ast.unparse(node)}")
            elif isinstance(node, ast.ImportFrom) and node.module == "os":
                bad += [f"{f.name}: from os import {a.name}"
                        for a in node.names]
    assert not bad


def _docstrings(tree) -> set:
    """The ids of the docstring nodes of a module, its classes and
    functions."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    getattr(first, "value", None), ast.Constant):
                out.add(id(first.value))
    return out


@pytest.mark.parametrize("module", SLICE_16 + SLICE_17)
def test_slice_modules_read_no_environment_and_no_reference_path(module):
    """No switch from the environment (the reference's ``ACX_NATIVE_WAVIO``,
    ``ACX_WAVIO_LIB`` and ``ACX_NATIVE_CACHE`` are not carried over) and no
    path into the JAX package: outside docstrings, no string names
    ``audiocodecs_tpu`` or a path under it, and nothing is imported from
    it."""
    rel = Path(*module.split("."))
    f = REPO / (f"{rel}.py" if (REPO / f"{rel}.py").is_file()
                else f"{rel}/__init__.py")
    tree = ast.parse(f.read_text())
    docs = _docstrings(tree)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in (
                "environ", "getenv", "putenv"):
            bad.append(ast.unparse(node))
        elif isinstance(node, ast.ImportFrom) and node.module == "os":
            bad += [f"from os import {a.name}" for a in node.names]
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            bad += [n for n in names if _is_reference(n)]
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in docs and (
                  node.value == "audiocodecs_tpu"
                  or "audiocodecs_tpu/" in node.value)):
            bad.append(repr(node.value))
    assert not bad, f"{f.name}: {bad}"


@pytest.mark.parametrize("copy,original", [
    ("audiocodecs_tpu_torch/csrc/wavio.cc", "csrc/wavio.cc"),
    ("audiocodecs_tpu_torch/downstream/metrics/dnsmos_v8.npz",
     "audiocodecs_tpu/downstream/metrics/dnsmos_v8.npz"),
    ("audiocodecs_tpu_torch/downstream/metrics/text_norm.py",
     "audiocodecs_tpu/downstream/metrics/text_norm.py"),
    ("audiocodecs_tpu_torch/utils/bytebpe.py",
     "audiocodecs_tpu/utils/bytebpe.py"),
    ("audiocodecs_tpu_torch/convert/onnx_lite.py",
     "audiocodecs_tpu/convert/onnx_lite.py"),
])
def test_port_copies_are_byte_equal_to_the_reference(copy, original):
    assert (REPO / copy).read_bytes() == (REPO / original).read_bytes()


def test_sr_path_defaults_to_the_card(monkeypatch, tmp_path):
    """Without a device the SR entry points and the examples ask for the
    card and raise where there is none."""
    from audiocodecs_tpu_torch.downstream.metrics.dnsmos import dnsmos_p808
    from audiocodecs_tpu_torch.downstream.recipes.quality import PairBattery
    from audiocodecs_tpu_torch.examples import reconstruct, stream, sweep_sr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dnsmos_p808([0.1, 0.2], 16000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PairBattery({}, 16000)
    for main, argv in ((reconstruct.main, ["--out",
                                           str(tmp_path / "r.wav")]),
                       (stream.main, [])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    dataset = tmp_path / "synthetic.yaml"
    dataset.write_text(
        (REPO / "hparams/datasets/synthetic.yaml").read_text().replace(
            "/tmp/audiocodecs_tpu_synthetic", str(tmp_path / "corpus"))
        .replace("num_utterances: 12", "num_utterances: 3"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep_sr.main(["--codecs", "encodec", "--output_folder",
                       str(tmp_path / "out"), "--dataset", str(dataset),
                       "--task", str(REPO / "hparams/tasks/sr.yaml")])
    assert (tmp_path / "corpus" / "test.csv").is_file()


def test_metric_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without a device the metric factories, the x-vector loader and the
    profiler ask for the card and raise where there is none, before any
    file is read."""
    from audiocodecs_tpu_torch.downstream.metrics import external, utmos
    from audiocodecs_tpu_torch.downstream.metrics.dwer import (
        make_dwer_checkpoint_metric,
    )
    from audiocodecs_tpu_torch.downstream.metrics.ppl import (
        make_perplexity_checkpoint_metric,
    )
    from audiocodecs_tpu_torch.downstream.models.speaker_encoder import (
        load_xvector,
    )
    from audiocodecs_tpu_torch.downstream.profiler import profile_codec
    from audiocodecs_tpu_torch.downstream.recipes.quality import (
        build_quality_metrics,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing")
    (tmp_path / "config.json").write_text("{}")
    (tmp_path / "model_v8.onnx").write_bytes(b"")
    calls = [
        lambda: utmos.make_utmos_checkpoint_metric(missing),
        lambda: utmos.load_utmos(missing),
        lambda: make_dwer_checkpoint_metric(missing, str(tmp_path)),
        lambda: make_perplexity_checkpoint_metric(missing, str(tmp_path)),
        lambda: load_xvector(missing),
        lambda: external.make_dwer_metric(str(tmp_path)),
        lambda: external.make_dwer_metric(checkpoint=missing,
                                          tokenizer_path=str(tmp_path)),
        lambda: external.make_speaker_similarity_metric(str(tmp_path)),
        lambda: external.make_speaker_similarity_metric(
            checkpoint=missing),
        lambda: external.make_perplexity_metric(str(tmp_path)),
        lambda: external.make_perplexity_metric(
            checkpoint=missing, tokenizer_path=str(tmp_path)),
        lambda: external.make_utmos_metric(missing),
        lambda: external.make_dnsmos_metric(str(tmp_path / "model_v8.onnx")),
        lambda: build_quality_metrics({"utmos_checkpoint": missing}, 16000),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()

    class _Codec:
        device = None
        sample_rate = 16000

        def state_dict(self):
            return {}

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_codec(_Codec(), seconds=(0.1,))


def test_metric_conversion_kinds_stand_alone(tmp_path):
    """``tools/convert_checkpoints_torch.py``'s metric-model kinds
    (whisper, gpt2, utmos, wavlm_xvector, dnsmos) in a fresh interpreter:
    each converts without importing ``transformers``, jax or the reference
    package."""
    code = (
        "import json, sys\n"
        "sys.path.insert(0, 'tools')\n"
        "import numpy as np, torch\n"
        "import convert_checkpoints_torch as cli\n"
        "from audiocodecs_tpu_torch.downstream.metrics import utmos\n"
        "from audiocodecs_tpu_torch.convert.torch_utils import "
        "synth_state_dict\n"
        "cfg = utmos.UTMOSConfig()\n"
        f"out = {str(tmp_path)!r}\n"
        "sd = {k: torch.from_numpy(v) for k, v in synth_state_dict("
        "utmos.utmos_schema(cfg)).items()}\n"
        "torch.save(sd, out + '/u.pt')\n"
        "assert cli.main(['convert', 'utmos', out + '/u.pt', "
        "out + '/o.pt']) == 0\n"
        "for kind in ('whisper', 'gpt2', 'wavlm_xvector', 'dnsmos'):\n"
        "    assert kind in cli.HF_CONVERTERS or kind in "
        "cli.METRIC_CONVERTERS\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {"PATH": os.environ.get("PATH", ""), "PYTHONPATH": str(REPO),
           "HOME": os.environ.get("HOME", str(REPO)),
           "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=str(REPO), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "audiocodecs_tpu_torch.downstream.metrics.utmos" in loaded
    assert not [m for m in loaded if _is_reference(m)]
    assert not [m for m in loaded if _is_transformers(m)]
