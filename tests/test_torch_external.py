"""The port's gated metric factories and their plumbing
(``audiocodecs_tpu_torch/downstream/metrics/external.py``,
``recipes/quality.py``, ``convert/{onnx_lite,dnsmos}.py``,
``metrics/text_norm.py``, ``utils/bytebpe.py``) against the JAX package,
on the CPU.

* WER and CER, the text normalisers and the byte-level BPE: equal to the
  JAX package's.
* ``read_onnx`` and ``convert_dnsmos_onnx`` on an ONNX protobuf the test
  writes by hand with DNSMOS's initializer names (the shipped weights):
  equal to the JAX functions' arrays; the ONNX DNSMOS metric equals the
  shipped one's scores.
* Every gate key of the JAX ``build_quality_metrics`` builds its metric
  in the port, from files the test writes (converted ``.npz`` checkpoints,
  HF directories, a TorchScript UTMOS); ``PairBattery``'s UTMOS, dWER,
  dCER and SpkSim equal the JAX battery's within 1e-5.
* A missing input raises as the reference's ``_require``.
"""

import json
import struct

import numpy as np
import pytest
import torch

from audiocodecs_tpu.convert import dnsmos as jconvert_dnsmos
from audiocodecs_tpu.convert import onnx_lite as jonnx
from audiocodecs_tpu.downstream.metrics import external as jexternal
from audiocodecs_tpu.downstream.metrics import text_norm as jtext_norm
from audiocodecs_tpu.downstream.metrics import utmos as jutmos
from audiocodecs_tpu.downstream.recipes import quality as jquality
from audiocodecs_tpu.nn.wavlm import WavLMConfig as JWavLMConfig
from audiocodecs_tpu.utils import bytebpe as jbytebpe
from audiocodecs_tpu.utils.checkpoint import save_params
from audiocodecs_tpu_torch.convert import dnsmos as convert_dnsmos
from audiocodecs_tpu_torch.convert import onnx_lite
from audiocodecs_tpu_torch.downstream.metrics import dnsmos, external
from audiocodecs_tpu_torch.downstream.metrics import text_norm, utmos
from audiocodecs_tpu_torch.downstream.models import speaker_encoder as xv
from audiocodecs_tpu_torch.downstream.recipes import quality
from audiocodecs_tpu_torch.nn.wavlm import WavLMConfig
from audiocodecs_tpu_torch.params import to_jax_params
from audiocodecs_tpu_torch.utils import bytebpe
from metric_pairs import byte_vocab, speech, tiny_gpt2, tiny_whisper
from metric_pairs import write_tokenizer
from zoo_pairs import one_thread  # noqa: F401 (autouse)

TEXTS = ["Mr. Smith won't pay $20.50 on the 3rd of May!",
         "the cat  sat; on the HAT", "wörld théâtre — ½ past 10",
         "", "  leading and trailing  "]


@pytest.mark.parametrize("hyp,ref", [
    ("a b c", "a b c"), ("a x c", "a b c"), ("", "a b"), ("a b c d", "a c"),
    ("ab cd", "ab ce"), ("a b", "ab")])
def test_error_rates_match_jax(hyp, ref):
    assert external.word_error_rate([hyp], [ref]) == \
        jexternal.word_error_rate([hyp], [ref])
    assert external.char_error_rate([hyp], [ref]) == \
        jexternal.char_error_rate([hyp], [ref])


@pytest.mark.parametrize("text", TEXTS)
def test_normalisers_and_bpe_match_jax(text, tmp_path):
    assert text_norm.EnglishTextNormalizer()(text) == \
        jtext_norm.EnglishTextNormalizer()(text)
    assert text_norm.BasicTextNormalizer()(text) == \
        jtext_norm.BasicTextNormalizer()(text)
    vocab, merges = byte_vocab()
    write_tokenizer(tmp_path, vocab, merges)
    port = bytebpe.ByteLevelBPE.from_dir(str(tmp_path))
    ref = jbytebpe.ByteLevelBPE.from_dir(str(tmp_path))
    assert port.encode(text) == ref.encode(text)
    assert port.decode(port.encode(text)) == ref.decode(ref.encode(text))


def _varint(n):
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num, payload):
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _tensor(name, a):
    """A TensorProto: dims (1), data_type float (2), name (8), raw (9)."""
    msg = b"".join(_varint(1 << 3) + _varint(d) for d in a.shape)
    msg += _varint(2 << 3) + _varint(1)
    msg += _field(8, name.encode())
    msg += _field(9, np.ascontiguousarray(a, "<f4").tobytes())
    return msg


def write_dnsmos_onnx(path):
    """A ModelProto (graph: field 7) whose initializers (field 5) carry the
    shipped DNSMOS weights under ``model_v8.onnx``'s names, with one
    float_data tensor (field 4) and a graph input (field 11) beside."""
    with np.load(dnsmos.DEFAULT_PARAMS_PATH) as raw:
        flat = {k: raw[k] for k in raw.files}
    graph = b""
    for i, (name, _) in enumerate(jconvert_dnsmos.DNSMOS_CONV_LAYERS):
        graph += _field(5, _tensor(f"{name}/kernel:0", flat[f"conv{i}_w"]))
        graph += _field(5, _tensor(f"{name}/bias:0", flat[f"conv{i}_b"]))
    for i, name in enumerate(jconvert_dnsmos.DNSMOS_DENSE_LAYERS):
        p = f"mos_estimator_small_1/{name}"
        graph += _field(5, _tensor(f"{p}/MatMul/ReadVariableOp/resource:0",
                                   flat[f"dense{i}_w"]))
        graph += _field(5, _tensor(f"{p}/BiasAdd/ReadVariableOp/resource:0",
                                   flat[f"dense{i}_b"]))
    packed = struct.pack("<3f", 1.0, 2.5, -3.0)
    graph += _field(5, _varint(1 << 3) + _varint(3) + _varint(2 << 3)
                    + _varint(1) + _field(4, packed) + _field(8, b"extra"))
    graph += _field(11, _field(1, b"input_1"))
    path.write_bytes(_varint(1 << 3) + _varint(7) + _field(7, graph))
    return flat


def test_onnx_reader_and_dnsmos_converter_match_jax(tmp_path):
    path = tmp_path / "model_v8.onnx"
    flat = write_dnsmos_onnx(path)
    g, jg = onnx_lite.read_onnx(str(path)), jonnx.read_onnx(str(path))
    assert sorted(g.initializers) == sorted(jg.initializers)
    for k, a in jg.initializers.items():
        np.testing.assert_array_equal(g.initializers[k], a)
    assert g.inputs == jg.inputs == ["input_1"]
    np.testing.assert_array_equal(g.initializers["extra"], [1.0, 2.5, -3.0])
    got = convert_dnsmos.convert_dnsmos_onnx(str(path))
    want = jconvert_dnsmos.convert_dnsmos_onnx(str(path))
    for part in ("conv", "dense"):
        for p, q in zip(got[part], want[part]):
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(p[leaf], q[leaf])
    saved = dnsmos.save_dnsmos_params(str(path), str(tmp_path / "d.npz"))
    for k, a in flat.items():
        np.testing.assert_array_equal(saved[k], a)
    metric = external.make_dnsmos_metric(str(path), device="cpu")
    sig = speech(3.0, 0)
    assert metric.metric([sig], 16000) == [
        dnsmos.dnsmos_p808(sig, 16000, device="cpu")]


class _TinyMOS(torch.nn.Module):
    def forward(self, x: torch.Tensor, sr: int) -> torch.Tensor:
        return 3.0 + x.mean() * 0.0 + float(sr) * 0.0


_SSL = dict(hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
            conv_dim=(8, 8), conv_kernel=(10, 4), conv_stride=(5, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
_XV = {"wavlm": dict(_SSL), "tdnn_dim": [8, 8, 12],
       "tdnn_kernel": [3, 3, 1], "tdnn_dilation": [1, 2, 1],
       "xvector_dim": 6}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every gate's files: UTMOS (a converted default-config checkpoint is
    too large for a unit test, so a tiny config's npz and the JAX
    metric's config), a TorchScript UTMOS, the toy Whisper and GPT-2 (npz
    with tokenizer directories, and HF directories) and a small x-vector
    (npz and its config overrides)."""
    d = tmp_path_factory.mktemp("gates")
    head = dict(emb_dim=4, num_domains=2, num_judges=8, blstm_hidden=8,
                proj_hidden=16, judge_id=3)
    ucfg = utmos.UTMOSConfig(ssl=WavLMConfig(**_SSL, gated_rel_pos=False),
                             **head)
    um = utmos.UTMOS(ucfg)
    um.load_state_dict(utmos.init_utmos_params(
        torch.Generator().manual_seed(0), ucfg))
    save_params(str(d / "utmos.npz"), to_jax_params(um.state_dict(), um))
    torch.jit.script(_TinyMOS()).save(str(d / "utmos_ts.pt"))
    (d / "whisper").mkdir()
    tiny_whisper(d / "whisper")
    (d / "gpt2").mkdir()
    tiny_gpt2(d / "gpt2")
    xcfg = xv.XVectorConfig(
        wavlm=WavLMConfig(**_SSL), tdnn_dim=(8, 8, 12), tdnn_kernel=(3, 3, 1),
        tdnn_dilation=(1, 2, 1), xvector_dim=6)
    xm = xv.XVector(xcfg)
    xm.load_state_dict(xv.init_xvector_params(
        torch.Generator().manual_seed(1), xcfg))
    save_params(str(d / "xvector.npz"), to_jax_params(xm.state_dict(), xm))
    return d, ucfg, head


def _gates(d):
    return {
        "utmos_checkpoint": str(d / "utmos.npz"),
        "utmos_model_path": str(d / "utmos_ts.pt"),
        "whisper_checkpoint": str(d / "whisper" / "whisper.npz"),
        "whisper_tokenizer": str(d / "whisper"),
        "whisper_path": str(d / "whisper" / "hf"),
        "speaker_encoder_checkpoint": str(d / "xvector.npz"),
        "speaker_encoder_config": json.loads(json.dumps(_XV)),
        "lm_checkpoint": str(d / "gpt2" / "gpt2.npz"),
        "lm_tokenizer": str(d / "gpt2"),
        "lm_path": str(d / "gpt2" / "hf"),
    }


@pytest.mark.parametrize("keys,slot", [
    (("utmos_checkpoint",), "UTMOS"), (("utmos_model_path",), "UTMOS"),
    (("whisper_checkpoint", "whisper_tokenizer"), "dwer"),
    (("whisper_path",), "dwer"),
    (("speaker_encoder_checkpoint", "speaker_encoder_config"), "spk"),
    (("lm_checkpoint", "lm_tokenizer", "whisper_checkpoint",
      "whisper_tokenizer"), "ppl"),
    (("lm_path", "whisper_path"), "ppl"),
    ((), "DNSMOS")])
def test_every_gate_builds_its_metric(files, monkeypatch, keys, slot):
    d, ucfg, _ = files
    # the tiny UTMOS checkpoint is read at its own config
    make = utmos.make_utmos_checkpoint_metric
    monkeypatch.setattr(utmos, "make_utmos_checkpoint_metric",
                        lambda p, cfg=None, **kw: make(p, ucfg, **kw))
    gates = _gates(d)
    cfg = {k: gates[k] for k in keys}
    out = quality.build_quality_metrics(cfg, 16000, device="cpu")
    sig = speech(0.5, 2)
    if slot in ("UTMOS", "DNSMOS"):
        assert sorted(out["single"]) == sorted({slot, "DNSMOS"})
        assert np.isfinite(out["single"][slot](sig))
        return
    assert out[slot] is not None
    if slot == "ppl":
        assert len(out[slot].metric([sig], 16000)) == 1
    else:
        assert np.isfinite(out[slot].metric([sig], [sig], 16000)[0])


def test_pair_battery_matches_jax(files, monkeypatch):
    d, ucfg, head = files
    gates = _gates(d)
    cfg = {k: gates[k] for k in (
        "utmos_checkpoint", "whisper_checkpoint", "whisper_tokenizer",
        "speaker_encoder_checkpoint", "speaker_encoder_config")}
    make = utmos.make_utmos_checkpoint_metric
    monkeypatch.setattr(utmos, "make_utmos_checkpoint_metric",
                        lambda p, cfg=None, **kw: make(p, ucfg, **kw))
    jcfg = jutmos.UTMOSConfig(
        ssl=JWavLMConfig(**_SSL, gated_rel_pos=False), **head)
    jmake = jutmos.make_utmos_jax_metric
    monkeypatch.setattr(jutmos, "make_utmos_jax_metric",
                        lambda p, cfg=None, **kw: jmake(p, jcfg, **kw))
    port = quality.PairBattery(cfg, 16000, device="cpu")
    ref = jquality.PairBattery(cfg, 16000)
    refsig = speech(1.0, 5)
    hyp = refsig + 0.03 * np.random.default_rng(6).standard_normal(
        refsig.size).astype(np.float32)
    for bat in (port, ref):
        bat.score_pair(hyp, refsig, uid="u0")
        bat.score_single(refsig, prefix="Ref", uid="u0")
    got, want = port.summary(), ref.summary()
    assert sorted(got) == sorted(want)
    for name in ("UTMOS", "RefUTMOS", "dWER", "dCER", "SpkSim"):
        assert name in got
        assert abs(got[name] - want[name]) <= 1e-5 * max(
            abs(want[name]), 1.0), name


def test_missing_inputs_raise_as_the_reference(tmp_path):
    for call, what in (
            (lambda: external.make_utmos_metric(), "UTMOS"),
            (lambda: external.make_dnsmos_metric(), "DNSMOS"),
            (lambda: external.make_dnsmos_metric(
                str(tmp_path / "none.onnx")), "DNSMOS"),
            (lambda: external.make_dwer_metric(device="cpu"), "dWER"),
            (lambda: external.make_dwer_metric(str(tmp_path),
                                               device="cpu"), "dWER"),
            (lambda: external.make_speaker_similarity_metric(device="cpu"),
             "Speaker similarity"),
            (lambda: external.make_perplexity_metric(device="cpu"),
             "ASR perplexity")):
        with pytest.raises(RuntimeError, match=f"{what}.*unavailable"):
            call()
