"""The port's serving loop (``audiocodecs_tpu_torch.examples.serve``) and
codec registry, on the CPU.

Each reply has its request's length and equals the row of the codec's own
``roundtrip`` on the padded batch it ran in, bit for bit (same device, same
shapes, same code); a request longer than the largest bucket raises; an
error in a batch reaches every request of it. The registry resolves the
reference's names for the ported families to the port's classes.
"""

import numpy as np
import pytest
import torch

from audiocodecs_tpu.models import available_codecs as jax_available
from audiocodecs_tpu_torch import models
from audiocodecs_tpu_torch.examples.serve import CodecServer
from audiocodecs_tpu_torch.models.bigcodec import BigCodec, BigCodecModelConfig
from audiocodecs_tpu_torch.models.encodec import Encodec, EncodecModelConfig

# the tiny EnCodec of tests/test_serve_example.py
ENCODEC = EncodecModelConfig(sampling_rate=800, num_filters=4, hidden_size=16,
                             upsampling_ratios=(4, 2), codebook_size=32,
                             codebook_dim=16, num_quantizers=4)
BIGCODEC = BigCodecModelConfig(ngf=4, up_ratios=(2, 5), dilations=(1, 3),
                               hidden_size=16, codebook_size=64,
                               codebook_dim=8, rnn_layers=1)


def _codec(family):
    if family == "encodec":
        return Encodec(800, 800, model_config=ENCODEC, num_codebooks=4,
                       device="cpu")
    return BigCodec(800, 800, model_config=BIGCODEC, device="cpu")


@pytest.mark.parametrize("family", ["encodec", "bigcodec"])
def test_replies_have_their_length_and_equal_the_roundtrip_row(family):
    codec = _codec(family)
    server = CodecServer(codec, buckets_s=(0.5, 1.0), max_batch=2,
                         max_wait_ms=20.0)
    try:
        rng = np.random.default_rng(0)
        reqs = [rng.standard_normal(int(800 * d)).astype(np.float32)
                for d in (0.3, 0.5, 0.9, 0.7, 0.1)]
        replies = [server.submit(w) for w in reqs]
        outs = [r.get(timeout=120) for r in replies]
    finally:
        server.stop()
    for w, r, o in zip(reqs, replies, outs):
        assert o.shape == w.shape and np.isfinite(o).all()
        assert r.batch.shape == (2, 400 if len(w) <= 400 else 800)
        np.testing.assert_array_equal(r.batch[r.row, : len(w)], w)
        want = codec.roundtrip(r.batch)[r.row, : len(w)].numpy()
        np.testing.assert_array_equal(o, want)
        assert r.done >= r.submitted


def test_oversized_request_raises():
    server = CodecServer(_codec("encodec"), buckets_s=(0.5, 1.0),
                         max_batch=2)
    try:
        with pytest.raises(ValueError, match="largest bucket"):
            server.submit(np.zeros(801, np.float32))
    finally:
        server.stop()


def test_a_failing_batch_reaches_every_request_and_the_worker_goes_on():
    codec = _codec("encodec")
    server = CodecServer(codec, buckets_s=(0.5,), max_batch=2,
                         max_wait_ms=50.0)
    real = codec.roundtrip
    try:
        codec.roundtrip = lambda sig: (_ for _ in ()).throw(
            RuntimeError("kernel launch failed"))
        bad = [server.submit(np.zeros(100, np.float32)) for _ in range(2)]
        for r in bad:
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                r.get(timeout=60)
        codec.roundtrip = real
        assert server.submit(np.zeros(100, np.float32)).get(
            timeout=60).shape == (100,)
    finally:
        server.stop()


def test_registry_names_and_classes():
    names = models.available_codecs()
    assert names == ["audiodec", "bicodec", "bigcodec", "dac", "dycast",
                     "encodec", "focalcodec", "hilcodec", "magicodec",
                     "mimi", "nanocodec", "past", "semanticodec",
                     "speechtokenizer", "stablecodec", "wavlm_kmeans",
                     "wavtokenizer", "xcodec2"]
    # every name the reference registers resolves; nothing is left to port
    assert names == sorted(jax_available())
    assert models._NOT_PORTED == ()
    from audiocodecs_tpu_torch.models.audiodec import AudioDec
    from audiocodecs_tpu_torch.models.bicodec import BiCodec
    from audiocodecs_tpu_torch.models.dac import DAC
    from audiocodecs_tpu_torch.models.dycast import DyCAST
    from audiocodecs_tpu_torch.models.focalcodec import FocalCodec
    from audiocodecs_tpu_torch.models.hilcodec import HILCodec
    from audiocodecs_tpu_torch.models.magicodec import MagiCodec
    from audiocodecs_tpu_torch.models.mimi import Mimi
    from audiocodecs_tpu_torch.models.nanocodec import NanoCodec
    from audiocodecs_tpu_torch.models.past import PAST
    from audiocodecs_tpu_torch.models.semanticodec import SemantiCodec
    from audiocodecs_tpu_torch.models.speechtokenizer import SpeechTokenizer
    from audiocodecs_tpu_torch.models.stablecodec import StableCodec
    from audiocodecs_tpu_torch.models.wavlm_kmeans import WavLMKmeans
    from audiocodecs_tpu_torch.models.wavtokenizer import WavTokenizer
    from audiocodecs_tpu_torch.models.xcodec2 import XCodec2

    want = {"bigcodec": BigCodec, "dac": DAC, "encodec": Encodec,
            "mimi": Mimi, "past": PAST, "speechtokenizer": SpeechTokenizer,
            "wavtokenizer": WavTokenizer, "audiodec": AudioDec,
            "hilcodec": HILCodec, "nanocodec": NanoCodec,
            "xcodec2": XCodec2, "stablecodec": StableCodec,
            "magicodec": MagiCodec, "wavlm_kmeans": WavLMKmeans,
            "dycast": DyCAST, "focalcodec": FocalCodec, "bicodec": BiCodec,
            "semanticodec": SemantiCodec}
    assert sorted(want) == names
    for name, cls in want.items():
        assert models.get_codec_class(name) is cls
        assert models.get_codec_class(name.upper()) is cls
    with pytest.raises(ValueError, match="unknown codec"):
        models.get_codec_class("nosuchcodec")


def test_server_main_on_the_cpu(capsys, monkeypatch):
    """``main`` end to end on a tiny codec of the registry's class, built in
    the family's balanced serving tier (BigCodec: bf16 decoder activations
    and the polynomial snake), which it prints."""
    from audiocodecs_tpu_torch.examples import serve
    from audiocodecs_tpu_torch.serving import apply_serving_preset

    built = []

    class Tiny:
        DEFAULT_ORIG_SR = 800

        def __new__(cls, sr, orig_sr, device, **preset):
            assert (sr, orig_sr, device) == (800, 800, "cpu")
            assert preset == apply_serving_preset("bigcodec")
            built.append(BigCodec(800, 800, model_config=BIGCODEC,
                                  device="cpu", **preset))
            return built[-1]

    monkeypatch.setattr(models, "get_codec_class", lambda name: Tiny)
    assert serve.main(["--codec", "bigcodec", "--requests", "3",
                       "--batch", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "3 requests" in out and "serving preset[bigcodec]" in out
    assert built[0].decode_form.dtype == torch.bfloat16


def test_server_main_serves_encodec_in_its_tier(capsys, monkeypatch):
    """``main --quality balanced`` builds EnCodec in the EnCodec-style tier
    (bf16 decoder activations, one bf16 pass), which it prints; the
    encoder stays exact."""
    from audiocodecs_tpu_torch.examples import serve
    from audiocodecs_tpu_torch.serving import apply_serving_preset

    built = []
    mc = EncodecModelConfig(sampling_rate=800, num_filters=4, hidden_size=8,
                            upsampling_ratios=(4, 2), codebook_size=16,
                            codebook_dim=8, num_quantizers=2)

    class Tiny:
        DEFAULT_ORIG_SR = 800

        def __new__(cls, sr, orig_sr, device, **preset):
            assert preset == apply_serving_preset("encodec", "balanced")
            built.append(Encodec(800, 800, num_codebooks=2, model_config=mc,
                                 device=device, **preset))
            return built[-1]

    monkeypatch.setattr(models, "get_codec_class", lambda name: Tiny)
    assert serve.main(["--codec", "encodec", "--quality", "balanced",
                       "--requests", "2", "--batch", "2", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out
    assert "2 requests" in out and "serving preset[encodec]" in out
    assert built[0].decoder.form.dtype == torch.bfloat16
    assert built[0].encoder.form.exact
