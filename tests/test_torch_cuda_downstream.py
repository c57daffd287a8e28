"""The port's downstream pieces on the card's machine: the native WAV
reader and writer against the ``wave`` path, DNSMOS on the card against
its CPU version, UTMOS (its BiLSTM through the LSTM kernel) against its CPU
version, and the profiler's FLOPs on the card against the CPU's. Every
test needs an NVIDIA GPU and skips without one. The file imports neither
JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_downstream.py

Tolerances: WAV arrays and bytes equal; DNSMOS within 1e-4 MOS (its convs
and mel projection run with TF32 off on both sides); UTMOS within 1e-4 of
max|score|; the profiler's card FLOPs within 1 % of the CPU's.
"""

import wave

import numpy as np
import pytest
import torch

from audiocodecs_tpu_torch.downstream.metrics import dnsmos
from audiocodecs_tpu_torch.utils.audio import read_wav, write_wav

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_native_wav_path_on_the_card_machine(dev, tmp_path, width):
    path = str(tmp_path / "in.wav")
    raw = np.random.default_rng(width).integers(0, 256, 2 * 999 * width,
                                                dtype=np.uint8)
    with wave.open(path, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(width)
        f.setframerate(16000)
        f.writeframes(raw.tobytes())
    got, sr = read_wav(path)
    want, sr_plain = read_wav(path, native=False)
    assert sr == sr_plain == 16000
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for native in (True, False):
        write_wav(str(tmp_path / f"{native}.wav"), got, sr, native=native)
    assert (tmp_path / "True.wav").read_bytes() == (
        tmp_path / "False.wav").read_bytes()


@pytest.mark.parametrize("seconds,rate", [(3.0, 16000), (12.5, 16000),
                                          (2.0, 24000)])
def test_dnsmos_on_the_card_matches_cpu(dev, seconds, rate):
    rng = np.random.default_rng(int(seconds * 10))
    t = np.arange(int(seconds * rate)) / rate
    sig = (0.2 * np.sin(2 * np.pi * 140 * t) * (1 + np.sin(2 * np.pi * 3 * t))
           + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
    got = dnsmos.dnsmos_p808(sig, rate, device=dev)
    want = dnsmos.dnsmos_p808(sig, rate, device="cpu")
    assert abs(got - want) <= 1e-4, (got, want)


def test_utmos_launches_the_lstm_kernel_and_matches_cpu(dev):
    from audiocodecs_tpu_torch.downstream.metrics import utmos
    from audiocodecs_tpu_torch.nn.wavlm import WavLMConfig
    from audiocodecs_tpu_torch.ops.lstm_recurrence import lstm_recurrence

    cfg = utmos.UTMOSConfig(ssl=WavLMConfig(
        hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
        gated_rel_pos=False), emb_dim=16, num_judges=8, judge_id=3,
        blstm_hidden=128, proj_hidden=64)
    cpu = utmos.UTMOS(cfg)
    cpu.load_state_dict(utmos.init_utmos_params(
        torch.Generator().manual_seed(0), cfg))
    card = utmos.UTMOS(cfg)
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev)
    wav = (np.random.default_rng(0).standard_normal((3, 16000))
           * 0.1).astype(np.float32)
    n = torch.tensor([16000, 12000, 7000])
    with torch.inference_mode():
        before = lstm_recurrence.launches
        got = utmos.apply_utmos_padded(card, torch.from_numpy(wav).to(dev),
                                       n.to(dev)).cpu()
        assert lstm_recurrence.launches - before == 2
        want = utmos.apply_utmos_padded(cpu, torch.from_numpy(wav), n)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_profiler_flops_on_the_card_match_cpu(dev):
    from audiocodecs_tpu_torch.downstream.profiler import profile_codec
    from audiocodecs_tpu_torch.models.encodec import Encodec

    card = Encodec(24000, device=dev,
                   generator=torch.Generator().manual_seed(0))
    cpu = Encodec(24000, device="cpu", state_dict={
        k: v.cpu() for k, v in card.state_dict().items()})
    got = profile_codec(card, seconds=(1,), runs=2, warmups=1)["1s"]
    want = profile_codec(cpu, seconds=(1,), runs=1, warmups=0)["1s"]
    assert abs(got["gflops"] - want["gflops"]) <= 0.01 * want["gflops"]
    assert got["memory"]["peak_bytes_in_use"] > 0
