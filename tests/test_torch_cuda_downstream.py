"""The port's downstream pieces on the card's machine: the native WAV
reader and writer against the ``wave`` path, and DNSMOS on the card against
its CPU version. Every test needs an NVIDIA GPU and skips without one. The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_downstream.py

Tolerances: WAV arrays and bytes equal; DNSMOS within 1e-4 MOS (its convs
and mel projection run with TF32 off on both sides).
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
