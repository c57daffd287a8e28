"""Kaldi-compatible log-mel filterbank, PyTorch.

Counterpart of ``audiocodecs_tpu/nn/kaldi_fbank.py`` (itself
``torchaudio.compliance.kaldi.fbank`` for the arguments its callers pass):
snip-edges framing, DC-offset removal, kaldi's preemphasis, a symmetric
Hann window (or kaldi's povey window, Hann^0.85), the power spectrum
zero-padded to the next power-of-two FFT with the Nyquist bin dropped,
kaldi's HTK-scale triangular mel banks from 20 Hz (unnormalised), and the
natural log floored at kaldi's epsilon. w2v-BERT's front end calls it with
the povey window (:mod:`.w2vbert`); AudioMAE and SemantiCodec with the Hann
window and 128 bins.

The mel banks are a numpy copy of the reference's, built in float64 and
cached here; the window too. The spectrum is ``torch.fft.rfft`` in fp32 and
the mel product runs in exact fp32 (TF32 off): it sets tokens downstream.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from audiocodecs_tpu_torch.nn.layers import exact_fp32

__all__ = ["kaldi_fbank", "audiomae_normalize", "AUDIOMAE_NORM_MEAN",
           "AUDIOMAE_NORM_STD"]

# AudioSet normalisation constants of AudioMAE / SemantiCodec
AUDIOMAE_NORM_MEAN = -4.2677393
AUDIOMAE_NORM_STD = 4.5689974

EPSILON = 1.1920928955078125e-07  # kaldi's epsilon (float32 eps)


def _hz_mel(hz):
    return 1127.0 * np.log1p(np.asarray(hz, np.float64) / 700.0)


@lru_cache(maxsize=8)
def _banks(sample_rate: int, window_pow2: int, num_bins: int,
           low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi mel banks [num_bins, window_pow2 // 2] (the Nyquist bin
    dropped, as kaldi's ``get_mel_banks``), float32."""
    nyquist = 0.5 * sample_rate
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    fft_bins = window_pow2 // 2
    fft_bin_width = sample_rate / window_pow2
    mel_lo, mel_hi = _hz_mel(low_freq), _hz_mel(high_freq)
    mel_delta = (mel_hi - mel_lo) / (num_bins + 1)
    bins = np.zeros((num_bins, fft_bins))
    mel_of_bin = _hz_mel(fft_bin_width * np.arange(fft_bins))
    for b in range(num_bins):
        left, center, right = (mel_lo + d * mel_delta
                               for d in (b, b + 1, b + 2))
        up = (mel_of_bin - left) / (center - left)
        down = (right - mel_of_bin) / (right - center)
        bins[b] = np.maximum(0.0, np.minimum(up, down))
    return bins.astype(np.float32)


@lru_cache(maxsize=8)
def _window(win: int, kind: str) -> np.ndarray:
    n = np.arange(win)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * n / (win - 1))
    if kind == "povey":
        hann = hann ** 0.85
    elif kind != "hanning":
        raise ValueError(f"unknown window {kind!r}")
    return hann.astype(np.float32)


def kaldi_fbank(sig, sample_rate: int = 16000, num_mel_bins: int = 128,
                frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
                preemphasis: float = 0.97, remove_dc_offset: bool = True,
                window: str = "hanning") -> torch.Tensor:
    """``sig`` [B, T] (or [T]) → log-mel [B, F, num_mel_bins], kaldi's
    semantics. ``window``: ``"hanning"`` or ``"povey"``."""
    sig = torch.as_tensor(sig)
    if sig.ndim == 1:
        sig = sig[None]
    win = int(sample_rate * frame_length_ms / 1000.0)
    hop = int(sample_rate * frame_shift_ms / 1000.0)
    n_frames = max(0, 1 + (sig.shape[-1] - win) // hop)  # snip_edges
    window_t = torch.from_numpy(_window(win, window)).to(sig.device)
    if n_frames == 0:
        return sig.new_zeros((sig.shape[0], 0, num_mel_bins))
    frames = sig.unfold(-1, win, hop)[:, :n_frames]  # [B, F, win]
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    frames = frames * window_t
    pow2 = 1
    while pow2 < win:
        pow2 *= 2
    spec = torch.fft.rfft(frames, n=pow2, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2)[..., : pow2 // 2]
    banks = torch.from_numpy(_banks(sample_rate, pow2, num_mel_bins)).to(
        sig.device)
    with exact_fp32():
        mel = torch.matmul(power, banks.T)
    return torch.log(torch.clamp(mel, min=EPSILON))


def audiomae_normalize(fbank: torch.Tensor) -> torch.Tensor:
    """AudioMAE's ``(x − mean) / (2·std)`` (AudioSet statistics)."""
    return (fbank - AUDIOMAE_NORM_MEAN) / (2.0 * AUDIOMAE_NORM_STD)
