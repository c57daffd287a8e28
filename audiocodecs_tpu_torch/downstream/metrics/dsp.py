"""Spectral and SNR metrics, PyTorch.

Counterpart of ``audiocodecs_tpu/downstream/metrics/dsp.py``:

* ``stft_mag`` — magnitude STFT (Hann window from ``np.hanning(n + 1)[:-1]``,
  centred reflect padding, ``|rfft|``), which the multi-scale STFT loss of
  codec training (:mod:`..parallel.train`) differentiates through;
* ``mel_filterbank`` — the HTK (or Slaney-scale) triangular bank, a float32
  numpy constant built on the host;
* ``mel_distance`` / ``stft_distance`` — per-utterance RMS distance between
  dB mel or dB magnitude spectrograms (reference ``metrics/
  mel_distance.py:30-64``, ``metrics/stft_distance.py:29-71``);
* ``si_snr`` — scale-invariant SNR in dB, per utterance.

Tensors stay on the caller's device; the FFT is the library's (cuFFT on the
card), as the reference leaves it to XLA. The distances run with TF32 off
(:func:`..nn.layers.exact_fp32`): the mel projection is a matmul.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from audiocodecs_tpu_torch.nn.layers import exact_fp32

__all__ = ["stft_mag", "mel_filterbank", "mel_distance", "stft_distance",
           "si_snr"]


def _hann(n_fft: int, win_length: int) -> np.ndarray:
    window = np.hanning(win_length + 1)[:-1].astype(np.float32)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        window = np.pad(window, (pad, n_fft - win_length - pad))
    return window


def stft_mag(x: torch.Tensor, n_fft: int = 1024, hop: int = 256,
             win_length: int | None = None) -> torch.Tensor:
    """``[..., T]`` → magnitude spectrogram ``[..., frames, n_fft//2+1]``.

    Hann window, centred (reflect-padded by ``n_fft // 2`` on both sides),
    frames at every ``hop`` samples."""
    window = torch.from_numpy(_hann(n_fft, win_length or n_fft)).to(
        device=x.device, dtype=x.dtype)
    pad = n_fft // 2
    lead = x.shape[:-1]
    x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    frames = x[:, 0].unfold(-1, n_fft, hop) * window  # [N, frames, n_fft]
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.abs().reshape(*lead, *spec.shape[-2:])


@lru_cache(maxsize=None)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None,
                   htk: bool = True) -> np.ndarray:
    """Triangular mel filterbank ``[n_fft//2+1, n_mels]`` (HTK scale, or
    the Slaney scale with ``htk=False``), float32."""
    fmax = fmax or sample_rate / 2

    def hz_to_mel(f):
        if htk:
            return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)
        f = np.asarray(f, dtype=np.float64)
        mel = f / (200.0 / 3)
        log_region = f >= 1000.0
        return np.where(
            log_region,
            15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / np.log(6.4) * 27.0,
            mel)

    def mel_to_hz(m):
        if htk:
            return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)
        m = np.asarray(m, dtype=np.float64)
        f = m * (200.0 / 3)
        log_region = m >= 15.0
        return np.where(log_region,
                        1000.0 * np.exp(np.log(6.4) * (m - 15.0) / 27.0), f)

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    fft_freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    fb = np.zeros((n_fft // 2 + 1, n_mels))
    for m in range(n_mels):
        lo, ctr, hi = freqs[m], freqs[m + 1], freqs[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


def _db(x: torch.Tensor, floor: float = 1e-5) -> torch.Tensor:
    return 20.0 * torch.log10(torch.clamp(x, min=floor))


def _rms_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((a - b) ** 2, dim=(-1, -2)))


def mel_distance(hyp: torch.Tensor, ref: torch.Tensor,
                 sample_rate: int = 16000, n_fft: int = 1024,
                 hop: int = 256, n_mels: int = 80) -> torch.Tensor:
    """Per-utterance RMS distance between dB mel spectrograms ``[B]``, over
    the shorter signal's length."""
    fb = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels)).to(
        device=hyp.device, dtype=hyp.dtype)
    T = min(hyp.shape[-1], ref.shape[-1])
    with exact_fp32():
        mh = _db(stft_mag(hyp[..., :T], n_fft, hop) @ fb)
        mr = _db(stft_mag(ref[..., :T], n_fft, hop) @ fb)
        return _rms_distance(mh, mr)


def stft_distance(hyp: torch.Tensor, ref: torch.Tensor, n_fft: int = 1024,
                  hop: int = 256) -> torch.Tensor:
    """Per-utterance RMS distance between dB magnitude STFTs ``[B]``, over
    the shorter signal's length."""
    T = min(hyp.shape[-1], ref.shape[-1])
    with exact_fp32():
        return _rms_distance(_db(stft_mag(hyp[..., :T], n_fft, hop)),
                             _db(stft_mag(ref[..., :T], n_fft, hop)))


def si_snr(hyp: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Scale-invariant SNR in dB, per utterance ``[B]``."""
    T = min(hyp.shape[-1], ref.shape[-1])
    hyp, ref = hyp[..., :T], ref[..., :T]
    hyp = hyp - hyp.mean(dim=-1, keepdim=True)
    ref = ref - ref.mean(dim=-1, keepdim=True)
    dot = torch.sum(hyp * ref, dim=-1, keepdim=True)
    s_target = dot * ref / torch.clamp(
        torch.sum(ref * ref, dim=-1, keepdim=True), min=1e-10)
    e_noise = hyp - s_target
    return 10.0 * torch.log10(
        torch.clamp(torch.sum(s_target ** 2, -1), min=1e-10)
        / torch.clamp(torch.sum(e_noise ** 2, -1), min=1e-10))
