"""Spectral and SNR metrics, PyTorch.

Counterpart of ``audiocodecs_tpu/downstream/metrics/dsp.py``:

* ``stft_mag`` — magnitude STFT (Hann window from ``np.hanning(n + 1)[:-1]``,
  centred reflect padding, ``|rfft|``), which the multi-scale STFT loss of
  codec training (:mod:`..parallel.train`) differentiates through;
* ``si_snr`` — scale-invariant SNR in dB, per utterance.

The reference's mel and STFT distances are not ported yet. Tensors stay on
the caller's device; the FFT is the library's (cuFFT on the card), as the
reference leaves it to XLA.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["stft_mag", "si_snr"]


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
