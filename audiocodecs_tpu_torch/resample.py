"""Polyphase windowed-sinc resampling (``torchaudio.functional.resample``
numerics).

Counterpart of ``audiocodecs_tpu/resample.py``, with its own copy of the
kernel-bank construction: the filter bank is built on the host in float64,
cast to the signal's float32, and applied as one strided ``F.conv1d`` with
one output channel per phase.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from audiocodecs_tpu_torch.nn.layers import exact_fp32

__all__ = ["resample", "resample_kernel", "resampled_length"]


def resampled_length(length: int, orig_freq: int, new_freq: int) -> int:
    """Output length of :func:`resample` for an input of ``length`` samples."""
    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // gcd, int(new_freq) // gcd
    return int(math.ceil(new * length / orig))


@lru_cache(maxsize=None)
def resample_kernel(orig_freq: int, new_freq: int,
                    lowpass_filter_width: int = 6, rolloff: float = 0.99,
                    resampling_method: str = "sinc_interp_hann",
                    beta: float | None = None):
    """Polyphase windowed-sinc bank ``(kernel [new, L] float64, width, orig,
    new)``, with torchaudio's clamping and windowing."""
    if orig_freq <= 0 or new_freq <= 0:
        raise ValueError("frequencies must be positive")
    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // gcd, int(new_freq) // gcd
    if lowpass_filter_width <= 0:
        raise ValueError("lowpass_filter_width must be positive")
    base_freq = min(orig, new) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig / base_freq))

    idx = np.arange(-width, width + orig, dtype=np.float64)[None] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    if resampling_method == "sinc_interp_hann":
        window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2
    elif resampling_method == "sinc_interp_kaiser":
        if beta is None:
            beta = 14.769656459379492
        window = (np.i0(beta * np.sqrt(1 - (t / lowpass_filter_width) ** 2))
                  / np.i0(beta))
    else:
        raise ValueError(f"unknown resampling_method: {resampling_method}")
    t *= math.pi
    scale = base_freq / orig
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel *= window * scale
    return kernel, width, orig, new


def resample(waveform: torch.Tensor, orig_freq: int, new_freq: int, *,
             lowpass_filter_width: int = 6, rolloff: float = 0.99,
             resampling_method: str = "sinc_interp_hann",
             beta: float | None = None) -> torch.Tensor:
    """Resample ``waveform`` (``[..., T]``) from ``orig_freq`` to
    ``new_freq``; the identity when the rates are equal."""
    if orig_freq == new_freq:
        return waveform
    kernel_np, width, orig, new = resample_kernel(
        orig_freq, new_freq, lowpass_filter_width=lowpass_filter_width,
        rolloff=rolloff, resampling_method=resampling_method, beta=beta)
    kernel = torch.as_tensor(kernel_np[:, None, :], dtype=waveform.dtype,
                             device=waveform.device)  # [new, 1, L]
    shape = waveform.shape
    length = shape[-1]
    x = F.pad(waveform.reshape(-1, 1, length), (width, width + orig))
    with exact_fp32():
        y = F.conv1d(x, kernel, stride=orig)  # [B*, new, frames]
    y = y.transpose(1, 2).reshape(y.shape[0], -1)  # interleave the phases
    target_length = int(math.ceil(new * length / orig))
    return y[:, :target_length].reshape(shape[:-1] + (target_length,))
