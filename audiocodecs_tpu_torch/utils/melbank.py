"""The Slaney mel filterbank (librosa's and torchaudio's ``mel_scale=
"slaney"``, ``norm="slaney"``), in float64 numpy.

The port's own copy of ``audiocodecs_tpu/utils/melbank.py``: BiCodec's
mel branch reads it, and the DNSMOS front end will. The bank is a
constant of the model, built once on the host and cast to float32.
"""

from __future__ import annotations

import numpy as np

__all__ = ["hz_to_mel_slaney", "mel_filterbank_slaney", "mel_to_hz_slaney"]

_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel_slaney(f):
    """Hz → Slaney mels: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, dtype=np.float64)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_HZ / _F_SP
                    + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
                    f / _F_SP)


def mel_to_hz_slaney(m):
    """Slaney mels → Hz, the inverse of :func:`hz_to_mel_slaney`."""
    m = np.asarray(m, dtype=np.float64)
    min_log_mel = _MIN_LOG_HZ / _F_SP
    return np.where(m >= min_log_mel,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - min_log_mel)),
                    m * _F_SP)


def mel_filterbank_slaney(sr: int, n_fft: int, n_mels: int,
                          fmin: float = 0.0,
                          fmax: float | None = None) -> np.ndarray:
    """Triangular filters ``[n_mels, n_fft // 2 + 1]`` (float32), each
    scaled to equal area (Slaney normalisation)."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    mel_pts = np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax),
                          n_mels + 2)
    hz_pts = mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
    return (weights * enorm[:, None]).astype(np.float32)
