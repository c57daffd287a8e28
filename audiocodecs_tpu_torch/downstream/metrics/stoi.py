"""STOI — Short-Time Objective Intelligibility (Taal et al., 2010).

The port's copy of ``audiocodecs_tpu/downstream/metrics/stoi.py``; its
resampler reads the port's :func:`audiocodecs_tpu_torch.resample.
resample_kernel` (the same float64 bank).

First-party implementation (the reference wraps torchmetrics, reference
``metrics/stoi.py:30-55``; that dependency is absent here). Host-side numpy:
metrics are off the device path.

Algorithm: resample to 10 kHz → remove silent frames (40 dB dynamic-range
VAD) → 512-point STFT (256 window... see constants) → 15 one-third-octave
bands from 150 Hz → 384 ms segments (30 frames) → clipped, normalized
intermediate correlation, averaged.
"""

from __future__ import annotations

import numpy as np

from audiocodecs_tpu_torch.resample import resample_kernel

__all__ = ["stoi"]

FS = 10000
N_FRAME = 256
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N = 30  # frames per segment
BETA = -15.0  # lower SDR bound (dB)
DYN_RANGE = 40.0


def _resample_np(x: np.ndarray, orig: int, new: int) -> np.ndarray:
    if orig == new:
        return x
    kernel, width, o, n = resample_kernel(orig, new)
    xp = np.pad(x, (width, width + o))
    frames = (len(xp) - kernel.shape[1]) // o + 1
    out = np.empty((frames, n))
    L = kernel.shape[1]
    for f in range(frames):
        out[f] = kernel @ xp[f * o : f * o + L]
    return out.reshape(-1)[: int(np.ceil(n * len(x) / o))]


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    flo = cf * 2 ** (-1.0 / 6)
    fhi = cf * 2 ** (1.0 / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo = np.argmin((f - flo[i]) ** 2)
        hi = np.argmin((f - fhi[i]) ** 2)
        obm[i, lo:hi] = 1.0
    return obm


def _stft_frames(x: np.ndarray):
    w = np.hanning(N_FRAME + 2)[1:-1]
    n_frames = max(0, (len(x) - N_FRAME) // (N_FRAME // 2) + 1)
    frames = np.stack(
        [x[i * (N_FRAME // 2) : i * (N_FRAME // 2) + N_FRAME] for i in range(n_frames)]
    ) if n_frames else np.zeros((0, N_FRAME))
    return np.abs(np.fft.rfft(frames * w, NFFT, axis=-1))


def _remove_silent(x: np.ndarray, y: np.ndarray):
    w = np.hanning(N_FRAME + 2)[1:-1]
    hop = N_FRAME // 2
    n_frames = max(0, (len(x) - N_FRAME) // hop + 1)
    if n_frames == 0:
        return x, y
    energies = np.array(
        [20 * np.log10(np.linalg.norm(x[i * hop : i * hop + N_FRAME] * w) + 1e-10)
         for i in range(n_frames)]
    )
    mask = energies > energies.max() - DYN_RANGE
    xs, ys = [], []
    cx, cy = np.zeros(len(x)), np.zeros(len(y))
    # overlap-add reconstruction of retained frames
    pos = 0
    for i in range(n_frames):
        if mask[i]:
            xs.append(x[i * hop : i * hop + N_FRAME] * w)
            ys.append(y[i * hop : i * hop + N_FRAME] * w)
    if not xs:
        return x, y
    out_len = (len(xs) - 1) * hop + N_FRAME
    ox, oy = np.zeros(out_len), np.zeros(out_len)
    for j, (fx, fy) in enumerate(zip(xs, ys)):
        ox[j * hop : j * hop + N_FRAME] += fx
        oy[j * hop : j * hop + N_FRAME] += fy
    return ox, oy


def stoi(hyp: np.ndarray, ref: np.ndarray, sample_rate: int) -> float:
    """STOI score in [~0, 1] for one utterance pair (1-D arrays)."""
    hyp = np.asarray(hyp, dtype=np.float64).reshape(-1)
    ref = np.asarray(ref, dtype=np.float64).reshape(-1)
    T = min(len(hyp), len(ref))
    hyp, ref = hyp[:T], ref[:T]
    hyp = _resample_np(hyp, sample_rate, FS)
    ref = _resample_np(ref, sample_rate, FS)
    ref, hyp = _remove_silent(ref, hyp)
    X = _stft_frames(ref)  # clean
    Y = _stft_frames(hyp)  # degraded
    if X.shape[0] < N:
        # Too short after silence removal to form one 30-frame segment.
        # pystoi (what the reference's torchmetrics wrapper calls,
        # reference metrics/stoi.py:30-55) warns and returns 1e-5 here;
        # match it so battery averages stay finite on short utterances.
        import warnings

        warnings.warn(
            "stoi: not enough STFT frames after silence removal; "
            "returning 1e-5", RuntimeWarning)
        return 1e-5
    obm = _thirdoct(FS, NFFT, NUM_BANDS, MIN_FREQ)
    Xb = np.sqrt((obm @ (X.T**2)))  # [bands, frames]
    Yb = np.sqrt((obm @ (Y.T**2)))
    d = []
    c = 10 ** (-BETA / 20)
    for m in range(N, Xb.shape[1] + 1):
        Xs = Xb[:, m - N : m]
        Ys = Yb[:, m - N : m]
        alpha = np.sqrt(
            np.sum(Xs**2, axis=1, keepdims=True)
            / np.maximum(np.sum(Ys**2, axis=1, keepdims=True), 1e-20)
        )
        Yp = np.minimum(Ys * alpha, Xs * (1 + c))
        xn = Xs - Xs.mean(axis=1, keepdims=True)
        yn = Yp - Yp.mean(axis=1, keepdims=True)
        num = np.sum(xn * yn, axis=1)
        den = np.linalg.norm(xn, axis=1) * np.linalg.norm(yn, axis=1)
        d.append(num / np.maximum(den, 1e-20))
    return float(np.mean(d))
