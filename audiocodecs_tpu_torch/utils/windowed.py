"""Windowed codec inference for long audio.

Counterpart of ``audiocodecs_tpu/utils/windowed.py``: any codec of the zoo
reconstructs an arbitrarily long ``[B, T]`` signal through fixed windows of
``window_seconds`` that overlap by ``overlap_ratio`` of a window. Each
window is one roundtrip (``sig_to_toks`` then ``toks_to_sig``) on the
codec's device; the host crossfades the outputs with linear ramps over the
overlap, in float64. The first window's head and the last window's tail
stay flat: no neighbour fades with them.

For causal codecs the streaming API (``encode_chunk`` / ``decode_chunk``)
is exact; windowing is the tool for the non-causal ones.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["windowed_reconstruct", "window_starts"]


def window_starts(T: int, window: int, hop: int) -> list[int]:
    """The first sample of each window: every ``hop`` samples, up to the
    first window that reaches the end."""
    starts = []
    for start in range(0, T, hop):
        starts.append(start)
        if start + window >= T:
            break
    return starts


def _queue_window(codec, chunk: np.ndarray):
    """Queue one window's roundtrip on the codec's device and its copy to
    the host; returns ``(host array or tensor, event or None)``."""
    dev = codec.device
    x = torch.from_numpy(np.ascontiguousarray(chunk, dtype=np.float32))
    if dev.type != "cuda":
        return codec.toks_to_sig(codec.sig_to_toks(x)).cpu().numpy(), None
    x = x.pin_memory().to(dev, non_blocking=True)
    rec = codec.toks_to_sig(codec.sig_to_toks(x))
    with torch.inference_mode():
        host = torch.empty(rec.shape, dtype=rec.dtype, pin_memory=True)
        host.copy_(rec, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    return host, done


def _fetch(pending) -> np.ndarray:
    host, done = pending
    if done is None:
        return host
    done.synchronize()
    return host.numpy()


def windowed_reconstruct(codec, sig: np.ndarray, window_seconds: float = 10.0,
                         overlap_ratio: float = 0.1) -> np.ndarray:
    """Reconstruct ``sig`` ``[B, T]`` (float32, at ``codec.sample_rate``)
    through fixed windows; returns ``[B, T]`` float32 on the host.

    A signal no longer than one window is one roundtrip. Otherwise the
    windows start every ``hop = window - overlap`` samples and the last is
    zero-padded to the full window, so every roundtrip has one shape. Window
    ``i + 1``'s input copy, roundtrip and output copy are queued on the card
    before the host waits for window ``i``'s output, so the card computes
    while the host crossfades."""
    sr = codec.sample_rate
    window = int(window_seconds * sr)
    overlap = int(window * overlap_ratio)
    hop = window - overlap
    sig = np.asarray(sig, dtype=np.float32)
    B, T = sig.shape
    if T <= window:
        return _fetch(_queue_window(codec, sig))[:, :T]

    out = np.zeros((B, T + window), np.float64)
    weight = np.zeros((T + window,), np.float64)
    starts = window_starts(T, window, hop)

    def window_ramp(start: int) -> np.ndarray:
        ramp = np.ones(window)
        if overlap > 0:
            if start != starts[0]:
                ramp[:overlap] = np.linspace(0.0, 1.0, overlap,
                                             endpoint=False)
            if start != starts[-1]:
                ramp[-overlap:] = np.linspace(1.0, 0.0, overlap,
                                              endpoint=False)
        return ramp

    def accumulate(rec: np.ndarray, start: int) -> None:
        n = min(rec.shape[1], window)
        ramp = window_ramp(start)
        out[:, start : start + n] += rec[:, :n] * ramp[:n]
        weight[start : start + n] += ramp[:n]

    pending: list = []
    for start in starts:
        chunk = sig[:, start : start + window]
        pad = window - chunk.shape[1]
        if pad:
            chunk = np.pad(chunk, ((0, 0), (0, pad)))
        pending.append((start, _queue_window(codec, chunk)))
        if len(pending) > 1:
            s0, p0 = pending.pop(0)
            accumulate(_fetch(p0), s0)
    for s0, p0 in pending:
        accumulate(_fetch(p0), s0)
    out = out[:, :T] / np.maximum(weight[:T], 1e-8)
    return out.astype(np.float32)
