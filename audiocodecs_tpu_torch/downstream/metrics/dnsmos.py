"""DNSMOS P.808, PyTorch.

Counterpart of ``audiocodecs_tpu/downstream/metrics/dnsmos.py``: Microsoft's
``model_v8`` CNN (reference ``metrics/dnsmos.py:45-152`` runs it through
onnxruntime) as an ``nn.Module`` on the card, its mel front end included.
The shipped ``dnsmos_v8.npz`` beside this module holds the converted
parameters (``conv{i}_w/b`` OIHW, ``dense{i}_w/b`` as ``[in, out]``);
:func:`dnsmos_state_dict` maps them onto the module.

Front end (librosa's ``melspectrogram(n_fft=321, hop_length=160,
n_mels=120)``): zero-padded centred frames, a periodic Hann window, the
power spectrum through the Slaney mel bank, ``power_to_db(ref=max)``
floored at -80 dB, then ``(db + 40) / 40``. The five 3 × 3 convs (ReLU, a
2 × 2 max pool after the first, second and fourth), a global max pool and
three dense layers give one MOS a 9.01 s window. The convs and the mel
projection run with TF32 off (:func:`..nn.layers.exact_fp32`).

:func:`dnsmos_p808` keeps the reference's windowing: the utterance is tiled
to at least 9.01 s, cut into 9.01 s windows at 1 s hops, and the windows'
scores averaged.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.utils.melbank import mel_filterbank_slaney

__all__ = ["DNSMOS", "DEFAULT_PARAMS_PATH", "dnsmos_p808",
           "dnsmos_state_dict", "load_dnsmos", "onnx_dnsmos",
           "save_dnsmos_params"]

SAMPLE_RATE = 16000
INPUT_LENGTH = 9.01
N_FFT = 321
HOP = 160
N_MELS = 120
SEG = int(INPUT_LENGTH * SAMPLE_RATE)  # 144160
MEL_SAMPLES = SEG - HOP  # the mel is computed over audio_seg[:-160]
_POOL = (True, True, False, True, False)
_CONVS = ((1, 32), (32, 32), (32, 32), (32, 32), (32, 64))

DEFAULT_PARAMS_PATH = os.path.join(os.path.dirname(__file__), "dnsmos_v8.npz")


class DNSMOS(nn.Module):
    """``[B, MEL_SAMPLES]`` raw 16 kHz audio → ``[B]`` P.808 MOS."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv2d(cin, cout, 3, padding=1)
                                   for cin, cout in _CONVS)
        self.dense = nn.ModuleList(nn.Linear(64, 64) for _ in range(2))
        self.dense.append(nn.Linear(64, 1))
        n = 2 * np.pi * np.arange(N_FFT) / N_FFT
        self.register_buffer("window", torch.from_numpy(
            (0.5 - 0.5 * np.cos(n)).astype(np.float32)), persistent=False)
        self.register_buffer("melfb", torch.from_numpy(
            mel_filterbank_slaney(SAMPLE_RATE, N_FFT, N_MELS)),
            persistent=False)

    def melspec(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, T]`` → normalised dB mel ``[B, frames, N_MELS]``."""
        xp = F.pad(x, (N_FFT // 2, N_FFT // 2))
        frames = xp.unfold(-1, N_FFT, HOP) * self.window
        spec = torch.fft.rfft(frames, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2  # [B, F, bins]
        mel = power @ self.melfb.T
        db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
        ref = torch.amax(db, dim=(1, 2), keepdim=True)
        db = torch.clamp(db - ref, min=-80.0)
        return (db + 40.0) / 40.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with exact_fp32():
            h = self.melspec(x)[:, None]  # NCHW, C = 1
            for conv, pool in zip(self.convs, _POOL):
                h = torch.relu(conv(h))
                if pool:
                    h = F.max_pool2d(h, 2)
            h = torch.amax(h, dim=(2, 3))  # global max pool → [B, 64]
            for i, layer in enumerate(self.dense):
                h = layer(h)
                if i < 2:
                    h = torch.relu(h)
        return h[:, 0]


def dnsmos_state_dict(params_path: str = DEFAULT_PARAMS_PATH) -> dict:
    """The npz's arrays as :class:`DNSMOS`'s state dict (float32, CPU):
    ``conv{i}_w/b`` to ``convs.{i}.weight/bias``, ``dense{i}_w`` transposed
    to ``dense.{i}.weight``."""
    with np.load(params_path) as raw:
        return _state_from_flat(raw)


def _state_from_flat(raw) -> dict:
    sd = {}
    for i in range(len(_CONVS)):
        sd[f"convs.{i}.weight"] = raw[f"conv{i}_w"]
        sd[f"convs.{i}.bias"] = raw[f"conv{i}_b"]
    for i in range(3):
        sd[f"dense.{i}.weight"] = raw[f"dense{i}_w"].T
        sd[f"dense.{i}.bias"] = raw[f"dense{i}_b"]
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}


def _flat(params: dict) -> dict:
    """:func:`..convert.dnsmos.convert_dnsmos_onnx`'s tree as the npz's
    flat ``conv{i}_w/b``, ``dense{i}_w/b``."""
    flat = {}
    for i, p in enumerate(params["conv"]):
        flat[f"conv{i}_w"], flat[f"conv{i}_b"] = p["w"], p["b"]
    for i, p in enumerate(params["dense"]):
        flat[f"dense{i}_w"], flat[f"dense{i}_b"] = p["w"], p["b"]
    return flat


def save_dnsmos_params(onnx_path: str, out_path: str) -> dict:
    """Convert ``model_v8.onnx`` and save it as the npz this module reads
    (the reference's ``save_dnsmos_params``); returns the flat arrays."""
    from audiocodecs_tpu_torch.convert.dnsmos import convert_dnsmos_onnx

    flat = _flat(convert_dnsmos_onnx(onnx_path))
    np.savez(out_path, **flat)
    return flat


def onnx_dnsmos(onnx_path: str, device=None) -> DNSMOS:
    """The model with the weights of ``model_v8.onnx`` on ``device`` (the
    card when ``None``)."""
    from audiocodecs_tpu_torch.codec import resolve_device
    from audiocodecs_tpu_torch.convert.dnsmos import convert_dnsmos_onnx

    dev = resolve_device(device)
    model = DNSMOS()
    model.load_state_dict(_state_from_flat(_flat(convert_dnsmos_onnx(
        onnx_path))), strict=True)
    return model.to(dev).eval()


@lru_cache(maxsize=4)
def load_dnsmos(params_path: str = DEFAULT_PARAMS_PATH,
                device: str = "cuda") -> DNSMOS:
    """The model with the file's weights on ``device``, built once."""
    model = DNSMOS()
    model.load_state_dict(dnsmos_state_dict(params_path), strict=True)
    return model.to(device).eval()


def dnsmos_p808(sig, sample_rate: int, params_path: str = DEFAULT_PARAMS_PATH,
                device=None, model: DNSMOS | None = None) -> float:
    """P.808 MOS of one utterance (1-D array) on ``device`` (the card when
    ``None``), with the reference's windowing: tile to ≥ 9.01 s, slide in
    1 s hops, average the windows' scores. ``model`` (on ``device``)
    takes the place of ``params_path``'s."""
    from audiocodecs_tpu_torch.codec import resolve_device
    from audiocodecs_tpu_torch.downstream.metrics.stoi import _resample_np

    dev = resolve_device(device)
    x = np.asarray(sig, dtype=np.float32).reshape(-1)
    if x.size == 0:  # empty input would tile forever below
        return float("nan")
    if sample_rate != SAMPLE_RATE:
        x = _resample_np(x.astype(np.float64),
                         sample_rate, SAMPLE_RATE).astype(np.float32)
    while len(x) < SEG:
        x = np.concatenate([x, x])
    num_hops = int(np.floor(len(x) / SAMPLE_RATE) - INPUT_LENGTH) + 1
    segs = [x[i * SAMPLE_RATE : i * SAMPLE_RATE + SEG][:MEL_SAMPLES]
            for i in range(num_hops)
            if len(x[i * SAMPLE_RATE :]) >= SEG]
    if not segs:
        return float("nan")
    if model is None:
        model = load_dnsmos(params_path, str(dev))
    with torch.inference_mode():
        scores = model(torch.from_numpy(np.stack(segs)).to(dev))
        return float(scores.mean(dtype=torch.float32).cpu())

