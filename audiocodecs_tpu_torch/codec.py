"""Standardized codec interface, PyTorch.

Counterpart of ``audiocodecs_tpu/codec.py``. The tensor contract is the
same: ``[B, T]`` waveforms ↔ ``[B, N, K]`` token grids ↔ ``[B, N, H]``
features, with relative ``length`` vectors in ``[0, 1]``. A ``Codec`` is an
``nn.Module`` that owns its weights on one device: the card unless the
caller asks for another (``device="cpu"``). Entry points take numpy arrays or
tensors, move them to that device, and run under ``torch.inference_mode()``
with TF32 off. PyTorch runs eagerly, so there is no jit cache:
:meth:`Codec.roundtrip` is the whole encode-and-decode path.

Sample-rate conversion in and out of the model's native rate uses the
polyphase resampler (:mod:`audiocodecs_tpu_torch.resample`). Token
corruption (:meth:`Codec.resample`) takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch import nn

from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.resample import resample as _resample_sig

__all__ = ["Codec", "CodecConfig", "MODES", "prune_params_for_mode",
           "resolve_device"]

MODES = ("encode", "decode", "reconstruct")


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Static configuration shared by every codec (the reference's)."""

    sample_rate: int
    orig_sample_rate: int
    mode: str = "reconstruct"
    num_codebooks: int = 1
    vocab_size: int = 1024
    vocab_sizes: Optional[tuple] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"`mode` ({self.mode}) must be one of {list(MODES)}")
        if self.vocab_sizes is not None:
            object.__setattr__(self, "vocab_sizes",
                               tuple(int(c) for c in self.vocab_sizes))
            if len(self.vocab_sizes) != self.num_codebooks:
                raise ValueError(f"{len(self.vocab_sizes)} vocab_sizes for "
                                 f"{self.num_codebooks} codebooks")
            if max(self.vocab_sizes) != self.vocab_size:
                raise ValueError(f"max(vocab_sizes)={max(self.vocab_sizes)} "
                                 f"must equal vocab_size={self.vocab_size}")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without CUDA that is an error, not the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the codec runs on the GPU by default; "
                "pass device='cpu' to run it on the CPU")
        device = "cuda"
    return torch.device(device)


def prune_params_for_mode(state_dict: dict, mode: str) -> dict:
    """Drop the entries a mode does not use (encode: no decoder; decode:
    no encoder)."""
    drop = {"encode": "decoder.", "decode": "encoder."}.get(mode)
    if drop is None:
        return dict(state_dict)
    return {k: v for k, v in state_dict.items() if not k.startswith(drop)}


def _serving(fn):
    """Entry-point wrapper: inference mode, TF32 off."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.inference_mode(), exact_fp32():
            return fn(*args, **kwargs)

    return wrapper


class Codec(nn.Module):
    """Abstract standardized codec.

    Subclasses implement ``_sig_to_toks`` / ``_toks_to_sig`` /
    ``_sig_to_feats`` / ``_sig_to_qfeats`` (and optionally
    ``_toks_to_qfeats`` / ``_feats_to_sig``) over tensors already on the
    codec's device and at its native rate, and ``embs()`` → ``[K, C, H]``.
    """

    def __init__(self, config: CodecConfig, device=None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        self._logits_cache: Optional[torch.Tensor] = None

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def orig_sample_rate(self) -> int:
        return self.config.orig_sample_rate

    @property
    def mode(self) -> str:
        return self.config.mode

    def forward(self, x, length=None):
        """Dispatch on mode: encode → toks, decode → sig, reconstruct → sig."""
        if self.mode == "encode":
            return self.sig_to_toks(x, length)
        if self.mode == "decode":
            return self.toks_to_sig(x, length)
        return self.toks_to_sig(self.sig_to_toks(x, length), length)

    @_serving
    def sig_to_toks(self, sig, length=None) -> torch.Tensor:
        """``[B, T]`` → ``[B, N, K]`` token grid (int64)."""
        sig = self._to_native_rate(self._tensor(sig, torch.float32))
        return self._sig_to_toks(sig, self._length(sig, length))

    @_serving
    def sig_to_feats(self, sig, length=None) -> torch.Tensor:
        """``[B, T]`` → ``[B, N, H]`` pre-quantization encoder features."""
        sig = self._to_native_rate(self._tensor(sig, torch.float32))
        return self._sig_to_feats(sig, self._length(sig, length))

    @_serving
    def sig_to_qfeats(self, sig, length=None) -> torch.Tensor:
        """``[B, T]`` → ``[B, N, H]`` post-quantization features."""
        sig = self._to_native_rate(self._tensor(sig, torch.float32))
        return self._sig_to_qfeats(sig, self._length(sig, length))

    @_serving
    def toks_to_sig(self, toks, length=None) -> torch.Tensor:
        """``[B, N, K]`` → ``[B, T]`` waveform."""
        toks = self._tensor(toks, torch.int64)
        return self._from_native_rate(
            self._toks_to_sig(toks, self._length(toks, length)))

    @_serving
    def toks_to_qfeats(self, toks, length=None) -> torch.Tensor:
        """``[B, N, K]`` → ``[B, N, H]`` quantized features."""
        toks = self._tensor(toks, torch.int64)
        return self._toks_to_qfeats(toks, self._length(toks, length))

    @_serving
    def feats_to_sig(self, feats, length=None) -> torch.Tensor:
        """``[B, N, H]`` → ``[B, T]`` waveform (vocode from features)."""
        feats = self._tensor(feats, torch.float32)
        return self._from_native_rate(
            self._feats_to_sig(feats, self._length(feats, length)))

    @_serving
    def roundtrip(self, sig) -> torch.Tensor:
        """Encode then decode ``[B, T]`` with the public path's resampling
        (the serving and benchmarking path)."""
        sig = self._to_native_rate(self._tensor(sig, torch.float32))
        toks = self._sig_to_toks(sig, None)
        return self._from_native_rate(self._toks_to_sig(toks, None))

    # ------------------------------------------------------------------ #
    # Token corruption and codebook logits
    # ------------------------------------------------------------------ #

    @_serving
    def resample(self, toks, generator: torch.Generator, p: float = 0.2,
                 temp: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None) -> torch.Tensor:
        """Stochastically corrupt tokens ``[B, N, K]``.

        With probability ``p`` per position, replace the token with a sample
        from the codebook-similarity distribution of the current token's
        row (temperature, then top-k or top-p filtered). ``generator`` is on
        the codec's device; its draws differ from ``jax.random``'s.
        """
        toks = self._tensor(toks, torch.int64)
        if p <= 0.0:
            return toks
        if top_k is not None and top_p is not None:
            raise NotImplementedError("choose at most one of top_k / top_p")
        logits = self.logits()  # [K, C, C]
        B, N, K = toks.shape
        C = logits.shape[-1]
        flat = logits.reshape(K * C, C)
        idx = toks + (torch.arange(K, device=toks.device) * C)[None, None]
        sel = flat[idx] / temp  # [B, N, K, C]
        if top_k is not None:
            kth = torch.sort(sel, dim=-1).values[..., -top_k][..., None]
            sel = torch.where(sel < kth, float("-inf"), sel)
        elif top_p is not None:
            probs = torch.softmax(sel, dim=-1)
            order = torch.argsort(-probs, dim=-1)
            sorted_probs = torch.gather(probs, -1, order)
            drop_sorted = (torch.cumsum(sorted_probs, -1) - sorted_probs) > top_p
            drop = torch.gather(drop_sorted, -1, torch.argsort(order, dim=-1))
            sel = torch.where(drop, float("-inf"), sel)
        mask = torch.rand(toks.shape, generator=generator,
                          device=toks.device) < p
        probs = torch.softmax(sel, dim=-1).reshape(-1, C)
        samples = torch.multinomial(probs, 1, generator=generator)
        return torch.where(mask, samples.reshape(B, N, K), toks)

    def logits(self) -> torch.Tensor:
        """Cached pairwise codebook logits ``[K, C, C]`` (−distance, −inf on
        the diagonal and on padded rows of smaller vocabularies)."""
        if self._logits_cache is None:
            with torch.inference_mode(), exact_fp32():
                embs = self.embs()  # [K, C, H]
                sq = torch.sum(embs**2, -1)
                d2 = (sq[:, :, None]
                      - 2.0 * torch.einsum("kch,kdh->kcd", embs, embs)
                      + sq[:, None, :])
                logits = -torch.sqrt(torch.clamp(d2, min=0.0))
                C = logits.shape[-1]
                ninf = torch.tensor(float("-inf"), device=logits.device)
                if self.config.vocab_sizes is not None:
                    valid = (torch.arange(C, device=logits.device)[None, :]
                             < torch.tensor(self.config.vocab_sizes,
                                            device=logits.device)[:, None])
                    logits = torch.where(valid[:, None, :], logits, ninf)
                eye = torch.eye(C, dtype=torch.bool, device=logits.device)
                self._logits_cache = torch.where(eye[None], ninf, logits)
        return self._logits_cache

    # ------------------------------------------------------------------ #
    # Subclass surface
    # ------------------------------------------------------------------ #

    def embs(self) -> torch.Tensor:
        raise NotImplementedError

    def _sig_to_toks(self, sig, length):
        raise NotImplementedError

    def _sig_to_feats(self, sig, length):
        raise NotImplementedError

    def _sig_to_qfeats(self, sig, length):
        raise NotImplementedError

    def _toks_to_sig(self, toks, length):
        raise NotImplementedError

    def _toks_to_qfeats(self, toks, length):
        raise NotImplementedError

    def _feats_to_sig(self, feats, length):
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # Internals
    # ------------------------------------------------------------------ #

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _length(self, x, length) -> torch.Tensor:
        if length is None:
            return torch.ones(x.shape[0], dtype=torch.float32,
                              device=self.device)
        return self._tensor(length, torch.float32)

    def _to_native_rate(self, sig):
        return _resample_sig(sig, self.config.sample_rate,
                             self.config.orig_sample_rate)

    def _from_native_rate(self, sig):
        return _resample_sig(sig, self.config.orig_sample_rate,
                             self.config.sample_rate)
