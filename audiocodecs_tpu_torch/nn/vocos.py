"""Vocos-style vocoder: ConvNeXt backbone and ISTFT head, PyTorch.

Counterpart of ``audiocodecs_tpu/nn/vocos.py``. It decodes EnCodec+Vocos
(``charactr/vocos-encodec-24khz``, conditioned on a bandwidth id) and
WavTokenizer (plain LayerNorm). Architecture: embed conv7 → [ConvNeXt block
× N: depthwise conv7 → (Ada)LayerNorm → pointwise MLP (exact GELU) →
layer-scale γ → residual] → final LayerNorm → linear to ``n_fft + 2`` →
magnitude exp(·) and phase → ISTFT (Hann overlap-add).

Features stay channel-last (``[B, N, C]``), as in the reference; only the
depthwise conv sees ``[B, C, N]``. The pointwise linears fold ``[B, N, C]``
into one ``[B·N, C]`` product each. Every product and conv runs in exact
fp32 (:func:`..nn.layers.exact_fp32`). No TPU kernel covers this module:
convs, products, FFTs and norms are library calls, as the reference leaves
them to XLA.

Weights keep the reference's names: ``embed.w`` and ``blocks.<i>.dwconv.w``
are :class:`..nn.layers.Conv1d` weights (``[dim, Cin, 7]`` and ``[dim, 1,
7]``), the linears ``pw1``, ``pw2`` and ``head`` are ``w [in, out]`` with
``b``, the norms ``g``/``b``, the AdaLN tables ``scale``/``shift [n, dim]``
and the continuous AdaLN ``scale_w``/``shift_w [cond_dim, dim]`` with
``scale_b``/``shift_b``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.nn.layers import Conv1d, exact_fp32
from audiocodecs_tpu_torch.nn.transformer import Linear, Norm

__all__ = ["VocosConfig", "Vocos", "apply_vocos", "apply_vocos_backbone",
           "init_vocos_params", "init_vocos_backbone_params", "istft"]


@dataclasses.dataclass(frozen=True)
class VocosConfig:
    input_channels: int = 128
    dim: int = 384
    intermediate_dim: int = 1152
    num_layers: int = 8
    n_fft: int = 1280
    hop_length: int = 320
    num_adanorm_embeddings: Optional[int] = 4  # None → plain LayerNorm
    eps: float = 1e-6


# ----------------------------------------------------------------------- #
# Modules (weights only; the functions below apply them)
# ----------------------------------------------------------------------- #


class AdaNorm(nn.Module):
    """Per-condition LayerNorm gain and bias tables, ``[n, dim]`` each."""

    def __init__(self, n: int, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(n, dim))
        self.shift = nn.Parameter(torch.empty(n, dim))


class AdaNormCont(nn.Module):
    """LayerNorm gain and bias as linears of a condition vector."""

    def __init__(self, cond_dim: int, dim: int):
        super().__init__()
        self.scale_w = nn.Parameter(torch.empty(cond_dim, dim))
        self.scale_b = nn.Parameter(torch.empty(dim))
        self.shift_w = nn.Parameter(torch.empty(cond_dim, dim))
        self.shift_b = nn.Parameter(torch.empty(dim))


def _norm_module(cfg: VocosConfig, cond_dim: Optional[int]):
    """(name suffix, module) of a norm in the config's form."""
    if cond_dim is not None:
        return "adanorm_cont", AdaNormCont(cond_dim, cfg.dim)
    if cfg.num_adanorm_embeddings:
        return "adanorm", AdaNorm(cfg.num_adanorm_embeddings, cfg.dim)
    return "norm", Norm(cfg.dim, "layernorm")


class ConvNeXtBlock(nn.Module):
    def __init__(self, cfg: VocosConfig, cond_dim: Optional[int] = None):
        super().__init__()
        self.dwconv = Conv1d(1, cfg.dim, 7)
        name, norm = _norm_module(cfg, cond_dim)
        self.add_module(name, norm)
        self.pw1 = Linear(cfg.dim, cfg.intermediate_dim, bias=True)
        self.pw2 = Linear(cfg.intermediate_dim, cfg.dim, bias=True)
        self.gamma = nn.Parameter(torch.empty(cfg.dim))


class Vocos(nn.Module):
    """Embed conv, ConvNeXt blocks, the in and out norms and (with
    ``head=True``) the ISTFT head's linear. ``cond_dim`` switches every
    norm but the last to continuous AdaLN (the backbone-only form)."""

    def __init__(self, cfg: VocosConfig, head: bool = True,
                 cond_dim: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = Conv1d(cfg.input_channels, cfg.dim, 7)
        name, norm = _norm_module(cfg, cond_dim)
        self.add_module(f"{name}_in", norm)
        self.blocks = nn.ModuleList(ConvNeXtBlock(cfg, cond_dim)
                                    for _ in range(cfg.num_layers))
        self.norm_out = Norm(cfg.dim, "layernorm")
        self.head = Linear(cfg.dim, cfg.n_fft + 2, bias=True) if head else None


# ----------------------------------------------------------------------- #
# Functions
# ----------------------------------------------------------------------- #


def _layernorm(x, g, b, eps):
    """LayerNorm over the last axis (biased variance)."""
    return F.layer_norm(x, (x.shape[-1],), g, b, eps)


def _ada_layernorm(x, p: AdaNorm, cond_id: int, eps):
    """Conditional LayerNorm: row ``cond_id`` of the scale/shift tables."""
    return F.layer_norm(x, (x.shape[-1],), p.scale[cond_id],
                        p.shift[cond_id], eps)


def _ada_layernorm_cont(x, p: AdaNormCont, cond, eps):
    """LayerNorm scaled and shifted by linears of ``cond`` [B, cond_dim]."""
    with exact_fp32():
        scale = torch.addmm(p.scale_b, cond, p.scale_w)
        shift = torch.addmm(p.shift_b, cond, p.shift_w)
    n = F.layer_norm(x, (x.shape[-1],), eps=eps)
    return n * scale[:, None, :] + shift[:, None, :]


def _dense(x, p: Linear):
    """``x @ w + b`` over the last axis as one ``[B·N, in]`` product."""
    with exact_fp32():
        y = torch.addmm(p.b, x.reshape(-1, x.shape[-1]), p.w)
    return y.view(*x.shape[:-1], y.shape[-1])


def _conv7(x, p: Conv1d, groups: int = 1):
    """Zero-padded ("same") conv7 of channel-last ``x`` [B, N, C]."""
    with exact_fp32():
        y = F.conv1d(x.transpose(1, 2), p.w, p.b, padding=3, groups=groups)
    return y.transpose(1, 2)


def _apply_norm(x, owner: nn.Module, name: str, cfg: VocosConfig, cond_id,
                cond):
    """The reference's order: continuous AdaLN if given a ``cond`` and the
    module has one, then AdaLN if given a ``cond_id``, else LayerNorm."""
    if cond is not None and hasattr(owner, f"adanorm_cont{name}"):
        return _ada_layernorm_cont(x, getattr(owner, f"adanorm_cont{name}"),
                                   cond, cfg.eps)
    if cond_id is not None and hasattr(owner, f"adanorm{name}"):
        return _ada_layernorm(x, getattr(owner, f"adanorm{name}"), cond_id,
                              cfg.eps)
    p = getattr(owner, f"norm{name}")
    return _layernorm(x, p.g, p.b, cfg.eps)


def _convnext_block(x, p: ConvNeXtBlock, cfg: VocosConfig, cond_id,
                    cond=None):
    h = _conv7(x, p.dwconv, groups=cfg.dim)
    h = _apply_norm(h, p, "", cfg, cond_id, cond)
    h = F.gelu(_dense(h, p.pw1), approximate="none")
    h = _dense(h, p.pw2)
    return x + h * p.gamma


def _hann(n_fft: int, device) -> torch.Tensor:
    """The periodic Hann window as the reference builds it: in float64 by
    numpy, then cast to float32."""
    return torch.from_numpy(
        np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(device)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """``frames`` [B, N, n] at offsets ``i·hop`` summed into ``[B, (N−1)·hop
    + n]``. ``F.fold`` gathers each output sample's terms in a fixed order,
    so the sum is the same on every run (no atomics)."""
    B, N, n = frames.shape
    out_len = (N - 1) * hop + n
    y = F.fold(frames.transpose(1, 2), output_size=(1, out_len),
               kernel_size=(1, n), stride=(1, hop))
    return y.view(B, out_len)


def istft(spec_real: torch.Tensor, spec_imag: torch.Tensor, n_fft: int,
          hop: int, padding: str = "center") -> torch.Tensor:
    """Inverse STFT with a Hann window, the reference's arithmetic.

    ``[B, N, n_fft//2+1]`` → ``[B, (N−1)·hop]`` with ``padding="center"``
    (trims ``n_fft//2`` a side), ``[B, N·hop]`` with ``"same"`` (trims
    ``(n_fft − hop)//2``). The imaginary parts of the DC and Nyquist bins
    are zeroed first: the reference's ``irfft`` ignores them, and a
    complex-to-real FFT that assumes a Hermitian input need not. The
    overlap-add is divided by ``max(Σw², 1e-11)``.
    """
    half = n_fft // 2 + 1
    keep = torch.ones(half, dtype=spec_imag.dtype, device=spec_imag.device)
    keep[0] = 0.0
    if n_fft % 2 == 0:
        keep[-1] = 0.0
    spec = torch.complex(spec_real, spec_imag * keep)
    window = _hann(n_fft, spec_real.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window  # [B, N, n_fft]
    B, N, _ = frames.shape
    y = _overlap_add(frames, hop)
    win_sq = _overlap_add((window * window).expand(1, N, n_fft), hop)
    y = y / torch.clamp(win_sq, min=1e-11)
    pad = n_fft // 2 if padding == "center" else (n_fft - hop) // 2
    return y[:, pad: y.shape[1] - pad]


def apply_vocos_backbone(model: Vocos, feats: torch.Tensor,
                         cfg: VocosConfig, cond_id: Optional[int] = None,
                         cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embed conv, ConvNeXt blocks and the final norm: ``feats`` [B, N,
    input_channels] → [B, N, dim]. ``cond_id``: the AdaLN row (a Python
    int); ``cond``: a continuous AdaLN condition [B, cond_dim]."""
    x = _conv7(feats, model.embed)
    x = _apply_norm(x, model, "_in", cfg, cond_id, cond)
    for p in model.blocks:
        x = _convnext_block(x, p, cfg, cond_id, cond)
    return _layernorm(x, model.norm_out.g, model.norm_out.b, cfg.eps)


def apply_vocos(model: Vocos, feats: torch.Tensor, cfg: VocosConfig,
                cond_id: Optional[int] = None) -> torch.Tensor:
    """``feats`` [B, N, input_channels] → waveform [B, (N−1)·hop] (the ISTFT
    with ``padding="center"``, as the reference calls it)."""
    y = _dense(apply_vocos_backbone(model, feats, cfg, cond_id), model.head)
    half = cfg.n_fft // 2 + 1
    mag = torch.exp(torch.clamp(y[..., :half], max=100.0))
    phase = y[..., half:]
    return istft(mag * torch.cos(phase), mag * torch.sin(phase), cfg.n_fft,
                 cfg.hop_length)


# ----------------------------------------------------------------------- #
# Init (random weights from an explicit generator)
# ----------------------------------------------------------------------- #


def init_vocos_params(generator: torch.Generator, cfg: VocosConfig) -> dict:
    """Flat state dict of a :class:`Vocos` with its head, in the reference
    package's distributions: convs N(0, 0.02²), linears N(0, 1/in), biases
    0, γ 1e-6, norms 1 and 0 (the draws differ from ``jax.random``'s)."""
    out = {}
    dim = cfg.dim

    def lin(name, i, o):
        out[f"{name}.w"] = torch.randn(i, o, generator=generator) * i ** -0.5
        out[f"{name}.b"] = torch.zeros(o)

    def norm(owner, suffix=""):
        n = cfg.num_adanorm_embeddings
        if n:
            out[f"{owner}adanorm{suffix}.scale"] = torch.ones(n, dim)
            out[f"{owner}adanorm{suffix}.shift"] = torch.zeros(n, dim)
        else:
            out[f"{owner}norm{suffix}.g"] = torch.ones(dim)
            out[f"{owner}norm{suffix}.b"] = torch.zeros(dim)

    for li in range(cfg.num_layers):
        pre = f"blocks.{li}"
        out[f"{pre}.dwconv.w"] = torch.randn(dim, 1, 7,
                                             generator=generator) * 0.02
        out[f"{pre}.dwconv.b"] = torch.zeros(dim)
        lin(f"{pre}.pw1", dim, cfg.intermediate_dim)
        lin(f"{pre}.pw2", cfg.intermediate_dim, dim)
        out[f"{pre}.gamma"] = torch.full((dim,), 1e-6)
        norm(f"{pre}.")
    out["embed.w"] = torch.randn(dim, cfg.input_channels, 7,
                                 generator=generator) * 0.02
    out["embed.b"] = torch.zeros(dim)
    norm("", "_in")
    out["norm_out.g"] = torch.ones(dim)
    out["norm_out.b"] = torch.zeros(dim)
    lin("head", dim, cfg.n_fft + 2)
    return out


def init_vocos_backbone_params(generator: torch.Generator, cfg: VocosConfig,
                               cond_dim: Optional[int] = None) -> dict:
    """The backbone without the head; ``cond_dim`` turns every norm but the
    last into continuous AdaLN (gain and bias weights N(0, 0.02²), biases 1
    and 0), as ``Vocos(cfg, head=False, cond_dim=cond_dim)`` holds them."""
    out = {k: v for k, v in init_vocos_params(generator, cfg).items()
           if not k.startswith("head.")}
    if cond_dim is None:
        return out
    out = {k: v for k, v in out.items()
           if not (".norm." in f".{k}" or k.startswith("norm_in.")
                   or "adanorm" in k)}
    for name in [f"blocks.{li}.adanorm_cont" for li in range(cfg.num_layers)
                 ] + ["adanorm_cont_in"]:
        out[f"{name}.scale_w"] = torch.randn(
            cond_dim, cfg.dim, generator=generator) * 0.02
        out[f"{name}.scale_b"] = torch.ones(cfg.dim)
        out[f"{name}.shift_w"] = torch.randn(
            cond_dim, cfg.dim, generator=generator) * 0.02
        out[f"{name}.shift_b"] = torch.zeros(cfg.dim)
    return out
