"""AudioMAE's patch ViT (SemantiCodec's semantic encoder), PyTorch.

Counterpart of ``audiocodecs_tpu/nn/audiomae.py``, weight-compatible with
its param tree (timm's names) through
:func:`audiocodecs_tpu_torch.params.from_jax_params`. A 1024-frame window of
a 128-bin kaldi fbank becomes 512 patches of 16 × 16 (64 along time, 8
along the bins), a cls token goes in front, then 12 pre-LN blocks of 768
wide with 12 heads: ``[B, 513, 768]`` a window, the cls dropped unless
``keep_cls``.

The patch embed is the reference's: the window reshaped to ``(B, gh, ps,
gw, ps)``, axes ``(0, 1, 3, 2, 4)``, then one product over the 256 pixels
of each patch with ``patch_embed.w`` [256, D], the patches in time-major
order (8 frequency patches a time column). The cls token and
``pos_embed`` are added before the blocks. LayerNorm eps is 1e-6, GELU is
exact, the attention's softmax runs in float32.

The tokens depend on this output, so all of it runs in exact float32
(TF32 off), as the reference's products at ``Precision.HIGHEST``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.nn.transformer import Linear, Norm, attention

__all__ = ["AudioMAE", "AudioMAEConfig", "apply_audiomae",
           "init_audiomae_params"]


@dataclasses.dataclass(frozen=True)
class AudioMAEConfig:
    mel_frames: int = 1024  # window length in mel frames
    mel_bins: int = 128
    patch_size: int = 16
    hidden_size: int = 768  # ViT-B
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    eps: float = 1e-6

    @property
    def grid(self) -> tuple[int, int]:
        return (self.mel_frames // self.patch_size,
                self.mel_bins // self.patch_size)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid
        return gh * gw


class Attention(nn.Module):
    def __init__(self, D: int):
        super().__init__()
        self.qkv = Linear(D, 3 * D, bias=True)
        self.proj = Linear(D, D, bias=True)


class MLP(nn.Module):
    def __init__(self, D: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(D, hidden, bias=True)
        self.fc2 = Linear(hidden, D, bias=True)


class ViTBlock(nn.Module):
    def __init__(self, cfg: AudioMAEConfig):
        super().__init__()
        D = cfg.hidden_size
        self.norm1, self.attn = Norm(D, "layernorm"), Attention(D)
        self.norm2 = Norm(D, "layernorm")
        self.mlp = MLP(D, int(D * cfg.mlp_ratio))


class AudioMAE(nn.Module):
    """``patch_embed``, ``cls_token`` [1, D], ``pos_embed`` [P + 1, D],
    ``blocks`` and the final ``norm``."""

    def __init__(self, cfg: AudioMAEConfig):
        super().__init__()
        D = cfg.hidden_size
        self.patch_embed = Linear(cfg.patch_size ** 2, D, bias=True)
        self.cls_token = nn.Parameter(torch.empty(1, D))
        self.pos_embed = nn.Parameter(torch.empty(cfg.num_patches + 1, D))
        self.blocks = nn.ModuleList(ViTBlock(cfg)
                                    for _ in range(cfg.num_layers))
        self.norm = Norm(D, "layernorm")


def _ln(x, p: Norm, eps: float):
    return F.layer_norm(x, (x.shape[-1],), p.g, p.b, eps)


def _lin(x, p: Linear):
    return torch.matmul(x, p.w) + p.b


def apply_audiomae(model: AudioMAE, mel: torch.Tensor, cfg: AudioMAEConfig,
                   keep_cls: bool = False) -> torch.Tensor:
    """``mel`` [B, mel_frames, mel_bins] → features [B, (1 +) P, D]."""
    B = mel.shape[0]
    ps, (gh, gw) = cfg.patch_size, cfg.grid
    D, H = cfg.hidden_size, cfg.num_heads
    x = mel.reshape(B, gh, ps, gw, ps).permute(0, 1, 3, 2, 4)
    with exact_fp32():
        x = _lin(x.reshape(B, gh * gw, ps * ps), model.patch_embed)
        x = torch.cat([model.cls_token.expand(B, 1, D), x], dim=1)
        x = x + model.pos_embed[None, : x.shape[1]]
        N = x.shape[1]
        for blk in model.blocks:
            qkv = _lin(_ln(x, blk.norm1, cfg.eps), blk.attn.qkv)
            q, k, v = (t.reshape(B, N, H, D // H)
                       for t in torch.chunk(qkv, 3, dim=-1))
            a = attention(q, k, v).reshape(B, N, D)
            x = x + _lin(a, blk.attn.proj)
            h = F.gelu(_lin(_ln(x, blk.norm2, cfg.eps), blk.mlp.fc1))
            x = x + _lin(h, blk.mlp.fc2)
        x = _ln(x, model.norm, cfg.eps)
    return x if keep_cls else x[:, 1:]


def init_audiomae_params(generator: torch.Generator, cfg: AudioMAEConfig,
                         prefix: str = "") -> dict:
    """Flat state dict of an :class:`AudioMAE` in the reference's
    distributions (linears N(0, 1/in) with zero biases, norms 1 and 0, the
    cls token and positions N(0, 0.02²)); the draws differ from
    ``jax.random``'s."""
    out, D = {}, cfg.hidden_size
    hidden = int(D * cfg.mlp_ratio)

    def lin(name, i, o):
        out[f"{name}.w"] = torch.randn((i, o), generator=generator) * i ** -.5
        out[f"{name}.b"] = torch.zeros(o)

    def norm(name):
        out[f"{name}.g"] = torch.ones(D)
        out[f"{name}.b"] = torch.zeros(D)

    for li in range(cfg.num_layers):
        pre = f"blocks.{li}"
        norm(f"{pre}.norm1")
        lin(f"{pre}.attn.qkv", D, 3 * D)
        lin(f"{pre}.attn.proj", D, D)
        norm(f"{pre}.norm2")
        lin(f"{pre}.mlp.fc1", D, hidden)
        lin(f"{pre}.mlp.fc2", hidden, D)
    lin("patch_embed", cfg.patch_size ** 2, D)
    out["cls_token"] = torch.randn((1, D), generator=generator) * 0.02
    out["pos_embed"] = torch.randn((cfg.num_patches + 1, D),
                                   generator=generator) * 0.02
    norm("norm")
    return {prefix + k: v for k, v in out.items()}
