"""HiFi-GAN generator (jik876, ResBlock1), PyTorch, ``[B, C, T]``.

Counterpart of ``audiocodecs_tpu/nn/hifigan.py``, weight-compatible with
its param tree through :func:`audiocodecs_tpu_torch.params.from_jax_params`
(conv weights ``[K, Cin, Cout]`` there; transposed convs stored
pre-flipped there and unflipped here). SemantiCodec's decode chain ends in
it (the AudioLDM 16 kHz config: 64 mels, hop 160, rates 5·4·2·2·2), and
WavLM + K-means' ``vocoder_variant="hifigan"`` vocodes 50 Hz WavLM features
with it (hop 320).

``conv_pre`` (k7, "same" zero padding) → per stage: leaky ReLU (0.1) → the
transposed conv (kernel K, stride u), cropped by ``(K − u) // 2`` at both
ends (so ``T·u + 1`` samples where ``K − u`` is odd) → the MRF, the
**mean** of the ResBlock1s (per dilation d: leaky → conv(k, d) → leaky →
conv(k, 1), plus the input) → leaky ReLU at slope **0.01** (the vendor's
bare ``F.leaky_relu``) → ``conv_post`` (k7) → tanh.

Each conv is a cuDNN call in a :class:`..nn.layers.DecodeForm`: exact
float32 by default, or bf16 activations and weights (SemantiCodec's serving
tier), where every conv, sum, mean and activation rounds to bf16 as in the
reference. cuDNN runs the transposed convs as backward-data convs, whose
algorithms may sum with atomics (two decodes of the same tokens differed
in the last bits on the H100), so the generator runs inside
:func:`..nn.layers.deterministic_convs` (no slower there). The ResBlock1
looks like DAC's residual unit but is another function (leaky ReLU, a
k-tap second conv), so the DAC unit's kernel does not take it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from audiocodecs_tpu_torch.nn.layers import (
    Conv1d,
    ConvTranspose1d,
    DecodeForm,
    deterministic_convs,
)

__all__ = ["AUDIOLDM_16K", "HiFiGAN", "HiFiGANConfig", "apply_hifigan",
           "init_hifigan_params"]


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    num_mels: int = 64
    upsample_rates: tuple = (5, 4, 2, 2, 2)
    upsample_kernel_sizes: tuple = (16, 16, 8, 4, 4)
    upsample_initial_channel: int = 1024
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))

    @property
    def hop_length(self) -> int:
        out = 1
        for u in self.upsample_rates:
            out *= u
        return out

    def stage_channels(self, i: int) -> int:
        return self.upsample_initial_channel // (2 ** (i + 1))


# AudioLDM / SemantiCodec 16 kHz vocoder (64-bin mel, hop 160)
AUDIOLDM_16K = HiFiGANConfig()


class ResUnit(nn.Module):
    """One dilation of a ResBlock1: ``c1`` (dilated) and ``c2``."""

    def __init__(self, c: int, k: int):
        super().__init__()
        self.c1, self.c2 = Conv1d(c, c, k), Conv1d(c, c, k)


class HiFiGAN(nn.Module):
    """``conv_pre``, ``ups``, ``resblocks[stage][kernel][dilation]`` and
    ``conv_post``, the reference's tree."""

    def __init__(self, cfg: HiFiGANConfig):
        super().__init__()
        ch = cfg.upsample_initial_channel
        self.conv_pre = Conv1d(cfg.num_mels, ch, 7)
        ups, stages = [], []
        for i, k in enumerate(cfg.upsample_kernel_sizes):
            cout = cfg.stage_channels(i)
            ups.append(ConvTranspose1d(ch, cout, k))
            stages.append(nn.ModuleList(
                nn.ModuleList(ResUnit(cout, rk) for _ in rd)
                for rk, rd in zip(cfg.resblock_kernel_sizes,
                                  cfg.resblock_dilation_sizes)))
            ch = cout
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(stages)
        self.conv_post = Conv1d(ch, 1, 7)


def _leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def _same(form: DecodeForm, x, conv: Conv1d, dilation: int = 1):
    pad = (conv.w.shape[-1] - 1) * dilation // 2
    return form.conv1d(x, conv, dilation=dilation, pad=pad)


def apply_hifigan(model: HiFiGAN, mel: torch.Tensor, cfg: HiFiGANConfig,
                  form: DecodeForm = DecodeForm()) -> torch.Tensor:
    """``mel`` [B, num_mels, T], in ``form``'s dtype (or, in the exact
    form, the weights') → waveform [B, T·hop (+ the odd stages' extra
    samples)] in that dtype."""
    with deterministic_convs():
        x = _same(form, mel, model.conv_pre)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            y = form.conv_transpose1d(_leaky(x, 0.1), model.ups[i],
                                      stride=u)
            p = (k - u) // 2
            y = y[..., p: y.shape[-1] - p]
            acc = None
            for units, dils in zip(model.resblocks[i],
                                   cfg.resblock_dilation_sizes):
                r = y
                for unit, d in zip(units, dils):
                    xt = _same(form, _leaky(r, 0.1), unit.c1, d)
                    r = r + _same(form, _leaky(xt, 0.1), unit.c2)
                acc = r if acc is None else acc + r
            x = acc / len(cfg.resblock_kernel_sizes)
        x = _same(form, _leaky(x, 0.01), model.conv_post)
    return torch.tanh(x)[:, 0]


def init_hifigan_params(generator: torch.Generator, cfg: HiFiGANConfig,
                        prefix: str = "") -> dict:
    """Flat state dict of a :class:`HiFiGAN` in the reference's
    distributions (conv weights N(0, 0.02²), zero biases); the draws differ
    from ``jax.random``'s."""
    out = {}

    def conv(name, shape, cout):
        out[f"{prefix}{name}.w"] = torch.randn(shape,
                                               generator=generator) * 0.02
        out[f"{prefix}{name}.b"] = torch.zeros(cout)

    ch = cfg.upsample_initial_channel
    conv("conv_pre", (ch, cfg.num_mels, 7), ch)
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        cout = cfg.stage_channels(i)
        conv(f"ups.{i}", (ch, cout, k), cout)
        for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                         cfg.resblock_dilation_sizes)):
            for d in range(len(rd)):
                for c in ("c1", "c2"):
                    conv(f"resblocks.{i}.{j}.{d}.{c}", (cout, cout, rk),
                         cout)
        ch = cout
    conv("conv_post", (1, ch, 7), 1)
    return out
