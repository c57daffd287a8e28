"""SEANet-style convolutional encoder/decoder stacks (EnCodec family).

Counterpart of ``audiocodecs_tpu/nn/seanet.py``: the same layer plans (a
list of ``(kind, layer_index, meta...)`` specs) build the modules, drive the
forward pass and name the state-dict keys (``<layer_index>.w`` …), so the
weight bridge maps the reference's param tree key for key. Inside the stacks
the layout is PyTorch's ``[B, C, T]``.

A stack computes in a :class:`..nn.layers.DecodeForm`, fixed when it is
built: the reference's ``_apply_plan`` under its switches
(``ACX_ACT_DTYPE``, ``ACX_CONV_PRECISION``). A bf16 form casts the input
to bf16 and the output back to the input's dtype; convs, transposed convs,
residual blocks and ELUs run in the form; each LSTM is an fp32 island whose
residual sum is cast back to the activations' dtype.

The residual blocks that the fused kernel covers (causal, dilations (1, 1),
k3 then 1×1 conv, conv shortcut: all of EnCodec's) go to
:func:`..ops.seanet_resblock.seanet_resblock` in the stack's form on every
device: it launches the CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors. The gate is fixed when a block is built. Other
blocks take the general path (:func:`_resnet_plain`) in the form: the
non-causal, reflect-padded blocks of SpeechTokenizer and EnCodec-48k and
Mimi's blocks without a conv shortcut run cuDNN, as the reference runs them
on XLA.

The ``"bilstm"`` kind (SpeechTokenizer's encoder) is a bidirectional LSTM
whose output, 2H wide, is added to the input duplicated over channels.

Streaming (:func:`init_stream_state`, :func:`apply_plan_streaming`) runs
each conv of a causal plan over one chunk with its carried left context
(:mod:`..nn.streaming`), residual blocks conv by conv as the reference does,
and carries the LSTM's ``(h, c)``. It runs fp32 activations whatever the
stack's form, as the reference's streaming path reads no activation dtype;
a stack with fp32 activations at one bf16 pass raises there.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from audiocodecs_tpu_torch.nn.layers import (
    Conv1d,
    ConvTranspose1d,
    DecodeForm,
    _cached,
    elu,
    pad1d,
)
from audiocodecs_tpu_torch.nn.lstm import (
    LSTM,
    BiLSTM,
    init_bilstm_params,
    init_lstm_params,
)
from audiocodecs_tpu_torch.nn.streaming import (
    conv_stream,
    convtr_stream,
    init_conv_state,
    init_convtr_state,
)
from audiocodecs_tpu_torch.ops.seanet_resblock import (
    pack_resblock_weights,
    seanet_resblock,
)

__all__ = ["SEANetConfig", "SEANet", "apply_plan_streaming", "stack_forms",
           "init_seanet_params", "init_stream_state", "seanet_decoder_plan",
           "seanet_encoder_plan"]


@dataclasses.dataclass(frozen=True)
class SEANetConfig:
    audio_channels: int = 1
    num_filters: int = 32
    hidden_size: int = 128
    ratios: tuple[int, ...] = (8, 5, 4, 2)  # decoder order (upsampling)
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    num_residual_layers: int = 1
    compress: int = 2
    num_lstm_layers: int = 2
    causal: bool = True
    pad_mode: str = "reflect"
    use_conv_shortcut: bool = True
    trim_right_ratio: float = 1.0
    # SpeechTokenizer's bidirectional encoder LSTM: output doubles to 2H and
    # the residual skip duplicates the input (y + cat(x, x))
    lstm_bidirectional: bool = False

    @property
    def hop_length(self) -> int:
        return math.prod(self.ratios)


# ----------------------------------------------------------------------- #
# Layer plans (the reference's, spec for spec)
# ----------------------------------------------------------------------- #


def seanet_encoder_plan(cfg: SEANetConfig):
    plan, i = [], 0
    plan.append(("conv", i, cfg.audio_channels, cfg.num_filters,
                 cfg.kernel_size, 1, 1))
    i += 1
    scale = 1
    for ratio in reversed(cfg.ratios):
        ch = scale * cfg.num_filters
        for j in range(cfg.num_residual_layers):
            plan.append(("resnet", i, ch, (cfg.dilation_growth_rate**j, 1)))
            i += 1
        plan.append(("elu", i)); i += 1
        plan.append(("conv", i, ch, ch * 2, ratio * 2, ratio, 1)); i += 1
        scale *= 2
    last_in = scale * cfg.num_filters
    if cfg.num_lstm_layers > 0:
        if cfg.lstm_bidirectional:
            plan.append(("bilstm", i, last_in)); i += 1
            last_in *= 2
        else:
            plan.append(("lstm", i, last_in)); i += 1
    plan.append(("elu", i)); i += 1
    plan.append(("conv", i, last_in, cfg.hidden_size,
                 cfg.last_kernel_size, 1, 1)); i += 1
    return plan


def seanet_decoder_plan(cfg: SEANetConfig):
    plan, i = [], 0
    scale = 2 ** len(cfg.ratios)
    plan.append(("conv", i, cfg.hidden_size, scale * cfg.num_filters,
                 cfg.kernel_size, 1, 1)); i += 1
    if cfg.num_lstm_layers > 0:
        plan.append(("lstm", i, scale * cfg.num_filters)); i += 1
    for ratio in cfg.ratios:
        ch = scale * cfg.num_filters
        plan.append(("elu", i)); i += 1
        plan.append(("convtr", i, ch, ch // 2, ratio * 2, ratio)); i += 1
        for j in range(cfg.num_residual_layers):
            plan.append(("resnet", i, ch // 2,
                         (cfg.dilation_growth_rate**j, 1)))
            i += 1
        scale //= 2
    plan.append(("elu", i)); i += 1
    plan.append(("conv", i, cfg.num_filters, cfg.audio_channels,
                 cfg.last_kernel_size, 1, 1)); i += 1
    return plan


# ----------------------------------------------------------------------- #
# Modules
# ----------------------------------------------------------------------- #


class ResBlock(nn.Module):
    """ELU → conv(k_res) → ELU → conv(1), plus a conv or identity shortcut.

    A block that the fused kernel takes (:func:`_fused_eligible`: its
    config, dilations and conv shapes, all fixed when it is built) keeps its
    conv weights in the kernel's layout for a precision
    (:func:`..ops.seanet_resblock.pack_resblock_weights`), built on its
    first forward on the card and again only when the precision or a conv
    weight changes: moves to another device, or is written in place
    (``load_state_dict`` and an optimizer's step bump the tensor's
    version, so a training step repacks each block once). The packed
    weights are no parameter or buffer, so the state dict is unchanged;
    the kernel's autograd Function takes them as a detached side input."""

    def __init__(self, ch: int, cfg: SEANetConfig):
        super().__init__()
        hidden = ch // cfg.compress
        ks = (cfg.residual_kernel_size, 1)
        self.block = nn.ModuleList(
            Conv1d(ch if bi == 0 else hidden,
                   ch if bi == len(ks) - 1 else hidden, k)
            for bi, k in enumerate(ks))
        self.shortcut = Conv1d(ch, ch, 1) if cfg.use_conv_shortcut else None

    def packed_weights(self, precision: str = "exact"):
        """The kernel's layout of (block.0.w, block.1.w, shortcut.w) for
        ``precision``, rebuilt only when it or a weight's (device,
        data_ptr, version) changed."""
        ws = (self.block[0].w, self.block[1].w, self.shortcut.w)
        return _cached(self, "packed", precision,
                       lambda *w: pack_resblock_weights(*w, precision),
                       params=ws)


def _fused_eligible(p: ResBlock, cfg: SEANetConfig, dilations) -> bool:
    return (cfg.causal and tuple(dilations) == (1, 1)
            and p.shortcut is not None
            and p.block[0].w.shape[-1] == 3 and p.block[1].w.shape[-1] == 1
            and p.shortcut.w.shape[-1] == 1)


def _resnet_plain(x, p: ResBlock, cfg: SEANetConfig, dilations,
                  form: DecodeForm = DecodeForm()):
    """ELU→conv(k_res, dilation)→ELU→conv(1) with (conv|identity) shortcut,
    each conv a library call in ``form`` (the reference's XLA form)."""
    h = x
    for conv, dil in zip(p.block, dilations):
        h = form.causal_conv1d(elu(h), conv, dilation=dil, causal=cfg.causal,
                               pad_mode=cfg.pad_mode)
    if p.shortcut is not None:
        x = form.causal_conv1d(x, p.shortcut, causal=cfg.causal,
                               pad_mode=cfg.pad_mode)
    return x + h


def _apply_resnet(x, p: ResBlock, cfg: SEANetConfig, dilations,
                  form: DecodeForm = DecodeForm()):
    if not _fused_eligible(p, cfg, dilations):
        return _resnet_plain(x, p, cfg, dilations, form)
    x = x.contiguous()
    # the two causal samples before t=0, padded as the k3 conv would pad
    halo = pad1d(x[..., :3], 2, 0, mode=cfg.pad_mode)[..., :2].contiguous()
    c1, c2, s = p.block[0], p.block[1], p.shortcut
    # the CPU path runs the plain version, which takes no packed weights
    packed = (p.packed_weights(form.precision) if x.device.type == "cuda"
              else None)
    return seanet_resblock(
        x, halo, *(form.param(c, n) for c in (c1, c2, s) for n in ("w", "b")),
        packed=packed, precision=form.precision)


def _apply_convtr(x, p: ConvTranspose1d, cfg: SEANetConfig, kernel: int,
                  stride: int, form: DecodeForm = DecodeForm()):
    y = form.conv_transpose1d(x, p, stride=stride)
    padding_total = kernel - stride
    if cfg.causal:
        right = math.ceil(padding_total * cfg.trim_right_ratio)
    else:
        right = padding_total // 2
    left = padding_total - right
    return y[..., left: y.shape[-1] - right]


def stack_forms(decode_dtype=torch.float32, decode_precision: str = "exact",
                encode_precision: str = "exact"):
    """The forms of a codec's two stacks from its constructor's arguments:
    ``(encoder form, decoder form)``. The encoder keeps fp32 activations
    (the reference's ``decoder-bfloat16`` casts only the decoder);
    ``encode_precision`` "default" is its ``ACX_CONV_PRECISION=default``,
    one bf16 pass in every conv and block of the encoder stack."""
    if encode_precision not in ("exact", "default"):
        raise ValueError(f"encode_precision must be 'exact' or 'default', "
                         f"got {encode_precision!r}")
    return (DecodeForm(precision=encode_precision),
            DecodeForm(decode_dtype, decode_precision))


class SEANet(nn.Module):
    """One SEANet stack built from a plan, computing in ``form``; the layer
    with plan index ``i`` is the submodule ``str(i)``. ``forward``:
    [B, Cin, T] → [B, Cout, T'], in and out in the input's dtype."""

    def __init__(self, cfg: SEANetConfig, plan,
                 form: DecodeForm = DecodeForm()):
        super().__init__()
        self.cfg = cfg
        self.plan = list(plan)
        self.form = form
        for spec in self.plan:
            kind, idx = spec[0], str(spec[1])
            if kind == "conv":
                _, _, cin, cout, k, _, _ = spec
                self.add_module(idx, Conv1d(cin, cout, k))
            elif kind == "convtr":
                _, _, cin, cout, k, _ = spec
                self.add_module(idx, ConvTranspose1d(cin, cout, k))
            elif kind == "resnet":
                self.add_module(idx, ResBlock(spec[2], cfg))
            elif kind == "lstm":
                dim = spec[2]
                self.add_module(idx, LSTM(cfg.num_lstm_layers, dim, dim))
            elif kind == "bilstm":
                dim = spec[2]
                self.add_module(idx, BiLSTM(cfg.num_lstm_layers, dim, dim))
            elif kind != "elu":
                raise NotImplementedError(f"plan kind {kind!r} is not ported")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, form = self.cfg, self.form
        in_dtype = x.dtype
        # bf16 activations in a bf16 form; fp32 forms keep the input's
        # dtype (float64 in the training tests), as does each LSTM island
        dt = form.dtype if form.dtype == torch.bfloat16 else in_dtype
        island = torch.float32 if dt == torch.bfloat16 else dt
        x = x.to(dt)
        for spec in self.plan:
            kind, idx = spec[0], str(spec[1])
            if kind == "elu":
                x = elu(x)
            elif kind == "conv":
                _, _, _cin, _cout, k, stride, dil = spec
                x = form.causal_conv1d(x, getattr(self, idx), stride=stride,
                                       dilation=dil, causal=cfg.causal,
                                       pad_mode=cfg.pad_mode)
            elif kind == "convtr":
                _, _, _cin, _cout, k, stride = spec
                x = _apply_convtr(x, getattr(self, idx), cfg, k, stride, form)
            elif kind == "resnet":
                x = _apply_resnet(x, getattr(self, idx), cfg, spec[3], form)
            elif kind == "lstm":
                # residual LSTM over [B, T, C], an fp32 island
                xf = x.to(island)
                y, _ = getattr(self, idx)(xf.transpose(1, 2))
                x = (xf + y.transpose(1, 2)).to(dt)
            elif kind == "bilstm":
                xf = x.to(island)
                y = getattr(self, idx)(xf.transpose(1, 2))
                x = (torch.cat([xf, xf], dim=1) + y.transpose(1, 2)).to(dt)
        return x.to(in_dtype)


# ----------------------------------------------------------------------- #
# Streaming (chunked-causal) execution with carried conv/LSTM state
# ----------------------------------------------------------------------- #


def init_stream_state(model: SEANet, batch: int) -> dict:
    """Zero state for streaming ``model``'s plan, on its device.

    Only valid for causal configs: the state replaces the left padding, so
    batch and streaming execution agree exactly with zero ("constant")
    padding; reflect-padded stacks differ at stream start."""
    cfg = model.cfg
    if not cfg.causal:
        raise ValueError("streaming requires a causal SEANet config")
    dev = next(model.parameters()).device
    state = {}
    for spec in model.plan:
        kind, idx = spec[0], str(spec[1])
        if kind == "conv":
            _, _, cin, _cout, k, stride, dil = spec
            state[idx] = init_conv_state(batch, k, stride, cin, dil, dev)
        elif kind == "convtr":
            _, _, _cin, cout, k, stride = spec
            state[idx] = init_convtr_state(batch, k, stride, cout, dev)
        elif kind == "resnet":
            _, _, ch, dilations = spec
            blk = getattr(model, idx)
            s = {"block": [
                init_conv_state(batch, conv.w.shape[-1], 1, conv.w.shape[1],
                                dil, dev)
                for conv, dil in zip(blk.block, dilations)]}
            if blk.shortcut is not None:
                s["shortcut"] = init_conv_state(batch, 1, 1, ch, device=dev)
            state[idx] = s
        elif kind == "lstm":
            dim = spec[2]
            state[idx] = [(torch.zeros(batch, dim, device=dev),
                           torch.zeros(batch, dim, device=dev))
                          for _ in range(cfg.num_lstm_layers)]
        elif kind != "elu":
            # e.g. "bilstm": its backward direction needs the whole signal
            raise NotImplementedError(
                f"streaming has no state/kernel for plan kind {kind!r}")
    return state


def apply_plan_streaming(x: torch.Tensor, model: SEANet, state: dict):
    """One chunk ``[B, C, L]`` through ``model``'s plan with carried state →
    (y, new state), in fp32 activations whatever ``model.form`` (the
    reference's streaming path reads no activation dtype). A stack whose
    form runs fp32 activations at one bf16 pass raises
    ``NotImplementedError``: the reference would stream its convs at that
    precision, which is not ported."""
    if model.form.dtype == torch.float32 and model.form.precision != "exact":
        raise NotImplementedError(
            "streaming in a one-pass form (fp32 activations, "
            f"precision={model.form.precision!r}) is not ported")
    new_state = dict(state)
    for spec in model.plan:
        kind, idx = spec[0], str(spec[1])
        if kind == "elu":
            x = elu(x)
        elif kind == "conv":
            _, _, _cin, _cout, _k, stride, dil = spec
            p = getattr(model, idx)
            x, new_state[idx] = conv_stream(x, state[idx], p.w, p.b,
                                            stride=stride, dilation=dil)
        elif kind == "convtr":
            _, _, _cin, _cout, _k, stride = spec
            p = getattr(model, idx)
            x, new_state[idx] = convtr_stream(x, state[idx], p.w, p.b,
                                              stride=stride, groups=p.groups)
        elif kind == "resnet":
            _, _, _ch, dilations = spec
            p, s = getattr(model, idx), state[idx]
            h, block = x, []
            for conv, cs, dil in zip(p.block, s["block"], dilations):
                h, ns = conv_stream(elu(h), cs, conv.w, conv.b, dilation=dil)
                block.append(ns)
            new_state[idx] = {"block": block}
            if p.shortcut is not None:
                x, new_state[idx]["shortcut"] = conv_stream(
                    x, s["shortcut"], p.shortcut.w, p.shortcut.b)
            x = x + h
        elif kind == "lstm":
            y, new_state[idx] = getattr(model, idx)(x.transpose(1, 2),
                                                    state[idx])
            x = x + y.transpose(1, 2)
        else:
            raise NotImplementedError(
                f"streaming has no kernel for plan kind {kind!r}")
    return x, new_state


# ----------------------------------------------------------------------- #
# Init (random weights from an explicit generator)
# ----------------------------------------------------------------------- #


def _init_conv(generator, cout, cin, k, *, transposed=False):
    scale = 1.0 / math.sqrt(cin * k)
    shape = (cin, cout, k) if transposed else (cout, cin, k)
    return {
        "w": torch.randn(shape, generator=generator) * scale,
        "b": (torch.rand(cout, generator=generator) * 2 - 1) * scale,
    }


def init_seanet_params(generator: torch.Generator, cfg: SEANetConfig,
                       plan) -> dict:
    """Flat state dict (``"<idx>.w"`` …) of one stack, in the reference
    package's distributions (the draws differ from ``jax.random``'s)."""
    flat = {}

    def put(prefix, tree):
        for k, v in tree.items():
            flat[f"{prefix}.{k}"] = v

    for spec in plan:
        kind, idx = spec[0], str(spec[1])
        if kind == "conv":
            _, _, cin, cout, k, _, _ = spec
            put(idx, _init_conv(generator, cout, cin, k))
        elif kind == "convtr":
            _, _, cin, cout, k, _ = spec
            put(idx, _init_conv(generator, cout, cin, k, transposed=True))
        elif kind == "resnet":
            ch = spec[2]
            hidden = ch // cfg.compress
            ks = (cfg.residual_kernel_size, 1)
            for bi, k in enumerate(ks):
                cin = ch if bi == 0 else hidden
                cout = ch if bi == len(ks) - 1 else hidden
                put(f"{idx}.block.{bi}", _init_conv(generator, cout, cin, k))
            if cfg.use_conv_shortcut:
                put(f"{idx}.shortcut", _init_conv(generator, ch, ch, 1))
        elif kind == "lstm":
            dim = spec[2]
            layers = init_lstm_params(generator, cfg.num_lstm_layers, dim, dim)
            for li, p in enumerate(layers):
                put(f"{idx}.{li}", p)
        elif kind == "bilstm":
            dim = spec[2]
            layers = init_bilstm_params(generator, cfg.num_lstm_layers, dim,
                                        dim)
            for li, p in enumerate(layers):
                for d in ("fwd", "bwd"):
                    put(f"{idx}.{li}.{d}", p[d])
    return flat
