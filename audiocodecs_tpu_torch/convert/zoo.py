"""Vendor checkpoint converters for the EnCodec lineage and BigCodec.

Counterpart of the first part of ``audiocodecs_tpu/convert/zoo.py``: one
``convert_*_state_dict(sd, cfg)`` and ``*_schema(cfg)`` pair a family, for
SpeechTokenizer (fnlp/SpeechTokenizer: the encodec-fork SEANet with a
bidirectional encoder LSTM, RVQ), PAST (audiocraft-style EnCodec, RVQ),
the Vocos head (charactr/vocos, also EnCodec + Vocos's), WavTokenizer (an
EnCodec encoder, one VQ, a Vocos head) and BigCodec (Alethia/BigCodec: DAC
snake blocks, residual LSTMs, one factorised VQ). A schema is the
documented vendor state-dict surface, key → shape.

Every converter here is strict: a checkpoint key it does not read raises
(``ValueError``, "unmapped"), so a release that appends modules fails with
their names instead of loading without them. The EMA-VQ training buffers
(``embed_avg``, ``cluster_size``, ``inited``) are the one tolerated
exception: the codebook itself is ``embed``.
"""

from __future__ import annotations

import numpy as np

from audiocodecs_tpu_torch.convert.torch_utils import (
    as_state_dict,
    conv_weight,
    lstm_schema,
    put_alpha,
    put_conv,
    put_linear,
    put_lstm,
    put_norm,
    to_np,
    wn_conv_schema,
)
from audiocodecs_tpu_torch.convert.vendor_seanet import (
    convert_vendor_seanet,
    rvq_schema,
    vendor_rvq_codebooks,
    vendor_seanet_schema,
)

__all__ = [
    "convert_speechtokenizer_state_dict", "speechtokenizer_schema",
    "convert_past_state_dict", "past_schema",
    "convert_vocos_state_dict", "vocos_schema",
    "convert_wavtokenizer_state_dict", "wavtokenizer_schema",
    "convert_bigcodec_state_dict", "bigcodec_schema",
]

_VQ_BUFFER_SUFFIXES = ("embed_avg", "cluster_size", "inited")


def _unmapped(sd, consumed: set, allow_suffixes=()) -> list:
    return sorted(k for k in sd if k not in consumed
                  and not any(k.endswith(s) for s in allow_suffixes))


class _TrackingDict(dict):
    """State-dict view that records which keys the converter read."""

    def __init__(self, sd):
        super().__init__(sd)
        self.read: set = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def _strict(sd: _TrackingDict, what: str) -> None:
    extra = _unmapped(sd, sd.read, _VQ_BUFFER_SUFFIXES)
    if extra:
        raise ValueError(
            f"{what}: {len(extra)} unmapped checkpoint keys — architecture "
            f"drift from the documented vendor schema. First few: "
            f"{extra[:8]}")


# --------------------------------------------------------------------- #
# SpeechTokenizer and PAST
# --------------------------------------------------------------------- #

def _seanet_rvq(sd, enc_cfg, dec_cfg, num_quantizers: int, what: str):
    sd = _TrackingDict(sd)
    out = {}
    convert_vendor_seanet(out, sd, enc_cfg, "encoder")
    convert_vendor_seanet(out, sd, dec_cfg, "decoder", decoder=True)
    out["codebooks"] = vendor_rvq_codebooks(sd, num_quantizers)
    _strict(sd, what)
    return as_state_dict(out)


def convert_speechtokenizer_state_dict(sd, cfg) -> dict:
    """``cfg``: :class:`..models.speechtokenizer.SpeechTokenizerModelConfig`.
    A bidirectional encoder LSTM (``*_reverse`` keys), a plain decoder
    LSTM, the RVQ's codebooks."""
    return _seanet_rvq(sd, cfg.seanet(True), cfg.seanet(False),
                       cfg.num_quantizers, "speechtokenizer")


def speechtokenizer_schema(cfg) -> dict:
    return {**vendor_seanet_schema(cfg.seanet(True), "encoder"),
            **vendor_seanet_schema(cfg.seanet(False), "decoder",
                                   decoder=True),
            **rvq_schema(cfg.num_quantizers, cfg.codebook_size,
                         cfg.codebook_dim)}


def convert_past_state_dict(sd, cfg) -> dict:
    """``cfg``: :class:`..models.seanet_rvq.SEANetRVQConfig`
    (``PAST.default_model_config()``)."""
    return _seanet_rvq(sd, cfg.seanet(), cfg.seanet(), cfg.num_quantizers,
                       "past")


def past_schema(cfg) -> dict:
    return {**vendor_seanet_schema(cfg.seanet(), "encoder"),
            **vendor_seanet_schema(cfg.seanet(), "decoder", decoder=True),
            **rvq_schema(cfg.num_quantizers, cfg.codebook_size,
                         cfg.codebook_dim)}


# --------------------------------------------------------------------- #
# Vocos backbone + ISTFT head (charactr/vocos, WavTokenizer's head)
# --------------------------------------------------------------------- #

def _adanorm(out, dst, sd, src):
    out[f"{dst}.scale"] = to_np(sd[f"{src}.scale.weight"]).astype(np.float32)
    out[f"{dst}.shift"] = to_np(sd[f"{src}.shift.weight"]).astype(np.float32)


def _put_vocos(out, sd, cfg, root: str, dst: str) -> None:
    b = f"{root}backbone"
    ada = cfg.num_adanorm_embeddings
    put_conv(out, f"{dst}embed", sd, f"{b}.embed")
    if ada:
        _adanorm(out, f"{dst}adanorm_in", sd, f"{b}.norm")
    else:
        put_norm(out, f"{dst}norm_in", sd, f"{b}.norm")
    for i in range(cfg.num_layers):
        src, d = f"{b}.convnext.{i}", f"{dst}blocks.{i}"
        put_conv(out, f"{d}.dwconv", sd, f"{src}.dwconv")
        put_linear(out, f"{d}.pw1", sd, f"{src}.pwconv1")
        put_linear(out, f"{d}.pw2", sd, f"{src}.pwconv2")
        out[f"{d}.gamma"] = to_np(sd[f"{src}.gamma"]).astype(np.float32)
        if ada:
            _adanorm(out, f"{d}.adanorm", sd, f"{src}.norm")
        else:
            put_norm(out, f"{d}.norm", sd, f"{src}.norm")
    put_norm(out, f"{dst}norm_out", sd, f"{b}.final_layer_norm")
    put_linear(out, f"{dst}head", sd, f"{root}head.out")


def convert_vocos_state_dict(sd, cfg, root: str = "") -> dict:
    """The Vocos backbone and head (``cfg``: :class:`..nn.vocos.
    VocosConfig`) → :class:`..nn.vocos.Vocos`'s state dict (prefix it with
    ``vocos.`` for an :class:`..models.encodec.Encodec` with
    ``use_vocos``). ``root`` prefixes the checkpoint's keys (``""`` for
    charactr/vocos, whose keys are ``backbone.*``/``head.*``). Keys it does
    not read are ignored here: a family's converter that nests the head
    checks the whole checkpoint."""
    out = {}
    _put_vocos(out, sd, cfg, root, "")
    return as_state_dict(out)


def vocos_schema(cfg, root: str = "") -> dict:
    b = f"{root}backbone"
    d, m = cfg.dim, cfg.intermediate_dim
    ada = cfg.num_adanorm_embeddings

    def norm_keys(prefix):
        if ada:
            return {f"{prefix}.scale.weight": (ada, d),
                    f"{prefix}.shift.weight": (ada, d)}
        return {f"{prefix}.weight": (d,), f"{prefix}.bias": (d,)}

    schema = {f"{b}.embed.weight": (d, cfg.input_channels, 7),
              f"{b}.embed.bias": (d,), **norm_keys(f"{b}.norm")}
    for i in range(cfg.num_layers):
        p = f"{b}.convnext.{i}"
        schema.update({
            f"{p}.dwconv.weight": (d, 1, 7), f"{p}.dwconv.bias": (d,),
            f"{p}.pwconv1.weight": (m, d), f"{p}.pwconv1.bias": (m,),
            f"{p}.pwconv2.weight": (d, m), f"{p}.pwconv2.bias": (d,),
            f"{p}.gamma": (d,), **norm_keys(f"{p}.norm")})
    schema.update({
        f"{b}.final_layer_norm.weight": (d,),
        f"{b}.final_layer_norm.bias": (d,),
        f"{root}head.out.weight": (cfg.n_fft + 2, d),
        f"{root}head.out.bias": (cfg.n_fft + 2,)})
    return schema


# --------------------------------------------------------------------- #
# WavTokenizer (novateur/WavTokenizer)
# --------------------------------------------------------------------- #

_WT_ENCODER = "feature_extractor.encodec.encoder"
_WT_VQ = "feature_extractor.encodec.quantizer.vq.layers"


def convert_wavtokenizer_state_dict(sd, cfg) -> dict:
    """``cfg``: :class:`..models.wavtokenizer.WavTokenizerModelConfig`. The
    EnCodec encoder under ``feature_extractor.encodec.encoder``, VQ layer
    0's codebook, the Vocos backbone and head at the top level."""
    sd = _TrackingDict(sd)
    out = {}
    convert_vendor_seanet(out, sd, cfg.seanet(), _WT_ENCODER, dst="encoder")
    out["codebook"] = vendor_rvq_codebooks(sd, 1, root=_WT_VQ)[0]
    _put_vocos(out, sd, cfg.vocos(), "", "vocos.")
    _strict(sd, "wavtokenizer")
    return as_state_dict(out)


def wavtokenizer_schema(cfg) -> dict:
    return {**vendor_seanet_schema(cfg.seanet(), _WT_ENCODER),
            **rvq_schema(1, cfg.codebook_size, cfg.codebook_dim,
                         root=_WT_VQ),
            **vocos_schema(cfg.vocos())}


# --------------------------------------------------------------------- #
# BigCodec (Alethia/BigCodec: DAC-lineage snake blocks + LSTM + 1 FVQ)
# --------------------------------------------------------------------- #

def _res_unit(out, dst, sd, src):
    """DAC ResidualUnit: Sequential(Snake, WNConv k7, Snake, WNConv k1)."""
    put_alpha(out, f"{dst}.alpha1", sd, f"{src}.block.0.alpha")
    put_conv(out, f"{dst}.conv1", sd, f"{src}.block.1")
    put_alpha(out, f"{dst}.alpha2", sd, f"{src}.block.2.alpha")
    put_conv(out, f"{dst}.conv2", sd, f"{src}.block.3")


def _put_codec_encoder(out, sd, cfg, dst: str) -> None:
    """BigCodec's ``CodecEncoder``: the stem, strided snake blocks, the
    residual LSTM, the snake and conv of the final block."""
    n_ru = len(cfg.dilations)
    put_conv(out, f"{dst}.stem", sd, "conv_blocks.0")
    for i in range(len(cfg.up_ratios)):
        src, d = f"conv_blocks.{i + 1}.block", f"{dst}.blocks.{i}"
        for j in range(n_ru):
            _res_unit(out, f"{d}.res.{j}", sd, f"{src}.{j}")
        put_alpha(out, f"{d}.alpha_down", sd, f"{src}.{n_ru}.alpha")
        put_conv(out, f"{d}.conv_down", sd, f"{src}.{n_ru + 1}")
    put_lstm(out, f"{dst}.rnn", sd, "rnn", cfg.rnn_layers)
    put_alpha(out, f"{dst}.alpha_out", sd, "conv_final_block.0.alpha")
    put_conv(out, f"{dst}.conv_out", sd, "conv_final_block.1")


def _proj(out, dst, sd, src):
    """A weight-normed 1×1 conv ``[Cout, Cin, 1]`` used as a linear:
    ``dst.w [Cin, Cout]``."""
    w = conv_weight(sd, src)
    out[f"{dst}.w"] = np.ascontiguousarray(w[:, :, 0].T)
    out[f"{dst}.b"] = to_np(sd[f"{src}.bias"]).astype(np.float32)


def convert_bigcodec_state_dict(ckpt, cfg) -> dict:
    """``ckpt``: the released ``bigcodec.pt`` dict of two state dicts,
    ``{"CodecEnc": ..., "generator": ...}``; ``cfg``:
    :class:`..models.bigcodec.BigCodecModelConfig`."""
    enc = _TrackingDict(ckpt["CodecEnc"])
    gen = _TrackingDict(ckpt["generator"])
    n_ru = len(cfg.dilations)
    out = {}
    _put_codec_encoder(out, enc, cfg, "encoder")
    _strict(enc, "bigcodec.CodecEnc")

    q = "quantizer.layers.0"
    _proj(out, "quantizer.in_proj", gen, f"{q}.in_proj")
    out["quantizer.codebook"] = to_np(
        gen[f"{q}.codebook.weight"]).astype(np.float32)
    _proj(out, "quantizer.out_proj", gen, f"{q}.out_proj")
    put_conv(out, "decoder.stem", gen, "conv_blocks.0")
    for i in range(len(cfg.up_ratios)):
        src, d = f"conv_blocks.{i + 1}.block", f"decoder.blocks.{i}"
        put_alpha(out, f"{d}.alpha_up", gen, f"{src}.0.alpha")
        put_conv(out, f"{d}.convtr", gen, f"{src}.1")
        for j in range(n_ru):
            _res_unit(out, f"{d}.res.{j}", gen, f"{src}.{2 + j}")
    put_lstm(out, "decoder.rnn", gen, "rnn", cfg.rnn_layers)
    put_alpha(out, "decoder.alpha_out", gen, "conv_final_block.0.alpha")
    put_conv(out, "decoder.conv_out", gen, "conv_final_block.1")
    _strict(gen, "bigcodec.generator")
    return as_state_dict(out)


def _res_unit_schema(prefix, ch):
    return {f"{prefix}.block.0.alpha": (1, ch, 1),
            f"{prefix}.block.2.alpha": (1, ch, 1),
            **wn_conv_schema(f"{prefix}.block.1", ch, ch, 7),
            **wn_conv_schema(f"{prefix}.block.3", ch, ch, 1)}


def bigcodec_schema(cfg) -> dict:
    """Two key → shape maps: ``{"CodecEnc": ..., "generator": ...}``."""
    n_ru = len(cfg.dilations)
    enc = wn_conv_schema("conv_blocks.0", cfg.ngf, 1, 7)
    d = cfg.ngf
    for i, stride in enumerate(cfg.up_ratios):
        b = f"conv_blocks.{i + 1}.block"
        for j in range(n_ru):
            enc.update(_res_unit_schema(f"{b}.{j}", d))
        enc[f"{b}.{n_ru}.alpha"] = (1, d, 1)
        enc.update(wn_conv_schema(f"{b}.{n_ru + 1}", d * 2, d, 2 * stride))
        d *= 2
    enc.update(lstm_schema("rnn", cfg.rnn_layers, d))
    enc["conv_final_block.0.alpha"] = (1, d, 1)
    enc.update(wn_conv_schema("conv_final_block.1", cfg.hidden_size, d, 3))

    q = "quantizer.layers.0"
    gen = {**wn_conv_schema(f"{q}.in_proj", cfg.codebook_dim,
                             cfg.hidden_size, 1),
           f"{q}.codebook.weight": (cfg.codebook_size, cfg.codebook_dim),
           **wn_conv_schema(f"{q}.out_proj", cfg.hidden_size,
                             cfg.codebook_dim, 1),
           **wn_conv_schema("conv_blocks.0", cfg.enc_width,
                             cfg.hidden_size, 7)}
    d = cfg.enc_width
    for i, stride in enumerate(reversed(cfg.up_ratios)):
        b = f"conv_blocks.{i + 1}.block"
        gen[f"{b}.0.alpha"] = (1, d, 1)
        gen.update(wn_conv_schema(f"{b}.1", d // 2, d, 2 * stride,
                                   transpose=True))
        for j in range(n_ru):
            gen.update(_res_unit_schema(f"{b}.{2 + j}", d // 2))
        d //= 2
    gen.update(lstm_schema("rnn", cfg.rnn_layers, cfg.enc_width))
    gen["conv_final_block.0.alpha"] = (1, cfg.ngf, 1)
    gen.update(wn_conv_schema("conv_final_block.1", 1, cfg.ngf, 7))
    return {"CodecEnc": enc, "generator": gen}
