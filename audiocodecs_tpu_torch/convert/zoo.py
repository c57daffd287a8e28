"""Vendor checkpoint converters for the codec zoo.

Counterpart of ``audiocodecs_tpu/convert/zoo.py``: one
``convert_*_state_dict(sd, cfg)`` and ``*_schema(cfg)`` pair a family. A
schema is the documented vendor state-dict surface, key → shape. The
EnCodec lineage and BigCodec: SpeechTokenizer (fnlp/SpeechTokenizer: the
encodec-fork SEANet with a bidirectional encoder LSTM, RVQ), PAST
(audiocraft-style EnCodec, RVQ), the Vocos head (charactr/vocos, also
EnCodec + Vocos's), WavTokenizer (an EnCodec encoder, one VQ, a Vocos head)
and BigCodec (Alethia/BigCodec: DAC snake blocks, residual LSTMs, one
factorised VQ). The rest of the zoo: X-Codec 2.0, StableCodec, NanoCodec,
AudioDec, MagiCodec, FocalCodec, BiCodec, SemantiCodec's pieces (with
:mod:`.audiomae` and :mod:`.ldm`), WavLM+K-means' HiFi-GAN vocoder,
HILCodec and DyCAST.

Every converter here is strict: a checkpoint key it does not read raises
(``ValueError``, "unmapped"), so a release that appends modules fails with
their names instead of loading without them. The buffers a family carries
without weights are the tolerated exceptions: the EMA-VQ's (``embed_avg``,
``cluster_size``, ``inited``), FSQ lattices, STFT windows, a batch norm's
``num_batches_tracked``. StableCodec, MagiCodec, FocalCodec, HILCodec and
DyCAST take ``key_map=``, a rename overlay (:mod:`.overlay`), for the tower
names no vendor schema pins.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from audiocodecs_tpu_torch.convert.overlay import apply_key_map
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
    to_tensor,
    wn_conv_schema,
)
from audiocodecs_tpu_torch.convert.vendor_seanet import (
    convert_vendor_seanet,
    rvq_schema,
    vendor_rvq_codebooks,
    vendor_seanet_schema,
)
from audiocodecs_tpu_torch.convert.w2vbert import convert_w2vbert_state_dict
from audiocodecs_tpu_torch.convert.wavlm import convert_wavlm_state_dict
from audiocodecs_tpu_torch.nn.wavlm import init_wavlm_params

__all__ = [
    "convert_speechtokenizer_state_dict", "speechtokenizer_schema",
    "convert_past_state_dict", "past_schema",
    "convert_vocos_state_dict", "vocos_schema",
    "convert_wavtokenizer_state_dict", "wavtokenizer_schema",
    "convert_bigcodec_state_dict", "bigcodec_schema",
    "convert_xcodec2_state_dict", "xcodec2_schema", "w2vbert_schema",
    "convert_stablecodec_state_dict", "stablecodec_schema",
    "convert_nanocodec_state_dict", "nanocodec_schema",
    "convert_audiodec_state_dict", "audiodec_schema",
    "convert_magicodec_state_dict", "magicodec_schema",
    "convert_focalcodec_state_dict", "focalcodec_schema", "wavlm_schema",
    "convert_bicodec_state_dict", "bicodec_schema",
    "convert_semanticodec_components",
    "convert_semanticodec_ldm_state_dict",
    "convert_semanticodec_vocoder_state_dict",
    "convert_wavlm_kmeans_vocoder",
    "convert_hilcodec_components", "convert_hilcodec_full_state_dict",
    "convert_hilcodec_state_dict", "hilcodec_schema",
    "convert_dycast_state_dict", "dycast_schema",
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


def _strict(sd: _TrackingDict, what: str, allow_suffixes=()) -> None:
    """Raise on a key the converter did not read, but the EMA-VQ buffers and
    a family's own ``allow_suffixes``."""
    extra = _unmapped(sd, sd.read, _VQ_BUFFER_SUFFIXES + allow_suffixes)
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


def _put_codec_encoder(out, sd, cfg, dst: str, root: str = "") -> None:
    """BigCodec's ``CodecEncoder`` (X-Codec 2.0's ``CodecEnc`` under
    ``root``): the stem, strided snake blocks, the residual LSTM, the snake
    and conv of the final block."""
    n_ru, r = len(cfg.dilations), root
    put_conv(out, f"{dst}.stem", sd, f"{r}conv_blocks.0")
    for i in range(len(cfg.up_ratios)):
        src, d = f"{r}conv_blocks.{i + 1}.block", f"{dst}.blocks.{i}"
        for j in range(n_ru):
            _res_unit(out, f"{d}.res.{j}", sd, f"{src}.{j}")
        put_alpha(out, f"{d}.alpha_down", sd, f"{src}.{n_ru}.alpha")
        put_conv(out, f"{d}.conv_down", sd, f"{src}.{n_ru + 1}")
    put_lstm(out, f"{dst}.rnn", sd, f"{r}rnn", cfg.rnn_layers)
    put_alpha(out, f"{dst}.alpha_out", sd, f"{r}conv_final_block.0.alpha")
    put_conv(out, f"{dst}.conv_out", sd, f"{r}conv_final_block.1")


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


def _codec_encoder_schema(cfg, root: str = "") -> dict:
    n_ru, r = len(cfg.dilations), root
    enc = wn_conv_schema(f"{r}conv_blocks.0", cfg.ngf, 1, 7)
    d = cfg.ngf
    for i, stride in enumerate(cfg.up_ratios):
        b = f"{r}conv_blocks.{i + 1}.block"
        for j in range(n_ru):
            enc.update(_res_unit_schema(f"{b}.{j}", d))
        enc[f"{b}.{n_ru}.alpha"] = (1, d, 1)
        enc.update(wn_conv_schema(f"{b}.{n_ru + 1}", d * 2, d, 2 * stride))
        d *= 2
    enc.update(lstm_schema(f"{r}rnn", cfg.rnn_layers, d))
    enc[f"{r}conv_final_block.0.alpha"] = (1, d, 1)
    enc.update(wn_conv_schema(f"{r}conv_final_block.1", cfg.hidden_size, d,
                              3))
    return enc


def bigcodec_schema(cfg) -> dict:
    """Two key → shape maps: ``{"CodecEnc": ..., "generator": ...}``."""
    n_ru = len(cfg.dilations)
    enc = _codec_encoder_schema(cfg)

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


# --------------------------------------------------------------------- #
# Shared pieces of the other families
# --------------------------------------------------------------------- #

def _f32(sd, key) -> np.ndarray:
    return to_np(sd[key]).astype(np.float32)


def _t(sd, key) -> np.ndarray:
    """A ``[out, in]`` weight as the port's ``[in, out]``."""
    return np.ascontiguousarray(to_np(sd[key]).T, dtype=np.float32)


def _prefixed(out: dict, dst: str, state: dict) -> None:
    out.update({f"{dst}{k}": v for k, v in state.items()})


def _wavlm_consumable_keys(cfg, prefix: str) -> set:
    """The keys :func:`.wavlm.convert_wavlm_state_dict` can read under
    ``prefix``: the schema's, and the ``parametrizations.weight.original
    {0,1}`` aliases of the positional conv's ``weight_{g,v}``."""
    keys = set(wavlm_schema(cfg, prefix))
    for k in list(keys):
        for old, new in (("weight_g", "parametrizations.weight.original0"),
                         ("weight_v", "parametrizations.weight.original1")):
            if k.endswith(old):
                keys.add(k[:-len(old)] + new)
    return keys


def _put_wavlm(out: dict, sd: _TrackingDict, cfg, prefix: str,
               dst: str) -> None:
    """A WavLM tower at ``prefix`` into ``dst``; its keys are marked read
    as the schema's only, so a module inside the tower that the schema
    lacks still trips the strict check."""
    _prefixed(out, dst, convert_wavlm_state_dict(sd, cfg, prefix))
    sd.read.update(k for k in _wavlm_consumable_keys(cfg, prefix)
                   if k in sd)


def wavlm_schema(cfg, prefix: str = "") -> dict:
    """HF ``WavLMModel``'s key → shape map (gated relative position; base
    or large), ``cfg`` a :class:`..nn.wavlm.WavLMConfig`. It also stands
    for BiCodec's wav2vec2-XLSR file, whose converter leaves the gated
    position's keys unread."""
    p = prefix
    C, I, H = cfg.hidden_size, cfg.intermediate_size, cfg.num_heads
    s = {}
    cin = 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        q = f"{p}feature_extractor.conv_layers.{i}"
        s[f"{q}.conv.weight"] = (c, cin, k)
        if cfg.conv_bias:
            s[f"{q}.conv.bias"] = (c,)
        if cfg.feat_extract_norm == "layer" or i == 0:
            s[f"{q}.layer_norm.weight"] = (c,)
            s[f"{q}.layer_norm.bias"] = (c,)
        cin = c
    s[f"{p}feature_projection.layer_norm.weight"] = (cin,)
    s[f"{p}feature_projection.layer_norm.bias"] = (cin,)
    s[f"{p}feature_projection.projection.weight"] = (C, cin)
    s[f"{p}feature_projection.projection.bias"] = (C,)
    g = cfg.num_conv_pos_embedding_groups
    pc = f"{p}encoder.pos_conv_embed.conv"
    s[f"{pc}.weight_g"] = (C, C // g, 1)
    s[f"{pc}.weight_v"] = (C, C // g, cfg.num_conv_pos_embeddings)
    s[f"{pc}.bias"] = (C,)
    s[f"{p}encoder.layer_norm.weight"] = (C,)
    s[f"{p}encoder.layer_norm.bias"] = (C,)
    s[f"{p}encoder.layers.0.attention.rel_attn_embed.weight"] = (
        cfg.num_buckets, H)
    for i in range(cfg.num_layers):
        q = f"{p}encoder.layers.{i}"
        for lin in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[f"{q}.attention.{lin}.weight"] = (C, C)
            s[f"{q}.attention.{lin}.bias"] = (C,)
        s[f"{q}.attention.gru_rel_pos_linear.weight"] = (8, cfg.head_dim)
        s[f"{q}.attention.gru_rel_pos_linear.bias"] = (8,)
        s[f"{q}.attention.gru_rel_pos_const"] = (1, H, 1, 1)
        for ln in ("layer_norm", "final_layer_norm"):
            s[f"{q}.{ln}.weight"] = (C,)
            s[f"{q}.{ln}.bias"] = (C,)
        s[f"{q}.feed_forward.intermediate_dense.weight"] = (I, C)
        s[f"{q}.feed_forward.intermediate_dense.bias"] = (I,)
        s[f"{q}.feed_forward.output_dense.weight"] = (C, I)
        s[f"{q}.feed_forward.output_dense.bias"] = (C,)
    return s


def _put_bs_roformer(out, sd, src: str, dst: str, depth: int) -> None:
    """BS-RoFormer blocks (lucidrains naming: RMSNorm ``gamma``, a fused
    ``to_qkv``, per-head ``to_gates``, GELU ``ff.net``) → :class:`..nn.
    roformer.Roformer`'s ``blocks``."""
    for i in range(depth):
        b, d = f"{src}.{i}", f"{dst}.blocks.{i}"
        out[f"{d}.attn_norm"] = _f32(sd, f"{b}.attn.norm.gamma")
        out[f"{d}.attn.qkv_w"] = _t(sd, f"{b}.attn.to_qkv.weight")
        put_linear(out, f"{d}.attn.gates", sd, f"{b}.attn.to_gates")
        out[f"{d}.attn.out_w"] = _t(sd, f"{b}.attn.to_out.0.weight")
        out[f"{d}.ffn_norm"] = _f32(sd, f"{b}.ff.net.0.gamma")
        out[f"{d}.ffn.w1"] = _t(sd, f"{b}.ff.net.1.weight")
        out[f"{d}.ffn.b1"] = _f32(sd, f"{b}.ff.net.1.bias")
        out[f"{d}.ffn.w2"] = _t(sd, f"{b}.ff.net.4.weight")
        out[f"{d}.ffn.b2"] = _f32(sd, f"{b}.ff.net.4.bias")


def _bs_roformer_schema(prefix: str, depth: int, dim: int, heads: int,
                        mult: int = 4) -> dict:
    s = {}
    for i in range(depth):
        b = f"{prefix}.{i}"
        s.update({
            f"{b}.attn.norm.gamma": (dim,),
            f"{b}.attn.to_qkv.weight": (3 * dim, dim),
            f"{b}.attn.to_gates.weight": (heads, dim),
            f"{b}.attn.to_gates.bias": (heads,),
            f"{b}.attn.to_out.0.weight": (dim, dim),
            f"{b}.ff.net.0.gamma": (dim,),
            f"{b}.ff.net.1.weight": (mult * dim, dim),
            f"{b}.ff.net.1.bias": (mult * dim,),
            f"{b}.ff.net.4.weight": (dim, mult * dim),
            f"{b}.ff.net.4.bias": (dim,)})
    return s


# --------------------------------------------------------------------- #
# X-Codec 2.0 (HKUST-Audio/xcodec2: CodecEnc + the w2v-BERT semantic
# branch + FSQ + a RoFormer/ISTFT generator)
# --------------------------------------------------------------------- #

# buffers of the fused checkpoint: the FSQ lattice, the ISTFT window, the
# rotary frequencies and the (training-only) spec-augment vector
_XCODEC2_BUFFER_SUFFIXES = (
    "masked_spec_embed", ".scales", "._levels", "._basis",
    ".implicit_codebook", ".window", ".inv_freq")


def _put_conv_bias_or_zeros(out, dst, sd, prefix) -> None:
    """A conv whose module has no bias upstream (``bias=False``): a zero
    ``dst.b`` unless the checkpoint carries one."""
    w = put_conv(out, dst, sd, prefix, bias=False)
    out[f"{dst}.b"] = (_f32(sd, f"{prefix}.bias") if f"{prefix}.bias" in sd
                       else np.zeros(w.shape[0], np.float32))


def convert_xcodec2_state_dict(sd, cfg) -> dict:
    """The fused ``HKUST-Audio/xcodec2`` state dict → :class:`..models.
    xcodec2.XCodec2`'s (``cfg``: its ``XCodec2ModelConfig``):
    ``CodecEnc`` (BigCodec's encoder), ``semantic_model`` (HF w2v-BERT 2.0,
    its first ``cfg.w2vbert.num_layers`` layers), ``SemanticEncoder_
    module``, ``fc_prior``/``fc_post_a``/``fc_post_s``, and the generator
    (the FSQ's projections, the BS-RoFormer backbone, the ISTFT head)."""
    sd = _TrackingDict(sd)
    out = {}
    _put_codec_encoder(out, sd, cfg.encoder(), "encoder", root="CodecEnc.")
    _prefixed(out, "w2vbert.", convert_w2vbert_state_dict(
        sd, num_layers=cfg.w2vbert.num_layers, prefix="semantic_model."))
    se = "SemanticEncoder_module"
    _put_conv_bias_or_zeros(out, "semantic_encoder.init", sd,
                            f"{se}.initial_conv")
    put_conv(out, "semantic_encoder.res1", sd, f"{se}.residual_blocks.1")
    put_conv(out, "semantic_encoder.res2", sd, f"{se}.residual_blocks.3")
    _put_conv_bias_or_zeros(out, "semantic_encoder.final", sd,
                            f"{se}.final_conv")
    for name in ("fc_prior", "fc_post_a", "fc_post_s"):
        put_linear(out, name, sd, name)
    for name in ("project_in", "project_out"):
        put_linear(out, f"quantizer.{name}", sd, f"generator.quantizer.{name}")
    put_conv(out, "backbone.embed", sd, "generator.backbone.embed")
    put_norm(out, "backbone.norm_in", sd, "generator.backbone.norm")
    _put_bs_roformer(out, sd, "generator.backbone.transformers",
                     "backbone.roformer", cfg.backbone_depth)
    put_norm(out, "backbone.norm_out", sd,
             "generator.backbone.final_layer_norm")
    put_linear(out, "head", sd, "generator.head.out")
    _strict(sd, "xcodec2", _XCODEC2_BUFFER_SUFFIXES)
    return as_state_dict(out)


def w2vbert_schema(cfg, prefix: str = "") -> dict:
    """HF ``Wav2Vec2BertModel``'s key → shape map (relative-key
    attention), ``cfg`` a :class:`..nn.w2vbert.W2VBertConfig`."""
    C, I = cfg.hidden_size, cfg.intermediate_size
    n_pos = cfg.left_max_positions + cfg.right_max_positions + 1
    p = prefix
    s = {
        f"{p}feature_projection.layer_norm.weight": (cfg.input_dim,),
        f"{p}feature_projection.layer_norm.bias": (cfg.input_dim,),
        f"{p}feature_projection.projection.weight": (C, cfg.input_dim),
        f"{p}feature_projection.projection.bias": (C,),
        f"{p}masked_spec_embed": (C,),
    }
    for i in range(cfg.num_layers):
        q = f"{p}encoder.layers.{i}"
        for ln in ("ffn1_layer_norm", "self_attn_layer_norm",
                   "ffn2_layer_norm", "final_layer_norm",
                   "conv_module.layer_norm",
                   "conv_module.depthwise_layer_norm"):
            s[f"{q}.{ln}.weight"] = (C,)
            s[f"{q}.{ln}.bias"] = (C,)
        for ffn in ("ffn1", "ffn2"):
            s[f"{q}.{ffn}.intermediate_dense.weight"] = (I, C)
            s[f"{q}.{ffn}.intermediate_dense.bias"] = (I,)
            s[f"{q}.{ffn}.output_dense.weight"] = (C, I)
            s[f"{q}.{ffn}.output_dense.bias"] = (C,)
        for lin in ("linear_q", "linear_k", "linear_v", "linear_out"):
            s[f"{q}.self_attn.{lin}.weight"] = (C, C)
            s[f"{q}.self_attn.{lin}.bias"] = (C,)
        s[f"{q}.self_attn.distance_embedding.weight"] = (n_pos, cfg.head_dim)
        s[f"{q}.conv_module.pointwise_conv1.weight"] = (2 * C, C, 1)
        s[f"{q}.conv_module.depthwise_conv.weight"] = (C, 1, cfg.conv_kernel)
        s[f"{q}.conv_module.pointwise_conv2.weight"] = (C, C, 1)
    return s


def xcodec2_schema(cfg) -> dict:
    """The fused checkpoint's key → shape map."""
    A, S, F = cfg.acoustic_dim, cfg.semantic_dim, cfg.fused_dim
    W, D = cfg.w2vbert.hidden_size, len(cfg.levels)
    se = "SemanticEncoder_module"
    s = {**_codec_encoder_schema(cfg.encoder(), "CodecEnc."),
         **w2vbert_schema(cfg.w2vbert, "semantic_model."),
         # the SemanticEncoder's convs are plain; stem and head bias-free
         f"{se}.initial_conv.weight": (S, W, 3),
         f"{se}.residual_blocks.1.weight": (S, S, 3),
         f"{se}.residual_blocks.1.bias": (S,),
         f"{se}.residual_blocks.3.weight": (S, S, 3),
         f"{se}.residual_blocks.3.bias": (S,),
         f"{se}.final_conv.weight": (S, S, 3)}
    for name, o, i in (("fc_prior", F, S + A), ("fc_post_a", A, F),
                       ("fc_post_s", S, F),
                       ("generator.quantizer.project_in", D, F),
                       ("generator.quantizer.project_out", F, D)):
        s[f"{name}.weight"] = (o, i)
        s[f"{name}.bias"] = (o,)
    b = "generator.backbone"
    s.update({f"{b}.embed.weight": (A, A, 7), f"{b}.embed.bias": (A,),
              f"{b}.norm.weight": (A,), f"{b}.norm.bias": (A,)})
    s.update(_bs_roformer_schema(f"{b}.transformers", cfg.backbone_depth, A,
                                 cfg.backbone_heads))
    s.update({f"{b}.final_layer_norm.weight": (A,),
              f"{b}.final_layer_norm.bias": (A,),
              "generator.head.out.weight": (cfg.n_fft + 2, A),
              "generator.head.out.bias": (cfg.n_fft + 2,)})
    return s


# --------------------------------------------------------------------- #
# StableCodec (stabilityai/stable-codec-speech-16k: the TAAE transformer)
# --------------------------------------------------------------------- #

def _put_taae(out, sd, src: str, dst: str, depth: int) -> None:
    """stable-audio-tools ``ContinuousTransformer`` blocks: ``to_q`` and
    ``to_kv`` fused into one qkv, the SwiGLU's ``ff.0.proj [2F, C]`` split
    into its value half (``w1``, rows :F) and its gate half (``wg``, rows
    F:), no gates."""
    for i in range(depth):
        b, d = f"{src}.layers.{i}", f"{dst}.blocks.{i}"
        qkv = np.concatenate([_f32(sd, f"{b}.self_attn.to_q.weight"),
                              _f32(sd, f"{b}.self_attn.to_kv.weight")])
        glu = _f32(sd, f"{b}.ff.ff.0.proj.weight")
        half = glu.shape[0] // 2
        out[f"{d}.attn_norm"] = _f32(sd, f"{b}.pre_norm.gamma")
        out[f"{d}.attn.qkv_w"] = np.ascontiguousarray(qkv.T)
        out[f"{d}.attn.out_w"] = _t(sd, f"{b}.self_attn.to_out.weight")
        out[f"{d}.ffn_norm"] = _f32(sd, f"{b}.ff_norm.gamma")
        out[f"{d}.ffn.w1"] = np.ascontiguousarray(glu[:half].T)
        out[f"{d}.ffn.wg"] = np.ascontiguousarray(glu[half:].T)
        out[f"{d}.ffn.w2"] = _t(sd, f"{b}.ff.ff.2.weight")


def convert_stablecodec_state_dict(sd, cfg, key_map=None) -> dict:
    """The TAAE state dict of ``stabilityai/stable-codec-speech-16k`` →
    :class:`..models.stablecodec.StableCodec`'s. The tower paths follow
    stable-audio-tools' conventions and could not be checked against a
    released file: diff one with ``tools/inspect_checkpoint_torch.py
    --family stablecodec`` first, and repair a renamed key with
    ``key_map`` (:mod:`.overlay`)."""
    sd = _TrackingDict(apply_key_map(sd, key_map))
    out = {}
    put_conv(out, "patch", sd, "encoder.patch_embed")
    _put_taae(out, sd, "encoder.outer", "enc_outer", cfg.depth_outer)
    put_linear(out, "enc_down", sd, "encoder.downsample")
    _put_taae(out, sd, "encoder.inner", "enc_inner", cfg.depth_inner)
    put_norm(out, "enc_norm", sd, "encoder.norm")
    put_linear(out, "to_latent", sd, "encoder.to_latent")
    put_linear(out, "from_latent", sd, "decoder.from_latent")
    _put_taae(out, sd, "decoder.inner", "dec_inner", cfg.depth_inner)
    put_linear(out, "dec_up", sd, "decoder.upsample")
    _put_taae(out, sd, "decoder.outer", "dec_outer", cfg.depth_outer)
    put_norm(out, "dec_norm", sd, "decoder.norm")
    put_conv(out, "unpatch", sd, "decoder.patch_unembed")
    _strict(sd, "stablecodec")
    return as_state_dict(out)


def _taae_schema(prefix: str, depth: int, dim: int, mult: int = 4) -> dict:
    s = {}
    for i in range(depth):
        b = f"{prefix}.layers.{i}"
        s.update({f"{b}.pre_norm.gamma": (dim,),
                  f"{b}.self_attn.to_q.weight": (dim, dim),
                  f"{b}.self_attn.to_kv.weight": (2 * dim, dim),
                  f"{b}.self_attn.to_out.weight": (dim, dim),
                  f"{b}.ff_norm.gamma": (dim,),
                  f"{b}.ff.ff.0.proj.weight": (2 * mult * dim, dim),
                  f"{b}.ff.ff.2.weight": (dim, mult * dim)})
    return s


def stablecodec_schema(cfg) -> dict:
    C, D, P = cfg.dim, cfg.latent_dim, cfg.patch
    s = {"encoder.patch_embed.weight": (C, 1, P),
         "encoder.patch_embed.bias": (C,),
         "encoder.downsample.weight": (C, 2 * C),
         "encoder.downsample.bias": (C,),
         "encoder.norm.weight": (C,), "encoder.norm.bias": (C,),
         "encoder.to_latent.weight": (D, C), "encoder.to_latent.bias": (D,),
         "decoder.from_latent.weight": (C, D),
         "decoder.from_latent.bias": (C,),
         "decoder.upsample.weight": (2 * C, C),
         "decoder.upsample.bias": (2 * C,),
         "decoder.norm.weight": (C,), "decoder.norm.bias": (C,),
         "decoder.patch_unembed.weight": (C, 1, P),
         "decoder.patch_unembed.bias": (1,)}
    for tower, depth in (("encoder.outer", cfg.depth_outer),
                         ("encoder.inner", cfg.depth_inner),
                         ("decoder.inner", cfg.depth_inner),
                         ("decoder.outer", cfg.depth_outer)):
        s.update(_taae_schema(tower, depth, C))
    return s


# --------------------------------------------------------------------- #
# NanoCodec (nvidia/nemo-nano-codec-*: NeMo's AudioCodecModel)
# --------------------------------------------------------------------- #

def _nemo_alpha(out, dst, sd, prefix) -> None:
    """NeMo's half-snake ``CodecActivation``: its Snake's α ``[1, C/2, 1]``
    → ``[C/2]``."""
    put_alpha(out, dst, sd, f"{prefix}.activation.snake_act.alpha")


def _put_nemo_res_layer(out, sd, src, dst, cfg) -> None:
    for bi in range(len(cfg.resblock_kernels)):
        for di in range(len(cfg.resblock_dilations)):
            u = f"{src}.res_blocks.{bi}.res_blocks.{di}"
            d = f"{dst}.blocks.{bi}.units.{di}"
            _nemo_alpha(out, f"{d}.alpha1", sd, f"{u}.input_activation")
            put_conv(out, f"{d}.input_conv", sd, f"{u}.input_conv.conv")
            _nemo_alpha(out, f"{d}.alpha2", sd, f"{u}.skip_activation")
            put_conv(out, f"{d}.skip_conv", sd, f"{u}.skip_conv.conv")


def convert_nanocodec_state_dict(sd, cfg) -> dict:
    """NeMo's ``AudioCodecModel`` state dict → :class:`..models.nanocodec.
    NanoCodec`'s. The ``vector_quantizer`` (group FSQ) has no weights; its
    buffers are tolerated. Module paths follow NeMo's
    ``audio_codec_modules.py`` (weight norm on ``Conv1dNorm.conv``, HiFi-GAN
    residual layers, the half-snake); a release's stage widths and rates
    want a diff against a real file before converting."""
    sd = _TrackingDict(sd)
    out = {}
    e, d = "audio_encoder", "audio_decoder"
    put_conv(out, "encoder.pre_conv", sd, f"{e}.pre_conv.conv")
    for i in range(len(cfg.down_sample_rates)):
        st = f"encoder.stages.{i}"
        _put_nemo_res_layer(out, sd, f"{e}.res_layers.{i}", f"{st}.res", cfg)
        _nemo_alpha(out, f"{st}.alpha", sd, f"{e}.activations.{i}")
        put_conv(out, f"{st}.down", sd,
                 f"{e}.down_sample_conv_layers.{i}.conv")
    _nemo_alpha(out, "encoder.post_alpha", sd, f"{e}.post_activation")
    put_conv(out, "encoder.post_conv", sd, f"{e}.post_conv.conv")
    put_conv(out, "decoder.pre_conv", sd, f"{d}.pre_conv.conv")
    for i in range(len(cfg.down_sample_rates)):
        st = f"decoder.stages.{i}"
        _nemo_alpha(out, f"{st}.alpha", sd, f"{d}.activations.{i}")
        put_conv(out, f"{st}.up", sd, f"{d}.up_sample_conv_layers.{i}.conv")
        _put_nemo_res_layer(out, sd, f"{d}.res_layers.{i}", f"{st}.res", cfg)
    _nemo_alpha(out, "decoder.post_alpha", sd, f"{d}.post_activation")
    put_conv(out, "decoder.post_conv", sd, f"{d}.post_conv.conv")
    _strict(sd, "nanocodec", ("num_levels", "cumulative_basis",
                                    "codebook_size_per_group"))
    return as_state_dict(out)


def nanocodec_schema(cfg) -> dict:
    def alpha(prefix, ch):
        return {f"{prefix}.activation.snake_act.alpha": (1, ch // 2, 1)}

    def res_layer(prefix, ch):
        s = {}
        for bi, k in enumerate(cfg.resblock_kernels):
            for di in range(len(cfg.resblock_dilations)):
                u = f"{prefix}.res_blocks.{bi}.res_blocks.{di}"
                s.update({**alpha(f"{u}.input_activation", ch),
                          **wn_conv_schema(f"{u}.input_conv.conv", ch, ch, k),
                          **alpha(f"{u}.skip_activation", ch),
                          **wn_conv_schema(f"{u}.skip_conv.conv", ch, ch, k)})
        return s

    e, d = "audio_encoder", "audio_decoder"
    ch = cfg.base_channels
    s = wn_conv_schema(f"{e}.pre_conv.conv", ch, 1, cfg.in_kernel_size)
    for i, rate in enumerate(cfg.down_sample_rates):
        s.update({**res_layer(f"{e}.res_layers.{i}", ch),
                  **alpha(f"{e}.activations.{i}", ch),
                  **wn_conv_schema(f"{e}.down_sample_conv_layers.{i}.conv",
                                   2 * ch, ch, 2 * rate)})
        ch *= 2
    s.update({**alpha(f"{e}.post_activation", ch),
              **wn_conv_schema(f"{e}.post_conv.conv", cfg.encoded_dim, ch,
                               cfg.out_kernel_size),
              **wn_conv_schema(f"{d}.pre_conv.conv", cfg.final_channels,
                               cfg.encoded_dim, cfg.in_kernel_size)})
    ch = cfg.final_channels
    for i, rate in enumerate(reversed(cfg.down_sample_rates)):
        s.update({**alpha(f"{d}.activations.{i}", ch),
                  **wn_conv_schema(f"{d}.up_sample_conv_layers.{i}.conv",
                                   ch // 2, ch, 2 * rate, transpose=True)})
        ch //= 2
        s.update(res_layer(f"{d}.res_layers.{i}", ch))
    s.update({**alpha(f"{d}.post_activation", ch),
              **wn_conv_schema(f"{d}.post_conv.conv", 1, ch,
                               cfg.out_kernel_size)})
    return s


# --------------------------------------------------------------------- #
# AudioDec (facebookresearch/AudioDec: the symAD generator)
# --------------------------------------------------------------------- #

def convert_audiodec_state_dict(sd, cfg) -> dict:
    """AudioDec's ``Generator`` state dict (symAD) → :class:`..models.
    audiodec.AudioDec`'s. ``CausalConv1d`` wraps a plain ``.conv``,
    ``CausalConvTranspose1d`` a ``.deconv``; the residual units' convs and
    the projector have no bias; the RVQ's codebooks are
    ``quantizer.codebook.layers.<k>.embed``. Every weight keeps its
    layout."""
    sd = _TrackingDict(sd)
    out = {}

    def res(dst, src):
        for j in range(len(cfg.dilations)):
            for c in ("conv1", "conv2"):
                put_conv(out, f"{dst}.res.{j}.{c}", sd,
                         f"{src}.res_units.{j}.{c}.conv", bias=False)

    put_conv(out, "encoder.stem", sd, "encoder.conv.conv")
    for i in range(len(cfg.strides)):
        b = f"encoder.conv_blocks.{i}"
        res(f"encoder.blocks.{i}", b)
        put_conv(out, f"encoder.blocks.{i}.down", sd, f"{b}.conv.conv")
    put_conv(out, "projector", sd, "projector.conv", bias=False)
    out["codebooks"] = np.stack([
        _f32(sd, f"quantizer.codebook.layers.{k}.embed")
        for k in range(cfg.num_quantizers)])
    put_conv(out, "decoder.stem", sd, "decoder.conv1.conv")
    for i in range(len(cfg.strides)):
        b = f"decoder.conv_blocks.{i}"
        put_conv(out, f"decoder.blocks.{i}.up", sd, f"{b}.conv1.deconv")
        res(f"decoder.blocks.{i}", b)
    put_conv(out, "decoder.head", sd, "decoder.conv2.conv")
    _strict(sd, "audiodec")
    return as_state_dict(out)


def audiodec_schema(cfg) -> dict:
    widths, k = cfg.widths, cfg.kernel_size

    def res(prefix, ch):
        s = {}
        for j in range(len(cfg.dilations)):
            s[f"{prefix}.res_units.{j}.conv1.conv.weight"] = (ch, ch, k)
            s[f"{prefix}.res_units.{j}.conv2.conv.weight"] = (ch, ch, 1)
        return s

    s = {"encoder.conv.conv.weight": (cfg.encode_channels, 1, k),
         "encoder.conv.conv.bias": (cfg.encode_channels,)}
    ch = cfg.encode_channels
    for i, stride in enumerate(cfg.strides):
        b = f"encoder.conv_blocks.{i}"
        s.update(res(b, ch))
        s[f"{b}.conv.conv.weight"] = (widths[i], ch, 2 * stride)
        s[f"{b}.conv.conv.bias"] = (widths[i],)
        ch = widths[i]
    s["projector.conv.weight"] = (cfg.code_dim, widths[-1], 3)
    for q in range(cfg.num_quantizers):
        s[f"quantizer.codebook.layers.{q}.embed"] = (cfg.codebook_size,
                                                     cfg.code_dim)
    s["decoder.conv1.conv.weight"] = (widths[-1], cfg.code_dim, k)
    s["decoder.conv1.conv.bias"] = (widths[-1],)
    outs = (*widths[::-1][1:], cfg.encode_channels)
    for i, (stride, o) in enumerate(zip(reversed(cfg.strides), outs)):
        b = f"decoder.conv_blocks.{i}"
        s[f"{b}.conv1.deconv.weight"] = (ch, o, 2 * stride)
        s[f"{b}.conv1.deconv.bias"] = (o,)
        s.update(res(b, o))
        ch = o
    s["decoder.conv2.conv.weight"] = (1, cfg.encode_channels, k)
    s["decoder.conv2.conv.bias"] = (1,)
    return s


# --------------------------------------------------------------------- #
# MagiCodec (MagiCodec-50Hz-Base's Generator)
# --------------------------------------------------------------------- #

def convert_magicodec_state_dict(sd, cfg, key_map=None) -> dict:
    """MagiCodec's ``Generator`` state dict → :class:`..models.magicodec.
    MagiCodec`'s; ``quantizer.codebook.weight`` is read as it is. The
    towers' naming (BS-RoFormer blocks under ``encoder.transformers`` and
    ``decoder.transformers`` around the patch convs and the VQ's
    projections) wants a diff against a real file; repair a renamed key
    with ``key_map`` (:mod:`.overlay`)."""
    sd = _TrackingDict(apply_key_map(sd, key_map))
    out = {}
    put_conv(out, "patch", sd, "encoder.patch_embed")
    _put_bs_roformer(out, sd, "encoder.transformers", "enc", cfg.depth)
    put_norm(out, "enc_norm", sd, "encoder.norm")
    put_linear(out, "in_proj", sd, "quantizer.in_proj")
    out["codebook"] = _f32(sd, "quantizer.codebook.weight")
    put_linear(out, "out_proj", sd, "quantizer.out_proj")
    _put_bs_roformer(out, sd, "decoder.transformers", "dec", cfg.depth)
    put_norm(out, "dec_norm", sd, "decoder.norm")
    put_conv(out, "unpatch", sd, "decoder.patch_unembed")
    _strict(sd, "magicodec")
    return as_state_dict(out)


def magicodec_schema(cfg) -> dict:
    C, D, k = cfg.dim, cfg.codebook_dim, 2 * cfg.hop_length
    s = {"encoder.patch_embed.weight": (C, 1, k),
         "encoder.patch_embed.bias": (C,),
         "encoder.norm.weight": (C,), "encoder.norm.bias": (C,),
         "quantizer.in_proj.weight": (D, C), "quantizer.in_proj.bias": (D,),
         "quantizer.codebook.weight": (cfg.codebook_size, D),
         "quantizer.out_proj.weight": (C, D),
         "quantizer.out_proj.bias": (C,),
         "decoder.norm.weight": (C,), "decoder.norm.bias": (C,),
         "decoder.patch_unembed.weight": (C, 1, k),
         "decoder.patch_unembed.bias": (1,)}
    for side in ("encoder", "decoder"):
        s.update(_bs_roformer_schema(f"{side}.transformers", cfg.depth, C,
                                     cfg.num_heads))
    return s


# --------------------------------------------------------------------- #
# FocalCodec (lucadellalib/focalcodec)
# --------------------------------------------------------------------- #

def _put_focal_blocks(out, sd, src: str, dst: str, cfg) -> None:
    """FocalNet-1D blocks (the official FocalNet naming: ``norm1``,
    ``modulation.{f, focal_layers.<l>.0, h, proj}``, ``norm2``,
    ``mlp.fc{1,2}``); the depthwise focal convs keep their layout."""
    for i in range(cfg.num_blocks):
        b, d = f"{src}.blocks.{i}", f"{dst}.blocks.{i}"
        put_norm(out, f"{d}.ln1", sd, f"{b}.norm1")
        put_linear(out, f"{d}.f", sd, f"{b}.modulation.f")
        for lvl in range(cfg.focal_levels):
            out[f"{d}.focal_convs.{lvl}.w"] = _f32(
                sd, f"{b}.modulation.focal_layers.{lvl}.0.weight")
        put_linear(out, f"{d}.h", sd, f"{b}.modulation.h")
        put_linear(out, f"{d}.proj", sd, f"{b}.modulation.proj")
        put_norm(out, f"{d}.ln2", sd, f"{b}.norm2")
        put_linear(out, f"{d}.mlp1", sd, f"{b}.mlp.fc1")
        put_linear(out, f"{d}.mlp2", sd, f"{b}.mlp.fc2")


def convert_focalcodec_state_dict(sd, cfg, key_map=None) -> dict:
    """A FocalCodec hub checkpoint → :class:`..models.focalcodec.
    FocalCodec`'s: ``encoder.*`` the truncated WavLM-large (HF naming),
    ``compressor``/``decompressor`` the FocalNet blocks and the boundary
    projections (``compressor.head``, ``decompressor.embed``), the BSQ has
    no weights (a ``codebook`` buffer is tolerated), ``decoder.*`` the
    Vocos backbone and head. The hub code re-implements WavLM and FocalNet
    under its own names; this follows the upstream names it derives from,
    so diff a real file with ``tools/inspect_checkpoint_torch.py --family
    focalcodec`` first and repair a renamed key with ``key_map``."""
    sd = _TrackingDict(apply_key_map(sd, key_map))
    out = {}
    _put_wavlm(out, sd, cfg.wavlm, "encoder.", "encoder.")
    _put_focal_blocks(out, sd, "compressor", "compressor", cfg.compressor())
    put_linear(out, "down_proj", sd, "compressor.head")
    put_linear(out, "up_proj", sd, "decompressor.embed")
    _put_focal_blocks(out, sd, "decompressor", "decompressor",
                      cfg.compressor())
    _put_vocos(out, sd, cfg.vocos(), "decoder.", "decoder.")
    _strict(sd, "focalcodec", ("codebook",))
    return as_state_dict(out)


def _focal_blocks_schema(prefix: str, cfg) -> dict:
    C = cfg.dim
    hidden = int(C * cfg.mlp_ratio)
    F = 2 * C + cfg.focal_levels + 1
    s = {}
    for i in range(cfg.num_blocks):
        b = f"{prefix}.blocks.{i}"
        m = f"{b}.modulation"
        s.update({f"{b}.norm1.weight": (C,), f"{b}.norm1.bias": (C,),
                  f"{m}.f.weight": (F, C), f"{m}.f.bias": (F,)})
        for lvl in range(cfg.focal_levels):
            s[f"{m}.focal_layers.{lvl}.0.weight"] = (
                C, 1, cfg.focal_window + 2 * lvl)
        s.update({f"{m}.h.weight": (C, C), f"{m}.h.bias": (C,),
                  f"{m}.proj.weight": (C, C), f"{m}.proj.bias": (C,),
                  f"{b}.norm2.weight": (C,), f"{b}.norm2.bias": (C,),
                  f"{b}.mlp.fc1.weight": (hidden, C),
                  f"{b}.mlp.fc1.bias": (hidden,),
                  f"{b}.mlp.fc2.weight": (C, hidden),
                  f"{b}.mlp.fc2.bias": (C,)})
    return s


def focalcodec_schema(cfg) -> dict:
    C, D = cfg.wavlm.hidden_size, cfg.codebook_bits
    return {**wavlm_schema(cfg.wavlm, "encoder."),
            **_focal_blocks_schema("compressor", cfg.compressor()),
            "compressor.head.weight": (D, C), "compressor.head.bias": (D,),
            "decompressor.embed.weight": (C, D),
            "decompressor.embed.bias": (C,),
            **_focal_blocks_schema("decompressor", cfg.compressor()),
            **vocos_schema(cfg.vocos(), root="decoder.")}


# --------------------------------------------------------------------- #
# BiCodec (SparkAudio/Spark-TTS-0.5B's BiCodec and its wav2vec2-XLSR)
# --------------------------------------------------------------------- #

def _put_vocos_backbone(out, sd, src: str, dst: str, num_layers: int,
                        cond: bool = False) -> None:
    """Spark-TTS's ``VocosBackbone`` (no ``backbone.`` level); ``cond``:
    the continuous AdaLayerNorm (``norm.scale``/``norm.shift`` linears)."""
    def ada(d, prefix):
        for part in ("scale", "shift"):
            out[f"{d}.{part}_w"] = _t(sd, f"{prefix}.{part}.weight")
            out[f"{d}.{part}_b"] = _f32(sd, f"{prefix}.{part}.bias")

    put_conv(out, f"{dst}.embed", sd, f"{src}.embed")
    if cond:
        ada(f"{dst}.adanorm_cont_in", f"{src}.norm")
    else:
        put_norm(out, f"{dst}.norm_in", sd, f"{src}.norm")
    for i in range(num_layers):
        p, d = f"{src}.convnext.{i}", f"{dst}.blocks.{i}"
        put_conv(out, f"{d}.dwconv", sd, f"{p}.dwconv")
        put_linear(out, f"{d}.pw1", sd, f"{p}.pwconv1")
        put_linear(out, f"{d}.pw2", sd, f"{p}.pwconv2")
        out[f"{d}.gamma"] = _f32(sd, f"{p}.gamma")
        if cond:
            ada(f"{d}.adanorm_cont", f"{p}.norm")
        else:
            put_norm(out, f"{d}.norm", sd, f"{p}.norm")
    put_norm(out, f"{dst}.norm_out", sd, f"{src}.final_layer_norm")


def _put_bn(out, dst, sd, prefix) -> None:
    put_norm(out, dst, sd, prefix)
    out[f"{dst}.mean"] = _f32(sd, f"{prefix}.running_mean")
    out[f"{dst}.var"] = _f32(sd, f"{prefix}.running_var")


def _put_ecapa(out, sd, src: str, dst: str, cfg) -> None:
    """wespeaker's ``ECAPA_TDNN_GLOB_c512`` → :class:`..nn.ecapa.Ecapa`:
    bias-free convs with batch norms (their running statistics), the
    Res2Net split convs, the squeeze-excitation linears, the attentive
    pooling's 1×1 convs as ``[in, out]`` matrices."""
    def crb(d, prefix):
        put_conv(out, f"{d}.conv", sd, f"{prefix}.conv", bias=False)
        _put_bn(out, f"{d}.bn", sd, f"{prefix}.bn")

    crb(f"{dst}.layer1", f"{src}.layer1")
    for li in (2, 3, 4):
        b, d = f"{src}.layer{li}.se_res2block", f"{dst}.layer{li}"
        crb(f"{d}.in", f"{b}.0")
        for i in range(cfg.scale - 1):
            put_conv(out, f"{d}.res2.convs.{i}", sd, f"{b}.1.convs.{i}",
                     bias=False)
            _put_bn(out, f"{d}.res2.bns.{i}", sd, f"{b}.1.bns.{i}")
        crb(f"{d}.out", f"{b}.2")
        for n in (1, 2):
            out[f"{d}.se.w{n}"] = _t(sd, f"{b}.3.linear{n}.weight")
            out[f"{d}.se.b{n}"] = _f32(sd, f"{b}.3.linear{n}.bias")
    put_conv(out, f"{dst}.conv", sd, f"{src}.conv")
    for n in (1, 2):
        _proj(out, f"{dst}.attn{n}", sd, f"{src}.pool.linear{n}")
    _put_bn(out, f"{dst}.pool_bn", sd, f"{src}.bn")
    put_linear(out, f"{dst}.linear", sd, f"{src}.linear")


def _put_perceiver(out, sd, src: str, dst: str, depth: int) -> None:
    """naturalspeech2's perceiver resampler (``to_q``/``to_kv``/``to_out``
    bias-free; the GEGLU feed-forward ``1``/``3``; RMSNorm ``gamma``s)."""
    out[f"{dst}.latents"] = _f32(sd, f"{src}.latents")
    for i in range(depth):
        a, f = f"{src}.layers.{i}.0", f"{src}.layers.{i}.1"
        d = f"{dst}.blocks.{i}"
        out[f"{d}.attn.norm"] = _f32(sd, f"{a}.norm.gamma")
        for name in ("q", "kv", "out"):
            out[f"{d}.attn.{name}_w"] = _t(sd, f"{a}.to_{name}.weight")
        out[f"{d}.ff.norm"] = _f32(sd, f"{f}.0.gamma")
        for n, layer in ((1, 1), (2, 3)):
            out[f"{d}.ff.w{n}"] = _t(sd, f"{f}.{layer}.weight")
            out[f"{d}.ff.b{n}"] = _f32(sd, f"{f}.{layer}.bias")
    out[f"{dst}.norm"] = _f32(sd, f"{src}.norm.gamma")
    if f"{src}.proj_context.weight" in sd:
        put_linear(out, f"{dst}.proj_context", sd, f"{src}.proj_context")


def convert_bicodec_state_dict(sd, cfg, w2v_sd=None,
                               allow_random_w2v: bool = False,
                               generator=None) -> dict:
    """Spark-TTS's BiCodec state dict, with the wav2vec2-large-XLSR-53
    state dict that ships as a separate file (``w2v_sd``, HF naming) →
    :class:`..models.bicodec.BiCodec`'s (``cfg``: its
    ``BiCodecModelConfig``). Without ``w2v_sd`` it raises unless
    ``allow_random_w2v``: then the tower is drawn by the port's own init
    from ``generator`` (seed 0 by default), which differs from the JAX
    package's draw. Module naming follows the released config (the
    Encoder's ``encoder.encoder``/``encoder.project``, the factorised VQ
    ``quantizer``, wespeaker's ECAPA and the perceiver under
    ``speaker_encoder``, the AdaLN ``prenet.decoder``, the DAC-style
    ``decoder.model``) and wants a diff against a real file."""
    if w2v_sd is None and not allow_random_w2v:
        raise ValueError(
            "bicodec: the wav2vec2-XLSR feature tower ships as a separate "
            "file in the Spark-TTS repo: pass it as w2v_sd=, or pass "
            "allow_random_w2v=True for a deliberately random tower (every "
            "semantic token is garbage then)")
    sd = _TrackingDict(sd)
    out = {}
    if w2v_sd is not None:
        _prefixed(out, "w2v.", convert_wavlm_state_dict(w2v_sd, cfg.w2v))
    else:
        gen = generator or torch.Generator().manual_seed(0)
        out.update(init_wavlm_params(gen, cfg.w2v, "w2v."))
    _put_vocos_backbone(out, sd, "encoder.encoder", "encoder.backbone",
                        cfg.encoder_layers)
    put_linear(out, "encoder.project", sd, "encoder.project")
    _proj(out, "quantizer.in_proj", sd, "quantizer.in_proj")
    out["quantizer.codebook"] = _f32(sd, "quantizer.codebook.weight")
    _proj(out, "quantizer.out_proj", sd, "quantizer.out_proj")
    se = "speaker_encoder"
    _put_ecapa(out, sd, f"{se}.speaker_encoder", "ecapa", cfg.ecapa())
    _put_perceiver(out, sd, f"{se}.perceiver_sampler", "perceiver",
                   cfg.perceiver().depth)
    for name in ("project_in", "project_out"):
        put_linear(out, f"speaker_fsq.{name}", sd, f"{se}.quantizer.{name}")
    put_linear(out, "speaker_fsq.project", sd, f"{se}.project")
    _put_vocos_backbone(out, sd, "prenet.decoder", "prenet.backbone",
                        cfg.prenet_layers, cond=True)
    put_linear(out, "prenet.project", sd, "prenet.project")
    n = len(cfg.decoder_rates)
    put_conv(out, "decoder.stem", sd, "decoder.model.0")
    for i in range(n):
        b, d = f"decoder.model.{i + 1}.block", f"decoder.blocks.{i}"
        put_alpha(out, f"{d}.alpha", sd, f"{b}.0.alpha")
        put_conv(out, f"{d}.convtr", sd, f"{b}.1")
        for j in range(3):
            _res_unit(out, f"{d}.res.{j}", sd, f"{b}.{2 + j}")
    put_alpha(out, "decoder.alpha_out", sd, f"decoder.model.{n + 1}.alpha")
    put_conv(out, "decoder.conv_out", sd, f"decoder.model.{n + 2}")
    _strict(sd, "bicodec", (
        ".window", "mel_scale.fb", "num_batches_tracked", ".scales",
        "._levels", "._basis", ".implicit_codebook"))
    return as_state_dict(out)


def _vocos_backbone_schema(root: str, num_layers: int, cin: int, dim: int,
                           inter: int, cond_dim=None) -> dict:
    def norm(prefix):
        if cond_dim:
            return {f"{prefix}.{p}.{leaf}": shape
                    for p in ("scale", "shift")
                    for leaf, shape in (("weight", (dim, cond_dim)),
                                        ("bias", (dim,)))}
        return {f"{prefix}.weight": (dim,), f"{prefix}.bias": (dim,)}

    s = {f"{root}.embed.weight": (dim, cin, 7), f"{root}.embed.bias": (dim,),
         **norm(f"{root}.norm")}
    for i in range(num_layers):
        p = f"{root}.convnext.{i}"
        s.update({f"{p}.dwconv.weight": (dim, 1, 7),
                  f"{p}.dwconv.bias": (dim,), **norm(f"{p}.norm"),
                  f"{p}.pwconv1.weight": (inter, dim),
                  f"{p}.pwconv1.bias": (inter,),
                  f"{p}.pwconv2.weight": (dim, inter),
                  f"{p}.pwconv2.bias": (dim,), f"{p}.gamma": (dim,)})
    s[f"{root}.final_layer_norm.weight"] = (dim,)
    s[f"{root}.final_layer_norm.bias"] = (dim,)
    return s


def bicodec_schema(cfg) -> dict:
    """The BiCodec file's key → shape map (its XLSR tower is
    :func:`wavlm_schema` of ``cfg.w2v``, a file of its own)."""
    H, D = cfg.latent_dim, cfg.codebook_dim
    C, A = cfg.speaker_channels, 3 * cfg.speaker_channels
    P, L = cfg.perceiver_dim, len(cfg.fsq_levels)
    pc, ec = cfg.perceiver(), cfg.ecapa()

    def bn(prefix, ch):
        return {f"{prefix}.{leaf}": (ch,) for leaf in
                ("weight", "bias", "running_mean", "running_var")}

    def crb(prefix, cin, cout, k):
        return {f"{prefix}.conv.weight": (cout, cin, k),
                **bn(f"{prefix}.bn", cout)}

    def lin(prefix, o, i):
        return {f"{prefix}.weight": (o, i), f"{prefix}.bias": (o,)}

    s = {**_vocos_backbone_schema("encoder.encoder", cfg.encoder_layers,
                                  cfg.w2v.hidden_size, cfg.encoder_dim,
                                  cfg.encoder_intermediate_dim),
         **lin("encoder.project", H, cfg.encoder_dim),
         **wn_conv_schema("quantizer.in_proj", D, H, 1),
         "quantizer.codebook.weight": (cfg.codebook_size, D),
         **wn_conv_schema("quantizer.out_proj", H, D, 1)}
    e = "speaker_encoder.speaker_encoder"
    s.update(crb(f"{e}.layer1", cfg.num_mels, C, 5))
    w = C // ec.scale
    for li in (2, 3, 4):
        b = f"{e}.layer{li}.se_res2block"
        s.update(crb(f"{b}.0", C, C, 1))
        for i in range(ec.scale - 1):
            s[f"{b}.1.convs.{i}.weight"] = (w, w, 3)
            s.update(bn(f"{b}.1.bns.{i}", w))
        s.update({**crb(f"{b}.2", C, C, 1),
                  **lin(f"{b}.3.linear1", ec.se_bottleneck, C),
                  **lin(f"{b}.3.linear2", C, ec.se_bottleneck)})
    s.update({f"{e}.conv.weight": (A, A, 1), f"{e}.conv.bias": (A,),
              f"{e}.pool.linear1.weight": (ec.attn_hidden, 3 * A, 1),
              f"{e}.pool.linear1.bias": (ec.attn_hidden,),
              f"{e}.pool.linear2.weight": (A, ec.attn_hidden, 1),
              f"{e}.pool.linear2.bias": (A,), **bn(f"{e}.bn", 2 * A),
              **lin(f"{e}.linear", cfg.speaker_dim, 2 * A)})
    p, I = "speaker_encoder.perceiver_sampler", pc.inner_dim
    s.update({f"{p}.latents": (cfg.num_global_tokens, P),
              **lin(f"{p}.proj_context", P, A)})
    for i in range(pc.depth):
        a, f = f"{p}.layers.{i}.0", f"{p}.layers.{i}.1"
        s.update({f"{a}.norm.gamma": (P,), f"{a}.to_q.weight": (I, P),
                  f"{a}.to_kv.weight": (2 * I, P),
                  f"{a}.to_out.weight": (P, I), f"{f}.0.gamma": (P,),
                  **lin(f"{f}.1", 2 * pc.ff_inner, P),
                  **lin(f"{f}.3", P, pc.ff_inner)})
    s.update({f"{p}.norm.gamma": (P,),
              **lin("speaker_encoder.quantizer.project_in", L, P),
              **lin("speaker_encoder.quantizer.project_out", P, L),
              **lin("speaker_encoder.project", cfg.speaker_dim,
                    P * cfg.num_global_tokens),
              **_vocos_backbone_schema(
                  "prenet.decoder", cfg.prenet_layers, H, cfg.prenet_dim,
                  cfg.prenet_intermediate_dim, cond_dim=cfg.speaker_dim),
              **lin("prenet.project", H, cfg.prenet_dim)})
    ch = cfg.decoder_channels
    s.update(wn_conv_schema("decoder.model.0", ch, H, 7))
    for i, k in enumerate(cfg.decoder_kernels[:len(cfg.decoder_rates)]):
        b = f"decoder.model.{i + 1}.block"
        s[f"{b}.0.alpha"] = (1, ch, 1)
        s.update(wn_conv_schema(f"{b}.1", ch // 2, ch, k, transpose=True))
        ch //= 2
        for j in range(3):
            s.update(_res_unit_schema(f"{b}.{2 + j}", ch))
    n = len(cfg.decoder_rates)
    s[f"decoder.model.{n + 1}.alpha"] = (1, ch, 1)
    s.update(wn_conv_schema(f"decoder.model.{n + 2}", 1, ch, 7))
    return s


# --------------------------------------------------------------------- #
# SemantiCodec and WavLM+K-means' HiFi-GAN vocoder
# --------------------------------------------------------------------- #

def _checked(a, want, what: str) -> torch.Tensor:
    t = to_tensor(a)
    if tuple(t.shape) != want:
        raise ValueError(f"{what} shape {tuple(t.shape)} != {want}")
    return t


def _latent_scale(sd, what: str) -> torch.Tensor:
    if "scale_factor" not in sd:
        raise ValueError(
            f"{what}: the checkpoint has no 'scale_factor': the LDM's latent "
            "scale is required (a decode at 1.0 is garbage audio); if the "
            "export dropped it, add the buffer back")
    return to_tensor(sd["scale_factor"]).reshape(())


def convert_semanticodec_components(cfg, audiomae_sd=None, centroids=None,
                                    acoustic_codebook=None,
                                    base_params=None, ldm_sd=None,
                                    vocoder_sd=None) -> dict:
    """:class:`..models.semanticodec.SemantiCodec`'s state dict assembled
    from the released pieces: the AudioMAE encoder (timm ViT naming), the
    semantic k-means ``centroid_npy`` ``[semantic_vocab, feature_dim]``,
    the acoustic VQ's codebook ``[acoustic_vocab, feature_dim]``, and for
    ``decoder_variant="ldm"`` the whole latent-diffusion checkpoint
    (``first_stage_model.*``, ``model.diffusion_model.*`` and its
    ``scale_factor``) and the HiFi-GAN vocoder's state dict. A piece not
    given keeps ``base_params``' tensors (a port state dict; by default the
    port's own init from seed 0, which differs from the JAX package's
    draw)."""
    from audiocodecs_tpu_torch.convert.audiomae import (
        convert_audiomae_state_dict)
    from audiocodecs_tpu_torch.convert.ldm import (
        convert_hifigan_state_dict, convert_unet_state_dict,
        convert_vae_state_dict, split_ldm_checkpoint)
    from audiocodecs_tpu_torch.models.semanticodec import (
        init_semanticodec_params)

    out = dict(base_params) if base_params is not None else (
        init_semanticodec_params(torch.Generator().manual_seed(0), cfg))
    if audiomae_sd is not None:
        _prefixed(out, "encoder.",
                  convert_audiomae_state_dict(audiomae_sd, cfg.audiomae()))
    if centroids is not None:
        out["semantic_codebook"] = _checked(
            centroids, (cfg.semantic_vocab, cfg.feature_dim), "centroid_npy")
    if acoustic_codebook is not None:
        out["acoustic_codebook"] = _checked(
            acoustic_codebook, (cfg.acoustic_vocab, cfg.feature_dim),
            "acoustic codebook")
    if ldm_sd is not None:
        parts = split_ldm_checkpoint(ldm_sd)
        _prefixed(out, "vae.", convert_vae_state_dict(parts["vae"],
                                                      cfg.vae_cfg))
        _prefixed(out, "unet.", convert_unet_state_dict(parts["unet"],
                                                        cfg.unet()))
        out["latent_scale"] = _latent_scale(ldm_sd, "semanticodec ldm_sd")
    if vocoder_sd is not None:
        _prefixed(out, "vocoder.", convert_hifigan_state_dict(
            vocoder_sd, cfg.vocoder_cfg))
    return out


def convert_semanticodec_ldm_state_dict(sd, cfg) -> dict:
    """The whole LDM checkpoint → the decoder's part of SemantiCodec's
    state dict (``vae.*``, ``unet.*``, ``latent_scale``); merge it with
    the encoder's pieces (:func:`convert_semanticodec_components`)."""
    from audiocodecs_tpu_torch.convert.ldm import (
        convert_unet_state_dict, convert_vae_state_dict, split_ldm_checkpoint)

    if getattr(cfg, "decoder_variant", "analog") != "ldm":
        cfg = dataclasses.replace(cfg, decoder_variant="ldm")
    parts = split_ldm_checkpoint(sd)
    out = {}
    _prefixed(out, "vae.", convert_vae_state_dict(parts["vae"], cfg.vae_cfg))
    _prefixed(out, "unet.", convert_unet_state_dict(parts["unet"],
                                                    cfg.unet()))
    out["latent_scale"] = _latent_scale(sd, "semanticodec-ldm")
    return out


def convert_semanticodec_vocoder_state_dict(sd, cfg) -> dict:
    """The HiFi-GAN vocoder's file → ``vocoder.*`` of SemantiCodec's state
    dict."""
    from audiocodecs_tpu_torch.convert.ldm import convert_hifigan_state_dict

    out = {}
    _prefixed(out, "vocoder.", convert_hifigan_state_dict(sd,
                                                          cfg.vocoder_cfg))
    return out


_SPEECHBRAIN_CONV = (".conv.weight_g", ".conv.weight_v", ".conv.weight",
                     ".conv.bias", ".conv.parametrizations.weight.original0",
                     ".conv.parametrizations.weight.original1")


def convert_wavlm_kmeans_vocoder(sd, cfg=None) -> dict:
    """A HiFi-GAN unit vocoder's state dict (``lucadellalib/discrete-
    wavlm-codec``) → :class:`..nn.hifigan.HiFiGAN`'s (prefix it with
    ``vocoder.`` for :class:`..models.wavlm_kmeans.WavLMKmeans` with
    ``vocoder_variant="hifigan"``). Takes jik876's flat naming
    (``conv_pre.weight_g``) and speechbrain's wrapped modules
    (``conv_pre.conv.weight_g``), whose inner ``.conv`` level is
    stripped. ``cfg`` defaults to that variant's HiFi-GAN."""
    from audiocodecs_tpu_torch.convert.ldm import convert_hifigan_state_dict
    from audiocodecs_tpu_torch.models.wavlm_kmeans import (
        WavLMKmeansModelConfig)

    flat = {}
    for k, v in sd.items():
        for suffix in _SPEECHBRAIN_CONV:
            if k.endswith(suffix):
                k = k[:-len(suffix)] + suffix[len(".conv"):]
                break
        flat[k] = v
    if cfg is None:
        cfg = WavLMKmeansModelConfig(vocoder_variant="hifigan").hifigan()
    return convert_hifigan_state_dict(flat, cfg)


# --------------------------------------------------------------------- #
# HILCodec
# --------------------------------------------------------------------- #

def convert_hilcodec_components(cfg=None, quantizer_sd=None,
                                base_params=None) -> dict:
    """The codebooks alone (``quantizer.layers.<k>.embed [C, emb]``, the
    interface the upstream wrapper pins) into ``base_params`` (a port
    state dict of :class:`..models.hilcodec.HILCodec`; by default the
    port's own init from seed 0); the towers keep the base's weights."""
    from audiocodecs_tpu_torch.models.hilcodec import (
        HILCodec, init_hilcodec_params)

    mc = cfg or HILCodec.default_model_config()
    out = dict(base_params) if base_params is not None else (
        init_hilcodec_params(torch.Generator().manual_seed(0), mc))
    if quantizer_sd is not None:
        cbs = []
        for k in range(mc.num_quantizers):
            key = f"quantizer.layers.{k}.embed"
            if key not in quantizer_sd:
                raise ValueError(f"hilcodec: missing codebook {key}")
            cbs.append(_checked(quantizer_sd[key],
                                (mc.codebook_size, mc.emb_dim),
                                f"hilcodec: codebook {k}"))
        out["codebooks"] = torch.stack(cbs)
    return out


def convert_hilcodec_full_state_dict(sd, cfg) -> dict:
    """A whole HILCodec state dict → :class:`..models.hilcodec.HILCodec`'s.
    The quantizer's naming is pinned by the upstream wrapper; the towers'
    is the documented guess for the architecture the paper describes
    (``encoder.conv_in``; per block ``skip`` (the 1×1 waveform
    projection), ``res.<u>.dw`` (depthwise) and ``res.<u>.pw`` (1×1),
    ``down``; ``encoder.conv_out``; the decoder mirrors it with transposed
    ``up`` convs and 1-channel ``skip`` heads). Diff a real file with
    ``tools/inspect_checkpoint_torch.py --family hilcodec`` first."""
    sd = _TrackingDict(sd)
    out = {}
    for side in ("encoder", "decoder"):
        put_conv(out, f"{side}.stem", sd, f"{side}.conv_in")
        for i in range(len(cfg.strides)):
            b = f"{side}.blocks.{i}"
            put_conv(out, f"{b}.{'down' if side == 'encoder' else 'up'}",
                     sd, f"{b}.{'down' if side == 'encoder' else 'up'}")
            for u in range(cfg.res_units_per_block):
                for c in ("dw", "pw"):
                    put_conv(out, f"{b}.res.{u}.{c}", sd, f"{b}.res.{u}.{c}")
            if cfg.waveform_skips:
                put_conv(out, f"{b}.skip", sd, f"{b}.skip")
        put_conv(out, f"{side}.head", sd, f"{side}.conv_out")
    out["codebooks"] = np.stack([
        _f32(sd, f"quantizer.layers.{k}.embed")
        for k in range(cfg.num_quantizers)])
    _strict(sd, "hilcodec")
    return as_state_dict(out)


def hilcodec_schema(cfg) -> dict:
    """The documented vendor schema's key → shape map."""
    widths, k, rk = cfg.widths, cfg.kernel_size, cfg.res_kernel_size

    def conv(prefix, cout, cin, kk):
        return {f"{prefix}.weight": (cout, cin, kk), f"{prefix}.bias": (cout,)}

    def res(prefix, ch):
        s = {}
        for u in range(cfg.res_units_per_block):
            s.update({**conv(f"{prefix}.res.{u}.dw", ch, 1, rk),
                      **conv(f"{prefix}.res.{u}.pw", ch, ch, 1)})
        return s

    s = conv("encoder.conv_in", cfg.channels, 1, k)
    for i, stride in enumerate(cfg.strides):
        b, ch = f"encoder.blocks.{i}", widths[i]
        if cfg.waveform_skips:
            s.update(conv(f"{b}.skip", ch, 1, 1))
        s.update({**res(b, ch), **conv(f"{b}.down", min(2 * ch,
                                                        cfg.max_channels),
                                       ch, 2 * stride)})
    top = min(2 * widths[-1], cfg.max_channels)
    s.update({**conv("encoder.conv_out", cfg.emb_dim, top, 3),
              **conv("decoder.conv_in", top, cfg.emb_dim, 3)})
    ch = top
    for i, (stride, o) in enumerate(zip(reversed(cfg.strides),
                                        reversed(widths))):
        b = f"decoder.blocks.{i}"
        # a ConvTranspose1d's weight is [Cin, Cout, K]
        s.update({f"{b}.up.weight": (ch, o, 2 * stride), f"{b}.up.bias": (o,),
                  **res(b, o)})
        if cfg.waveform_skips:
            s.update(conv(f"{b}.skip", 1, o, 1))
        ch = o
    s.update(conv("decoder.conv_out", 1, ch, k))
    for q in range(cfg.num_quantizers):
        s[f"quantizer.layers.{q}.embed"] = (cfg.codebook_size, cfg.emb_dim)
    return s


def convert_hilcodec_state_dict(sd, cfg, *, allow_partial: bool = False,
                                key_map=None) -> dict:
    """The command-line path: a whole checkpoint through
    :func:`convert_hilcodec_full_state_dict`, after the ``key_map``
    overlay (:mod:`.overlay`), the first repair for renamed towers. Where
    the towers do not convert it raises, unless ``allow_partial``: then it
    warns and converts the codebooks alone, the towers kept at the port's
    own init (:func:`convert_hilcodec_components`)."""
    sd = apply_key_map(sd, key_map)
    try:
        return convert_hilcodec_full_state_dict(sd, cfg)
    except (KeyError, ValueError) as e:
        if not allow_partial:
            raise ValueError(
                f"hilcodec: the towers did not convert ({e}). Diff the "
                "checkpoint with tools/inspect_checkpoint_torch.py --family "
                "hilcodec and repair the names with a key map, or convert "
                "with allow_partial=True (--allow-partial) to take the "
                "codebooks alone, the towers left at a random init") from e
        warnings.warn(
            f"hilcodec: the towers did not convert ({e}); converting the "
            "quantizer's codebooks alone, the towers stay at a random init. "
            "Diff the checkpoint with tools/inspect_checkpoint_torch.py "
            "--family hilcodec and repair the names with a key map.",
            stacklevel=2)
        quant = {k: v for k, v in sd.items() if k.startswith("quantizer.")}
        return convert_hilcodec_components(cfg, quantizer_sd=quant)


# --------------------------------------------------------------------- #
# DyCAST (lucadellalib/dycast)
# --------------------------------------------------------------------- #

def convert_dycast_state_dict(sd, cfg, key_map=None) -> dict:
    """A DyCAST hub checkpoint → :class:`..models.dycast.DyCAST`'s. The
    vendor's schema is unreleased; this is the JAX package's documented
    guess, from the component names the upstream wrapper touches and the
    author's FocalCodec lineage: ``encoder.*`` the WavLM tower (HF
    naming), ``boundary_predictor.head`` a ``[1, H]`` linear, ``compressor.
    proj.weight [2·ch, H]``, ``decoder.embed.weight [H, 2·ch]``,
    ``decoder.vocoder.model.<i>.*`` an EnCodec-style SEANet decoder, an
    optional ``retriever.bank [M, H]``; a ``codebook`` buffer is
    tolerated. Every tower name is uncertain: diff a real file with
    ``tools/inspect_checkpoint_torch.py --family dycast`` first."""
    sd = _TrackingDict(apply_key_map(sd, key_map))
    out = {}
    _put_wavlm(out, sd, cfg.wavlm, "encoder.", "wavlm.")
    out["proj"] = _t(sd, "compressor.proj.weight")
    out["unproj"] = _t(sd, "decoder.embed.weight")
    convert_vendor_seanet(out, sd, cfg.vocoder(), "decoder.vocoder",
                          decoder=True, dst="vocoder")
    out["boundary.w"] = _f32(sd, "boundary_predictor.head.weight").reshape(-1)
    out["boundary.b"] = _f32(sd, "boundary_predictor.head.bias").reshape(())
    if "retriever.bank" in sd:
        out["retriever_bank"] = _f32(sd, "retriever.bank")
    H, D = cfg.wavlm.hidden_size, 2 * cfg.num_channels
    if out["proj"].shape != (H, D):
        raise ValueError(f"dycast: compressor.proj maps {out['proj'].shape}"
                         f", expected ({H}, {D})")
    if out["unproj"].shape != (D, H):
        raise ValueError(f"dycast: decoder.embed maps "
                         f"{out['unproj'].shape}, expected ({D}, {H})")
    _strict(sd, "dycast", ("codebook",))
    return as_state_dict(out)


def dycast_schema(cfg) -> dict:
    """The documented guess's key → shape map."""
    H, D = cfg.wavlm.hidden_size, 2 * cfg.num_channels
    s = {**wavlm_schema(cfg.wavlm, "encoder."),
         "boundary_predictor.head.weight": (1, H),
         "boundary_predictor.head.bias": (1,),
         "compressor.proj.weight": (D, H), "decoder.embed.weight": (H, D),
         **vendor_seanet_schema(cfg.vocoder(), "decoder.vocoder",
                                decoder=True)}
    if cfg.use_retriever:
        s["retriever.bank"] = (cfg.retriever_bank_size, H)
    return s
