"""Whisper (encoder-decoder ASR), PyTorch.

Counterpart of ``audiocodecs_tpu/nn/whisper.py``. The reference's dWER and
ASR perplexity transcribe with a downloaded faster-whisper model
(``downstream/metrics/dwer.py:33-49``); here the Whisper forward runs on
the card from a converted HF ``WhisperForConditionalGeneration`` checkpoint
(:func:`..convert.whisper.convert_whisper_state_dict`).

* The log-mel front end (:func:`log_mel_spectrogram`) is HF's
  ``WhisperFeatureExtractor``: a Hann-400, hop-160, reflect-centred power
  spectrogram with the last frame dropped, the Slaney mel bank (80 or 128
  bins), ``log10`` floored at the row's max - 8, then ``(x + 4) / 4``.
* The encoder and decoder are pre-LN stacks of absolute learned (decoder)
  or sinusoidal (encoder) positions, biased q/v/o and bias-free k, exact
  GELU; attention is :func:`..nn.transformer.attention` (two batched
  products and the softmax in fp32), not ``scaled_dot_product_attention``:
  these logits set the transcript's tokens. Every product runs with TF32
  off.
* :func:`whisper_generate` is greedy decoding over a preallocated KV cache
  of static shape (the forced prompt and every new token written in place,
  the positions past the current one masked), with each layer's
  cross-attention K/V computed once from the encoder states. The forced
  prompt is prefilled through the same step. ``decode_dtype=torch.bfloat16``
  (opt-in) runs the decoder's weights and cache in bf16 and the logits
  against an fp32 copy of the embedding. ``torch.argmax`` takes the first
  of tied maxima, as ``jnp.argmax`` does.

Weights keep the reference's names: ``encoder.{conv1, conv2}`` (convs, ``w
[Cout, Cin, 3]`` here), ``encoder.pos``, ``encoder.layers.<i>.{ln1, attn,
ln2, mlp}``, ``encoder.ln_post``; ``decoder.{embed, pos}``,
``decoder.layers.<i>.{ln1, self_attn, ln_x, cross_attn, ln2, mlp}``,
``decoder.ln_post``; an attention is ``q``, ``k`` (no bias), ``v``, ``o``,
an MLP ``fc1``, ``fc2`` (linears ``w [in, out]``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.nn.layers import Conv1d, conv1d, exact_fp32
from audiocodecs_tpu_torch.nn.transformer import (
    Linear,
    Norm,
    _linear,
    _norm,
    attention,
    causal_mask,
)
from audiocodecs_tpu_torch.utils.melbank import mel_filterbank_slaney

__all__ = ["WhisperConfig", "Whisper", "init_whisper_params",
           "log_mel_spectrogram", "whisper_encode", "whisper_decode",
           "whisper_generate"]

_SAMPLE_RATE = 16000
_N_FFT = 400
_HOP = 160


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Mirrors the HF ``WhisperConfig`` fields the forward needs."""

    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_heads: int = 6
    decoder_layers: int = 4
    decoder_heads: int = 6
    encoder_ffn: int = 1536
    decoder_ffn: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448
    eos_token: int = 50257
    decoder_start_token: int = 50258
    norm_eps: float = 1e-5

    @property
    def enc_head_dim(self) -> int:
        return self.d_model // self.encoder_heads

    @property
    def dec_head_dim(self) -> int:
        return self.d_model // self.decoder_heads

    # one field map shared by the checkpoint converter (attributes of an
    # HF config) and the metric loader (a config.json dict)
    _HF_FIELDS = {
        "vocab_size": "vocab_size",
        "num_mel_bins": "num_mel_bins",
        "d_model": "d_model",
        "encoder_layers": "encoder_layers",
        "encoder_heads": "encoder_attention_heads",
        "decoder_layers": "decoder_layers",
        "decoder_heads": "decoder_attention_heads",
        "encoder_ffn": "encoder_ffn_dim",
        "decoder_ffn": "decoder_ffn_dim",
        "max_source_positions": "max_source_positions",
        "max_target_positions": "max_target_positions",
        "eos_token": "eos_token_id",
        "decoder_start_token": "decoder_start_token_id",
    }

    @classmethod
    def from_hf_dict(cls, d: dict) -> "WhisperConfig":
        """Build from an HF ``config.json`` dict (KeyError on missing)."""
        return cls(**{ours: d[hf] for ours, hf in cls._HF_FIELDS.items()})

    @property
    def multilingual(self) -> bool:
        """Released-checkpoint heuristic: ``.en`` models have vocab 51864
        (their tokenizers still contain the language tokens, so HF forces
        only ``[sot, notimestamps]`` for them)."""
        return self.vocab_size != 51864


# --------------------------------------------------------------------- #
# Log-mel front end (OpenAI/HF WhisperFeatureExtractor numerics)
# --------------------------------------------------------------------- #


def log_mel_spectrogram(wav: torch.Tensor,
                        num_mel_bins: int = 80) -> torch.Tensor:
    """``wav`` [B, T] at 16 kHz → log-mel features [B, T // 160, n_mels].
    Pad or trim to 30 s beforehand for checkpoint-exact behaviour."""
    pad = _N_FFT // 2
    x = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    n_frames = wav.shape[1] // _HOP  # centred: 1 + T // hop; drop the last
    frames = x.unfold(-1, _N_FFT, _HOP)[:, :n_frames]  # [B, F, 400]
    window = torch.from_numpy(
        np.hanning(_N_FFT + 1)[:-1].astype(np.float32)).to(wav.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel_f = torch.from_numpy(mel_filterbank_slaney(
        _SAMPLE_RATE, _N_FFT, num_mel_bins)).to(wav.device)  # [M, 201]
    with exact_fp32():
        mel = torch.matmul(power, mel_f.T)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    floor = torch.amax(log_spec, dim=(1, 2), keepdim=True) - 8.0
    return (torch.maximum(log_spec, floor) + 4.0) / 4.0


# --------------------------------------------------------------------- #
# Modules (weights only; the functions below apply them)
# --------------------------------------------------------------------- #


class _Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q, self.k = Linear(d, d, True), Linear(d, d, False)
        self.v, self.o = Linear(d, d, True), Linear(d, d, True)


class _MLP(nn.Module):
    def __init__(self, d: int, ffn: int):
        super().__init__()
        self.fc1, self.fc2 = Linear(d, ffn, True), Linear(ffn, d, True)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.ln1, self.attn = Norm(d, "layernorm"), _Attention(d)
        self.ln2, self.mlp = Norm(d, "layernorm"), _MLP(d, cfg.encoder_ffn)


class _DecoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.ln1, self.self_attn = Norm(d, "layernorm"), _Attention(d)
        self.ln_x, self.cross_attn = Norm(d, "layernorm"), _Attention(d)
        self.ln2, self.mlp = Norm(d, "layernorm"), _MLP(d, cfg.decoder_ffn)


class _Encoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.conv1 = Conv1d(cfg.num_mel_bins, d, 3)
        self.conv2 = Conv1d(d, d, 3)
        self.pos = nn.Parameter(torch.empty(cfg.max_source_positions, d))
        self.layers = nn.ModuleList(_EncoderLayer(cfg)
                                    for _ in range(cfg.encoder_layers))
        self.ln_post = Norm(d, "layernorm")


class _Decoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.pos = nn.Parameter(torch.empty(cfg.max_target_positions, d))
        self.layers = nn.ModuleList(_DecoderLayer(cfg)
                                    for _ in range(cfg.decoder_layers))
        self.ln_post = Norm(d, "layernorm")


class Whisper(nn.Module):
    """The model's weights (``encoder``, ``decoder``) and its config."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = _Encoder(cfg)
        self.decoder = _Decoder(cfg)


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def init_whisper_params(generator: torch.Generator,
                        cfg: WhisperConfig) -> dict:
    """Random weights of :class:`Whisper` as a state dict on the
    generator's device, in the reference's distributions (linears
    N(0, 1/in) with zero biases, convs N(0, 1/(3·cin)), norms 1 and 0, the
    encoder's sinusoids, the token and decoder position embeddings
    N(0, 0.02²)); the draws differ from the reference's."""
    dev = generator.device
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in Whisper(cfg).state_dict().items()}
    out = {}
    for k, shape in shapes.items():
        leaf = k.rsplit(".", 1)[-1]
        if k == "encoder.pos":
            t = torch.from_numpy(_sinusoids(*shape)).to(dev)
        elif k in ("decoder.embed", "decoder.pos"):
            t = torch.randn(shape, generator=generator, device=dev) * 0.02
        elif leaf == "g":
            t = torch.ones(shape, device=dev)
        elif leaf == "b":
            t = torch.zeros(shape, device=dev)
        elif ".conv" in k:  # [Cout, Cin, 3]
            t = torch.randn(shape, generator=generator, device=dev) * (
                3 * shape[1]) ** -0.5
        else:  # a linear [in, out]
            t = torch.randn(shape, generator=generator, device=dev
                            ) * shape[0] ** -0.5
        out[k] = t
    return out


# --------------------------------------------------------------------- #
# Encoder
# --------------------------------------------------------------------- #


def _gelu(x):
    return F.gelu(x, approximate="none")


def _mha(h, p: _Attention, num_heads: int, head_dim: int, kv=None,
         mask=None):
    """Pre-normed hidden [B, T, D] → attention output [B, T, D]; ``kv``:
    the source states of cross-attention (``h`` when None)."""
    B, T, D = h.shape
    src = h if kv is None else kv
    S = src.shape[1]
    q = _linear(h, p.q).reshape(B, T, num_heads, head_dim)
    k = _linear(src, p.k).reshape(B, S, num_heads, head_dim)
    v = _linear(src, p.v).reshape(B, S, num_heads, head_dim)
    return _linear(attention(q, k, v, mask).reshape(B, T, D), p.o)


def _ffn(x, p: _MLP):
    return _linear(_gelu(_linear(x, p.fc1)), p.fc2)


def whisper_encode(model: Whisper, mel: torch.Tensor) -> torch.Tensor:
    """Log-mel features [B, F, M] → encoder states [B, F // 2, D]."""
    cfg, enc = model.cfg, model.encoder
    eps = cfg.norm_eps
    x = F.pad(mel.transpose(1, 2), (1, 1))
    x = _gelu(conv1d(x, enc.conv1.w, enc.conv1.b))
    x = _gelu(conv1d(F.pad(x, (1, 1)), enc.conv2.w, enc.conv2.b, stride=2))
    x = x.transpose(1, 2) + enc.pos[None, : x.shape[2]]
    for p in enc.layers:
        x = x + _mha(_norm(x, p.ln1, "layernorm", eps), p.attn,
                     cfg.encoder_heads, cfg.enc_head_dim)
        x = x + _ffn(_norm(x, p.ln2, "layernorm", eps), p.mlp)
    return _norm(x, enc.ln_post, "layernorm", eps)


def _logits(x, embed):
    with exact_fp32():
        return torch.matmul(x, embed.T)


# --------------------------------------------------------------------- #
# Decoder (full-sequence forward: teacher forcing, scoring)
# --------------------------------------------------------------------- #


def whisper_decode(model: Whisper, tokens: torch.Tensor,
                   enc_states: torch.Tensor) -> torch.Tensor:
    """Token ids [B, L] and encoder states → logits [B, L, vocab] (the
    output projection is the token embedding, HF's tied ``proj_out``)."""
    cfg, dec = model.cfg, model.decoder
    eps = cfg.norm_eps
    L = tokens.shape[1]
    x = dec.embed[tokens] + dec.pos[None, :L]
    mask = causal_mask(L, L, device=x.device)
    for p in dec.layers:
        x = x + _mha(_norm(x, p.ln1, "layernorm", eps), p.self_attn,
                     cfg.decoder_heads, cfg.dec_head_dim, mask=mask)
        x = x + _mha(_norm(x, p.ln_x, "layernorm", eps), p.cross_attn,
                     cfg.decoder_heads, cfg.dec_head_dim, kv=enc_states)
        x = x + _ffn(_norm(x, p.ln2, "layernorm", eps), p.mlp)
    return _logits(_norm(x, dec.ln_post, "layernorm", eps), dec.embed)


# --------------------------------------------------------------------- #
# Greedy generation (KV cache of static shape)
# --------------------------------------------------------------------- #


def _dec_step(cfg, dec: _Decoder, tok_emb, enc_kv, cache, pos: int,
              logits_embed):
    """One decode step. ``tok_emb`` [B, 1, D]; writes this step's keys and
    values into ``cache`` at ``pos`` and returns the logits [B, V]."""
    Hd, Dd, eps = cfg.decoder_heads, cfg.dec_head_dim, cfg.norm_eps
    x = tok_emb
    B = x.shape[0]
    capacity = cache["k"].shape[2]
    valid = torch.arange(capacity, device=x.device) <= pos
    mask = torch.where(valid, 0.0, float("-inf")).to(torch.float32)
    for li, p in enumerate(dec.layers):
        h = _norm(x, p.ln1, "layernorm", eps)
        q = _linear(h, p.self_attn.q).reshape(B, 1, Hd, Dd)
        cache["k"][li, :, pos] = _linear(h, p.self_attn.k).reshape(B, Hd, Dd)
        cache["v"][li, :, pos] = _linear(h, p.self_attn.v).reshape(B, Hd, Dd)
        a = attention(q, cache["k"][li], cache["v"][li], mask)
        x = x + _linear(a.reshape(B, 1, Hd * Dd), p.self_attn.o)
        h = _norm(x, p.ln_x, "layernorm", eps)
        qx = _linear(h, p.cross_attn.q).reshape(B, 1, Hd, Dd)
        a = attention(qx, enc_kv[li][0], enc_kv[li][1])
        x = x + _linear(a.reshape(B, 1, Hd * Dd), p.cross_attn.o)
        x = x + _ffn(_norm(x, p.ln2, "layernorm", eps), p.mlp)
    x = _norm(x, dec.ln_post, "layernorm", eps)
    return _logits(x[:, 0].to(logits_embed.dtype), logits_embed)


def whisper_generate(model: Whisper, mel: torch.Tensor,
                     forced_tokens: Sequence[int],
                     max_new_tokens: int = 224,
                     enc_states: Optional[torch.Tensor] = None,
                     decode_dtype: Optional[torch.dtype] = None):
    """Greedy transcription of log-mel ``mel`` [B, F, M]. Returns (tokens
    [B, max_new_tokens] int64, lengths [B]): the tokens after the forced
    prompt (``forced_tokens``: start of transcript, language, task, no
    timestamps, as the caller gives them), the end-of-text token repeated
    once a row has emitted it, and each row's count of tokens before its
    first end-of-text.

    ``decode_dtype=torch.bfloat16`` runs the decoder's weights, the
    encoder states and the cache in bf16 (the logits against an fp32 copy
    of the embedding). A near tie may flip a token, so it is opt-in."""
    cfg = model.cfg
    with torch.inference_mode():
        if enc_states is None:
            enc_states = whisper_encode(model, mel)
        dec = model.decoder
        logits_embed = dec.embed
        cdtype = torch.float32
        if decode_dtype is not None:
            import copy

            dec = copy.deepcopy(dec).to(decode_dtype)
            enc_states = enc_states.to(decode_dtype)
            cdtype = decode_dtype
        Hd, Dd = cfg.decoder_heads, cfg.dec_head_dim
        B, S = enc_states.shape[:2]
        enc_kv = [(_linear(enc_states, p.cross_attn.k).reshape(B, S, Hd, Dd),
                   _linear(enc_states, p.cross_attn.v).reshape(B, S, Hd, Dd))
                  for p in dec.layers]
        L = len(forced_tokens)
        capacity = L + max_new_tokens
        if capacity > cfg.max_target_positions:
            raise ValueError(
                f"{L} forced + {max_new_tokens} new tokens exceed the "
                f"decoder's {cfg.max_target_positions} positions")
        shape = (cfg.decoder_layers, B, capacity, Hd, Dd)
        dev = enc_states.device
        cache = {"k": torch.zeros(shape, dtype=cdtype, device=dev),
                 "v": torch.zeros(shape, dtype=cdtype, device=dev)}
        logits = None
        for i, t in enumerate(forced_tokens):  # the prompt, a step a token
            emb = (dec.embed[t] + dec.pos[i]).expand(B, 1, -1)
            logits = _dec_step(cfg, dec, emb, enc_kv, cache, i, logits_embed)
        toks = []
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        for i in range(max_new_tokens):
            tok = torch.argmax(logits, dim=-1)
            tok = torch.where(alive, tok, cfg.eos_token)
            toks.append(tok)
            alive = alive & (tok != cfg.eos_token)
            if i + 1 < max_new_tokens:  # the last token's logits are unused
                emb = (dec.embed[tok] + dec.pos[L + i])[:, None]
                logits = _dec_step(cfg, dec, emb, enc_kv, cache, L + i,
                                   logits_embed)
        toks = torch.stack(toks, dim=1)
        lengths = torch.cumprod((toks != cfg.eos_token).to(torch.int64),
                                dim=1).sum(dim=1)
    return toks, lengths
