"""Llama-3-style decoder for the generative speech tasks (SLM, TTS).

Counterpart of ``audiocodecs_tpu/downstream/models/llama.py`` (the
reference's ``downstream/models/llama3.py``: RMSNorm, SwiGLU, GQA, RoPE, a
KV cache, the multi-codebook interleaved embedding, per-codebook heads and
``generate``), on the port's :mod:`...nn.transformer`:

* the body is a :class:`...nn.transformer.Transformer` with ``rmsnorm``,
  ``swiglu`` and a final norm; attention is the port's own two products in
  full fp32 (:func:`...nn.transformer.attention`), not
  ``scaled_dot_product_attention``;
* the KV cache is a preallocated ``[L, B, S, Hkv, D]`` pair written in place
  at each position (the reference package's fixed-capacity buffer);
* generation is a loop over decode steps with the reference package's
  alive mask, EOS handling and head/band convention;
* multi-codebook token grids are flattened K-interleaved; the embedding is
  one table with per-codebook bands and the head one fused product.

Weights keep the reference's tree ``{"body", "embedding", "head"}``:
:func:`llama_from_jax` builds the module from it. ``moe_experts > 0``
replaces every layer's SwiGLU MLP by the switch-MoE FFN of
:mod:`...parallel.moe` (leaves ``router``, ``w_in``, ``w_out``), in training
and in generation; ``remat`` recomputes each layer in the backward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from audiocodecs_tpu_torch.downstream.models.multihead import (
    init_multihead_linear,
    multihead_logits,
)
from audiocodecs_tpu_torch.nn.transformer import (
    Transformer,
    TransformerConfig,
    _ffn,
    _linear,
    _norm,
    apply_rope,
    apply_transformer,
    attention,
    causal_mask,
    init_transformer_params,
    rope_cos_sin,
)

__all__ = ["Llama", "LlamaConfig", "init_kv_cache", "init_llama_params",
           "llama_embed", "llama_forward", "llama_from_jax",
           "llama_generate", "nucleus_filter"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 1024
    num_codebooks: int = 1
    hidden_size: int = 512
    num_layers: int = 6
    num_heads: int = 8
    num_kv_heads: int = 4
    intermediate_size: int = 1408
    max_seq_len: int = 2048
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    # special tokens after the K·C content rows (bos = C·K, eos = C·K + 1,
    # pad = C·K + 2 in the flat vocab)
    num_special: int = 3
    # per-layer activation recomputation in the backward
    remat: bool = False
    # moe_experts > 0: every layer's MLP becomes a switch-MoE FFN of width
    # moe_ffn_size (intermediate_size when 0); top_k 1 is switch, 2 GShard;
    # the training loss adds moe_aux_weight · the load-balancing loss
    moe_experts: int = 0
    moe_ffn_size: int = 0
    moe_capacity_factor: float = 2.0
    moe_top_k: int = 1
    moe_aux_weight: float = 0.0

    def transformer(self) -> TransformerConfig:
        moe = None
        if self.moe_experts > 0:
            from audiocodecs_tpu_torch.parallel.moe import MoEConfig

            moe = MoEConfig(
                hidden_size=self.hidden_size,
                ffn_size=self.moe_ffn_size or self.intermediate_size,
                num_experts=self.moe_experts,
                capacity_factor=self.moe_capacity_factor,
                top_k=self.moe_top_k,
                aux_weight=self.moe_aux_weight,
            )
        return TransformerConfig(
            hidden_size=self.hidden_size,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.hidden_size // self.num_heads,
            intermediate_size=self.intermediate_size,
            act="swiglu",
            norm="rmsnorm",
            norm_eps=self.norm_eps,
            rope_theta=self.rope_theta,
            causal=True,
            remat=self.remat,
            moe=moe,
        )

    @property
    def flat_vocab(self) -> int:
        """Rows in the embedding table: K·C content + special tokens."""
        return self.num_codebooks * self.vocab_size + self.num_special

    @property
    def head_vocab(self) -> int:
        """Per-codebook head width: content vocab + special logits (so EOS
        is trainable and generatable)."""
        return self.vocab_size + self.num_special

    @property
    def bos_token(self) -> int:
        return self.num_codebooks * self.vocab_size

    @property
    def eos_token(self) -> int:
        return self.num_codebooks * self.vocab_size + 1

    @property
    def pad_token(self) -> int:
        return self.num_codebooks * self.vocab_size + 2


class _Table(nn.Module):
    def __init__(self, rows: int, dim: int):
        super().__init__()
        self.table = nn.Parameter(torch.empty(rows, dim))


class _Head(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(dim, out))


class Llama(nn.Module):
    """``body`` (the transformer with its final norm), ``embedding.table``
    [K·C + specials, H] and ``head.w`` [H, K·(C + specials)]: the
    reference's tree, key for key."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.body = Transformer(cfg.transformer(), final_norm=True)
        self.embedding = _Table(cfg.flat_vocab, cfg.hidden_size)
        self.head = _Head(cfg.hidden_size,
                          cfg.num_codebooks * cfg.head_vocab)


def init_llama_params(generator: torch.Generator, cfg: LlamaConfig) -> dict:
    """:class:`Llama`'s state dict in the reference's distributions (the
    draws differ from ``jax.random``'s)."""
    sd = init_transformer_params(generator, cfg.transformer(), "body.")
    sd["body.final_norm.g"] = torch.ones(cfg.hidden_size)
    sd["embedding.table"] = torch.randn(cfg.flat_vocab, cfg.hidden_size,
                                        generator=generator) * 0.02
    sd["head.w"] = init_multihead_linear(
        generator, cfg.hidden_size, cfg.num_codebooks, cfg.head_vocab,
        bias=False)["w"]
    return sd


def llama_from_jax(tree, cfg: LlamaConfig, device=None) -> Llama:
    """The reference's ``{"body", "embedding", "head"}`` tree (numpy
    arrays) as a :class:`Llama` on ``device``."""
    from audiocodecs_tpu_torch.params import from_jax_params

    model = Llama(cfg)
    model.load_state_dict(from_jax_params(tree, model), strict=True)
    return model.to(device)


def _head(model: Llama) -> dict:
    return {"w": model.head.w}


def llama_embed(model: Llama, flat_toks: torch.Tensor,
                cfg: LlamaConfig) -> torch.Tensor:
    """K-interleaved flat tokens ``[B, L]`` → embeddings ``[B, L, H]``.

    The layout is ``[BOS, f0c0, f0c1, …, f0c(K−1), f1c0, …]``: content
    position ``p`` holds codebook ``(p−1) % K`` and reads row ``tok +
    ((p−1) % K)·C``, so the band is the codebook (what seeding from
    ``codec.embs()`` assumes). Special tokens (≥ K·C) read their own rows.
    """
    return model.embedding.table[embed_rows(flat_toks, cfg)]


def embed_rows(flat_toks: torch.Tensor, cfg: LlamaConfig,
               offset: int = 0) -> torch.Tensor:
    """The embedding rows that :func:`llama_embed` reads for ``flat_toks``
    ``[B, L]`` whose first token sits at position ``offset`` of the
    sequence."""
    K, C = cfg.num_codebooks, cfg.vocab_size
    flat_toks = flat_toks.to(torch.int64)
    pos = offset + torch.arange(flat_toks.shape[1], device=flat_toks.device)
    cb = torch.remainder(pos - 1, K)
    return torch.where(flat_toks >= K * C, flat_toks,
                       flat_toks + cb[None] * C)


def llama_forward(model: Llama, embs: torch.Tensor, cfg: LlamaConfig,
                  positions: Optional[torch.Tensor] = None,
                  return_aux: bool = False):
    """Embeddings ``[B, L, H]`` → per-codebook logits ``[B, L, K, C +
    specials]``; ``return_aux`` also returns the MoE load-balancing losses
    summed over the layers (0 for the dense stack)."""
    h, aux = apply_transformer(model.body, embs, cfg.transformer(),
                               positions, return_aux=True)
    logits = multihead_logits(_head(model), h, num_heads=cfg.num_codebooks)
    return (logits, aux) if return_aux else logits


# --------------------------------------------------------------------- #
# KV-cached autoregressive generation
# --------------------------------------------------------------------- #


def init_kv_cache(cfg: LlamaConfig, batch: int, capacity: int,
                  dtype=torch.float32, device=None) -> dict:
    """``{"k", "v"}``, each zeros ``[L, B, capacity, Hkv, D]``."""
    t = cfg.transformer()
    shape = (t.num_layers, batch, capacity, t.num_kv_heads, t.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _attend(x, p, t: TransformerConfig, cos, sin, k_cache, v_cache, start,
            mask):
    """One layer over ``x`` [B, T, H] at positions ``start …``: its keys and
    values written into the caches [B, S, Hkv, D] in place, attention over
    the caches under ``mask``."""
    B, T, _ = x.shape
    h = _norm(x, p.ln1, t.norm, t.norm_eps)
    q = _linear(h, p.q).reshape(B, T, t.num_heads, t.head_dim)
    k = _linear(h, p.k).reshape(B, T, t.num_kv_heads, t.head_dim)
    v = _linear(h, p.v).reshape(B, T, t.num_kv_heads, t.head_dim)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    k_cache[:, start:start + T] = k
    v_cache[:, start:start + T] = v
    a = attention(q, k_cache[:, :start + T], v_cache[:, :start + T], mask)
    x = x + _linear(a.reshape(B, T, t.num_heads * t.head_dim), p.o)
    return x + _ffn(_norm(x, p.ln2, t.norm, t.norm_eps), p, t)


def _run_cached(model: Llama, cfg: LlamaConfig, x, cache, start: int):
    """``x`` [B, T, H] at positions ``start … start + T − 1`` through every
    layer against the cache, filled in place → the last position's
    logits [B, K, C + specials]."""
    t = cfg.transformer()
    T = x.shape[1]
    cos, sin = rope_cos_sin(torch.arange(start, start + T, device=x.device),
                            t.head_dim, t.rope_theta)
    mask = causal_mask(T, start + T, device=x.device)[None, None, None]
    for li, p in enumerate(model.body.layers):
        x = _attend(x, p, t, cos, sin, cache["k"][li], cache["v"][li],
                    start, mask)
    x = _norm(x, model.body.final_norm, t.norm, t.norm_eps)
    return multihead_logits(_head(model), x[:, -1],
                            num_heads=cfg.num_codebooks)


def nucleus_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """``logits`` with ``-inf`` outside the nucleus: the most probable
    entries whose preceding cumulative probability is at most ``top_p``
    (the reference's ``_sample_top_p`` before its draw)."""
    probs = torch.softmax(logits, dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    sp = torch.gather(probs, -1, order)
    keep_sorted = (torch.cumsum(sp, dim=-1) - sp) <= top_p
    keep = torch.gather(keep_sorted, -1, torch.argsort(order, dim=-1))
    return torch.where(keep, logits, float("-inf"))


@torch.no_grad()
def llama_generate(
    model: Llama,
    cfg: LlamaConfig,
    prompt_flat_toks: torch.Tensor,
    max_gen_toks: int,
    generator: Optional[torch.Generator] = None,
    top_p: Optional[float] = None,
    temperature: float = 1.0,
    prompt_emb_add: Optional[torch.Tensor] = None,
):
    """Autoregressive generation, greedy (``top_p`` None or 0) or
    temperature-scaled nucleus sampling drawn from ``generator`` (on the
    model's device).

    ``prompt_flat_toks``: [B, L] K-interleaved flat tokens (with BOS);
    ``prompt_emb_add``: optional additive conditioning on the prompt
    embeddings (the TTS recipe's speaker embedding). Returns (tokens [B,
    max_gen_toks], lengths [B]): a row halts at EOS through an alive mask
    (later tokens are ``pad``), and its length counts the tokens before
    its first EOS.
    """
    B, L = prompt_flat_toks.shape
    K, C = cfg.num_codebooks, cfg.vocab_size
    dev = prompt_flat_toks.device
    table = model.embedding.table
    cache = init_kv_cache(cfg, B, L + max_gen_toks, table.dtype, dev)
    embs = llama_embed(model, prompt_flat_toks, cfg)
    if prompt_emb_add is not None:
        embs = embs + prompt_emb_add
    logits = _run_cached(model, cfg, embs, cache, 0)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    out = []
    for i in range(max_gen_toks):
        # the hidden state at position p − 1 predicts position p through
        # head (p − 1) % K, which is also the codebook (and embedding band)
        # of the content at p under the [BOS, content…] layout
        cb = (L + i - 1) % K
        lg = logits[:, cb]
        if top_p is None or top_p == 0.0:
            tok = torch.argmax(lg, dim=-1)
        else:
            probs = torch.softmax(
                nucleus_filter(lg / max(temperature, 1e-6), top_p), dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        # head ids ≥ C are specials → the flat special ids
        tok = torch.where(tok >= C, K * C + (tok - C), tok)
        tok = torch.where(alive, tok, cfg.pad_token)
        out.append(tok)
        alive = alive & (tok != cfg.eos_token)
        if i + 1 < max_gen_toks:
            emb = table[torch.where(tok >= K * C, tok, tok + cb * C)][:, None]
            logits = _run_cached(model, cfg, emb, cache, L + i)
    toks = torch.stack(out, dim=1)
    lengths = torch.sum(torch.cumprod((toks != cfg.eos_token).to(
        torch.int64), dim=1), dim=1)
    return toks, lengths
