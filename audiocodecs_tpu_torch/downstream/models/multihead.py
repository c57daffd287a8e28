"""Fused multi-codebook embedding and output-head layers.

Counterpart of ``audiocodecs_tpu/downstream/models/multihead.py`` (the
reference's ``MultiHeadEmbedding``/``MultiHeadLinear``,
``downstream/models/multihead.py:28-94``): one ``[ΣC_k(+1), H]`` table with
per-codebook row offsets, so a ``[B, N, K]`` token grid embeds in one
gather, and one fused ``[H, ΣC_k]`` projection for the per-codebook logits.

``vocab_size`` is one int (uniform codebooks) or a per-codebook sequence
(heterogeneous, e.g. SemantiCodec's semantic/acoustic split). With
heterogeneous vocabs the logits are ``[..., K, Cmax]`` with ``-1e9`` past
each codebook's vocab, which softmax, cross-entropy and argmax pass through
unchanged. Parameters are dicts of tensors in the reference's layout; the
head's product runs with TF32 off (``Precision.HIGHEST`` there).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from audiocodecs_tpu_torch.nn.layers import exact_fp32

__all__ = [
    "multihead_embed",
    "multihead_logits",
    "init_multihead_embedding",
    "init_multihead_linear",
    "fused_table_from_embs",
    "vocab_offsets",
]

VocabSpec = Union[int, Sequence[int]]


def _vocab_list(vocab_size: VocabSpec, num_codebooks: int) -> list[int]:
    if isinstance(vocab_size, (list, tuple)):
        if len(vocab_size) != num_codebooks:
            raise ValueError(
                f"{len(vocab_size)} vocab sizes for {num_codebooks} codebooks"
            )
        return [int(c) for c in vocab_size]
    return [int(vocab_size)] * num_codebooks


def vocab_offsets(vocab_size: VocabSpec, num_codebooks: int) -> np.ndarray:
    """Row offset of each codebook in the fused table: cumsum of sizes."""
    sizes = _vocab_list(vocab_size, num_codebooks)
    return np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)


def multihead_embed(params, toks: torch.Tensor, *, vocab_size: VocabSpec,
                    pad_token: int | None = None,
                    pad_is_vocab: bool = False) -> torch.Tensor:
    """``toks`` [..., K] → embeddings [..., K, H].

    Codebook k's token t reads row ``t + offset_k``. Padding: a shared
    ``pad_token`` id, or (``pad_is_vocab``, the reference's ``padding_idx``)
    token ``C_k`` in codebook k; both read the table's last row.
    """
    K = toks.shape[-1]
    dev = toks.device
    toks = toks.to(torch.int64)
    sizes = torch.tensor(_vocab_list(vocab_size, K), device=dev)
    offsets = torch.from_numpy(vocab_offsets(vocab_size, K)).to(dev)
    idx = toks + offsets
    table = params["table"]
    pad_row = table.shape[0] - 1
    if pad_is_vocab:
        idx = torch.where(toks == sizes, pad_row, idx)
    elif pad_token is not None:
        idx = torch.where(toks == pad_token, pad_row, idx)
    return F.embedding(idx, table)


def multihead_logits(params, x: torch.Tensor, *, num_heads: int,
                     vocab_size: VocabSpec | None = None) -> torch.Tensor:
    """``x`` [..., H] → per-codebook logits via one fused product.

    Uniform vocabs → [..., K, C]. Heterogeneous → [..., K, Cmax] with
    ``-1e9`` past each codebook's vocab.
    """
    with exact_fp32():
        y = torch.matmul(x, params["w"])
    if "b" in params:
        y = y + params["b"]
    if vocab_size is None or not isinstance(vocab_size, (list, tuple)):
        return y.reshape(*y.shape[:-1], num_heads, y.shape[-1] // num_heads)
    sizes = _vocab_list(vocab_size, num_heads)
    offs = vocab_offsets(vocab_size, num_heads)
    cmax = max(sizes)
    # large-negative (not -inf) padding: zero softmax mass, NaN-safe grads
    return torch.stack([F.pad(y[..., int(o):int(o) + c], (0, cmax - c),
                              value=-1e9)
                        for o, c in zip(offs, sizes)], dim=-2)


def fused_table_from_embs(codec_embs, vocab_size: VocabSpec,
                          dim: int) -> np.ndarray:
    """The fused table from codec codebooks ``[K, Cmax, H]`` (a numpy array
    or a tensor on any device; reference ``train_asr.py:235-238``), H
    truncated or zero-padded to ``dim`` and each codebook's padded tail
    dropped under heterogeneous vocabs."""
    ce = (codec_embs.detach().cpu().numpy() if hasattr(codec_embs, "detach")
          else np.asarray(codec_embs))
    sizes = _vocab_list(vocab_size, ce.shape[0])
    rows = np.concatenate([ce[k, :c] for k, c in enumerate(sizes)], axis=0)
    table = np.zeros((rows.shape[0], dim), np.float32)
    d = min(rows.shape[1], dim)
    table[:, :d] = rows[:, :d]
    return table


def init_multihead_embedding(generator: torch.Generator, num_codebooks: int,
                             vocab_size: VocabSpec, dim: int,
                             pad_row: bool = False):
    """N(0, 0.02²) rows (the draws differ from ``jax.random``'s)."""
    rows = sum(_vocab_list(vocab_size, num_codebooks)) + (1 if pad_row else 0)
    return {"table": torch.randn(rows, dim, generator=generator) * 0.02}


def init_multihead_linear(generator: torch.Generator, dim: int,
                          num_codebooks: int, vocab_size: VocabSpec,
                          bias: bool = True):
    out = sum(_vocab_list(vocab_size, num_codebooks))
    p = {"w": torch.randn(dim, out, generator=generator) * dim**-0.5}
    if bias:
        p["b"] = torch.zeros(out)
    return p
