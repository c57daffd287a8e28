"""Codebook utilization / normalized entropy.

The port's copy of ``audiocodecs_tpu/downstream/metrics/codebook_util.py``
(host numpy over the token grids, copied off the device first).

Capability parity with the reference's ``codebook_util`` metric (reference
``metrics/codebook_util.py:28-86``): fraction of codebook entries used and
normalized token-distribution entropy per codebook, accumulated over a
dataset. Unlike the reference (batch-size-1 assert, ``:41``), this version is
batch-agnostic — counts are one ``np.bincount`` per codebook a batch.
"""

from __future__ import annotations

import numpy as np

__all__ = ["CodebookUtilization"]


class CodebookUtilization:
    def __init__(self, num_codebooks: int, vocab_size: int,
                 vocab_sizes=None):
        """``vocab_sizes``: optional per-codebook vocab list (heterogeneous
        codecs like SemantiCodec); utilization/entropy normalize per
        codebook by ITS vocab, not the max."""
        self.num_codebooks = num_codebooks
        self.vocab_size = vocab_size
        self.vocab_sizes = np.asarray(
            vocab_sizes if vocab_sizes is not None
            else [vocab_size] * num_codebooks)
        if len(self.vocab_sizes) != num_codebooks:
            raise ValueError("one vocab size per codebook")
        self.clear()

    def clear(self):
        self.counts = np.zeros((self.num_codebooks, self.vocab_size), np.int64)

    def append(self, toks, length=None):
        """``toks``: [B, N, K] (optionally masked by relative ``length``)."""
        toks = np.asarray(toks)
        B, Nt, K = toks.shape
        if length is not None:
            abs_lens = np.round(np.asarray(length) * Nt).astype(int)
            mask = np.arange(Nt)[None, :] < abs_lens[:, None]
        else:
            mask = np.ones((B, Nt), bool)
        for k in range(K):
            vals = toks[:, :, k][mask]
            self.counts[k] += np.bincount(vals, minlength=self.vocab_size)

    def summarize(self, field=None):
        used = (self.counts > 0).sum(axis=1) / self.vocab_sizes  # [K]
        total = self.counts.sum(axis=1, keepdims=True)
        p = self.counts / np.maximum(total, 1)
        ent = -(p * np.log(np.maximum(p, 1e-12))).sum(axis=1)
        norm_ent = ent / np.log(np.maximum(self.vocab_sizes, 2))
        stats = {
            "utilization": used.tolist(),
            "avg_utilization": float(used.mean()),
            "norm_entropy": norm_ent.tolist(),
            "avg_norm_entropy": float(norm_ent.mean()),
        }
        return stats[field] if field else stats
