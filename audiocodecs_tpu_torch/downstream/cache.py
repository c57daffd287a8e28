"""Host-side codec token cache.

Counterpart of ``audiocodecs_tpu/downstream/cache.py`` (the reference's
``_CACHE``/``cache_bs{B}.pt``, ``train_asr.py:36,46-64,137-140,256-261``):
a frozen codec's token grids are memoised so that epochs after the first
skip the encode. Keys are utterance IDs; one ``.npz`` holds the cache, one
unpadded ``[n, K]`` entry an ID, in the reference package's layout, so a
cache written by either package loads in the other.

Augmented batches never touch it (the recipes bypass it, as the reference
does, ``train_asr.py:50-64``).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["TokenCache"]


class TokenCache:
    def __init__(self, path: str | None = None, max_items: int | None = None):
        self.path = path
        self.max_items = max_items
        self._store: dict[str, np.ndarray] = {}
        if path and os.path.exists(path):
            with np.load(path) as data:
                self._store = {k: data[k] for k in data.files}

    def get_batch(self, ids: list[str]):
        """All-or-nothing batch lookup → stacked ``[B, N, K]`` numpy array
        padded with token 0 to the longest entry, or None."""
        if any(i not in self._store for i in ids):
            return None
        toks = [self._store[i] for i in ids]
        N = max(t.shape[0] for t in toks)
        out = np.zeros((len(toks), N, toks[0].shape[1]), toks[0].dtype)
        for b, t in enumerate(toks):
            out[b, : t.shape[0]] = t
        return out

    def put_batch(self, ids: list[str], toks, tok_lengths=None):
        """Store per-utterance slices of a padded ``[B, N, K]`` grid (a
        numpy array or a tensor on any device)."""
        toks = (toks.detach().cpu().numpy() if hasattr(toks, "detach")
                else np.asarray(toks))
        for b, i in enumerate(ids):
            if self.max_items is not None and len(self._store) >= self.max_items:
                return
            n = toks.shape[1]
            if tok_lengths is not None:
                n = int(round(float(tok_lengths[b]) * toks.shape[1]))
            self._store[i] = toks[b, :n].copy()

    def __len__(self):
        return len(self._store)

    def __contains__(self, key):
        return key in self._store

    def save(self, path: str | None = None):
        path = path or self.path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            np.savez(path, **self._store)
