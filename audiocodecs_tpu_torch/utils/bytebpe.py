"""Byte-level BPE (GPT-2 / Whisper tokenizer family), pure Python.

The reference never tokenizes text itself — dWER decodes through a
downloaded faster-whisper tokenizer and ASR perplexity encodes through a
downloaded HF ``AutoTokenizer`` (reference ``downstream/metrics/dwer.py``,
``perplexity.py:33-57``). This module implements the byte-level BPE those
tokenizers use, first-party, from the checkpoint's own data files:
``vocab.json`` (token string → id) and ``merges.txt`` (merge ranks), so
text encode/decode needs no ``transformers`` at metric time.

Decode needs only ``vocab.json``; encode additionally needs the merge
ranks and the GPT-2 regex pre-tokenizer (the ``regex`` module's unicode
categories — available as a transformers dependency).
"""

from __future__ import annotations

import functools
import json
import os
from typing import Optional, Sequence

__all__ = ["bytes_to_unicode", "ByteLevelBPE"]

# GPT-2's pre-tokenizer pattern (contractions, letter runs, number runs,
# punctuation runs, trailing spaces) — the same pattern Whisper's
# tokenizer uses.
_PRETOKEN_PATTERN = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
    r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's bijective byte → printable-unicode-codepoint map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


class ByteLevelBPE:
    """Encode/decode for byte-level BPE vocabularies.

    ``vocab``: token-string → id. ``merges``: ordered ``(left, right)``
    pairs (rank = position). ``special_ids``: ids dropped on decode —
    ``<|...|>`` control tokens are auto-detected from the vocab.
    """

    def __init__(self, vocab: dict[str, int],
                 merges: Optional[Sequence[tuple[str, str]]] = None,
                 special_ids: Optional[set[int]] = None):
        self.vocab = vocab
        self.itos = {i: t for t, i in vocab.items()}
        self.has_merges = merges is not None  # [] is a valid byte-only BPE
        self.ranks = {pair: r for r, pair in enumerate(merges or [])}
        auto_special = {i for t, i in vocab.items()
                        if t.startswith("<|") and t.endswith("|>")}
        self.special_ids = auto_special | (special_ids or set())
        self._word_cache: dict[str, list[int]] = {}

    @classmethod
    def from_dir(cls, path: str) -> "ByteLevelBPE":
        """Load from a HF checkpoint dir (``vocab.json`` [+ ``merges.txt``,
        ``added_tokens.json``])."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        special = set()
        added = os.path.join(path, "added_tokens.json")
        if os.path.exists(added):
            with open(added, encoding="utf-8") as f:
                added_vocab = json.load(f)
            special |= set(added_vocab.values())
            vocab = {**vocab, **added_vocab}
        merges: Optional[list[tuple[str, str]]] = None
        mpath = os.path.join(path, "merges.txt")
        if os.path.exists(mpath):
            merges = []
            with open(mpath, encoding="utf-8") as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line or line.startswith("#version"):
                        continue
                    a, _, b = line.partition(" ")
                    merges.append((a, b))
        return cls(vocab, merges, special)

    def token_id(self, token: str) -> int:
        """Lookup a literal token string (for forced/prompt ids)."""
        return self.vocab[token]

    # ------------------------------------------------------------- decode

    def decode(self, ids: Sequence[int]) -> str:
        u2b = {u: b for b, u in bytes_to_unicode().items()}
        chunks = []
        for i in ids:
            i = int(i)
            if i in self.special_ids or i not in self.itos:
                continue
            chunks.append(self.itos[i])
        data = bytes(u2b[c] for c in "".join(chunks) if c in u2b)
        return data.decode("utf-8", errors="replace")

    # ------------------------------------------------------------- encode

    def _bpe_word(self, word: str) -> list[int]:
        """Merge a unicode-mapped pre-token down to vocab ids."""
        if word in self._word_cache:
            return self._word_cache[word]
        symbols = list(word)
        while len(symbols) > 1:
            best, best_rank = None, None
            for pair in zip(symbols, symbols[1:]):
                r = self.ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = pair, r
            if best is None:
                break
            merged, i = [], 0
            while i < len(symbols):
                if (i < len(symbols) - 1
                        and (symbols[i], symbols[i + 1]) == best):
                    merged.append(symbols[i] + symbols[i + 1])
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        unk = self.vocab.get("<|endoftext|>", 0)
        ids = [self.vocab.get(s, unk) for s in symbols]
        self._word_cache[word] = ids
        return ids

    def encode(self, text: str) -> list[int]:
        if not self.has_merges:
            raise ValueError("encode() needs merges.txt (decode-only vocab)")
        import regex  # unicode-category support for the GPT-2 pattern

        b2u = bytes_to_unicode()
        ids: list[int] = []
        for pretoken in regex.findall(_PRETOKEN_PATTERN, text):
            mapped = "".join(b2u[b] for b in pretoken.encode("utf-8"))
            ids.extend(self._bpe_word(mapped))
        return ids
