"""First-party subword text tokenizers for the ASR/TTS recipes.

The port's copy of ``audiocodecs_tpu/downstream/text.py`` (pure Python):
given the same texts it builds the same pieces in the same order, so
``itos``, ``encode`` and ``decode`` agree with the reference package's.

The reference trains a SentencePiece model over the train manifest
(``token_type: bpe``, ``num_tokens: 1000`` — reference
``downstream/hparams/tasks/asr.yaml:54-55,97-103``). SentencePiece is not
available in this environment, so this module implements the two
SentencePiece model types first-party, pure-Python, trained on the manifest
texts exactly like the reference wrapper does:

* :class:`BPETokenizer` — classic byte-pair-encoding over word-internal
  character sequences with the SentencePiece ``▁`` word-boundary marker.
* :class:`UnigramTokenizer` — unigram LM (Kudo 2018 lite): substring seed
  vocabulary, EM probability fits, likelihood-loss pruning to the target
  size, Viterbi encoding.

Both expose the recipe tokenizer contract (``vocab_size``, ``blank_id``,
``encode``, ``decode``) shared with
:class:`.recipes.common.CharTokenizer`; CTC heads
size themselves from ``vocab_size``. ``character_coverage`` mirrors
SentencePiece: the rarest characters beyond the coverage quantile fall to
``<unk>``.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict

__all__ = ["BPETokenizer", "UnigramTokenizer", "build_tokenizer"]

_WORD_MARK = "▁"  # SentencePiece "▁"


def _word_freqs(texts):
    words = Counter()
    for t in texts:
        for w in t.split():
            words[_WORD_MARK + w] += 1
    return words


def _covered_chars(words, character_coverage: float):
    """Character inventory covering ``character_coverage`` of occurrences
    (rarest chars → ``<unk>``, like SentencePiece)."""
    char_freq = Counter()
    for w, f in words.items():
        for c in w:
            char_freq[c] += f
    total = sum(char_freq.values())
    if total == 0:
        return set()
    keep, acc = set(), 0
    for c, f in char_freq.most_common():
        if acc >= character_coverage * total and c != _WORD_MARK:
            break
        keep.add(c)
        acc += f
    keep.add(_WORD_MARK)
    return keep


class BPETokenizer:
    """Word-internal BPE with incremental pair-count training.

    ``vocab_size`` counts ALL pieces incl. ``<blank>``/``<unk>`` and the
    single characters; training stops early if no pair repeats."""

    def __init__(self, texts, vocab_size: int = 1000,
                 character_coverage: float = 1.0):
        words = _word_freqs(texts)
        chars = _covered_chars(words, character_coverage)
        # word → tuple of symbols (unknown chars dropped to <unk> marker)
        seqs = {}
        for w, f in words.items():
            seqs[w] = tuple(c if c in chars else "<unk>" for c in w)
        alphabet = sorted(chars | ({"<unk>"} if any(
            "<unk>" in s for s in seqs.values()) else set()))
        self.itos = ["<blank>", "<unk>"] + [
            c for c in alphabet if c != "<unk>"]
        self.blank_id = 0
        self.unk_id = 1
        merges = []
        max_merges = max(0, vocab_size - len(self.itos))
        # pair counts + index pair → words containing it
        pair_counts = Counter()
        pair_words = defaultdict(set)
        for w, seq in seqs.items():
            f = words[w]
            for a, b in zip(seq, seq[1:]):
                pair_counts[(a, b)] += f
                pair_words[(a, b)].add(w)
        for _ in range(max_merges):
            # never merge across unk: such pairs are excluded from
            # SELECTION (recording them in merges would make encode()
            # apply a merge training skipped, collapsing '<unk>'+char
            # into one <unk> and silently deleting the character)
            candidates = [kv for kv in pair_counts.items()
                          if "<unk>" not in kv[0]]
            if not candidates:
                break
            # deterministic: highest count, then lexicographic
            pair = min(candidates, key=lambda kv: (-kv[1], kv[0]))[0]
            if pair_counts[pair] < 2:
                break
            merges.append(pair)
            new_sym = pair[0] + pair[1]
            for w in list(pair_words[pair]):
                seq = seqs[w]
                f = words[w]
                # remove old pair contributions
                for a, b in zip(seq, seq[1:]):
                    pair_counts[(a, b)] -= f
                    if pair_counts[(a, b)] <= 0:
                        del pair_counts[(a, b)]
                    pair_words[(a, b)].discard(w)
                seq = self._merge_seq(seq, pair, new_sym)
                seqs[w] = seq
                for a, b in zip(seq, seq[1:]):
                    pair_counts[(a, b)] += f
                    pair_words[(a, b)].add(w)
            self.itos.append(new_sym)
        self.merge_ranks = {p: i for i, p in enumerate(merges)}
        self.stoi = {s: i for i, s in enumerate(self.itos)}
        self._cache = {}

    @staticmethod
    def _merge_seq(seq, pair, new_sym):
        out, i = [], 0
        while i < len(seq):
            if (i + 1 < len(seq) and seq[i] == pair[0]
                    and seq[i + 1] == pair[1]):
                out.append(new_sym)
                i += 2
            else:
                out.append(seq[i])
                i += 1
        return tuple(out)

    @property
    def vocab_size(self) -> int:
        return len(self.itos)

    def _encode_word(self, w: str):
        if w in self._cache:
            return self._cache[w]
        seq = tuple(c if c in self.stoi else "<unk>" for c in w)
        while len(seq) > 1:
            best, rank = None, None
            for p in zip(seq, seq[1:]):
                r = self.merge_ranks.get(p)
                if r is not None and (rank is None or r < rank):
                    best, rank = p, r
            if best is None:
                break
            seq = self._merge_seq(seq, best, best[0] + best[1])
        ids = tuple(self.stoi.get(s, self.unk_id) for s in seq)
        self._cache[w] = ids
        return ids

    def encode(self, text: str):
        ids = []
        for w in text.split():
            ids.extend(self._encode_word(_WORD_MARK + w))
        return ids

    def decode(self, ids) -> str:
        s = "".join(self.itos[i] for i in ids
                    if i not in (self.blank_id, self.unk_id)
                    and 0 <= i < len(self.itos))
        return s.replace(_WORD_MARK, " ").strip()


class UnigramTokenizer:
    """Unigram-LM tokenizer (Kudo 2018, compact variant).

    Seed vocabulary = covered characters + the most frequent substrings
    (len ≤ ``max_piece_len``); 2 EM rounds re-estimate piece probabilities
    from Viterbi segmentations; pruning drops the pieces whose removal
    costs the least likelihood until ``vocab_size`` remains (single
    characters are never pruned, so every string stays encodable)."""

    def __init__(self, texts, vocab_size: int = 1000,
                 character_coverage: float = 1.0, max_piece_len: int = 8,
                 seed_factor: int = 4, em_rounds: int = 2):
        words = _word_freqs(texts)
        chars = _covered_chars(words, character_coverage)
        norm_words = Counter()
        for w, f in words.items():
            norm_words["".join(
                c if c in chars else "\x00" for c in w)] += f
        # substring seed counts (split at unk boundaries)
        sub_counts = Counter()
        for w, f in norm_words.items():
            for part in w.split("\x00"):
                L = len(part)
                for i in range(L):
                    for j in range(i + 1, min(L, i + max_piece_len) + 1):
                        sub_counts[part[i:j]] += f
        seed_size = max(vocab_size * seed_factor, len(chars) + 8)
        pieces = {c: float(f) for c, f in sub_counts.items() if len(c) == 1}
        for s, f in sub_counts.most_common():
            if len(pieces) >= seed_size:
                break
            if len(s) > 1:
                pieces[s] = float(f)
        for _ in range(em_rounds):
            pieces = self._em_round(norm_words, pieces, max_piece_len)
        # prune to target: keep all single chars; drop lowest-prob pieces
        target = max(vocab_size - 2, len([p for p in pieces if len(p) == 1]))
        multi = sorted((p for p in pieces if len(p) > 1),
                       key=lambda p: -pieces[p])
        singles = [p for p in pieces if len(p) == 1]
        kept = singles + multi[: max(0, target - len(singles))]
        total = sum(pieces[p] for p in kept) or 1.0
        self.logp = {p: math.log(pieces[p] / total + 1e-12) for p in kept}
        self.itos = ["<blank>", "<unk>"] + sorted(
            kept, key=lambda p: (-self.logp[p], p))
        self.stoi = {s: i for i, s in enumerate(self.itos)}
        self.blank_id = 0
        self.unk_id = 1
        self.max_piece_len = max_piece_len
        self._cache = {}

    def _em_round(self, norm_words, pieces, max_piece_len):
        total = sum(pieces.values()) or 1.0
        logp = {p: math.log(f / total + 1e-12) for p, f in pieces.items()}
        new_counts = defaultdict(float)
        for w, f in norm_words.items():
            for part in w.split("\x00"):
                for piece in self._viterbi(part, logp, max_piece_len):
                    new_counts[piece] += f
        # chars always survive with a floor so encoding stays total
        for p in pieces:
            if len(p) == 1:
                new_counts[p] = max(new_counts.get(p, 0.0), 0.5)
        return {p: c for p, c in new_counts.items() if c > 0}

    @staticmethod
    def _viterbi(s: str, logp, max_piece_len):
        L = len(s)
        if L == 0:
            return []
        best = [(-math.inf, -1)] * (L + 1)
        best[0] = (0.0, -1)
        for j in range(1, L + 1):
            for i in range(max(0, j - max_piece_len), j):
                piece = s[i:j]
                lp = logp.get(piece)
                if lp is None and j - i == 1:
                    lp = -20.0  # unk char fallback
                if lp is None or best[i][0] == -math.inf:
                    continue
                score = best[i][0] + lp
                if score > best[j][0]:
                    best[j] = (score, i)
        out, j = [], L
        while j > 0:
            i = best[j][1]
            if i < 0:  # unreachable — emit char as unk
                i = j - 1
            out.append(s[i:j])
            j = i
        return out[::-1]

    @property
    def vocab_size(self) -> int:
        return len(self.itos)

    def encode(self, text: str):
        ids = []
        for w in text.split():
            w = _WORD_MARK + w
            if w in self._cache:
                ids.extend(self._cache[w])
                continue
            wi = []
            for piece in self._viterbi(w, self.logp, self.max_piece_len):
                wi.append(self.stoi.get(piece, self.unk_id))
            self._cache[w] = tuple(wi)
            ids.extend(wi)
        return ids

    def decode(self, ids) -> str:
        s = "".join(self.itos[i] for i in ids
                    if i not in (self.blank_id, self.unk_id)
                    and 0 <= i < len(self.itos))
        return s.replace(_WORD_MARK, " ").strip()


def build_tokenizer(texts, token_type: str = "char",
                    num_tokens: int = 1000,
                    character_coverage: float = 1.0):
    """Factory mirroring the reference tokenizer surface
    (``token_type ∈ {"bpe", "unigram", "char"}``, reference
    ``asr.yaml:54-55``); ``char`` ignores ``num_tokens`` like the
    reference's char mode."""
    if token_type == "char":
        from audiocodecs_tpu_torch.downstream.recipes.common import (
            CharTokenizer,
        )

        return CharTokenizer(texts)
    if token_type == "bpe":
        return BPETokenizer(texts, vocab_size=num_tokens,
                            character_coverage=character_coverage)
    if token_type == "unigram":
        return UnigramTokenizer(texts, vocab_size=num_tokens,
                                character_coverage=character_coverage)
    raise ValueError(
        f"token_type must be one of 'bpe', 'unigram', 'char'; "
        f"got {token_type!r}")
