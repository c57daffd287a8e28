"""ASR perplexity: byte-level BPE encode + GPT-2 on the card.

Counterpart of ``audiocodecs_tpu/downstream/metrics/ppl_jax.py``. The
reference transcribes with Whisper and scores the text with a downloaded
HF causal LM (reference ``downstream/metrics/perplexity.py:33-156``); here
text is encoded with the checkpoint's own byte-level BPE
(:mod:`..utils.bytebpe`) and scored by the converted GPT-2
(:mod:`..nn.gpt2`) on the card. Texts are grouped by length into
power-of-two buckets (16 up to the LM's context) and scored ``batch_size``
rows at a time; a text of fewer than two tokens scores nan, as the
reference's. Signals are transcribed first through Whisper
(:mod:`.dwer`) when a Whisper backend is given.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from audiocodecs_tpu_torch.downstream.metrics.base import MetricStats

__all__ = ["make_perplexity_checkpoint_metric", "perplexity_metric"]


def _bucket(n: int, cap: int) -> int:
    """Next power-of-two length ≥ n (≥ 16, ≤ cap)."""
    b = 16
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


def perplexity_metric(model, tokenizer_path: str, transcribe=None,
                      batch_size: int = 8) -> MetricStats:
    """The ASR-PPL ``MetricStats`` of a loaded :class:`..nn.gpt2.GPT2`
    (on its device) and the ``vocab.json``/``merges.txt`` of
    ``tokenizer_path``: ``metric(texts)`` or ``metric(sigs, sample_rate)``
    through ``transcribe``; it also carries ``text_ppl``."""
    from audiocodecs_tpu_torch.nn.gpt2 import gpt2_nll
    from audiocodecs_tpu_torch.utils.bytebpe import ByteLevelBPE

    cfg = model.cfg
    dev = next(model.parameters()).device
    bpe = ByteLevelBPE.from_dir(tokenizer_path)

    def text_ppl(texts: list[str]) -> list[float]:
        out = [float("nan")] * len(texts)
        by_bucket: dict[int, list] = {}
        for idx, t in enumerate(texts):
            ids = bpe.encode(t)[: cfg.n_positions]
            if len(ids) < 2:
                continue  # nan, like the reference's torch path
            by_bucket.setdefault(_bucket(len(ids), cfg.n_positions),
                                 []).append((idx, ids))
        for L, group in by_bucket.items():
            for start in range(0, len(group), batch_size):
                chunk = group[start:start + batch_size]
                toks = np.zeros((batch_size, L), np.int64)
                lens = np.full((batch_size,), 2, np.int64)  # dummy rows
                for b, (_, ids) in enumerate(chunk):
                    toks[b, : len(ids)] = ids
                    lens[b] = len(ids)
                with torch.inference_mode():
                    nll = gpt2_nll(model, torch.from_numpy(toks).to(dev),
                                   torch.from_numpy(lens).to(dev))
                nll = nll.cpu().numpy()
                for b, (idx, _) in enumerate(chunk):
                    out[idx] = float(math.exp(nll[b]))
        return out

    def metric(sigs_or_texts, sample_rate: int | None = None):
        if len(sigs_or_texts) == 0:
            return []
        if isinstance(sigs_or_texts[0], str):
            return text_ppl(sigs_or_texts)
        if transcribe is None:
            raise RuntimeError(
                "Whisper for PPL transcription is unavailable: pass "
                "whisper_checkpoint= or whisper_path= to score signals "
                "(the perplexity of their Whisper transcripts)")
        if sample_rate is None:
            raise ValueError("pass sample_rate= (Hz) to score signals")
        return text_ppl(transcribe(sigs_or_texts, sample_rate))

    stats = MetricStats(metric, name="ASR-PPL")
    stats.text_ppl = text_ppl
    stats.model = model
    return stats


def make_perplexity_checkpoint_metric(
        checkpoint: str, tokenizer_path: str | None = None, cfg=None,
        whisper_checkpoint: str | None = None,
        whisper_tokenizer: str | None = None, batch_size: int = 8,
        device=None) -> MetricStats:
    """Text perplexity from a converted GPT-2 checkpoint (the reference's
    ``.npz`` or a ``.pt`` state dict) on ``device`` (the card when
    ``None``); the reference's ``make_perplexity_jax_metric``.
    ``tokenizer_path`` (default: the checkpoint's directory) holds
    ``vocab.json``, ``merges.txt`` and, without ``cfg``, ``config.json``;
    ``whisper_checkpoint`` adds signal transcription."""
    from audiocodecs_tpu_torch.codec import resolve_device
    from audiocodecs_tpu_torch.nn.gpt2 import GPT2, GPT2Config
    from audiocodecs_tpu_torch.utils.checkpoint import load_model_state

    dev = resolve_device(device)
    tokenizer_path = tokenizer_path or os.path.dirname(checkpoint)
    if cfg is None:
        cfg_json = os.path.join(tokenizer_path, "config.json")
        if not os.path.exists(cfg_json):
            raise ValueError(
                f"no config.json in {tokenizer_path!r} — pass cfg= or copy "
                "the HF config next to vocab.json")
        with open(cfg_json, encoding="utf-8") as f:
            cfg = GPT2Config.from_hf_dict(json.load(f))
    model = GPT2(cfg)
    model.load_state_dict(load_model_state(checkpoint, model), strict=True)
    transcribe = None
    if whisper_checkpoint is not None:
        from audiocodecs_tpu_torch.downstream.metrics.dwer import (
            make_dwer_checkpoint_metric,
        )

        transcribe = make_dwer_checkpoint_metric(
            whisper_checkpoint,
            whisper_tokenizer or os.path.dirname(whisper_checkpoint),
            device=dev).transcribe
    return perplexity_metric(model.to(dev).eval(), tokenizer_path,
                             transcribe, batch_size)
