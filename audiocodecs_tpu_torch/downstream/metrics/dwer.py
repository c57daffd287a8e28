"""dWER and dCER: Whisper transcription on the card + a byte-level decode.

Counterpart of ``audiocodecs_tpu/downstream/metrics/dwer_jax.py``. The
reference's dWER downloads a faster-whisper model and transcribes on the
host (reference ``downstream/metrics/dwer.py:33-115``); here a converted
Whisper (:mod:`..convert.whisper`) runs :func:`..nn.whisper.whisper_generate`
on the card, and the token ids become text through the byte-level BPE
decoder of :mod:`..utils.bytebpe` driven by the checkpoint's
``vocab.json`` (and ``added_tokens.json``): no ``transformers``.

Each signal is resampled to 16 kHz, padded or cut to Whisper's 30 s
window, transcribed greedily (batches padded up to a power of two no
larger than ``batch_size``), and memoised by the sha1 of its samples, so
dWER and dCER of the same signals transcribe once. Transcripts go through
the reference's English (or basic) normaliser (:mod:`.text_norm`) before
the word or character error rate.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from audiocodecs_tpu_torch.downstream.metrics.base import MetricStats
from audiocodecs_tpu_torch.utils.bytebpe import ByteLevelBPE

__all__ = ["ByteLevelDecoder", "dwer_metric", "make_dwer_checkpoint_metric",
           "whisper_forced_tokens"]

_WHISPER_SR = 16000
_CHUNK = 30 * _WHISPER_SR  # Whisper's fixed 30 s analysis window

# dWER needs only the decode direction; ASR perplexity encodes through the
# same class
ByteLevelDecoder = ByteLevelBPE


def whisper_forced_tokens(decoder: ByteLevelBPE,
                          decoder_start_token: int,
                          language: str = "en",
                          task: str = "transcribe",
                          multilingual: bool | None = None) -> list[int]:
    """The greedy prompt: ``<|startoftranscript|><|lang|><|task|>
    <|notimestamps|>``, as the reference's.

    English-only (``.en``) checkpoints get ``[start, <|notimestamps|>]``
    (HF's generation config; their tokenizers still contain the language
    tokens, so pass ``multilingual=False`` for them). ``multilingual=None``
    decides by vocabulary membership. An unknown ``language`` on a
    multilingual model raises."""
    if multilingual is None:
        try:
            decoder.token_id("<|en|>")
            multilingual = True
        except KeyError:
            multilingual = False
    toks = [decoder_start_token]
    if multilingual:
        try:
            toks.append(decoder.token_id(f"<|{language}|>"))
        except KeyError:
            raise ValueError(
                f"language {language!r} has no <|{language}|> token in this "
                "Whisper vocabulary — pass a supported two-letter code"
            ) from None
        toks.append(decoder.token_id(f"<|{task}|>"))
    try:
        toks.append(decoder.token_id("<|notimestamps|>"))
    except KeyError:
        pass  # a vocabulary without timestamp tokens
    return toks


def _normalizer(language: str):
    from audiocodecs_tpu_torch.downstream.metrics.text_norm import (
        BasicTextNormalizer,
        EnglishTextNormalizer,
    )

    return (EnglishTextNormalizer() if language == "en"
            else BasicTextNormalizer())


def dwer_metric(model, tokenizer_path: str, language: str = "en",
                max_new_tokens: int = 224, batch_size: int = 8,
                decode_dtype=None) -> MetricStats:
    """The dWER ``MetricStats`` of a loaded :class:`..nn.whisper.Whisper`
    (on its device) and the tokenizer files of ``tokenizer_path``; it also
    carries ``transcribe(sigs, sample_rate)``, ``cer`` and ``normalize``.
    ``max_new_tokens`` is cut to the positions the decoder has past the
    prompt."""
    from audiocodecs_tpu_torch.nn.whisper import (
        log_mel_spectrogram,
        whisper_generate,
    )
    from audiocodecs_tpu_torch.resample import resample

    cfg = model.cfg
    dev = next(model.parameters()).device
    decoder = ByteLevelDecoder.from_dir(tokenizer_path)
    # released checkpoints: .en models (vocab 51864) get no language/task
    # tokens though their tokenizers hold them; other vocabularies decide
    # by membership
    multilingual = (cfg.multilingual
                    if cfg.vocab_size in (51864, 51865) else None)
    forced = whisper_forced_tokens(decoder, cfg.decoder_start_token,
                                   language, multilingual=multilingual)
    normalize = _normalizer(language)
    # no more new tokens than the decoder has positions for
    max_new_tokens = min(max_new_tokens,
                         cfg.max_target_positions - len(forced))
    cache: dict = {}

    def transcribe(sigs, sample_rate: int) -> list[str]:
        if sample_rate is None:
            raise ValueError("pass sample_rate= (Hz) to transcribe signals")
        sigs = [np.asarray(s, np.float32) for s in sigs]
        if sample_rate != _WHISPER_SR:
            sigs = [resample(torch.from_numpy(s)[None], sample_rate,
                             _WHISPER_SR)[0].numpy() for s in sigs]
        keys = [hashlib.sha1(s.tobytes()).digest() for s in sigs]
        todo = [(k, s) for k, s in zip(keys, sigs) if k not in cache]
        for start in range(0, len(todo), batch_size):
            group = todo[start:start + batch_size]
            bucket = 1
            while bucket < len(group):
                bucket *= 2
            wav = np.zeros((min(bucket, batch_size), _CHUNK), np.float32)
            for b, (_, s) in enumerate(group):
                s = s[:_CHUNK]
                wav[b, : s.size] = s
            with torch.inference_mode():
                mel = log_mel_spectrogram(torch.from_numpy(wav).to(dev),
                                          cfg.num_mel_bins)
                toks, lengths = whisper_generate(
                    model, mel, forced, max_new_tokens=max_new_tokens,
                    decode_dtype=decode_dtype)
            toks, lengths = toks.cpu().numpy(), lengths.cpu().numpy()
            for b, (k, _) in enumerate(group):
                cache[k] = decoder.decode(toks[b, : lengths[b]])
        out = [cache[k] for k in keys]
        if len(cache) > 8192:  # bound an eval set's memory
            cache.clear()
            cache.update(zip(keys, out))
        return out

    def _texts(hyp_sigs, ref_sigs, sample_rate):
        hyp = [normalize(t) for t in transcribe(hyp_sigs, sample_rate)]
        ref = [normalize(t) for t in transcribe(ref_sigs, sample_rate)]
        return hyp, ref

    def metric(hyp_sigs, ref_sigs, sample_rate: int):
        from audiocodecs_tpu_torch.downstream.metrics.external import (
            word_error_rate,
        )

        hyp, ref = _texts(hyp_sigs, ref_sigs, sample_rate)
        return [word_error_rate([h], [r]) for h, r in zip(hyp, ref)]

    def cer(hyp_sigs, ref_sigs, sample_rate: int):
        from audiocodecs_tpu_torch.downstream.metrics.external import (
            char_error_rate,
        )

        hyp, ref = _texts(hyp_sigs, ref_sigs, sample_rate)
        return [char_error_rate([h], [r]) for h, r in zip(hyp, ref)]

    stats = MetricStats(metric, name="dWER")
    stats.transcribe = transcribe
    stats.cer = cer
    stats.normalize = normalize
    stats.model = model
    return stats


def make_dwer_checkpoint_metric(params_path: str, tokenizer_path: str,
                                cfg=None, language: str = "en",
                                max_new_tokens: int = 224,
                                batch_size: int = 8, decode_dtype=None,
                                device=None) -> MetricStats:
    """dWER from a converted Whisper checkpoint (the reference's ``.npz``
    or a ``.pt`` state dict) and its tokenizer directory, on ``device``
    (the card when ``None``); the reference's ``make_dwer_jax_metric``.
    Without ``cfg`` the architecture comes from ``tokenizer_path``'s
    ``config.json``."""
    from audiocodecs_tpu_torch.codec import resolve_device
    from audiocodecs_tpu_torch.nn.whisper import Whisper, WhisperConfig
    from audiocodecs_tpu_torch.utils.checkpoint import load_model_state

    dev = resolve_device(device)
    if cfg is None:
        cfg_json = os.path.join(tokenizer_path, "config.json")
        if not os.path.exists(cfg_json):
            raise ValueError(
                f"no config.json in {tokenizer_path!r} — pass cfg= or copy "
                "the HF config next to vocab.json")
        with open(cfg_json, encoding="utf-8") as f:
            cfg = WhisperConfig.from_hf_dict(json.load(f))
    model = Whisper(cfg)
    model.load_state_dict(load_model_state(params_path, model), strict=True)
    return dwer_metric(model.to(dev).eval(), tokenizer_path, language,
                       max_new_tokens, batch_size, decode_dtype)
