"""Metrics backed by pretrained models (gated), and the error rates.

Counterpart of ``audiocodecs_tpu/downstream/metrics/external.py``. The
reference computes UTMOS, DNSMOS, dWER, speaker similarity and ASR
perplexity through downloaded models (reference ``metrics/utmos.py``,
``dnsmos.py``, ``dwer.py``, ``speaker_similarity.py``, ``perplexity.py``).
Here each factory runs the port's own model on the card (``device``, the
card when ``None``) from local files, and raises through :func:`_require`,
naming what to provide, when they are missing:

* ``make_dwer_metric``: a converted Whisper checkpoint (``checkpoint`` +
  ``tokenizer_path``, :mod:`.dwer`) or an HF Whisper directory
  (``whisper_path``: ``config.json``, the weights, ``vocab.json``), read
  with :func:`..convert.checkpoint_files.read_hf_directory` and converted
  by :mod:`..convert.whisper`, where the reference loads it through
  ``transformers`` (which the port does not use);
* ``make_speaker_similarity_metric``: a converted x-vector checkpoint
  (``checkpoint``) or an HF ``WavLMForXVector`` directory (``model_path``);
* ``make_perplexity_metric``: a converted GPT-2 (``checkpoint``) or an HF
  GPT-2 directory (``lm_path``), with Whisper for signals;
* ``make_utmos_metric``: a TorchScript ``utmos22_strong`` file
  (``torch.jit.load``), as the reference's;
* ``make_dnsmos_metric``: ``model_v8.onnx``, read by :mod:`..convert.
  onnx_lite` into the port's DNSMOS (the reference runs onnxruntime).
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from audiocodecs_tpu_torch.downstream.metrics.base import MetricStats

__all__ = [
    "make_dwer_metric",
    "make_speaker_similarity_metric",
    "make_perplexity_metric",
    "make_utmos_metric",
    "make_dnsmos_metric",
    "word_error_rate",
    "char_error_rate",
]


def _edit_distance(r: list, h: list) -> int:
    d = np.zeros((len(r) + 1, len(h) + 1), np.int32)
    d[:, 0] = np.arange(len(r) + 1)
    d[0, :] = np.arange(len(h) + 1)
    for i in range(1, len(r) + 1):
        for j in range(1, len(h) + 1):
            sub = d[i - 1, j - 1] + (r[i - 1] != h[j - 1])
            d[i, j] = min(sub, d[i - 1, j] + 1, d[i, j - 1] + 1)
    return int(d[len(r), len(h)])


def word_error_rate(hyps: list[str], refs: list[str]) -> float:
    """Corpus WER via Levenshtein over words (used by dWER and ASR eval)."""
    errs = tot = 0
    for hyp, ref in zip(hyps, refs):
        h, r = hyp.split(), ref.split()
        errs += _edit_distance(r, h)
        tot += len(r)
    return errs / max(tot, 1)


def char_error_rate(hyps: list[str], refs: list[str]) -> float:
    """Corpus CER: Levenshtein over characters with a ``_`` boundary token
    between words, like the reference's ``ErrorRateStats(split_tokens=True)``
    (dWER's CER field, reference ``metrics/dwer.py:50,103``)."""
    errs = tot = 0
    for hyp, ref in zip(hyps, refs):
        h = list("_".join(hyp.split()))
        r = list("_".join(ref.split()))
        errs += _edit_distance(r, h)
        tot += len(r)
    return errs / max(tot, 1)


def _require(condition: bool, what: str, how: str):
    if not condition:
        raise RuntimeError(
            f"{what} is unavailable in this environment. {how} "
            "(This metric wraps an external pretrained model, matching the "
            "reference's behavior of downloading it at first use; this "
            "environment has no network egress.)"
        )


def _hf_dir(path: str, what: str, how: str):
    """``(config, state dict)`` of an HF directory, or :func:`_require`'s
    error when it has no ``config.json``."""
    from audiocodecs_tpu_torch.convert.checkpoint_files import (
        read_hf_directory,
    )

    _require(os.path.isfile(os.path.join(path, "config.json")), what, how)
    return read_hf_directory(path)


_WHISPER_HOW = ("Pass checkpoint= (converted Whisper checkpoint) with "
                "tokenizer_path=, or whisper_path pointing at a local HF "
                "Whisper directory (config.json, the weights, vocab.json).")


def make_dwer_metric(whisper_path: str | None = None,
                     language: str = "en",
                     checkpoint: str | None = None,
                     tokenizer_path: str | None = None,
                     device=None) -> MetricStats:
    """Differential WER: transcribe hyp and ref with Whisper, WER between
    them (reference ``metrics/dwer.py:33-115``), on ``device``."""
    if checkpoint is not None:
        from audiocodecs_tpu_torch.downstream.metrics.dwer import (
            make_dwer_checkpoint_metric,
        )

        return make_dwer_checkpoint_metric(
            checkpoint, tokenizer_path or os.path.dirname(checkpoint),
            language=language, device=device)
    _require(whisper_path is not None, "dWER (Whisper transcription)",
             _WHISPER_HOW)
    from audiocodecs_tpu_torch.codec import resolve_device
    from audiocodecs_tpu_torch.convert.whisper import (
        convert_whisper_state_dict,
    )
    from audiocodecs_tpu_torch.downstream.metrics.dwer import dwer_metric
    from audiocodecs_tpu_torch.nn.whisper import Whisper, WhisperConfig

    dev = resolve_device(device)
    config, sd = _hf_dir(whisper_path, "dWER (Whisper transcription)",
                         _WHISPER_HOW)
    cfg = WhisperConfig.from_hf_dict(config)
    model = Whisper(cfg)
    model.load_state_dict(convert_whisper_state_dict(sd, cfg), strict=True)
    return dwer_metric(model.to(dev).eval(), whisper_path, language)


def make_speaker_similarity_metric(model_path: str | None = None,
                                   checkpoint: str | None = None,
                                   config: dict | None = None,
                                   device=None) -> MetricStats:
    """Cosine similarity of x-vector speaker embeddings (reference
    ``metrics/speaker_similarity.py:34-123``), on ``device``: from a
    converted ``wavlm_xvector`` checkpoint (``checkpoint``, ``config``
    holding :class:`..models.speaker_encoder.XVectorConfig` overrides) or
    an HF ``WavLMForXVector`` directory (``model_path``). Each utterance is
    embedded at its own length (the pooling must not see padding)."""
    from audiocodecs_tpu_torch.codec import resolve_device
    from audiocodecs_tpu_torch.downstream.models.speaker_encoder import (
        XVector,
        apply_xvector,
        convert_xvector_state_dict,
        load_xvector,
    )

    if checkpoint is not None:
        _, _, embed_fn = load_xvector(checkpoint, config, device)
    else:
        how = ("Pass checkpoint= (converted wavlm_xvector checkpoint) or "
               "model_path= (a local HF WavLMForXVector directory, e.g. "
               "microsoft/wavlm-base-plus-sv).")
        _require(model_path is not None,
                 "Speaker similarity (WavLM x-vector)", how)
        from audiocodecs_tpu_torch.convert.wavlm import wavlm_config_from_hf
        from audiocodecs_tpu_torch.downstream.models.speaker_encoder import (
            XVectorConfig,
        )
        dev = resolve_device(device)
        hf, sd = _hf_dir(model_path, "Speaker similarity (WavLM x-vector)",
                         how)
        cfg = XVectorConfig(
            wavlm=wavlm_config_from_hf(SimpleNamespace(**hf)),
            tdnn_dim=tuple(hf["tdnn_dim"]),
            tdnn_kernel=tuple(hf["tdnn_kernel"]),
            tdnn_dilation=tuple(hf["tdnn_dilation"]),
            xvector_dim=hf["xvector_output_dim"],
            use_weighted_layer_sum=hf["use_weighted_layer_sum"])
        model = XVector(cfg)
        model.load_state_dict(convert_xvector_state_dict(sd, cfg),
                              strict=True)
        model = model.to(dev).eval()

        def embed_fn(sig):
            with torch.inference_mode():
                return apply_xvector(model, torch.as_tensor(
                    sig, dtype=torch.float32, device=dev))

    def embed(sigs, sample_rate):
        del sample_rate  # the caller resamples; the x-vector is 16 kHz
        return np.stack([embed_fn(np.asarray(s, np.float32)[None])[0]
                         .cpu().numpy() for s in sigs])

    def metric(hyp_sigs, ref_sigs, sample_rate: int):
        he = embed(hyp_sigs, sample_rate)
        re_ = embed(ref_sigs, sample_rate)
        num = np.sum(he * re_, axis=-1)
        den = np.linalg.norm(he, axis=-1) * np.linalg.norm(re_, axis=-1)
        return num / np.maximum(den, 1e-12)

    stats = MetricStats(metric, name="SpkSim")
    stats.embed = embed
    return stats


def make_perplexity_metric(lm_path: str | None = None,
                           whisper_path: str | None = None,
                           checkpoint: str | None = None,
                           tokenizer_path: str | None = None,
                           whisper_checkpoint: str | None = None,
                           whisper_tokenizer: str | None = None,
                           device=None) -> MetricStats:
    """Token-weighted LM perplexity of (Whisper-transcribed) text
    (reference ``metrics/perplexity.py:33-156``), on ``device``: a
    converted GPT-2 (``checkpoint`` + ``tokenizer_path``, and
    ``whisper_checkpoint`` for signals) or an HF GPT-2 directory
    (``lm_path``, and ``whisper_path`` for signals)."""
    if checkpoint is not None:
        from audiocodecs_tpu_torch.downstream.metrics.ppl import (
            make_perplexity_checkpoint_metric,
        )

        return make_perplexity_checkpoint_metric(
            checkpoint, tokenizer_path,
            whisper_checkpoint=whisper_checkpoint,
            whisper_tokenizer=whisper_tokenizer, device=device)
    how = ("Pass checkpoint= (converted GPT-2 checkpoint) or lm_path "
           "pointing at a local HF GPT-2 directory (e.g. gpt2-large).")
    _require(lm_path is not None, "ASR perplexity (causal LM)", how)
    from audiocodecs_tpu_torch.codec import resolve_device
    from audiocodecs_tpu_torch.convert.gpt2 import convert_gpt2_state_dict
    from audiocodecs_tpu_torch.downstream.metrics.ppl import (
        perplexity_metric,
    )
    from audiocodecs_tpu_torch.nn.gpt2 import GPT2, GPT2Config

    dev = resolve_device(device)
    config, sd = _hf_dir(lm_path, "ASR perplexity (causal LM)", how)
    cfg = GPT2Config.from_hf_dict(config)
    model = GPT2(cfg)
    model.load_state_dict(convert_gpt2_state_dict(sd, cfg), strict=True)
    transcribe = None
    if whisper_path:
        transcribe = make_dwer_metric(whisper_path, device=dev).transcribe
    return perplexity_metric(model.to(dev).eval(), lm_path, transcribe)


def make_utmos_metric(model_path: str | None = None,
                      device=None) -> MetricStats:
    """UTMOS predicted MOS (reference ``metrics/utmos.py:30-54``) from a
    locally saved TorchScript ``utmos22_strong`` module, on ``device``.
    For a converted checkpoint use
    :func:`.utmos.make_utmos_checkpoint_metric`."""
    _require(
        model_path is not None,
        "UTMOS",
        "Pass model_path pointing at a locally-saved utmos22_strong "
        "TorchScript module.",
    )
    from audiocodecs_tpu_torch.codec import resolve_device

    dev = resolve_device(device)
    predictor = torch.jit.load(model_path, map_location=dev).eval()

    def metric(sigs, sample_rate: int):
        out = []
        for s in sigs:
            with torch.no_grad():
                out.append(float(predictor(
                    torch.as_tensor(np.asarray(s), device=dev)[None],
                    sample_rate)))
        return out

    return MetricStats(metric, name="UTMOS")


def make_dnsmos_metric(onnx_path: str | None = None,
                       device=None) -> MetricStats:
    """DNSMOS P.808 from ``model_v8.onnx`` (reference ``metrics/dnsmos.py:
    45-152`` runs it through onnxruntime): the file's weights in the port's
    DNSMOS on ``device``, scored with the reference's 9.01 s windows
    (:func:`.dnsmos.dnsmos_p808`)."""
    _require(
        onnx_path is not None and os.path.isfile(onnx_path),
        "DNSMOS (model_v8.onnx)",
        "Pass onnx_path to the DNSMOS model.",
    )
    from audiocodecs_tpu_torch.downstream.metrics.dnsmos import (
        dnsmos_p808,
        onnx_dnsmos,
    )

    model = onnx_dnsmos(onnx_path, device)
    dev = next(model.parameters()).device

    def metric(sigs, sample_rate: int):
        return [dnsmos_p808(np.asarray(s), sample_rate, device=dev,
                            model=model) for s in sigs]

    return MetricStats(metric, name="DNSMOS")
