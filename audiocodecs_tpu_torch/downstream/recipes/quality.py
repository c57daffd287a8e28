"""Shared gated quality-metric construction for recipe eval batteries.

Counterpart of ``audiocodecs_tpu/downstream/recipes/quality.py``. The
reference instantiates the same metric "computers" in several recipes
(``test_sr.py:102-143``, ``train_slm.py:265-296``, ``train_tts.py:266-281``);
this module resolves the config keys to the port's backends, each on
``device`` (the card when ``None``):

  * ``dnsmos_params`` → DNSMOS (:mod:`..metrics.dnsmos`; defaults to the
    shipped params, on by default as in the reference);
  * ``utmos_checkpoint`` (a converted checkpoint, :mod:`..metrics.utmos`,
    ``utmos_bucket_seconds``) / ``utmos_model_path`` (TorchScript);
  * ``whisper_checkpoint`` + ``whisper_tokenizer`` / ``whisper_path`` (an
    HF directory) → dWER and dCER (:mod:`..metrics.dwer`);
  * ``speaker_encoder_checkpoint`` (+ ``speaker_encoder_config``) /
    ``speaker_encoder_model_path`` → SpkSim (the WavLM x-vector);
  * ``lm_checkpoint`` + ``lm_tokenizer`` / ``lm_path`` → ASR perplexity
    (GPT-2), which also needs a Whisper gate;
  * STOI, PESQ (host numpy), MelD and STFTD (:mod:`..metrics.dsp`, on the
    device) in :class:`PairBattery`.

Every metric is optional: a missing gate omits the metric, as the
reference's ``compute_metrics`` switches do.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["build_quality_metrics", "trim_row",
           "reconcile_length", "PairBattery"]

def trim_row(sig_row: np.ndarray, rel_len: float) -> np.ndarray:
    """Cut one padded signal row to its valid length (relative)."""
    n = int(round(float(rel_len) * sig_row.shape[-1]))
    return sig_row[: max(n, 1)]


def reconcile_length(rec: np.ndarray, T: int) -> np.ndarray:
    """Replicate-pad / trim ``[B, T']`` to the reference length ``T``
    (reference test_sr.py:90-100; shared by the SR/SLM/TTS recipes)."""
    if rec.shape[1] < T:
        pad = T - rec.shape[1]
        rec = np.concatenate([rec, np.repeat(rec[:, -1:], pad, axis=1)],
                             axis=1)
    return rec[:, :T]


def build_quality_metrics(cfg: dict, sample_rate: int,
                          want: tuple = ("utmos", "dnsmos", "dwer", "spk",
                                         "ppl"), device=None) -> dict:
    """Resolve config gates to metric callables on ``device`` (the card
    when ``None``).

    Returns a dict with:
      * ``single``: ``{name: fn(sig_1d) -> float}`` — UTMOS / DNSMOS rows.
      * ``dwer``: MetricStats-like with ``.metric([hyp],[ref],sr)`` and
        ``.cer``, or None.
      * ``spk``: MetricStats-like with ``.metric(hyp[None],ref[None],sr)``
        or None.
      * ``ppl``: MetricStats-like with ``.metric([sig]|[text],sr)`` or None.
    """
    out: dict = {"single": {}, "dwer": None, "spk": None, "ppl": None}

    if "dnsmos" in want:
        dnsmos_params = cfg.get("dnsmos_params")
        if dnsmos_params is None:
            from audiocodecs_tpu_torch.downstream.metrics.dnsmos import (
                DEFAULT_PARAMS_PATH,
            )
            dnsmos_params = (DEFAULT_PARAMS_PATH
                             if os.path.exists(DEFAULT_PARAMS_PATH) else "")
        if dnsmos_params:
            from audiocodecs_tpu_torch.downstream.metrics.dnsmos import (
                dnsmos_p808,
            )

            out["single"]["DNSMOS"] = (
                lambda s: dnsmos_p808(s, sample_rate, dnsmos_params, device))

    if "utmos" in want:
        utmos = None
        if cfg.get("utmos_checkpoint"):
            from audiocodecs_tpu_torch.downstream.metrics.utmos import (
                make_utmos_checkpoint_metric,
            )
            utmos = make_utmos_checkpoint_metric(
                cfg["utmos_checkpoint"],
                bucket_seconds=float(cfg.get("utmos_bucket_seconds", 0.0)),
                device=device)
        elif cfg.get("utmos_model_path"):  # a TorchScript file
            from audiocodecs_tpu_torch.downstream.metrics.external import (
                make_utmos_metric,
            )
            utmos = make_utmos_metric(cfg["utmos_model_path"], device)
        if utmos is not None:
            out["single"]["UTMOS"] = (
                lambda s: float(utmos.metric([s], sample_rate)[0]))

    if "dwer" in want and (cfg.get("whisper_checkpoint")
                           or cfg.get("whisper_path")):
        from audiocodecs_tpu_torch.downstream.metrics.external import (
            make_dwer_metric,
        )
        out["dwer"] = make_dwer_metric(
            cfg.get("whisper_path"),
            cfg.get("dwer_language", "en"),
            checkpoint=cfg.get("whisper_checkpoint"),
            tokenizer_path=cfg.get("whisper_tokenizer"),
            device=device,
        )

    if "spk" in want and (cfg.get("speaker_encoder_checkpoint")
                          or cfg.get("speaker_encoder_model_path")):
        from audiocodecs_tpu_torch.downstream.metrics.external import (
            make_speaker_similarity_metric,
        )
        out["spk"] = make_speaker_similarity_metric(
            model_path=cfg.get("speaker_encoder_model_path"),
            checkpoint=cfg.get("speaker_encoder_checkpoint"),
            config=cfg.get("speaker_encoder_config"),
            device=device,
        )

    # PPL needs BOTH an LM and a transcription backend — recipes score
    # signals, and the LM alone would raise mid-eval on the first signal
    if ("ppl" in want
            and (cfg.get("lm_checkpoint") or cfg.get("lm_path"))
            and (cfg.get("whisper_checkpoint") or cfg.get("whisper_path"))):
        from audiocodecs_tpu_torch.downstream.metrics.external import (
            make_perplexity_metric,
        )
        out["ppl"] = make_perplexity_metric(
            lm_path=cfg.get("lm_path"),
            whisper_path=cfg.get("whisper_path"),
            checkpoint=cfg.get("lm_checkpoint"),
            tokenizer_path=cfg.get("lm_tokenizer"),
            whisper_checkpoint=cfg.get("whisper_checkpoint"),
            whisper_tokenizer=cfg.get("whisper_tokenizer"),
            device=device,
        )

    return out


class PairBattery:
    """Per-utterance (hyp, ref) quality battery with mean summarization.

    The reference's SE/SS/TTS recipes all score generated/enhanced speech
    against a reference signal with the same metric set
    (UTMOS/DNSMOS/STOI/PESQ/MelD/STFTD/dWER/SpkSim — e.g. reference
    ``train_se.py:153-161``); this accumulates that battery. DSP metrics
    (STOI/PESQ/MelD/STFTD) are first-party and always on; the rest follow
    the config gates of :func:`build_quality_metrics`. Control-row
    variants are scored by passing ``prefix="Rec"`` / ``"Ref"``. DNSMOS,
    MelD and STFTD run on ``device`` (the card when ``None``).
    """

    def __init__(self, cfg: dict, sample_rate: int,
                 want: tuple = ("utmos", "dnsmos", "dwer", "spk"),
                 dsp: bool = True, device=None):
        from audiocodecs_tpu_torch.codec import resolve_device

        self.sample_rate = sample_rate
        self.device = resolve_device(device)
        self.quality = build_quality_metrics(cfg, sample_rate, want,
                                             self.device)
        self.dsp = dsp
        self.scores: dict[str, list] = {}
        self.ids: dict[str, list] = {}
        self._uid = None

    def add(self, name: str, val: float):
        self.scores.setdefault(name, []).append(float(val))
        self.ids.setdefault(name, []).append(self._uid)

    def score_pair(self, hyp: np.ndarray, ref: np.ndarray,
                   prefix: str = "", uid: str | None = None):
        """One trimmed hypothesis row vs its trimmed reference row."""
        self._uid = uid
        T = min(hyp.shape[-1], ref.shape[-1])
        hyp, ref = np.asarray(hyp)[:T], np.asarray(ref)[:T]
        for name, fn in self.quality["single"].items():
            self.add(prefix + name, fn(hyp))
        if self.dsp:
            import torch

            from audiocodecs_tpu_torch.downstream.metrics.dsp import (
                mel_distance,
                stft_distance,
            )
            from audiocodecs_tpu_torch.downstream.metrics.pesq import pesq
            from audiocodecs_tpu_torch.downstream.metrics.stoi import stoi

            self.add(prefix + "STOI", stoi(hyp, ref, self.sample_rate))
            self.add(prefix + "PESQ", pesq(hyp, ref, self.sample_rate))
            h, r = (torch.as_tensor(np.asarray(a, np.float32),
                                    device=self.device)[None]
                    for a in (hyp, ref))
            self.add(prefix + "MelD",
                     float(mel_distance(h, r, self.sample_rate)[0]))
            self.add(prefix + "STFTD", float(stft_distance(h, r)[0]))
        if self.quality["dwer"] is not None:
            dwer = self.quality["dwer"]
            self.add(prefix + "dWER",
                     dwer.metric([hyp], [ref], self.sample_rate)[0])
            if hasattr(dwer, "cer"):
                self.add(prefix + "dCER",
                         dwer.cer([hyp], [ref], self.sample_rate)[0])
        if self.quality["spk"] is not None:
            self.add(prefix + "SpkSim", self.quality["spk"].metric(
                hyp[None], ref[None], self.sample_rate)[0])

    def score_single(self, sig: np.ndarray, prefix: str = "",
                     uid: str | None = None):
        """Single-signal rows only (UTMOS/DNSMOS) — the Ref control rows."""
        self._uid = uid
        for name, fn in self.quality["single"].items():
            self.add(prefix + name, fn(np.asarray(sig)))

    def summary(self) -> dict:
        # Finite-filtered mean, same policy as MetricStats.summarize
        # (metrics/base.py): one degenerate utterance (e.g. a PESQ nan on
        # pathological input) must not poison the battery average.
        def _mean(vals):
            arr = np.asarray(vals, dtype=np.float64)
            arr = arr[np.isfinite(arr)]
            return float(arr.mean()) if arr.size else float("nan")

        return {name: _mean(vals) for name, vals in self.scores.items()}

    def write_stats(self, out_dir: str):
        """Per-utterance metric files like the reference's MetricStats dumps
        (one ``<metric>.txt`` per metric: ``uid value`` lines + the mean)."""
        os.makedirs(out_dir, exist_ok=True)
        for name, vals in self.scores.items():
            with open(os.path.join(out_dir, f"{name.lower()}.txt"),
                      "w") as f:
                for uid, v in zip(self.ids[name], vals):
                    f.write(f"{uid if uid is not None else '-'}\t{v:.6f}\n")
                if vals:
                    arr = np.asarray(vals, dtype=np.float64)
                    arr = arr[np.isfinite(arr)]
                    m = float(arr.mean()) if arr.size else float("nan")
                    f.write(f"# mean\t{m:.6f}\n")
