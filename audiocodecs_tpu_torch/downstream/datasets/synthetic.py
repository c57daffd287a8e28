"""Synthetic test corpus generator.

The port's copy of ``audiocodecs_tpu/downstream/datasets/synthetic.py``: the
same knobs and seed give the same manifests and byte-identical WAV files
(written by the port's native writer).

Generates a small deterministic speech-like corpus (wavs + transcripts +
class labels + noisy/clean pairs + 2-speaker mixtures) so every recipe runs
end-to-end offline — the role the reference's real-dataset preps play, with
the same manifest contract.
"""

from __future__ import annotations

import json
import os

import numpy as np

from audiocodecs_tpu_torch.downstream.datasets.manifest import (
    write_manifest,
)
from audiocodecs_tpu_torch.utils.audio import write_wav

__all__ = ["prepare_synthetic", "corpus_fingerprint", "GENERATOR_VERSION"]

# Bump whenever the rendered AUDIO changes for the same knobs (motif
# derivation, normalization, envelope, noise...). prepare_data compares
# the fingerprint file in prep_dir against corpus_fingerprint(...) and
# regenerates on mismatch, so stale corpora from an older generator are
# never silently reused (same knobs != same audio across versions).
# v2 = acoustic-transcript corpus (formant motifs); v3 = v2 + derived
# scenario/emotion label columns (the AUDIO bytes are unchanged for the
# same knobs — the bump only forces a manifest rewrite so older corpora
# gain the new columns).
GENERATOR_VERSION = 3

_FINGERPRINT_FILE = "_fingerprint.json"


def corpus_fingerprint(**params) -> dict:
    """Canonical {generator_version, params} dict identifying a corpus."""
    return {
        "generator_version": GENERATOR_VERSION,
        "params": {k: params[k] for k in sorted(params)},
    }

_WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
          "hotel", "india", "juliett"]

# Every word is a fixed sequence of formant segments (derived once from a
# hash of the word), rendered on the SPEAKER's f0 harmonics — so the
# transcript is acoustically recoverable speaker-invariantly (ASR/TTS/KS
# have something real to learn) while speaker identity stays in the pitch
# (SI stays learnable). The reference validates its recipes on real
# speech; this is the offline stand-in with the same learnability
# structure.
_MOTIFS: dict[str, list[tuple[float, float, float, float]]] = {}


def _word_motif(word: str) -> list[tuple[float, float, float, float]]:
    """[(formant_hz, width_hz, dur_s, gain)] — deterministic per word."""
    if word not in _MOTIFS:
        import zlib

        r = np.random.default_rng(zlib.crc32(word.encode()))
        n = int(r.integers(2, 5))
        # Formants capped at 0.9 kHz: the quality-loop codec is trained
        # with waveform MSE, and phase-locking partials much above ~1 kHz
        # from 100 Hz-frame tokens is an optimization cliff (the 2.8 kHz
        # version of this corpus collapsed the codec to silence — valid
        # SI-SNR -32 dB with recon MSE pinned at signal power).
        _MOTIFS[word] = [
            (float(r.uniform(250.0, 900.0)), float(r.uniform(60.0, 150.0)),
             float(r.uniform(0.08, 0.14)), float(r.uniform(0.7, 1.0)))
            for _ in range(n)
        ]
    return _MOTIFS[word]


def _render_words(rng, sample_rate: int, words: list[str], f0: float,
                  target_seconds: float) -> np.ndarray:
    """Concatenate the word motifs at speaker pitch ``f0``, time-scaled so
    the utterance lands near ``target_seconds``."""
    gap = 0.03
    specs = [_word_motif(w) for w in words]
    natural = sum(d for segs in specs for (_, _, d, _) in segs) \
        + gap * max(0, len(words) - 1)
    scale = float(np.clip(target_seconds / max(natural, 1e-6), 0.6, 1.8))
    kmax = max(1, int(min(3400.0, sample_rate / 2 - 400.0) // f0))
    k = np.arange(1, kmax + 1)[:, None]
    pieces = []
    for segs in specs:
        for (formant, width, dur, gain) in segs:
            n = int(sample_rate * dur * scale)
            t = np.arange(n) / sample_rate
            vib = 1 + 0.015 * np.sin(
                2 * np.pi * 3.0 * t + rng.uniform(0, 2 * np.pi))
            phase = 2 * np.pi * f0 * np.cumsum(vib) / sample_rate
            # low-harmonic pitch anchor: k=1..2 always carry energy, so
            # every segment has a phase-lockable fundamental (speaker
            # identity cue for SI, waveform anchor for the MSE codec)
            amps = np.exp(-0.5 * ((k * f0 - formant) / width) ** 2) \
                + 0.3 * np.exp(-0.5 * ((k - 1) / 1.2) ** 2)
            seg = (amps * np.sin(k * phase[None, :])).sum(0)
            # aspiration: band-limited noise at the formant — an
            # f0-independent cue so the word survives speaker changes
            spec = np.fft.rfft(rng.standard_normal(n))
            fr = np.fft.rfftfreq(n, 1 / sample_rate)
            spec *= np.exp(-0.5 * ((fr - formant) / (1.5 * width)) ** 2)
            asp = np.fft.irfft(spec, n)
            asp *= 0.18 / (np.sqrt(np.mean(asp ** 2)) + 1e-9)
            seg = seg + asp
            env = np.clip(np.minimum(t / 0.015, (t[-1] - t) / 0.02), 0, 1) \
                if n > 1 else np.ones(n)
            pieces.append(seg * env * gain)
        pieces.append(np.zeros(int(sample_rate * gap * scale)))
    sig = np.concatenate(pieces[:-1]) if pieces else np.zeros(1)
    # RMS-normalize (peak-guarded) instead of peak-normalize: narrowband
    # utterances land at a consistent loudness (~power 0.029) instead of
    # crest-factor-dependent power, keeping the waveform-MSE recon term
    # commensurate with the quantizer terms at codec-training init.
    rms = np.sqrt(np.mean(sig ** 2)) + 1e-9
    peak = np.max(np.abs(sig)) + 1e-9
    sig = sig * min(0.17 / rms, 0.9 / peak)
    noise = rng.standard_normal(len(sig)) * 0.01
    return (sig + noise).astype(np.float32)


def _utt_scale(words: list[str], seconds: float) -> float:
    """The time-scale factor `_render_words` applies (its speaking rate)."""
    gap = 0.03
    natural = sum(d for w in words for (_, _, d, _) in _word_motif(w)) \
        + gap * max(0, len(words) - 1)
    return float(np.clip(seconds / max(natural, 1e-6), 0.6, 1.8))


def prepare_synthetic(
    out_dir: str,
    sample_rate: int = 16000,
    num_utts: int = 12,
    num_speakers: int = 4,
    num_classes: int = 3,
    min_seconds: float = 0.5,
    max_seconds: float = 2.0,
    seed: int = 0,
) -> dict[str, str]:
    """Create wavs + manifests; returns {split: manifest_path}.

    Columns: ID, duration, wav, wrd (transcript), utt_label (class),
    spk_id, noisy_wav (for SE), mix_wav/src2_wav (for SS), plus two
    labels DERIVED from properties the audio already carries (so IC/SER
    get decision boundaries distinct from KS's first-word class without
    changing a single audio byte): ``scenario`` = the LAST word's class
    (the reference's IC task keys on SLURP scenarios, a trailing-content
    cue) and ``emotion`` = speaking-rate tercile of the utterance's
    time-scale factor (tempo as the affect stand-in for SER).
    """
    fingerprint = corpus_fingerprint(
        sample_rate=sample_rate, num_utts=num_utts,
        num_speakers=num_speakers, num_classes=num_classes,
        min_seconds=min_seconds, max_seconds=max_seconds, seed=seed,
    )
    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(out_dir, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    rows = []
    f0s = rng.uniform(90, 260, size=num_speakers)
    for i in range(num_utts):
        spk = i % num_speakers
        seconds = float(rng.uniform(min_seconds, max_seconds))
        n_words = int(np.clip(round(seconds / 0.38), 1, 6))
        words = list(rng.choice(_WORDS, n_words))
        wrd = " ".join(words)
        sig = _render_words(rng, sample_rate, words, f0s[spk], seconds)
        wav = os.path.join(wav_dir, f"utt{i:04d}.wav")
        write_wav(wav, sig, sample_rate)
        # noisy version (SE)
        noisy = sig + rng.standard_normal(len(sig)).astype(np.float32) * 0.05
        noisy_wav = os.path.join(wav_dir, f"utt{i:04d}_noisy.wav")
        write_wav(noisy_wav, noisy, sample_rate)
        # 2-speaker mixture (SS): another speaker saying other words
        other_words = list(rng.choice(_WORDS, n_words))
        other = _render_words(rng, sample_rate, other_words,
                              f0s[(spk + 1) % num_speakers], seconds)
        if len(other) < len(sig):
            other = np.pad(other, (0, len(sig) - len(other)))
        mix = (sig + other[: len(sig)]) * 0.5
        mix_wav = os.path.join(wav_dir, f"utt{i:04d}_mix.wav")
        src2_wav = os.path.join(wav_dir, f"utt{i:04d}_src2.wav")
        write_wav(mix_wav, mix, sample_rate)
        write_wav(src2_wav, other[: len(sig)], sample_rate)
        rows.append(
            {
                "ID": f"utt{i:04d}",
                "duration": round(len(sig) / sample_rate, 4),
                "wav": wav,
                "wrd": wrd,
                # label = first word's class → IC/KS/SER have an acoustic
                # decision boundary to learn (was round-robin, unlearnable)
                "utt_label": f"class{_WORDS.index(words[0]) % num_classes}",
                # IC stand-in: last word's class (distinct boundary from
                # utt_label on multi-word utterances, same acoustic cue)
                "scenario": f"class{_WORDS.index(words[-1]) % num_classes}",
                "_scale": _utt_scale(words, seconds),
                "spk_id": f"spk{spk}",
                "noisy_wav": noisy_wav,
                "mix_wav": mix_wav,
                "src2_wav": src2_wav,
            }
        )
    # SER stand-in: speaking-rate terciles over the corpus — relative
    # tempo is in the audio (segment durations all stretch by _scale)
    # and is independent of the first/last-word classes.
    scales = np.array([r.pop("_scale") for r in rows])
    q1, q2 = np.quantile(scales, [1 / 3, 2 / 3])
    for r, s in zip(rows, scales):
        r["emotion"] = ("tempo_fast" if s < q1
                        else "tempo_slow" if s > q2 else "tempo_neutral")
    n = len(rows)
    splits = {
        # boundaries clamped so every split is non-empty down to n=3
        # (write_manifest rejects empty manifests)
        "train": rows[: max(1, min(int(n * 0.6), n - 2))],
        "valid": rows[max(1, min(int(n * 0.6), n - 2))
                      : max(2, min(int(n * 0.8), n - 1))],
        "test": rows[max(2, min(int(n * 0.8), n - 1)) :],
    }
    out = {}
    for split, split_rows in splits.items():
        path = os.path.join(out_dir, f"{split}.csv")
        write_manifest(path, split_rows)
        out[split] = path
    with open(os.path.join(out_dir, _FINGERPRINT_FILE), "w") as f:
        json.dump(fingerprint, f, indent=1, sort_keys=True)
    return out
