"""Manifest preparation for the reference's remaining corpora layouts.

The port's copy of ``audiocodecs_tpu/downstream/datasets/corpora.py``.

Capability parity with the reference's dataset preps (reference
``downstream/datasets/{mls,voicebank,librimix,vctk,iemocap,slurp,
speechcommands}.py``): each walks the raw corpus layout into the CSV manifest
contract (ID, duration, wav, + task columns, ``$DATA_ROOT`` substitution).
All preps are host-side; wav durations read from headers.

Layouts handled:
  * VoiceBank-DEMAND — ``{clean,noisy}_{train,test}set*_wav/`` pairs +
    ``*.txt`` transcripts → SE rows (``wav`` = clean, ``noisy_wav``).
  * LibriMix — ``wav16k/<mode>/<split>/{mix_clean,s1,s2}/`` → SS rows
    (``mix_wav``, ``wav`` = s1, ``src2_wav`` = s2).
  * VCTK — ``wav48_silence_trimmed/<spk>/`` + ``txt/<spk>/`` → VC rows
    (``spk_id``, transcripts).
  * IEMOCAP — ``Session*/sentences/wav/.../*.wav`` with
    ``EmoEvaluation`` labels → SER rows (``utt_label``).
  * SLURP — ``slurp_real/*.jsonl`` metadata + audio dir → IC rows
    (``utt_label`` = scenario).
  * SpeechCommands — ``<keyword>/<file>.wav`` → KS rows
    (``utt_label`` = keyword, ``_background_noise_`` skipped).
  * MLS — ``mls_<lang>/<split>/audio/...`` + ``transcripts.txt`` → ASR rows
    with a ``locale`` column (reference ``mls.py:376-377``).
"""

from __future__ import annotations

import json
import os
import wave

from audiocodecs_tpu_torch.downstream.datasets.manifest import (
    write_manifest,
)

__all__ = [
    "prepare_voicebank",
    "prepare_librimix",
    "prepare_vctk",
    "prepare_iemocap",
    "prepare_slurp",
    "prepare_speechcommands",
    "prepare_mls",
]


def _dur(path: str) -> float:
    with wave.open(path, "rb") as f:
        return f.getnframes() / f.getframerate()


def _wavs(root: str):
    for dirpath, _, files in os.walk(root):
        for fname in sorted(files):
            if fname.endswith(".wav"):
                yield os.path.join(dirpath, fname)


def prepare_voicebank(data_folder: str, prep_dir: str) -> dict[str, str]:
    out = {}
    pairs = {
        "train": ("clean_trainset_28spk_wav", "noisy_trainset_28spk_wav"),
        "test": ("clean_testset_wav", "noisy_testset_wav"),
    }
    for split, (clean_dir, noisy_dir) in pairs.items():
        clean_root = os.path.join(data_folder, clean_dir)
        noisy_root = os.path.join(data_folder, noisy_dir)
        rows = []
        for clean in _wavs(clean_root):
            uid = os.path.basename(clean)[:-4]
            noisy = os.path.join(noisy_root, f"{uid}.wav")
            if not os.path.exists(noisy):
                continue
            rows.append({
                "ID": uid, "duration": round(_dur(clean), 4),
                "wav": clean, "noisy_wav": noisy,
            })
        if rows:
            path = os.path.join(prep_dir, f"{split}.csv")
            write_manifest(path, rows)
            out[split] = path
    return out


def prepare_librimix(data_folder: str, prep_dir: str,
                     mode: str | None = None, num_speakers: int = 2,
                     add_noise: bool = False) -> dict[str, str]:
    """LibriMix layouts. ``num_speakers``/``add_noise`` select the mix
    directory like the reference's dataset YAML knobs (reference
    ``hparams/datasets/libri1mix-test.yaml``): 1 speaker → ``mix_single``
    (clean source + noise), 2 speakers → ``mix_both`` with noise else
    ``mix_clean``. 1-speaker rows carry ``in_wav`` (the noisy mixture) for
    noisy-in/clean-out evaluation."""
    if mode is None:
        mode = ("mix_single" if num_speakers == 1
                else ("mix_both" if add_noise else "mix_clean"))
    out = {}
    for split in ("train-100", "dev", "test"):
        base = os.path.join(data_folder, "wav16k", "min", split)
        mix_root = os.path.join(base, mode)
        if not os.path.isdir(mix_root):
            continue
        rows = []
        for mix in _wavs(mix_root):
            uid = os.path.basename(mix)[:-4]
            s1 = os.path.join(base, "s1", f"{uid}.wav")
            s2 = os.path.join(base, "s2", f"{uid}.wav")
            if not os.path.exists(s1):
                continue
            if num_speakers == 1:
                rows.append({
                    "ID": uid, "duration": round(_dur(mix), 4),
                    "wav": s1, "in_wav": mix, "mix_wav": mix,
                })
                continue
            if not os.path.exists(s2):
                continue
            rows.append({
                "ID": uid, "duration": round(_dur(mix), 4),
                "wav": s1, "src2_wav": s2, "mix_wav": mix,
            })
        if rows:
            name = {"train-100": "train", "dev": "valid"}.get(split, split)
            path = os.path.join(prep_dir, f"{name}.csv")
            write_manifest(path, rows)
            out[name] = path
    return out


def prepare_vctk(data_folder: str, prep_dir: str) -> dict[str, str]:
    wav_root = None
    for cand in ("wav48_silence_trimmed", "wav48", "wav16"):
        if os.path.isdir(os.path.join(data_folder, cand)):
            wav_root = os.path.join(data_folder, cand)
            break
    if wav_root is None:
        raise FileNotFoundError(f"no VCTK wav dir under {data_folder}")
    rows = []
    for spk in sorted(os.listdir(wav_root)):
        spk_dir = os.path.join(wav_root, spk)
        if not os.path.isdir(spk_dir):
            continue
        for wav in _wavs(spk_dir):
            uid = os.path.basename(wav)[:-4]
            txt = os.path.join(data_folder, "txt", spk,
                               uid.split("_mic")[0] + ".txt")
            wrd = ""
            if os.path.exists(txt):
                wrd = open(txt).read().strip()
            rows.append({
                "ID": uid, "duration": round(_dur(wav), 4), "wav": wav,
                "wrd": wrd, "spk_id": spk,
            })
    path = os.path.join(prep_dir, "test.csv")
    write_manifest(path, rows)
    return {"test": path}


def prepare_iemocap(data_folder: str, prep_dir: str,
                    keep_labels=("neu", "hap", "ang", "sad")) -> dict[str, str]:
    rows = []
    for sess in sorted(os.listdir(data_folder)):
        if not sess.startswith("Session"):
            continue
        eval_dir = os.path.join(data_folder, sess, "dialog", "EmoEvaluation")
        labels = {}
        if os.path.isdir(eval_dir):
            for fname in os.listdir(eval_dir):
                if not fname.endswith(".txt"):
                    continue
                for line in open(os.path.join(eval_dir, fname),
                                 errors="ignore"):
                    if line.startswith("["):
                        parts = line.split("\t")
                        if len(parts) >= 3:
                            labels[parts[1]] = parts[2]
        wav_root = os.path.join(data_folder, sess, "sentences", "wav")
        for wav in _wavs(wav_root):
            uid = os.path.basename(wav)[:-4]
            lab = labels.get(uid)
            if lab == "exc":
                lab = "hap"  # merge excited→happy (standard protocol)
            if lab not in keep_labels:
                continue
            rows.append({
                "ID": uid, "duration": round(_dur(wav), 4), "wav": wav,
                "utt_label": lab, "spk_id": uid.split("_")[0],
            })
    n = len(rows)
    splits = {"train": rows[: int(n * 0.8)],
              "valid": rows[int(n * 0.8): int(n * 0.9)],
              "test": rows[int(n * 0.9):]}
    out = {}
    for name, part in splits.items():
        if part:
            path = os.path.join(prep_dir, f"{name}.csv")
            write_manifest(path, part)
            out[name] = path
    return out


def prepare_slurp(data_folder: str, prep_dir: str,
                  audio_dir: str = "slurp_real") -> dict[str, str]:
    out = {}
    mapping = {"train": "train.jsonl", "valid": "devel.jsonl",
               "test": "test.jsonl"}
    for split, meta in mapping.items():
        meta_path = os.path.join(data_folder, meta)
        if not os.path.exists(meta_path):
            continue
        rows = []
        for line in open(meta_path):
            item = json.loads(line)
            for rec in item.get("recordings", []):
                wav = os.path.join(data_folder, audio_dir, rec["file"])
                if not wav.endswith(".wav") or not os.path.exists(wav):
                    continue
                rows.append({
                    "ID": rec["file"].rsplit(".", 1)[0],
                    "duration": round(_dur(wav), 4), "wav": wav,
                    "wrd": item.get("sentence", ""),
                    "utt_label": item.get("scenario", "unknown"),
                })
        if rows:
            path = os.path.join(prep_dir, f"{split}.csv")
            write_manifest(path, rows)
            out[split] = path
    return out


def prepare_speechcommands(data_folder: str, prep_dir: str) -> dict[str, str]:
    val_list = set()
    test_list = set()
    for name, target in (("validation_list.txt", val_list),
                        ("testing_list.txt", test_list)):
        p = os.path.join(data_folder, name)
        if os.path.exists(p):
            target.update(x.strip() for x in open(p))
    splits = {"train": [], "valid": [], "test": []}
    for kw in sorted(os.listdir(data_folder)):
        kw_dir = os.path.join(data_folder, kw)
        if not os.path.isdir(kw_dir) or kw.startswith("_"):
            continue
        for wav in _wavs(kw_dir):
            rel = f"{kw}/{os.path.basename(wav)}"
            row = {
                "ID": rel.replace("/", "_")[:-4],
                "duration": round(_dur(wav), 4), "wav": wav, "utt_label": kw,
            }
            if rel in val_list:
                splits["valid"].append(row)
            elif rel in test_list:
                splits["test"].append(row)
            else:
                splits["train"].append(row)
    out = {}
    for name, part in splits.items():
        if part:
            path = os.path.join(prep_dir, f"{name}.csv")
            write_manifest(path, part)
            out[name] = path
    return out


def prepare_mls(data_folder: str, prep_dir: str,
                locale: str = "en") -> dict[str, str]:
    out = {}
    for split, name in (("train", "train"), ("dev", "valid"),
                        ("test", "test")):
        base = os.path.join(data_folder, split)
        trans_path = os.path.join(base, "transcripts.txt")
        if not os.path.exists(trans_path):
            continue
        trans = {}
        for line in open(trans_path):
            uid, _, text = line.strip().partition("\t")
            trans[uid] = text
        rows = []
        for wav in _wavs(os.path.join(base, "audio")):
            uid = os.path.basename(wav)[:-4]
            if uid not in trans:
                continue
            rows.append({
                "ID": uid, "duration": round(_dur(wav), 4), "wav": wav,
                "wrd": trans[uid], "locale": locale,
                "spk_id": uid.split("_")[0],
            })
        if rows:
            path = os.path.join(prep_dir, f"{name}.csv")
            write_manifest(path, rows)
            out[name] = path
    return out
