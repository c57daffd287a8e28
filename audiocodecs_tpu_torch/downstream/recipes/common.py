"""Shared recipe preparation (the reference's ``prepare_recipe``,
``utils.py:73-224``): dataset prep on the main process only, manifest path
resolution, label encoding, experiment-directory setup.

The port's copy of ``audiocodecs_tpu/downstream/recipes/common.py``. The
main process is rank 0 of ``torch.distributed`` when a process group is
initialised, else this process."""

from __future__ import annotations

import os

__all__ = ["prepare_data", "encode_labels", "CharTokenizer",
           "read_split_manifests", "loader_kwargs", "vocab_spec",
           "is_main_process"]


def is_main_process() -> bool:
    """Rank 0 of the initialised ``torch.distributed`` group; true when no
    group is initialised."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def prepare_data(cfg: dict) -> dict:
    """Resolve/prepare manifests in-place; returns the updated config."""
    cfg = dict(cfg)
    if cfg.get("dataset") == "synthetic":
        prep_dir = cfg.get("prep_dir", "/tmp/audiocodecs_tpu_synthetic")
        if is_main_process():
            from audiocodecs_tpu_torch.downstream.datasets import synthetic

            # corpus-shape knobs pass through so a dataset yaml fully
            # determines the corpus (deterministic re-prep on a clean box)
            # ("corpus_seed" not "seed": the task axis owns "seed" and the
            # 3-axis merge is unique-key)
            extra = {
                k: t(cfg[k])
                for k, t in (("num_classes", int),
                             ("min_seconds", float), ("max_seconds", float))
                if k in cfg
            }
            # "corpus_speakers" not "num_speakers": the task axis owns
            # "num_speakers" (SS separation-source count, ss.yaml /
            # librimix) and the 3-axis merge is unique-key — same reason
            # the generator seed rides in as "corpus_seed". The legacy
            # name still works for synthetic-only configs (tests).
            if "corpus_speakers" in cfg:
                extra["num_speakers"] = int(cfg["corpus_speakers"])
            elif "num_speakers" in cfg:
                extra["num_speakers"] = int(cfg["num_speakers"])
            if "corpus_seed" in cfg:
                extra["seed"] = int(cfg["corpus_seed"])
            kwargs = dict(
                sample_rate=int(cfg.get("sample_rate", 16000)),
                num_utts=int(cfg.get("num_utterances", 12)),
                **extra,
            )
            # Regenerate unless the prepped corpus carries a fingerprint
            # matching BOTH the knobs and the generator version — a corpus
            # prepped by an older synthetic.py is stale even when the
            # manifests exist (same knobs, different audio).
            params = dict(num_speakers=4, num_classes=3, min_seconds=0.5,
                          max_seconds=2.0, seed=0)
            params.update(kwargs)
            want = synthetic.corpus_fingerprint(**params)
            fp_path = os.path.join(prep_dir, "_fingerprint.json")
            have = None
            if os.path.exists(fp_path):
                import json

                try:
                    with open(fp_path) as f:
                        have = json.load(f)
                except (OSError, ValueError):
                    have = None
            if have != want or not os.path.exists(
                os.path.join(prep_dir, "test.csv")
            ):
                synthetic.prepare_synthetic(prep_dir, **kwargs)
        for key in ("train_csv", "valid_csv", "test_csv"):
            if key in cfg and isinstance(cfg[key], str):
                cfg[key] = cfg[key].replace("{prep_dir}", prep_dir)
    elif cfg.get("dataset") in ("voicebank", "librimix", "vctk", "iemocap",
                                "slurp", "speechcommands", "mls"):
        import importlib

        corpora = importlib.import_module(
            "audiocodecs_tpu_torch.downstream.datasets.corpora"
        )
        prep_fn = getattr(corpora, f"prepare_{cfg['dataset']}")
        prep_dir = cfg.get("prep_dir", cfg.get("output_folder", "."))
        if "{data_folder}" in prep_dir:
            prep_dir = prep_dir.replace("{data_folder}",
                                        str(cfg.get("data_folder")))
        cfg["prep_dir"] = prep_dir
        if is_main_process() and not os.path.exists(
            os.path.join(prep_dir, "test.csv")
        ):
            import inspect

            os.makedirs(prep_dir, exist_ok=True)
            # forward dataset-yaml knobs that the prep fn accepts
            # (e.g. librimix num_speakers/add_noise, mls languages)
            accepted = set(inspect.signature(prep_fn).parameters) - {
                "data_folder", "prep_dir"
            }
            kwargs = {k: cfg[k] for k in accepted
                      if k in cfg and cfg[k] is not None}
            prep_fn(cfg["data_folder"], prep_dir, **kwargs)
        for key in ("train_csv", "valid_csv", "test_csv"):
            if key in cfg and isinstance(cfg[key], str):
                cfg[key] = cfg[key].replace("{prep_dir}", prep_dir)
    elif cfg.get("dataset") == "librispeech":
        from audiocodecs_tpu_torch.downstream.datasets.librispeech import (
            prepare_librispeech,
        )

        prep_dir = cfg.get("prep_dir", cfg.get("output_folder", "."))
        if "{data_folder}" in prep_dir:
            prep_dir = prep_dir.replace("{data_folder}",
                                        str(cfg.get("data_folder")))
        cfg["prep_dir"] = prep_dir
        if is_main_process():
            prepare_librispeech(cfg)
        for key in ("train_csv", "valid_csv", "test_csv"):
            if key in cfg and isinstance(cfg[key], str):
                cfg[key] = cfg[key].replace("{prep_dir}", prep_dir)
    return cfg


def vocab_spec(codec):
    """Per-codebook vocab sizes for downstream layers: a K-tuple when the
    codec declares heterogeneous codebooks (``CodecConfig.vocab_sizes``,
    e.g. SemantiCodec), else the shared int."""
    if codec.config.vocab_sizes is not None:
        return tuple(codec.config.vocab_sizes)
    return codec.config.vocab_size


def encode_labels(rows, field: str = "utt_label"):
    """Fit a label encoder over manifest rows (reference label_encoder,
    ``utils.py:129-134``) → (label→index dict, index→label list)."""
    labels = sorted({r[field] for r in rows})
    return {l: i for i, l in enumerate(labels)}, labels


class CharTokenizer:
    """Character tokenizer for ASR/TTS text (SentencePiece is unavailable in
    this environment; char mode matches the reference's char-token option)."""

    def __init__(self, texts):
        chars = sorted({c for t in texts for c in t})
        self.blank_id = 0  # CTC blank / pad
        self.itos = ["<blank>"] + chars
        self.stoi = {c: i + 1 for i, c in enumerate(chars)}

    @property
    def vocab_size(self):
        return len(self.itos)

    def encode(self, text: str):
        return [self.stoi[c] for c in text if c in self.stoi]

    def decode(self, ids) -> str:
        return "".join(self.itos[i] for i in ids if 0 < i < len(self.itos))


def read_split_manifests(cfg: dict, splits=("train", "valid", "test")):
    """Per-split manifests with the reference's duration filters applied
    (``{split}_remove_if_shorter`` / ``{split}_remove_if_longer`` seconds —
    reference ``hparams/tasks/asr.yaml:19-23``)."""
    from audiocodecs_tpu_torch.downstream.datasets.manifest import (
        filter_by_duration,
        read_manifest,
    )

    out = {}
    for s in splits:
        rows = read_manifest(cfg[f"{s}_csv"], cfg.get("data_folder"))
        out[s] = filter_by_duration(
            rows,
            float(cfg.get(f"{s}_remove_if_shorter", 0.0)),
            float(cfg.get(f"{s}_remove_if_longer", float("inf"))),
        )
        if not out[s]:
            raise ValueError(
                f"{s} split is empty after duration filtering "
                f"({cfg.get(f'{s}_remove_if_shorter', 0.0)}–"
                f"{cfg.get(f'{s}_remove_if_longer', 'inf')} s)")
    return out


def loader_kwargs(cfg: dict) -> dict:
    """BucketedLoader kwargs from config, including the reference's
    dynamic-batching surface (``dynamic_batching`` +
    ``max_batch_length``/``train_max_batch_length`` seconds of audio per
    batch, ``max_batch_size`` row cap — reference ``utils.py:137-217``)."""
    kw = {
        "batch_size": int(cfg.get("batch_size", 4)),
        "num_buckets": int(cfg.get("num_length_buckets",
                                   cfg.get("num_buckets", 3))),
        "num_workers": int(cfg.get("dataloader_workers", 0)),
    }
    if "sorting" in cfg:
        kw["sorting"] = str(cfg["sorting"])
    if cfg.get("dynamic_batching", False):
        mbl = cfg.get("max_batch_length",
                      cfg.get("train_max_batch_length"))
        if mbl:
            kw["batch_seconds"] = float(mbl)
        if cfg.get("max_batch_size"):
            kw["batch_size"] = int(cfg["max_batch_size"])
    return kw
