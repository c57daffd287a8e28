"""Utterance-classification recipes: IC / KS / SER / SI.

Counterpart of ``audiocodecs_tpu/downstream/recipes/classification.py``.
One skeleton serves the reference's classification quartet (``train_ic.py``
/ ``train_ks.py`` / ``train_ser.py`` / ``train_si.py``): frozen codec
tokens → multihead embedding (seeded from ``codec.embs()``) → weighted
codebook pooling → a one-layer LSTM → masked statistics pooling → a linear
head → cross-entropy; the metric is the error rate. The task only changes
the label field and the dataset.

The codec and the probe run on one device, the card unless the caller asks
for the CPU. The codec's tokens are cached by utterance ID
(:class:`..cache.TokenCache`); augmented batches bypass the cache. The
probe's LSTM is :func:`...nn.lstm.lstm`, whose recurrence launches the LSTM
kernel on the card and whose gradient recomputes through the plain version.
Under ``precision: bf16`` the recurrence takes its bf16 gates and ``w_hh``
up to float32 at the kernel's boundary and its output back down
(:func:`probe_lstm`): the kernel takes float32 only.

Run (``--device cpu`` for the CPU):
    python -m audiocodecs_tpu_torch.downstream.recipes.classification \\
        hparams/tasks/ic.yaml hparams/codecs/encodec.yaml \\
        hparams/datasets/synthetic.yaml
"""

from __future__ import annotations

import itertools
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from audiocodecs_tpu_torch.downstream.models.multihead import (
    fused_table_from_embs,
    init_multihead_embedding,
    multihead_embed,
)
from audiocodecs_tpu_torch.downstream.models.pooling import (
    init_weighted_pooling,
    weighted_pooling,
)
from audiocodecs_tpu_torch.downstream.recipes.trainer import (
    Trainer,
    params_from_jax,
    trainer_kwargs,
    tree_map,
)
from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.nn.lstm import init_lstm_params, lstm
from audiocodecs_tpu_torch.ops.lstm_recurrence import lstm_recurrence
from audiocodecs_tpu_torch.utils.masking import length_mask

__all__ = ["build_probe_params", "classification_loss", "encode_batch_fn",
           "main", "probe_forward", "probe_lstm", "probe_params_from_jax",
           "run_classification"]


def build_probe_params(generator: torch.Generator, num_codebooks, vocab_size,
                       emb_dim, hidden, num_classes, codec_embs=None):
    """The probe's param tree in the reference's layout (``embedding``,
    ``pool``, ``lstm``, ``head``), float32 on the CPU; the embedding is the
    codec's codebooks (:func:`..models.multihead.fused_table_from_embs`)
    when ``codec_embs`` is given. The draws differ from ``jax.random``'s."""
    if codec_embs is not None:
        # pretrain the probe embedding from the codec's codebook vectors
        # (reference train_asr.py:235-238), truncated or padded to emb_dim
        emb = {"table": torch.from_numpy(
            fused_table_from_embs(codec_embs, vocab_size, emb_dim))}
    else:
        emb = init_multihead_embedding(generator, num_codebooks, vocab_size,
                                       emb_dim)
    return {
        "embedding": emb,
        "pool": init_weighted_pooling(generator, num_codebooks),
        "lstm": init_lstm_params(generator, 1, emb_dim, hidden),
        "head": {
            "w": torch.randn(2 * hidden, num_classes, generator=generator)
            * hidden**-0.5,
            "b": torch.zeros(num_classes),
        },
    }


# the reference's probe tree (numpy arrays) → the same tree of float32
# tensors on a device: the probe keeps the reference's layout
probe_params_from_jax = params_from_jax


def probe_lstm(x: torch.Tensor, params) -> torch.Tensor:
    """The probe's stacked LSTM ``x`` [B, N, C] → [B, N, H]. In float32 it is
    :func:`...nn.lstm.lstm`. In bf16 the input projection runs in bf16 (as
    the reference's bf16 loss does) and the recurrence in float32 through
    the same kernel wrapper, its gates, ``w_hh`` and state cast up at the
    boundary and its output cast back down."""
    if x.dtype == torch.float32:
        return lstm(x, params)[0]
    for p in params:
        B, T, cin = x.shape
        H = p["w_hh"].shape[0]
        gates = (torch.matmul(x.transpose(0, 1).reshape(T * B, cin),
                              p["w_ih"]) + p["b"]).view(T, B, 4 * H)
        zeros = torch.zeros(B, H, device=x.device)
        with exact_fp32():
            ys, _, _ = lstm_recurrence(gates.float().contiguous(),
                                       p["w_hh"].float().contiguous(),
                                       zeros, zeros)
        x = ys.to(x.dtype).transpose(0, 1)
    return x


def probe_forward(params, toks, length, *, vocab_size):
    """``toks`` [B, N, K] → class logits [B, num_classes]."""
    x = multihead_embed(params["embedding"], toks, vocab_size=vocab_size)
    x = weighted_pooling(params["pool"], x)  # [B, N, H]
    y = probe_lstm(x, params["lstm"])  # [B, N, H]
    mask = length_mask(length, y.shape[1], dtype=y.dtype)[..., None]
    denom = torch.clamp(mask.sum(dim=1), min=1.0)
    mean = (y * mask).sum(dim=1) / denom
    var = ((y - mean[:, None]) ** 2 * mask).sum(dim=1) / denom
    stats = torch.cat([mean, torch.sqrt(var + 1e-8)], dim=-1)
    with exact_fp32():
        return stats @ params["head"]["w"] + params["head"]["b"]


def classification_loss(params, batch, generator, *, vocab_size):
    """Mean cross-entropy of the probe's logits and the batch's labels;
    aux: the accuracy."""
    logits = probe_forward(params, batch["toks"], batch["length"],
                           vocab_size=vocab_size)
    loss = F.cross_entropy(logits, batch["label"])
    acc = (torch.argmax(logits, -1) == batch["label"]).float().mean()
    return loss, {"acc": acc}


def encode_batch_fn(codec, cache, augmenter=None, generator=None):
    """``encode(batch, augment) -> toks`` [B, N, K] on the codec's device:
    cached by utterance ID, or, with ``augment`` and an augmenter, the
    augmented waveform's tokens, which never touch the cache (reference
    ``train_ic.py:47-63``). ``generator`` (on the codec's device) draws
    the augmentation."""
    dev = codec.device

    def encode(batch, augment=False):
        if augment and augmenter is not None:
            sig = torch.from_numpy(np.asarray(batch["sig"])).to(dev)
            length = torch.from_numpy(np.asarray(batch["length"])).to(dev)
            samples = torch.round(length * sig.shape[1])
            return codec.sig_to_toks(augmenter(sig, generator, samples),
                                     length).clone()
        toks = cache.get_batch(batch["ids"])
        if toks is not None:
            return torch.from_numpy(toks).to(dev)
        toks = codec.sig_to_toks(batch["sig"], batch["length"]).clone()
        cache.put_batch(batch["ids"], toks)
        return toks

    return encode


def run_classification(cfg: dict, device=None, init_params=None) -> dict:
    """Train and test the probe of ``cfg`` (task, codec and dataset axes
    merged) with the codec and the probe on ``device`` (the card when
    ``None``; without CUDA that raises). ``init_params``: the probe's
    initial tree in the reference's layout (numpy arrays) in place of the
    seeded init. Writes the checkpoints, ``token_cache.npz`` and
    ``summary.json`` under ``output_folder`` and returns the summary."""
    from audiocodecs_tpu_torch.codec import resolve_device
    from audiocodecs_tpu_torch.downstream.augment import build_augmenter
    from audiocodecs_tpu_torch.downstream.cache import TokenCache
    from audiocodecs_tpu_torch.downstream.config import (
        build_codec,
        dump_config,
    )
    from audiocodecs_tpu_torch.downstream.datasets.loader import (
        BucketedLoader,
    )
    from audiocodecs_tpu_torch.downstream.recipes.common import (
        encode_labels,
        loader_kwargs,
        read_split_manifests,
        vocab_spec,
    )

    dev = resolve_device(device)
    sample_rate = int(cfg["sample_rate"])
    label_field = cfg.get("label_field", "utt_label")
    out_dir = cfg.get("output_folder", f"results/{cfg.get('task', 'cls')}")
    os.makedirs(out_dir, exist_ok=True)
    dump_config(cfg, out_dir)
    seed = int(cfg.get("seed", 0))

    rows = read_split_manifests(cfg)
    label_map, labels = encode_labels(
        rows["train"] + rows["valid"] + rows["test"], label_field
    )

    codec = build_codec(cfg, sample_rate, mode="encode", device=dev)
    K = codec.config.num_codebooks
    C = vocab_spec(codec)  # int, or K-tuple for heterogeneous codebooks
    cache = TokenCache(os.path.join(out_dir, "token_cache.npz"))
    augmenter = build_augmenter(cfg) if cfg.get("augment", False) else None
    encode_batch = encode_batch_fn(
        codec, cache, augmenter,
        torch.Generator(dev).manual_seed(seed + 17))

    emb_dim = int(cfg.get("embedding_dim_probe", 128))
    hidden = int(cfg.get("probe_hidden", 128))
    if init_params is not None:
        params = probe_params_from_jax(init_params, dev)
    else:
        params = build_probe_params(
            torch.Generator().manual_seed(seed), K, C, emb_dim, hidden,
            len(labels),
            codec_embs=(codec.embs() if cfg.get("pretrain_embeddings", True)
                        else None))
        params = tree_map(lambda t: t.to(dev), params)

    def loss_fn(params, batch, generator):
        return classification_loss(params, batch, generator, vocab_size=C)

    # token corruption (the Codec.resample tool, reference codec.py:121-148)
    # after the cache, so that cached clean tokens stay reusable
    corrupt_p = float(cfg.get("token_corrupt_p", 0.0))
    corrupt_gen = torch.Generator(dev).manual_seed(seed + 1)

    def make_batches(split, shuffle, augment=False):
        epoch_counter = itertools.count()

        def gen():
            next(epoch_counter)
            loader = BucketedLoader(
                rows[split], sample_rate, shuffle=shuffle, seed=seed,
                **loader_kwargs(cfg),
            )
            for batch in loader:
                toks = encode_batch(batch, augment)
                if augment and corrupt_p > 0.0:
                    toks = codec.resample(toks, corrupt_gen,
                                          p=corrupt_p).clone()
                yield {
                    "toks": toks,
                    "length": torch.from_numpy(
                        np.asarray(batch["length"])).to(dev),
                    "label": torch.tensor(
                        [label_map[r[label_field]] for r in batch["rows"]],
                        device=dev),
                }
        return gen

    def error_rate(params, split):
        errs = tot = 0
        with torch.no_grad():
            for batch in make_batches(split, False)():
                pred = torch.argmax(probe_forward(
                    params, batch["toks"], batch["length"], vocab_size=C), -1)
                errs += int((pred != batch["label"]).sum())
                tot += len(batch["label"])
        return errs / max(tot, 1)

    trainer = Trainer(
        loss_fn, params, lr=float(cfg.get("lr", 1e-3)),
        output_folder=out_dir, **trainer_kwargs(cfg)
    )
    trainer.fit(
        int(cfg.get("epochs", 5)),
        make_batches("train", True, augment=True),
        valid_fn=lambda p: error_rate(p, "valid"),
        generator=torch.Generator(dev).manual_seed(seed),
    )
    cache.save()
    params = trainer.load_checkpoint("best")
    test_er = error_rate(params, "test")
    summary = {"test_ER": test_er, "best_valid_ER": trainer.best_metric,
               "num_classes": len(labels)}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None):
    """``task.yaml codec.yaml dataset.yaml [--key value ...]``; ``--device
    cpu`` runs on the CPU (the card otherwise)."""
    from audiocodecs_tpu_torch.downstream.recipes.common import run_cli

    return run_cli(run_classification, argv)


if __name__ == "__main__":
    sys.exit(main())
