"""Speech separation (SS): mixture tokens → per-speaker token grids with PIT.

Counterpart of ``audiocodecs_tpu/downstream/recipes/ss.py`` (the reference's
``train_ss.py``: the head predicts S×K codebooks, a permutation-invariant CE
trains it, and each speaker's argmax is vocoded and scored — reference
``train_ss.py:46-51,144-176,196-230``). PIT is the minimum over the S!
permutations of the per-speaker CE (S = 2 by default), taken inside the
loss.

The mixture and its S sources are encoded in one codec call of (S + 1)·B
rows; there is no token cache. The model is :class:`.se.TokenModel` with
S·K heads (a vocabulary tuple repeated S times when the codec's codebooks
differ in size). At test time the permutation is the one of the best mean
SI-SNR, a strict ``>`` keeping the first of equals.

Run (``--device cpu`` for the CPU):
    python -m audiocodecs_tpu_torch.downstream.recipes.ss \\
        hparams/tasks/ss.yaml hparams/codecs/encodec.yaml \\
        hparams/datasets/synthetic.yaml
"""

from __future__ import annotations

import itertools
import json
import os
import sys

import numpy as np
import torch

from audiocodecs_tpu_torch.downstream.recipes.se import (
    encoder_config,
    init_token_model,
    token_ce,
    token_logits,
    token_model_from_jax,
)
from audiocodecs_tpu_torch.utils.masking import length_mask

__all__ = ["head_vocab", "main", "pit_loss", "run_ss", "ss_forward"]


def head_vocab(vocab_size, num_speakers: int):
    """The head's vocabulary: the codec's, repeated per speaker when it is a
    per-codebook tuple."""
    return (tuple(vocab_size) * num_speakers
            if isinstance(vocab_size, (list, tuple)) else vocab_size)


def ss_forward(model, toks, *, vocab_size, num_codebooks, num_speakers):
    """Mixture ``toks`` [B, N, K] → logits [B, N, S, K, C]."""
    logits = token_logits(model, toks, vocab_size=vocab_size,
                          num_heads=num_speakers * num_codebooks,
                          head_vocab=head_vocab(vocab_size, num_speakers))
    B, N = logits.shape[:2]
    return logits.reshape(B, N, num_speakers, num_codebooks, -1)


def pit_loss(logits: torch.Tensor, tgt: torch.Tensor, length: torch.Tensor,
             perms) -> torch.Tensor:
    """Permutation-invariant CE: ``logits`` [B, N, S, K, C], ``tgt``
    [B, S, N, K]; each (predicted, target) speaker pair's masked mean CE
    [B], each permutation's mean over speakers, the least permutation per
    row, the mean over rows."""
    S, K = logits.shape[2], logits.shape[3]
    mask = length_mask(length, logits.shape[1],
                       dtype=logits.dtype)[..., None]  # [B, N, 1]
    denom = torch.clamp(mask.sum((1, 2)) * K, min=1.0)
    cost = torch.stack([torch.stack([
        (token_ce(logits[:, :, s_pred], tgt[:, s_tgt]) * mask).sum((1, 2))
        / denom for s_tgt in range(S)], -1) for s_pred in range(S)],
        -2)  # [B, S_pred, S_tgt]
    perm_losses = torch.stack(
        [sum(cost[:, i, p[i]] for i in range(S)) / S for p in perms], -1)
    return perm_losses.min(-1).values.mean()


def run_ss(cfg: dict, device=None, init_params=None) -> dict:
    """Train and test the SS recipe of ``cfg`` (task, codec and dataset
    axes merged) with the codec and the model on ``device`` (the card when
    ``None``; without CUDA that raises). ``init_params``: the model's
    initial tree in the reference's layout (numpy arrays) in place of the
    seeded init. Writes the checkpoints, the battery's stats files and
    ``summary.json`` under ``output_folder`` and returns the summary."""
    from audiocodecs_tpu_torch.codec import resolve_device
    from audiocodecs_tpu_torch.downstream.config import (
        build_codec,
        dump_config,
    )
    from audiocodecs_tpu_torch.downstream.datasets.loader import (
        BucketedLoader,
    )
    from audiocodecs_tpu_torch.downstream.metrics.dsp import si_snr
    from audiocodecs_tpu_torch.downstream.recipes.common import (
        loader_kwargs,
        read_field_signals,
        read_split_manifests,
        vocab_spec,
    )
    from audiocodecs_tpu_torch.downstream.recipes.quality import PairBattery
    from audiocodecs_tpu_torch.downstream.recipes.trainer import (
        Trainer,
        trainer_kwargs,
    )
    from audiocodecs_tpu_torch.utils.audio import read_wav

    dev = resolve_device(device)
    sample_rate = int(cfg["sample_rate"])
    S = int(cfg.get("num_speakers", 2))
    out_dir = cfg.get("output_folder", "results/ss")
    os.makedirs(out_dir, exist_ok=True)
    dump_config(cfg, out_dir)
    seed = int(cfg.get("seed", 0))

    rows = read_split_manifests(cfg)
    codec = build_codec(cfg, sample_rate, device=dev)
    K, C = codec.config.num_codebooks, vocab_spec(codec)
    cfg_t = encoder_config({**cfg, "encoder_type": "transformer"})
    shape = (K, C, cfg_t, S * K, head_vocab(C, S))
    if init_params is not None:
        model = token_model_from_jax(init_params, *shape, device=dev)
    else:
        model = init_token_model(torch.Generator().manual_seed(seed),
                                 *shape).to(dev)

    src_fields = ["wav", "src2_wav"][:S]
    perms = list(itertools.permutations(range(S)))

    def encode_batch(batch):
        """The mixture and all sources in one codec call → mixture toks
        [B, N, K], source toks [B, S, N, K], sources [S, B, T]."""
        mix = batch["sig"]
        B = mix.shape[0]
        srcs = np.stack([read_field_signals(batch, f) for f in src_fields])
        stacked = np.concatenate([mix, *srcs], axis=0)
        lens = np.tile(batch["length"], S + 1)
        toks = codec.sig_to_toks(stacked, lens).clone()
        src_toks = toks[B:].reshape(S, B, *toks.shape[1:]).transpose(0, 1)
        return toks[:B], src_toks, srcs

    def loss_fn(model, batch, generator):
        logits = ss_forward(model, batch["mix_toks"], vocab_size=C,
                            num_codebooks=K, num_speakers=S)
        return pit_loss(logits, batch["src_toks"], batch["length"],
                        perms), {}

    def make_batches(split, shuffle, with_audio=False):
        def gen():
            loader = BucketedLoader(
                rows[split], sample_rate, shuffle=shuffle, seed=seed,
                read_fn=lambda r: read_wav(r["mix_wav"])[0][0],
                **loader_kwargs(cfg),
            )
            for batch in loader:
                mix_toks, src_toks, srcs = encode_batch(batch)
                out = {"mix_toks": mix_toks, "src_toks": src_toks,
                       "length": torch.from_numpy(
                           np.asarray(batch["length"])).to(dev)}
                if with_audio:
                    out["srcs"] = srcs
                    out["ids"] = batch["ids"]
                yield out
        return gen

    def pit_loss_of(model, split):
        tot, n = 0.0, 0
        with torch.no_grad():
            for batch in make_batches(split, False)():
                tot += float(loss_fn(model, batch, None)[0])
                n += 1
        return tot / max(n, 1)

    trainer = Trainer(loss_fn, model, lr=float(cfg.get("lr", 1e-3)),
                      output_folder=out_dir, **trainer_kwargs(cfg))
    trainer.fit(
        int(cfg.get("epochs", 5)),
        make_batches("train", True),
        valid_fn=lambda m: pit_loss_of(m, "valid"),
        generator=torch.Generator(dev).manual_seed(seed),
    )
    model = trainer.load_checkpoint("best")

    # Test: vocode each speaker, best-permutation SI-SNR and the
    # per-speaker battery on that pairing (reference train_ss.py:225-234)
    battery = PairBattery(cfg, sample_rate, device=dev)
    sisnrs = []
    for batch in make_batches("test", False, with_audio=True)():
        with torch.no_grad():
            pred = torch.argmax(ss_forward(
                model, batch["mix_toks"], vocab_size=C, num_codebooks=K,
                num_speakers=S), -1)  # [B, N, S, K]
        est = [codec.toks_to_sig(pred[:, :, s]) for s in range(S)]
        srcs = torch.from_numpy(batch["srcs"]).to(dev)
        T = min(min(e.shape[1] for e in est), srcs.shape[2])
        # si_snr of every (estimate, source) pair [S, S, B]
        pair = torch.stack([torch.stack([si_snr(est[i][:, :T],
                                                srcs[j, :, :T])
                                         for j in range(S)])
                            for i in range(S)]).cpu().numpy()
        est_np = [e[:, :T].cpu().numpy() for e in est]
        for b in range(pred.shape[0]):
            best, best_perm = -np.inf, perms[0]
            for p in perms:
                score = float(np.mean([float(pair[i, p[i], b])
                                       for i in range(S)]))
                if score > best:
                    best, best_perm = score, p
            sisnrs.append(best)
            for i in range(S):
                battery.score_pair(est_np[i][b],
                                   batch["srcs"][best_perm[i], b, :T],
                                   uid=f"{batch['ids'][b]}_{i}")
    summary = {
        "test_PIT_loss": pit_loss_of(model, "test"),
        "test_SISNR_pit": float(np.mean(sisnrs)) if sisnrs else float("nan"),
    }
    summary.update(battery.summary())
    battery.write_stats(out_dir)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None):
    """``task.yaml codec.yaml dataset.yaml [--key value ...]``; ``--device
    cpu`` runs on the CPU (the card otherwise)."""
    from audiocodecs_tpu_torch.downstream.recipes.common import run_cli

    return run_cli(run_ss, argv)


if __name__ == "__main__":
    sys.exit(main())
