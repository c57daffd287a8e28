"""Train a small EnCodec from scratch (VQ-VAE style), on the card by default.

The port's twin of ``examples/train_codec.py``: the same flags (plus
``--device``), the same synthetic batches or random crops of a WAV
manifest, Adam with an optional cosine decay to 1 % of the rate, EMA
codebooks with dead-code restarts and the optional multi-scale STFT term.
The result is saved as the JAX package's param tree (an ``.npz`` that its
``load_params`` reads). Exits 0 when the reconstruction loss fell.

    python -m audiocodecs_tpu_torch.examples.train_codec --steps 50
    python -m audiocodecs_tpu_torch.examples.train_codec --device cpu --steps 3
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "codec_scratch.npz"))
    p.add_argument("--num-filters", type=int, default=8)
    p.add_argument("--train-manifest", default=None,
                   help="CSV manifest (ID,duration,wav,...): train on random "
                        "crops of real corpus wavs instead of the synthetic "
                        "example signal")
    p.add_argument("--valid-manifest", default=None,
                   help="held-out manifest: report valid SI-SNR at the end")
    p.add_argument("--log-every", type=int, default=0,
                   help="print a loss line every N steps (0 = 5 per run)")
    p.add_argument("--spec-weight", type=float, default=0.0,
                   help="multi-scale STFT loss weight (EnCodec-style "
                        "spectral term; 0 = waveform MSE only)")
    p.add_argument("--spec-delay", type=int, default=0,
                   help="steps before the spectral term engages")
    p.add_argument("--spec-ramp", type=int, default=300,
                   help="steps to ramp the spectral weight in after "
                        "--spec-delay")
    p.add_argument("--cosine-decay", action="store_true",
                   help="cosine-decay the learning rate to 1%% over the run")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' on request)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from audiocodecs_tpu_torch.downstream.metrics.dsp import si_snr
    from audiocodecs_tpu_torch.models.encodec import (
        Encodec,
        EncodecModelConfig,
    )
    from audiocodecs_tpu_torch.parallel.train import (
        init_codec_opt_state,
        make_codec_train_step,
    )
    from audiocodecs_tpu_torch.params import to_jax_params
    from audiocodecs_tpu_torch.utils.audio import example_signal, read_wav
    from audiocodecs_tpu_torch.utils.checkpoint import save_params

    sr, K = 16000, 4
    cfg = EncodecModelConfig(
        sampling_rate=sr,
        num_filters=args.num_filters,
        hidden_size=32,
        upsampling_ratios=(8, 5, 4),
        codebook_size=256,
        codebook_dim=32,
        num_quantizers=K,
    )
    model = Encodec(sr, sr, model_config=cfg, num_codebooks=K,
                    generator=torch.Generator().manual_seed(0),
                    device=args.device)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
    schedule = None
    if args.cosine_decay:
        # optax.cosine_decay_schedule(lr, steps, alpha=0.01)
        n = max(args.steps, 1)
        schedule = torch.optim.lr_scheduler.LambdaLR(
            optimizer, lambda t: 0.99 * 0.5 * (1 + math.cos(
                math.pi * min(t, n) / n)) + 0.01)
    opt_state = init_codec_opt_state(optimizer, model, num_codebooks=K)
    step = make_codec_train_step(model, num_codebooks=K,
                                 spec_weight=args.spec_weight,
                                 spec_delay=args.spec_delay,
                                 spec_ramp=args.spec_ramp)

    rng = np.random.default_rng(0)
    T = int(sr * args.seconds)

    def load_corpus(manifest):
        import csv

        sigs = []
        with open(manifest) as f:
            for row in csv.DictReader(f):
                sig, wav_sr = read_wav(row["wav"])
                if wav_sr != sr:
                    raise ValueError(f"{row['wav']}: {wav_sr} Hz, not {sr}")
                sigs.append(np.asarray(sig, np.float32).reshape(-1))
        return sigs

    if args.train_manifest:
        corpus = load_corpus(args.train_manifest)

        def draw_batch():
            out = np.zeros((args.batch, T), np.float32)
            for b in range(args.batch):
                sig = corpus[rng.integers(len(corpus))]
                if len(sig) > T:
                    off = rng.integers(len(sig) - T + 1)
                    out[b] = sig[off:off + T]
                else:
                    out[b, :len(sig)] = sig
            return out
    else:
        base = example_signal(sr, args.seconds)

        def draw_batch():
            noise = rng.standard_normal((args.batch, T)).astype(np.float32)
            return (base[None] * rng.uniform(0.5, 1.0)
                    + 0.05 * noise).astype(np.float32)

    log_every = args.log_every or max(1, args.steps // 5)
    t0 = time.perf_counter()
    loss0 = recon0 = None
    for i in range(args.steps):
        metrics = step(opt_state, draw_batch())
        if schedule is not None:
            schedule.step()
        if i == 0:
            loss0 = float(metrics["loss"])
            recon0 = float(metrics["recon"])
        if i % log_every == 0:
            print(f"step {i}: loss={float(metrics['loss']):.4f} "
                  f"recon={float(metrics['recon']):.4f} "
                  f"util={float(metrics['codebook_util']):.2f}", flush=True)
    dt = time.perf_counter() - t0
    if loss0 is not None:  # --steps 0: save-only smoke run
        print(f"{args.steps} steps in {dt:.1f}s on {model.device}; "
              f"loss {loss0:.4f} -> {float(metrics['loss']):.4f}; "
              f"recon {recon0!r} -> {float(metrics['recon'])!r}")

    if args.valid_manifest:
        vals = []
        for sig in load_corpus(args.valid_manifest):
            x = np.zeros((1, T), np.float32)
            x[0, :min(len(sig), T)] = sig[:T]
            rec = model.toks_to_sig(model.sig_to_toks(x)).cpu()
            vals.append(float(si_snr(rec[:, :T], torch.from_numpy(x)).mean()))
        print(f"valid SI-SNR: {np.mean(vals):+.2f} dB over {len(vals)} utts",
              flush=True)

    save_params(args.out, to_jax_params(model.state_dict(), model))
    print(f"saved {args.out}")
    # success = reconstruction improved (the total loss is not comparable
    # across the run when the spec curriculum changes the objective)
    return 0 if (recon0 is None or float(metrics["recon"]) < recon0) else 1


if __name__ == "__main__":
    sys.exit(main())
