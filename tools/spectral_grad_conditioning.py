#!/usr/bin/env python3
"""How far float32 rounding moves the port's codec-training gradient once
the multi-scale STFT term is on, on the CPU.

    python3 tools/spectral_grad_conditioning.py [--draws N]

Builds the tiny EnCodec of ``tests/test_torch_train.py`` (8 filters, ratios
(4, 2), LSTM H = 32, 2 codebooks of 64 x 16, 800 Hz) from a seeded
generator, takes that file's first batch (4 x 800 of N(0, 0.1^2), numpy
seed 0) and ``codec_loss`` with EMA codebooks and ``spec_weight`` 0.5, and
prints, each as a share of the float64 value's max:

* the worst leaf gradient of float32 against float64, with and without the
  spectral term;
* the reconstruction's float32 error (max and rms);
* in float64 alone, how far dL/drec moves when the reconstruction moves by
  Gaussian noise of that rms (``--draws`` draws), where, and which FFT size
  and term of ``msstft_loss`` moves it, with that size's smallest |S|;
* how far dL/drec moves in float32 between the straight-through
  ``feats + (q - feats)`` and ``q`` itself (equal in exact arithmetic).

The last line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from audiocodecs_tpu_torch.downstream.metrics.dsp import stft_mag  # noqa: E402
from audiocodecs_tpu_torch.models.encodec import (  # noqa: E402
    Encodec, EncodecModelConfig)
from audiocodecs_tpu_torch.parallel import train  # noqa: E402
from audiocodecs_tpu_torch.quant.rvq import rvq_quantize_stats  # noqa: E402

SR, K, SPEC = 800, 2, 0.5


def _model(dtype):
    cfg = EncodecModelConfig(sampling_rate=SR, num_filters=8, hidden_size=16,
                             upsampling_ratios=(4, 2), codebook_size=64,
                             codebook_dim=16, num_quantizers=2)
    return Encodec(SR, SR, num_codebooks=K, device="cpu", model_config=cfg,
                   generator=torch.Generator().manual_seed(0)).to(dtype)


def _rec_grad(rec, sig):
    """dL/drec of the reconstruction and spectral terms at ``rec``."""
    r = rec.detach().clone().requires_grad_()
    loss = torch.mean((r - sig) ** 2) + SPEC * train.msstft_loss(r, sig)
    return torch.autograd.grad(loss, r)[0]


def _forward(model, sig, straight_through=True):
    feats = model.encoder(sig[:, None]).transpose(1, 2)
    _, q, *_ = rvq_quantize_stats(feats, model.codebooks.detach(), K)
    q_in = feats + (q - feats).detach() if straight_through else q
    return model.decoder(q_in.transpose(1, 2))[:, 0, :sig.shape[1]]


def _share(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=5)
    args = ap.parse_args()
    sig = (np.random.default_rng(0).standard_normal((4, SR)) * 0.1).astype(
        np.float32)
    out = {}
    for spec in (0.0, SPEC):
        grads = {}
        for dtype in (torch.float32, torch.float64):
            model = _model(dtype)
            loss, _ = train.codec_loss(model, sig, K, spec_weight=spec,
                                       ema=True)
            loss.backward()
            grads[dtype] = {n: p.grad for n, p in model.named_parameters()
                            if p.grad is not None}
        worst = max(grads[torch.float64],
                    key=lambda n: _share(grads[torch.float32][n],
                                         grads[torch.float64][n]))
        out[f"leaf_grad_f32_err_spec{spec}"] = _share(
            grads[torch.float32][worst], grads[torch.float64][worst])
        out[f"leaf_grad_f32_worst_spec{spec}"] = worst

    with torch.no_grad():
        rec64 = _forward(_model(torch.float64), torch.from_numpy(sig).double())
        rec32 = _forward(_model(torch.float32), torch.from_numpy(sig))
        rec32_q = _forward(_model(torch.float32), torch.from_numpy(sig),
                           straight_through=False)
    err = rec32.double() - rec64
    rms = float(err.pow(2).mean().sqrt())
    out.update(rec_f32_err_max=float(err.abs().max()), rec_f32_err_rms=rms,
               rec_max=float(rec64.abs().max()))

    sig64 = torch.from_numpy(sig).double()
    base = _rec_grad(rec64, sig64)
    gen = torch.Generator().manual_seed(1)
    moves = []
    for _ in range(args.draws):
        moved = rec64 + rms * torch.randn(rec64.shape, generator=gen,
                                          dtype=torch.float64)
        d = (_rec_grad(moved, sig64) - base).abs()
        at = divmod(int(d.argmax()), d.shape[1])
        moves.append({"share": float(d.max() / base.abs().max()),
                      "at": list(at)})
        if len(moves) == 1:
            by_term = {}
            for n_fft in (256, 512, 1024):
                for term in ("linear", "log"):
                    g = [_term_grad(r, sig64, n_fft, term)
                         for r in (rec64, moved)]
                    by_term[f"{n_fft}_{term}"] = float(
                        (g[1] - g[0]).abs().max() / base.abs().max())
                by_term[f"{n_fft}_min_S"] = float(
                    stft_mag(rec64, n_fft, n_fft // 4).min())
            out["first_draw_by_term"] = by_term
    out["f64_moves_at_f32_rms"] = moves
    sig32 = torch.from_numpy(sig)
    out["f32_straight_through_vs_q"] = float(
        (_rec_grad(rec32, sig32) - _rec_grad(rec32_q, sig32)).abs().max()
        / base.abs().max())
    for k, v in out.items():
        print(f"{k}: {v}")
    print(json.dumps(out))


def _term_grad(rec, sig, n_fft, term):
    """The gradient of one FFT size's linear or log-magnitude L1 term."""
    r = rec.detach().clone().requires_grad_()
    sh, sr = stft_mag(r, n_fft, n_fft // 4), stft_mag(sig, n_fft, n_fft // 4)
    if term == "linear":
        val = torch.mean(torch.abs(sh - sr))
    else:
        val = torch.mean(torch.abs(torch.log(sh + 1e-5)
                                   - torch.log(sr + 1e-5)))
    return torch.autograd.grad(SPEC * val / 3, r)[0]


if __name__ == "__main__":
    main()
