"""Codec training (VQ-VAE style) on one device.

Counterpart of the single-device codec part of
``audiocodecs_tpu/parallel/train.py``: reconstruction + commitment losses
through a straight-through RVQ, EMA codebooks with dead-code restarts, and
an optional multi-scale STFT term on a curriculum. The model is the port's
:class:`~audiocodecs_tpu_torch.models.encodec.Encodec` (its ``encoder``,
``decoder`` and ``codebooks``); the optimizer is a ``torch.optim``
optimizer over its parameters, updated in place.

On the card the encoder's and decoder's LSTMs and causal residual blocks
run the package's kernels in the forward; their backward recomputes
through the plain versions (:mod:`..ops._autograd`). The step runs its
forward and its backward with TF32 off (:func:`..nn.layers.exact_fp32`):
the switches are process-wide, so a ``backward()`` outside the ``with``
would run cuDNN's weight gradients in TF32.

Sharding (the reference's ``shard_codec_params``) and the language-model
steps are not ported yet.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from audiocodecs_tpu_torch.downstream.metrics.dsp import stft_mag
from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.quant.rvq import rvq_quantize, rvq_quantize_stats

__all__ = ["codec_loss", "init_codec_opt_state", "make_codec_train_step",
           "msstft_loss", "restart_rows"]

# the reference draws dead-code restarts from fold_in(PRNGKey(0x5EAC0DE), step)
DEAD_CODE_SEED = 0x5EAC0DE


def msstft_loss(rec: torch.Tensor, sig: torch.Tensor,
                fft_sizes=(256, 512, 1024)) -> torch.Tensor:
    """Multi-scale STFT loss: linear-magnitude L1 plus log-magnitude L1 at
    each FFT size (hop ``n_fft // 4``), averaged over the sizes."""
    total = 0.0
    for n_fft in fft_sizes:
        hop = n_fft // 4
        sh = stft_mag(rec, n_fft, hop)
        sr = stft_mag(sig, n_fft, hop)
        total = total + torch.mean(torch.abs(sh - sr)) + torch.mean(
            torch.abs(torch.log(sh + 1e-5) - torch.log(sr + 1e-5)))
    return total / len(fft_sizes)


def codec_loss(model, sig, num_codebooks: int, commit_weight=0.25,
               spec_weight=0.0, ema: bool = False):
    """VQ-VAE reconstruction + commitment (+ codebook) losses, plus the
    multi-scale STFT term when ``spec_weight`` may be nonzero.

    ``sig`` [B, T] (array or tensor; moved to the model's device and
    dtype: float32 on the card, any float type on the CPU). The RVQ
    argmax is straight-through; the reconstruction is trimmed to the shorter
    of input and output. With ``ema`` the codebooks enter detached, the
    codebook term is dropped and the aux carries the per-stage statistics
    ``(counts, sums, residuals)`` for :func:`make_codec_train_step`'s EMA
    update: returns ``(loss, (metrics, stats))``, else ``(loss, metrics)``.

    The spectral term is computed when ``spec_weight`` is a tensor (a
    curriculum weight, which may be 0 at this step but not at every step) or
    a nonzero number, as the reference gates it on a traced scalar."""
    sig = torch.as_tensor(sig, dtype=model.codebooks.dtype,
                          device=model.device)
    feats = model.encoder(sig[:, None, :]).transpose(1, 2)
    if ema:
        _, q, counts, sums, residuals = rvq_quantize_stats(
            feats, model.codebooks.detach(), num_codebooks)
    else:
        _, q = rvq_quantize(feats, model.codebooks, num_codebooks)
    q_st = feats + (q - feats).detach()
    rec = model.decoder(q_st.transpose(1, 2))[:, 0]
    T = min(rec.shape[1], sig.shape[1])
    recon = torch.mean((rec[:, :T] - sig[:, :T]) ** 2)
    commit = torch.mean((feats - q.detach()) ** 2)
    loss = recon + commit_weight * commit
    metrics = {"recon": recon, "commit": commit}
    if not ema:
        codebook = torch.mean((q - feats.detach()) ** 2)
        loss = loss + codebook
        metrics["codebook"] = codebook
    if isinstance(spec_weight, torch.Tensor) or spec_weight != 0:
        spec = msstft_loss(rec[:, :T], sig[:, :T])
        loss = loss + spec_weight * spec
        metrics["spec"] = spec
    if ema:
        return loss, (metrics, (counts, sums, residuals))
    return loss, metrics


def init_codec_opt_state(optimizer: torch.optim.Optimizer, model,
                         num_codebooks: int):
    """``(optimizer, qstate)`` for :func:`make_codec_train_step`'s EMA
    rule: ``optimizer`` (e.g. ``torch.optim.Adam(model.parameters(), lr)``)
    and the quantizer's EMA state on the model's device: per-code
    ``cluster_size`` [K, C] and ``embed_sum`` [K, C, H], zero, and
    ``steps``, the number of updates made (an int)."""
    cb = model.codebooks[:num_codebooks]
    qstate = {
        "cluster_size": torch.zeros(cb.shape[:2], dtype=cb.dtype,
                                    device=cb.device),
        "embed_sum": torch.zeros(cb.shape, dtype=cb.dtype, device=cb.device),
        "steps": 0,
    }
    return optimizer, qstate


def restart_rows(steps: int, num_codebooks: int, codebook_size: int,
                 n: int) -> torch.Tensor:
    """Rows of this batch's residuals ``[K, C]`` (int64, on the CPU) that
    replace dead codes at update ``steps``: a ``torch.Generator`` seeded
    from the reference's constant and the step, so that the card and the
    CPU draw the same rows (the draws differ from ``jax.random``'s)."""
    gen = torch.Generator().manual_seed((DEAD_CODE_SEED << 32) + steps)
    return torch.randint(0, n, (num_codebooks, codebook_size), generator=gen)


@torch.no_grad()
def _ema_codebook_update(model, qstate: dict, stats, num_codebooks: int,
                         decay: float, expire_threshold: float) -> None:
    """The EMA codebook rule with dead-code restarts, in place on
    ``model.codebooks[:K]`` and ``qstate``.

    On the first update the batch statistics are adopted outright (a
    data-dependent init); later ones decay toward them. Cluster means are
    Laplace-smoothed. Codes whose EMA cluster size is below
    ``expire_threshold`` restart from this batch's residuals at
    :func:`restart_rows`."""
    counts, sums, residuals = stats  # [K, C], [K, C, H], [K, B·N, H]
    K, C = num_codebooks, counts.shape[1]
    if qstate["steps"] == 0:
        cs, es = counts, sums
    else:
        cs = decay * qstate["cluster_size"] + (1.0 - decay) * counts
        es = decay * qstate["embed_sum"] + (1.0 - decay) * sums
    eps = 1e-5
    n = cs.sum(dim=-1, keepdim=True)
    smoothed = (cs + eps) / (n + C * eps) * n
    embed = es / smoothed[..., None]
    rows = restart_rows(qstate["steps"], K, C, residuals.shape[1])
    cand = torch.gather(residuals, 1, rows.to(residuals.device)[..., None]
                        .expand(-1, -1, residuals.shape[2]))
    dead = cs < expire_threshold
    embed = torch.where(dead[..., None], cand, embed)
    cs = torch.where(dead, torch.ones_like(cs), cs)
    es = torch.where(dead[..., None], cand, es)
    model.codebooks[:K] = embed
    qstate.update(cluster_size=cs, embed_sum=es, steps=qstate["steps"] + 1)


def make_codec_train_step(model, num_codebooks: int, spec_weight: float = 0.0,
                          ema_decay: float | None = 0.99,
                          expire_threshold: float = 1.0,
                          commit_weight: float = 0.25,
                          commit_warmup: int = 500, spec_delay: int = 0,
                          spec_ramp: int = 300):
    """The step ``(opt_state, sig) → metrics`` that trains ``model`` in
    place: zero the gradients, forward and backward with TF32 off, the
    optimizer's update, then (EMA rule) the codebook update.

    With ``ema_decay`` (the default) codebooks train by EMA statistics with
    dead-code restarts and ``opt_state`` is :func:`init_codec_opt_state`'s
    ``(optimizer, qstate)``; the commitment weight ramps in linearly over
    ``commit_warmup`` updates and the spectral weight over ``spec_ramp``
    updates after ``spec_delay`` (the reference's reasons are in its
    docstring). With ``ema_decay=None`` codebooks train by gradient,
    ``opt_state`` is the optimizer alone and both weights are fixed.

    ``metrics`` holds detached scalar tensors on the model's device:
    ``loss``, ``recon``, ``commit``, ``codebook`` (gradient rule), ``spec``
    (when computed) and ``codebook_util`` (EMA rule: the share of codes
    that won an assignment in this batch). The gradients stay in the
    parameters' ``.grad`` until the next step. The forward, the backward
    and the update run inside the profiler ranges ``codec_train_step.forward``,
    ``.backward`` and ``.update`` (free when no profiler records)."""
    use_ema = ema_decay is not None

    def weights(steps: int):
        """(commit weight, spectral weight) at update ``steps``."""
        if not use_ema:
            return commit_weight, spec_weight
        cw = commit_weight * min(1.0, steps / max(commit_warmup, 1))
        if spec_weight <= 0:
            return cw, 0.0
        ramp = min(max((steps - spec_delay) / max(spec_ramp, 1), 0.0), 1.0)
        return cw, torch.tensor(spec_weight * ramp)

    def step(opt_state, sig):
        if use_ema:
            optimizer, qstate = opt_state
            cw, sw = weights(qstate["steps"])
        else:
            optimizer, (cw, sw) = opt_state, weights(0)
        optimizer.zero_grad(set_to_none=True)
        with exact_fp32():
            with record_function("codec_train_step.forward"):
                loss, aux = codec_loss(model, sig, num_codebooks,
                                       commit_weight=cw, spec_weight=sw,
                                       ema=use_ema)
            with record_function("codec_train_step.backward"):
                loss.backward()
        metrics, stats = aux if use_ema else (aux, None)
        with record_function("codec_train_step.update"):
            optimizer.step()
            if use_ema:
                _ema_codebook_update(model, qstate, stats, num_codebooks,
                                     ema_decay, expire_threshold)
                metrics["codebook_util"] = (stats[0] > 0).float().mean()
        metrics["loss"] = loss
        return {k: v.detach() for k, v in metrics.items()}

    return step
