"""Voice conversion (VC) evaluation by token or feature manipulation.

Counterpart of ``audiocodecs_tpu/downstream/recipes/vc.py`` (the reference's
``test_vc.py``), one of three strategies by codec:

* ``acoustic_splice`` (K > 1, e.g. EnCodec): keep the source's codebook 0
  and splice codebooks 1:K from the reference speaker, circularly padded to
  the source's length (reference ``test_vc.py:98-111``);
* ``knn_feats`` (K = 1, e.g. BigCodec): kNN-VC in feature space — each of
  the source's ``toks_to_qfeats`` frames becomes the mean of its top-k
  cosine neighbours among the reference's ``sig_to_feats`` frames, then
  ``feats_to_sig`` vocodes (reference ``test_vc.py:113-128,345-382``, after
  bshall/knn-vc);
* ``global_token_swap`` (BiCodec): the 32 global (speaker) tokens at the
  head of the stream are swapped for the reference's (``test_vc.py:88-96``).

:func:`knn_convert`'s similarity product runs in true fp32 (it sets the
picks), and the top-k is a stable descending sort: among equal
similarities the lower index comes first, as ``jax.lax.top_k`` orders them
(``torch.topk`` leaves their order open).

Run (``--device cpu`` for the CPU):
    python -m audiocodecs_tpu_torch.downstream.recipes.vc \\
        hparams/tasks/vc.yaml hparams/codecs/encodec.yaml \\
        hparams/datasets/synthetic.yaml
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from audiocodecs_tpu_torch.nn.layers import exact_fp32, unit_norm

__all__ = ["convert_pair", "knn_convert", "main", "run_vc",
           "splice_acoustic_tokens", "vc_pairs"]


def knn_convert(src_feats: torch.Tensor, match_feats: torch.Tensor,
                topk: int = 4) -> torch.Tensor:
    """Replace each source frame by the mean of its top-k cosine neighbours.

    ``src_feats``: [N, H]; ``match_feats``: [M, H] → [N, H]."""
    with exact_fp32():
        sims = unit_norm(src_feats) @ unit_norm(match_feats).T  # [N, M]
    idx = torch.sort(sims, dim=-1, descending=True,
                     stable=True).indices[:, :topk]
    return torch.mean(match_feats[idx], dim=1)


def splice_acoustic_tokens(src_toks: np.ndarray,
                           ref_toks: np.ndarray) -> np.ndarray:
    """Keep codebook 0 of ``src_toks`` [N, K]; codebooks 1:K from
    ``ref_toks`` [M, K], circularly padded to N (reference
    ``test_vc.py:98-111``)."""
    N = src_toks.shape[0]
    M = ref_toks.shape[0]
    reps = int(np.ceil(N / M))
    ref_tiled = np.tile(ref_toks, (reps, 1))[:N]
    out = src_toks.copy()
    out[:, 1:] = ref_tiled[:, 1:]
    return out


def vc_pairs(rows: list) -> list:
    """Each manifest row with the first row of another speaker."""
    pairs = []
    for r in rows:
        ref = next((q for q in rows if q.get("spk_id") != r.get("spk_id")),
                   None)
        if ref is not None:
            pairs.append((r, ref))
    return pairs


def convert_pair(codec, strategy: str, src, ref, topk: int = 4):
    """``src`` [1, T] in the voice of ``ref`` [1, T'] by ``strategy`` →
    (the converted waveform [T''] on the codec's device, the source's
    tokens [1, N, K] as a numpy array)."""
    if strategy == "global_token_swap":
        from audiocodecs_tpu_torch.models.bicodec import NUM_GLOBAL_TOKENS

        src_toks = codec.sig_to_toks(src)
        mixed = src_toks.clone()
        mixed[:, :NUM_GLOBAL_TOKENS] = codec.sig_to_toks(ref)[
            :, :NUM_GLOBAL_TOKENS]
        return codec.toks_to_sig(mixed)[0], src_toks.cpu().numpy()
    if strategy == "acoustic_splice":
        src_toks = codec.sig_to_toks(src)[0].cpu().numpy()
        ref_toks = codec.sig_to_toks(ref)[0].cpu().numpy()
        mixed = splice_acoustic_tokens(src_toks, ref_toks)
        return codec.toks_to_sig(mixed[None])[0], src_toks[None]
    match = codec.sig_to_feats(ref)[0]  # [M, H]
    src_toks = codec.sig_to_toks(src)
    src_q = codec.toks_to_qfeats(src_toks)[0]
    if src_q.shape[-1] != match.shape[-1]:
        raise ValueError(
            f"knn_feats: features of width {match.shape[-1]} and quantized "
            f"features of width {src_q.shape[-1]} (a BigCodec needs "
            "latent: false)")
    conv = knn_convert(src_q, match, topk=topk)
    return codec.feats_to_sig(conv[None])[0], src_toks.cpu().numpy()


def run_vc(cfg: dict, device=None) -> dict:
    """Convert up to ``max_pairs`` test utterances to another speaker's
    voice with the codec of ``cfg`` on ``device`` (the card when ``None``;
    without CUDA that raises); writes the converted WAVs, the battery's
    stats files and ``summary.json`` under ``output_folder`` and returns
    the summary."""
    from audiocodecs_tpu_torch.codec import resolve_device
    from audiocodecs_tpu_torch.downstream.config import (
        build_codec,
        dump_config,
    )
    from audiocodecs_tpu_torch.downstream.datasets.manifest import (
        read_manifest,
    )
    from audiocodecs_tpu_torch.downstream.metrics.codebook_util import (
        CodebookUtilization,
    )
    from audiocodecs_tpu_torch.downstream.metrics.dsp import mel_distance
    from audiocodecs_tpu_torch.downstream.recipes.quality import PairBattery
    from audiocodecs_tpu_torch.utils.audio import read_wav, write_wav

    dev = resolve_device(device)
    sample_rate = int(cfg["sample_rate"])
    out_dir = cfg.get("output_folder", "results/vc")
    os.makedirs(out_dir, exist_ok=True)
    dump_config(cfg, out_dir)

    rows = read_manifest(cfg["test_csv"], cfg.get("data_folder"))
    codec = build_codec(cfg, sample_rate, device=dev)
    K = codec.config.num_codebooks

    pairs = vc_pairs(rows)
    if not pairs:
        raise ValueError("need at least two speakers for VC")

    audio_dir = os.path.join(out_dir, "audios")
    os.makedirs(audio_dir, exist_ok=True)
    strategy = ("global_token_swap" if type(codec).__name__ == "BiCodec"
                else "knn_feats" if K == 1 else "acoustic_splice")
    # converted speech scored against the source content (reference
    # test_vc.py:152-161; Rec/Ref control rows :164-183)
    battery = PairBattery(cfg, sample_rate, device=dev)
    compute_ref = bool(cfg.get("compute_ref_metrics", False))
    cbu = CodebookUtilization(K, codec.config.vocab_size,
                              vocab_sizes=codec.config.vocab_sizes)
    melds = []
    for src_row, ref_row in pairs[: int(cfg.get("max_pairs", 8))]:
        src, _ = read_wav(src_row["wav"])
        ref, _ = read_wav(ref_row["wav"])
        out, src_toks = convert_pair(codec, strategy, src, ref,
                                     int(cfg.get("topk", 4)))
        cbu.append(src_toks)
        uid = f"{src_row['ID']}_to_{ref_row['ID']}"
        out_np = out.cpu().numpy()
        write_wav(os.path.join(audio_dir, f"{uid}.wav"), out_np, sample_rate)
        T = min(len(out_np), src.shape[1])
        melds.append(float(mel_distance(
            out[None, :T], torch.from_numpy(src[:, :T]).to(dev),
            sample_rate)[0]))
        battery.score_pair(out_np[:T], src[0, :T], uid=uid)
        if compute_ref:
            rec = codec.toks_to_sig(codec.sig_to_toks(src))[0].cpu().numpy()
            Tr = min(len(rec), src.shape[1])
            battery.score_pair(rec[:Tr], src[0, :Tr], prefix="Rec", uid=uid)
            battery.score_single(src[0], prefix="Ref", uid=uid)

    summary = {"strategy": strategy, "pairs": len(melds),
               "MelD_vs_source": float(np.mean(melds)),
               "codebook_util": cbu.summarize("avg_utilization"),
               "norm_entropy": cbu.summarize("avg_norm_entropy")}
    summary.update(battery.summary())
    battery.write_stats(out_dir)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None):
    """``task.yaml codec.yaml dataset.yaml [--key value ...]``; ``--device
    cpu`` runs on the CPU (the card otherwise)."""
    from audiocodecs_tpu_torch.downstream.recipes.common import run_cli

    return run_cli(run_vc, argv)


if __name__ == "__main__":
    sys.exit(main())
