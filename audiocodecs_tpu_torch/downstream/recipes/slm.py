"""Speech language modelling (SLM).

Counterpart of ``audiocodecs_tpu/downstream/recipes/slm.py`` (the
reference's ``train_slm.py``): the ``[B, N, K]`` token grid is flattened
K-interleaved to ``[B, N·K]`` and wrapped in BOS/EOS, the Llama-style
decoder (:mod:`..models.llama`) trains on next-token CE, and at test time
the recipe reports the token perplexity, generates a continuation of each
utterance's first half and vocodes it, and runs the 2×2 likelihood
consistency check (reference ``train_slm.py:59-157``; the embedding is
seeded from the codec's ``embs()``, ``:424-427``).

One device, one process: ``model_parallel``, ``pipeline_parallel`` or
``expert_parallel`` above 1, and ``moe_experts > 0``, raise (the parallel
layer and the MoE FFN are ROADMAP A.11). At 1, the default of
``slm.yaml``, the reference trains through the same ``nll`` as here.
Generation draws from a ``torch.Generator`` on the model's device, seeded
``1 + batch index`` as the reference's ``PRNGKey(1 + bi)`` (the draws
differ from ``jax.random``'s).

Run (``--device cpu`` for the CPU):
    python -m audiocodecs_tpu_torch.downstream.recipes.slm \\
        hparams/tasks/slm.yaml hparams/codecs/encodec.yaml \\
        hparams/datasets/synthetic.yaml
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from audiocodecs_tpu_torch.downstream.models.llama import (
    Llama,
    LlamaConfig,
    init_llama_params,
    llama_embed,
    llama_forward,
    llama_from_jax,
)
from audiocodecs_tpu_torch.downstream.recipes.se import token_ce

__all__ = ["check_single_device", "flatten_with_specials", "llama_config",
           "main", "next_token_nll", "run_slm", "seed_embeddings"]


def flatten_with_specials(toks: np.ndarray, tok_lengths: np.ndarray,
                          bos: int, eos: int, pad: int, max_flat: int):
    """[B, N, K] + valid frame counts → flat [B, max_flat] with BOS/EOS/pad
    and a loss mask (mask covers content + EOS, not BOS/pad)."""
    B, N, K = toks.shape
    flat = np.full((B, max_flat), pad, np.int32)
    mask = np.zeros((B, max_flat), np.float32)
    for b in range(B):
        n = int(round(float(tok_lengths[b]) * N))
        seq = toks[b, :n].reshape(-1)[: max_flat - 2]
        flat[b, 0] = bos
        flat[b, 1 : 1 + len(seq)] = seq
        flat[b, 1 + len(seq)] = eos
        mask[b, 1 : 2 + len(seq)] = 1.0
    return flat, mask


def check_single_device(cfg: dict) -> None:
    """Raise for what the port's one-device recipe cannot run: a parallel
    degree above 1 or the switch-MoE FFN (ROADMAP A.11)."""
    for key in ("model_parallel", "pipeline_parallel", "expert_parallel"):
        if int(cfg.get(key, 1)) > 1:
            raise NotImplementedError(
                f"{key} > 1: the parallel layer is not ported yet "
                "(ROADMAP A.11)")
    if int(cfg.get("moe_experts", 0)) > 0:
        raise NotImplementedError(
            "moe_experts > 0: the switch-MoE FFN is not ported yet "
            "(ROADMAP A.11)")


def llama_config(cfg: dict, K: int, C: int, **fields) -> LlamaConfig:
    """The decoder of the task's keys (``d_model``, ``num_layers``,
    ``num_heads``, ``num_kv_heads``, ``ffn_dim``, ``remat``) over K
    codebooks of C; ``fields`` sets the others."""
    return LlamaConfig(
        vocab_size=C,
        num_codebooks=K,
        hidden_size=int(cfg.get("d_model", 256)),
        num_layers=int(cfg.get("num_layers", 4)),
        num_heads=int(cfg.get("num_heads", 4)),
        num_kv_heads=int(cfg.get("num_kv_heads", 2)),
        intermediate_size=int(cfg.get("ffn_dim", 688)),
        remat=bool(cfg.get("remat", False)),
        **fields,
    )


def seed_embeddings(state: dict, codec_embs, K: int, C: int) -> None:
    """Copy the codec's codebooks ``[K, C, D]`` into the content rows
    ``[:K·C]`` of ``state["embedding.table"]`` (D cut or the rest left)."""
    ce = torch.as_tensor(codec_embs).detach().cpu().reshape(K * C, -1)
    table = state["embedding.table"]
    dim = min(ce.shape[-1], table.shape[-1])
    table[: K * C, :dim] = ce[:, :dim]


def next_token_nll(model: Llama, flat: torch.Tensor, mask: torch.Tensor,
                   lcfg: LlamaConfig, embs: torch.Tensor | None = None):
    """Masked mean CE of next-token prediction over K-interleaved ``flat``
    [B, L]: position i predicts i + 1 through the head of codebook
    ``(i + 1) % K``, i.e. ``i % K`` after BOS; special targets (EOS, pad,
    text ids) map to the extra head logits after the C content ones,
    clipped to the three specials' (``C + min(t − K·C, 2)``).

    ``embs`` replaces ``llama_embed(flat)`` (TTS adds its speaker
    conditioning there)."""
    K, C = lcfg.num_codebooks, lcfg.vocab_size
    if embs is None:
        embs = llama_embed(model, flat, lcfg)
    logits = llama_forward(model, embs, lcfg)  # [B, L, K, C + specials]
    L = flat.shape[1]
    cb = torch.arange(L - 1, device=flat.device) % K
    lg = logits[:, torch.arange(L - 1, device=flat.device), cb]
    tgt = flat[:, 1:].to(torch.int64)
    head_tgt = torch.where(tgt >= K * C,
                           C + torch.clamp(tgt - K * C, max=2), tgt)
    ce = token_ce(lg, head_tgt)
    m = mask[:, 1:]
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)


def run_slm(cfg: dict, device=None, init_params=None) -> dict:
    """Train and test the SLM recipe of ``cfg`` (task, codec and dataset
    axes merged) with the codec and the decoder on ``device`` (the card
    when ``None``; without CUDA that raises). ``init_params``: the
    decoder's initial tree in the reference's layout (numpy arrays, its
    embedding already seeded) in place of the seeded init. Writes the
    checkpoints, ``token_cache.npz``, the generated WAVs, the battery's
    stats files and ``summary.json`` under ``output_folder`` and returns
    the summary."""
    check_single_device(cfg)
    from audiocodecs_tpu_torch.codec import resolve_device
    from audiocodecs_tpu_torch.downstream.cache import TokenCache
    from audiocodecs_tpu_torch.downstream.config import (
        build_codec,
        dump_config,
    )
    from audiocodecs_tpu_torch.downstream.datasets.loader import (
        BucketedLoader,
    )
    from audiocodecs_tpu_torch.downstream.models.llama import llama_generate
    from audiocodecs_tpu_torch.downstream.recipes.common import (
        loader_kwargs,
        read_split_manifests,
    )
    from audiocodecs_tpu_torch.downstream.recipes.quality import (
        PairBattery,
        reconcile_length,
        trim_row,
    )
    from audiocodecs_tpu_torch.downstream.recipes.trainer import (
        Trainer,
        trainer_kwargs,
    )
    from audiocodecs_tpu_torch.utils.audio import write_wav

    dev = resolve_device(device)
    sample_rate = int(cfg["sample_rate"])
    out_dir = cfg.get("output_folder", "results/slm")
    os.makedirs(out_dir, exist_ok=True)
    dump_config(cfg, out_dir)
    seed = int(cfg.get("seed", 0))

    rows = read_split_manifests(cfg)
    codec = build_codec(cfg, sample_rate, device=dev)
    K, C = codec.config.num_codebooks, codec.config.vocab_size
    cache = TokenCache(os.path.join(out_dir, "token_cache.npz"))

    lcfg = llama_config(cfg, K, C,
                        max_seq_len=int(cfg.get("max_seq_len", 2048)))
    if init_params is not None:
        model = llama_from_jax(init_params, lcfg, dev)
    else:
        state = init_llama_params(torch.Generator().manual_seed(seed), lcfg)
        if cfg.get("pretrain_embeddings", True):
            seed_embeddings(state, codec.embs(), K, C)
        model = Llama(lcfg)
        model.load_state_dict(state, strict=True)
        model = model.to(dev)

    max_flat = int(cfg.get("max_flat_len", 512))

    def tokens_of(batch) -> np.ndarray:
        toks = cache.get_batch(batch["ids"])
        if toks is None:
            toks = codec.sig_to_toks(batch["sig"],
                                     batch["length"]).cpu().numpy()
            cache.put_batch(batch["ids"], toks)
        return toks

    def encode_batch(batch):
        return flatten_with_specials(
            tokens_of(batch), batch["length"], lcfg.bos_token,
            lcfg.eos_token, lcfg.pad_token, max_flat)

    def loss_fn(model, batch, generator):
        return next_token_nll(model, batch["flat"], batch["mask"], lcfg), {}

    def make_batches(split, shuffle):
        def gen():
            loader = BucketedLoader(
                rows[split], sample_rate, shuffle=shuffle, seed=seed,
                **loader_kwargs(cfg),
            )
            for batch in loader:
                flat, mask = encode_batch(batch)
                yield {"flat": torch.from_numpy(flat).to(dev),
                       "mask": torch.from_numpy(mask).to(dev)}
        return gen

    def valid_ppl(model, split):
        tot, n = 0.0, 0
        with torch.no_grad():
            for batch in make_batches(split, False)():
                tot += float(next_token_nll(model, batch["flat"],
                                            batch["mask"], lcfg))
                n += 1
        return float(np.exp(tot / max(n, 1)))

    trainer = Trainer(loss_fn, model, lr=float(cfg.get("lr", 1e-3)),
                      output_folder=out_dir, **trainer_kwargs(cfg))
    trainer.fit(
        int(cfg.get("epochs", 5)),
        make_batches("train", True),
        valid_fn=lambda m: valid_ppl(m, "valid"),
        generator=torch.Generator(dev).manual_seed(seed),
    )
    cache.save()
    model = trainer.load_checkpoint("best")
    summary = {"test_PPL": valid_ppl(model, "test")}

    # Continuations of the first half (reference train_slm.py:95-123),
    # vocoded and scored by UTMOS/DNSMOS on the continuation, SpkSim
    # against the prompt and ASR-PPL on the spliced signal (reference
    # train_slm.py:192-213; Rec/Ref control rows :199-217 under
    # compute_ref_metrics); each metric is config-gated
    if cfg.get("generate", True):
        gen_frames = int(cfg.get("gen_frames", 8))
        battery = PairBattery(cfg, sample_rate,
                              want=("utmos", "dnsmos", "spk", "ppl"),
                              device=dev)
        compute_ref = bool(cfg.get("compute_ref_metrics", False))
        gen_dir = os.path.join(out_dir, "generated")
        os.makedirs(gen_dir, exist_ok=True)
        max_batches = int(cfg.get("gen_batches", 0)) or (1 << 30)
        n_gen = total_gen = 0
        loader = BucketedLoader(rows["test"], sample_rate,
                                **loader_kwargs(cfg))
        for bi, batch in enumerate(loader):
            if bi >= max_batches:
                break
            flat, _ = encode_batch(batch)
            toks_full = cache.get_batch(batch["ids"])
            # prompt length ≡ 1 (mod K): BOS, then whole frames
            L = flat.shape[1]
            prompt_len = (min(L // 2, 64) // K) * K + 1
            prompt_frames = (prompt_len - 1) // K
            gen_toks, _ = llama_generate(
                model, lcfg, torch.from_numpy(flat[:, :prompt_len]).to(dev),
                gen_frames * K, torch.Generator(dev).manual_seed(1 + bi),
                top_p=float(cfg.get("top_p", 0.9)),
                temperature=float(cfg.get("temperature", 1.0)))
            grid = torch.clamp(gen_toks, 0, C - 1).reshape(
                gen_toks.shape[0], -1, K)
            gen_sig = codec.toks_to_sig(grid).cpu().numpy()
            sig_np = np.asarray(batch["sig"])
            lens = np.asarray(batch["length"])
            # task-rate samples per token frame, from this batch's encode
            hop = max(sig_np.shape[1] // max(toks_full.shape[1], 1), 1)
            prompt_sig = sig_np[:, : prompt_frames * hop]
            rec_np = None
            if compute_ref:
                rec = codec.toks_to_sig(toks_full, lens).cpu().numpy()
                rec_np = reconcile_length(rec, sig_np.shape[1])
            for i, uid in enumerate(batch["ids"]):
                total_gen += 1
                g, p_ = gen_sig[i], prompt_sig[i]
                hyp = np.concatenate([p_, g])  # prompt + continuation
                battery.score_single(g, uid=uid)
                if battery.quality["spk"] is not None:
                    battery.add("SpkSim", battery.quality["spk"].metric(
                        g[None], p_[None], sample_rate)[0])
                if battery.quality["ppl"] is not None:
                    battery.add("Perplexity", battery.quality["ppl"].metric(
                        [hyp], sample_rate)[0])
                if n_gen < int(cfg.get("save_gen_audios", 4)):
                    write_wav(os.path.join(gen_dir, f"{uid}_gen.wav"), g,
                              sample_rate)
                    n_gen += 1
                if compute_ref:
                    r = trim_row(rec_np[i], lens[i])
                    s = trim_row(sig_np[i], lens[i])
                    battery.score_pair(r, s, prefix="Rec", uid=uid)
                    battery.score_single(s, prefix="Ref", uid=uid)
                    if battery.quality["ppl"] is not None:
                        battery.add("RefPerplexity", battery.quality[
                            "ppl"].metric([s], sample_rate)[0])
        summary["generated"] = total_gen
        summary.update(battery.summary())
        battery.write_stats(out_dir)

    # Likelihood consistency (reference train_slm.py:125-157): the model
    # should give an utterance's own continuation a higher likelihood than
    # another utterance's
    if cfg.get("consistency_eval", True):
        batches = list(make_batches("test", False)())
        if batches:
            flats = torch.cat([b["flat"] for b in batches])[:8]
            masks = torch.cat([b["mask"] for b in batches])[:8]
            B, L = flats.shape
            if B >= 2:
                half = max(K + 1, (L // 2) // K * K)

                def half_nll(prompt_flat, cont_flat, cont_mask):
                    combo = torch.cat([prompt_flat[:, :half],
                                       cont_flat[:, half:]], dim=1)
                    m = torch.cat([torch.zeros_like(cont_mask[:, :half]),
                                   cont_mask[:, half:]], dim=1)
                    return float(next_token_nll(model, combo, m, lcfg))

                errs = 0
                with torch.no_grad():
                    for i in range(B):
                        j = (i + 1) % B
                        own = half_nll(flats[i:i + 1], flats[i:i + 1],
                                       masks[i:i + 1])
                        cross = half_nll(flats[j:j + 1], flats[i:i + 1],
                                         masks[i:i + 1])
                        errs += int(cross <= own)
                summary["consistency_ER"] = errs / B

    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None):
    """``task.yaml codec.yaml dataset.yaml [--key value ...]``; ``--device
    cpu`` runs on the CPU (the card otherwise)."""
    from audiocodecs_tpu_torch.downstream.recipes.common import run_cli

    return run_cli(run_slm, argv)


if __name__ == "__main__":
    sys.exit(main())
