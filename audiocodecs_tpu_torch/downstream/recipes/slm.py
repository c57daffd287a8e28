"""Speech language modelling (SLM).

Counterpart of ``audiocodecs_tpu/downstream/recipes/slm.py`` (the
reference's ``train_slm.py``): the ``[B, N, K]`` token grid is flattened
K-interleaved to ``[B, N·K]`` and wrapped in BOS/EOS, the Llama-style
decoder (:mod:`..models.llama`) trains on next-token CE, and at test time
the recipe reports the token perplexity, generates a continuation of each
utterance's first half and vocodes it, and runs the 2×2 likelihood
consistency check (reference ``train_slm.py:59-157``; the embedding is
seeded from the codec's ``embs()``, ``:424-427``).

``moe_experts > 0`` makes the decoder's FFNs switch-MoE, whose weighted
load-balancing loss the training objective adds. Over several ranks
(``torchrun``, one rank a card) the decoder trains on a mesh, as the
reference's recipe does: ``model_parallel: N`` shards it Megatron-style
(:func:`...parallel.train.shard_llama_params`), ``pipeline_parallel: S``
splits its depth into S GPipe stages of ``num_microbatches``
(:mod:`...parallel.pipeline`), ``expert_parallel: S`` splits its experts
(:func:`...parallel.moe.shard_moe_llama_params`); one of them at a time,
since they share the ``model`` axis. Evaluation, generation and the
consistency check run on the whole decoder, gathered on every rank.
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
from audiocodecs_tpu_torch.parallel.train import slm_interleaved_ce

__all__ = ["flatten_with_specials", "llama_config", "main",
           "next_token_nll", "parallel_degrees", "run_slm",
           "seed_embeddings"]


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


def parallel_degrees(cfg: dict) -> tuple:
    """``(model_parallel, pipeline_parallel, expert_parallel)`` of ``cfg``,
    refused as the reference refuses them: more than one above 1 (they
    share the ``model`` axis), and ``expert_parallel`` without experts;
    and a degree the launched ranks cannot hold."""
    from audiocodecs_tpu_torch.parallel.mesh import launched_world_size

    mp, pp, ep = (int(cfg.get(k, 1)) for k in (
        "model_parallel", "pipeline_parallel", "expert_parallel"))
    if sum(x > 1 for x in (mp, pp, ep)) > 1:
        raise ValueError(
            "set ONE of model_parallel / pipeline_parallel / "
            "expert_parallel > 1 (they all occupy the model mesh axis)")
    if ep > 1 and int(cfg.get("moe_experts", 0)) <= 0:
        raise ValueError("expert_parallel needs moe_experts > 0")
    world = launched_world_size()
    if world % max(mp, pp, ep):
        raise ValueError(
            f"a model axis of {max(mp, pp, ep)} needs a multiple of that "
            f"many ranks, one a device; {world} launched")
    return mp, pp, ep


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
                   lcfg: LlamaConfig, embs: torch.Tensor | None = None,
                   with_aux: bool = False):
    """Masked mean CE of next-token prediction over K-interleaved ``flat``
    [B, L] (:func:`..parallel.train.slm_interleaved_ce`).

    ``embs`` replaces ``llama_embed(flat)`` (TTS adds its speaker
    conditioning there). ``with_aux`` adds the weighted MoE load-balancing
    loss (training only: the evaluation's PPL stays the pure CE)."""
    K, C = lcfg.num_codebooks, lcfg.vocab_size
    if embs is None:
        embs = llama_embed(model, flat, lcfg)
    # [B, L, K, C + specials]
    logits, aux = llama_forward(model, embs, lcfg, return_aux=True)
    aux = (lcfg.moe_aux_weight * aux if with_aux and lcfg.moe_experts > 0
           and lcfg.moe_aux_weight > 0 else 0.0)
    return slm_interleaved_ce(logits, flat, mask, K, C) + aux


def run_slm(cfg: dict, device=None, init_params=None) -> dict:
    """Train and test the SLM recipe of ``cfg`` (task, codec and dataset
    axes merged) with the codec and the decoder on ``device`` (the card
    when ``None``; without CUDA that raises). ``init_params``: the
    decoder's initial tree in the reference's layout (numpy arrays, its
    embedding already seeded) in place of the seeded init. Writes the
    checkpoints, ``token_cache.npz``, the generated WAVs, the battery's
    stats files and ``summary.json`` under ``output_folder`` and returns
    the summary."""
    mp, pp, ep = parallel_degrees(cfg)
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
        is_main_process,
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

    lcfg = llama_config(
        cfg, K, C, max_seq_len=int(cfg.get("max_seq_len", 2048)),
        moe_experts=int(cfg.get("moe_experts", 0)),
        moe_ffn_size=int(cfg.get("moe_ffn_size", 0)),
        moe_capacity_factor=float(cfg.get("moe_capacity_factor", 2.0)),
        moe_top_k=int(cfg.get("moe_top_k", 1)),
        moe_aux_weight=float(cfg.get("moe_aux_weight", 0.0)))
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
        return next_token_nll(model, batch["flat"], batch["mask"], lcfg,
                              with_aux=True), {}

    def make_batches(split, shuffle):
        # the GPipe schedule splits each batch into microbatches, so ragged
        # tail batches are padded back to batch_size with all-pad zero-mask
        # rows (no loss contribution)
        pad_to = int(cfg.get("batch_size", 4)) if pp > 1 else 0

        def gen():
            loader = BucketedLoader(
                rows[split], sample_rate, shuffle=shuffle, seed=seed,
                **loader_kwargs(cfg),
            )
            for batch in loader:
                flat, mask = encode_batch(batch)
                if pad_to and flat.shape[0] < pad_to:
                    extra = pad_to - flat.shape[0]
                    flat = np.concatenate(
                        [flat, np.full((extra, flat.shape[1]),
                                       lcfg.pad_token, np.int32)])
                    mask = np.concatenate(
                        [mask, np.zeros((extra, mask.shape[1]), np.float32)])
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

    # the parallel layouts (the reference's slm.py:186-237): each trains
    # through the sharded module's own loss; evaluation reads the whole
    # decoder, gathered on every rank
    sharder, mesh, train_loss = None, None, loss_fn
    if ep > 1:
        from audiocodecs_tpu_torch.parallel.moe import shard_moe_llama_params

        mp, sharder = ep, shard_moe_llama_params  # experts on 'model'
    if pp > 1:
        from audiocodecs_tpu_torch.parallel.mesh import make_mesh
        from audiocodecs_tpu_torch.parallel.pipeline import (
            make_pp_slm_loss, shard_pp_llama_params, stack_pipeline_stages)
        from audiocodecs_tpu_torch.params import to_jax_params

        mesh = make_mesh(model_parallel=pp, device=dev)
        pp_loss = make_pp_slm_loss(lcfg, mesh,
                                   int(cfg.get("num_microbatches", 2)))

        def train_loss(stage, batch, generator):
            return pp_loss(stage, batch["flat"], batch["mask"]), {}

        def sharder(m, mesh_):
            return shard_pp_llama_params(stack_pipeline_stages(
                to_jax_params(m.state_dict(), m), pp), mesh_, lcfg)
    else:
        from audiocodecs_tpu_torch.parallel.mesh import launched_world_size

        if sharder is None and (mp > 1 or launched_world_size() > 1):
            from audiocodecs_tpu_torch.parallel.train import (
                shard_llama_params)

            sharder = shard_llama_params
        if sharder is not None:
            def train_loss(m, batch, generator):
                return m.nll(batch["flat"], batch["mask"], with_aux=True), {}

    def eval_model(m):
        return m.full_module() if sharder is not None else m

    trainer = Trainer(train_loss, model, lr=float(cfg.get("lr", 1e-3)),
                      output_folder=out_dir, model_parallel=mp,
                      param_sharder=sharder, mesh=mesh,
                      **trainer_kwargs(cfg))
    trainer.fit(
        int(cfg.get("epochs", 5)),
        make_batches("train", True),
        valid_fn=lambda m: valid_ppl(eval_model(m), "valid"),
        generator=torch.Generator(dev).manual_seed(seed),
    )
    if is_main_process():  # every rank holds the same cache
        cache.save()
    model = eval_model(trainer.load_checkpoint("best"))
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

    if is_main_process():
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
