"""TTS: a text prompt → the Llama decoder over K-interleaved audio tokens.

Counterpart of ``audiocodecs_tpu/downstream/recipes/tts.py`` (the
reference's ``train_tts.py``: text tokens and an optional speaker
embedding as the prompt, next-token CE over the audio tokens, generation
and vocoding at test time — reference ``train_tts.py:82-153,205-230``).

Text tokens sit in a vocabulary band after the audio content rows and the
three specials (flat id ``K·C + 3 + id``, ``num_special = 3 + the
tokenizer's vocabulary``); the prompt is padded to a multiple of K so that
the audio starts on codebook 0. With ``speaker_encoder_checkpoint`` a WavLM
x-vector (:func:`..models.speaker_encoder.load_xvector`) embeds each
utterance once (cached by ID), a linear ``spk_proj`` (drawn from a seeded
generator) maps it to the model width, and it is added at position 0 in
training and in generation. Generation draws from a ``torch.Generator``
seeded ``2 + batch index`` (the reference's ``PRNGKey(2 + bi)``; the draws
differ from ``jax.random``'s).

Run (``--device cpu`` for the CPU):
    python -m audiocodecs_tpu_torch.downstream.recipes.tts \\
        hparams/tasks/tts.yaml hparams/codecs/encodec.yaml \\
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
)
from audiocodecs_tpu_torch.downstream.recipes.slm import (
    flatten_with_specials,
    llama_config,
    next_token_nll,
    seed_embeddings,
)
from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.nn.transformer import Linear

__all__ = ["SpeakerLlama", "build_sequences", "main", "run_tts",
           "speaker_condition", "text_prompt_len", "tts_nll"]


class SpeakerLlama(Llama):
    """:class:`..models.llama.Llama` with ``spk_proj`` (``w`` [D, H], ``b``
    [H]), the speaker projection, in the reference's tree."""

    def __init__(self, cfg: LlamaConfig, spk_dim: int):
        super().__init__(cfg)
        self.spk_proj = Linear(spk_dim, cfg.hidden_size, True)


def text_prompt_len(max_text: int, K: int) -> int:
    """The text prompt's length: ``max_text`` + 1, rounded up past a
    multiple of K so that the audio starts on codebook 0."""
    return ((max_text + 1) // K + 1) * K


def build_sequences(toks: np.ndarray, length, texts, lcfg: LlamaConfig,
                    max_text: int, max_flat: int):
    """[text prompt | BOS | audio tokens | EOS | pad] a row (reference
    ``train_tts.py:82-88``) → (flat [B, max_flat] int32, loss mask
    [B, max_flat]): ``toks`` [B, N, K] and ``length`` [B] the audio,
    ``texts`` each row's tokenizer ids (cut to ``max_text``), in the band
    ``K·C + 3 + id``; the mask covers the audio and its EOS."""
    K, C = lcfg.num_codebooks, lcfg.vocab_size
    prompt_len = text_prompt_len(max_text, K)
    B = toks.shape[0]
    audio_flat, audio_mask = flatten_with_specials(
        toks, length, lcfg.bos_token, lcfg.eos_token, lcfg.pad_token,
        max_flat - prompt_len)
    flat = np.full((B, max_flat), lcfg.pad_token, np.int32)
    mask = np.zeros((B, max_flat), np.float32)
    for i, ids in enumerate(texts):
        text = np.asarray(ids[:max_text], np.int32)
        flat[i, : len(text)] = K * C + 3 + text
        flat[i, prompt_len:] = audio_flat[i]
        mask[i, prompt_len:] = audio_mask[i]
    return flat, mask


def speaker_condition(model: SpeakerLlama,
                      spk_emb: torch.Tensor) -> torch.Tensor:
    """``spk_emb`` [B, D] → the addend of position 0, [B, H]."""
    with exact_fp32():
        return spk_emb @ model.spk_proj.w + model.spk_proj.b


def tts_nll(model: Llama, flat: torch.Tensor, mask: torch.Tensor,
            lcfg: LlamaConfig, spk_emb: torch.Tensor | None = None):
    """Masked next-token CE (:func:`.slm.next_token_nll`), the speaker's
    condition added to position 0's embedding when ``spk_emb`` is given.
    Text tokens are never targets (the mask leaves out the prompt)."""
    embs = None
    if spk_emb is not None:
        embs = llama_embed(model, flat, lcfg)
        cond = speaker_condition(model, spk_emb)
        embs = torch.cat([embs[:, :1] + cond[:, None], embs[:, 1:]], dim=1)
    return next_token_nll(model, flat, mask, lcfg, embs)


def run_tts(cfg: dict, device=None, init_params=None) -> dict:
    """Train and test the TTS recipe of ``cfg`` (task, codec and dataset
    axes merged) with the codec, the decoder and the speaker encoder on
    ``device`` (the card when ``None``; without CUDA that raises).
    ``init_params``: the decoder's initial tree in the reference's layout
    (numpy arrays; its embedding already seeded and ``spk_proj`` in it when
    the config has a speaker encoder) in place of the seeded init. Writes
    the checkpoints, ``token_cache.npz``, the generated WAVs, the battery's
    stats files and ``summary.json`` under ``output_folder`` and returns
    the summary."""
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
    from audiocodecs_tpu_torch.downstream.text import build_tokenizer
    from audiocodecs_tpu_torch.params import from_jax_params
    from audiocodecs_tpu_torch.utils.audio import write_wav

    dev = resolve_device(device)
    sample_rate = int(cfg["sample_rate"])
    out_dir = cfg.get("output_folder", "results/tts")
    os.makedirs(out_dir, exist_ok=True)
    dump_config(cfg, out_dir)
    seed = int(cfg.get("seed", 0))

    rows = read_split_manifests(cfg)
    tokenizer = build_tokenizer(
        [r["wrd"] for r in rows["train"]],
        token_type=cfg.get("token_type", "char"),
        num_tokens=int(cfg.get("num_tokens", 1000)),
        character_coverage=float(cfg.get("character_coverage", 1.0)),
    )
    codec = build_codec(cfg, sample_rate, device=dev)
    K, C = codec.config.num_codebooks, codec.config.vocab_size
    cache = TokenCache(os.path.join(out_dir, "token_cache.npz"))

    # text tokens: an extra band after the audio rows and the specials
    lcfg = llama_config(cfg, K, C, num_special=3 + tokenizer.vocab_size)

    # the optional speaker-embedding prefix (reference train_tts.py:96-101)
    xv_embed = None
    spk_cache: dict = {}
    if cfg.get("speaker_encoder_checkpoint"):
        from audiocodecs_tpu_torch.downstream.models.speaker_encoder import (
            load_xvector,
        )

        _, xv_cfg, xv_embed = load_xvector(
            cfg["speaker_encoder_checkpoint"],
            cfg.get("speaker_encoder_config"), device=dev)
        model = SpeakerLlama(lcfg, xv_cfg.xvector_dim)
    else:
        model = Llama(lcfg)
    if init_params is not None:
        model.load_state_dict(from_jax_params(init_params, model),
                              strict=True)
    else:
        state = init_llama_params(torch.Generator().manual_seed(seed), lcfg)
        if cfg.get("pretrain_embeddings", True):
            # the audio rows from codec.embs() (reference
            # train_tts.py:448-450); text and special rows stay drawn
            seed_embeddings(state, codec.embs(), K, C)
        if xv_embed is not None:
            D = xv_cfg.xvector_dim
            state["spk_proj.w"] = torch.randn(
                D, lcfg.hidden_size,
                generator=torch.Generator().manual_seed(seed + 7)) * D**-0.5
            state["spk_proj.b"] = torch.zeros(lcfg.hidden_size)
        model.load_state_dict(state, strict=True)
    model = model.to(dev)

    def spk_emb_of(batch) -> torch.Tensor:
        embs = []
        for i, r in enumerate(batch["rows"]):
            if r["ID"] not in spk_cache:
                spk_cache[r["ID"]] = xv_embed(
                    batch["sig"][i:i + 1])[0].clone()
            embs.append(spk_cache[r["ID"]])
        return torch.stack(embs)  # [B, spk_dim]

    max_text = int(cfg.get("max_text_len", 48))
    max_flat = int(cfg.get("max_flat_len", 384))
    prompt_len = text_prompt_len(max_text, K)

    def sequences_of(batch):
        toks = cache.get_batch(batch["ids"])
        if toks is None:
            toks = codec.sig_to_toks(batch["sig"],
                                     batch["length"]).cpu().numpy()
            cache.put_batch(batch["ids"], toks)
        return build_sequences(
            toks, batch["length"],
            [tokenizer.encode(r["wrd"]) for r in batch["rows"]], lcfg,
            max_text, max_flat)

    def loss_fn(model, batch, generator):
        return tts_nll(model, batch["flat"], batch["mask"], lcfg,
                       batch.get("spk_emb")), {}

    def make_batches(split, shuffle, rows_too=False):
        def gen():
            loader = BucketedLoader(
                rows[split], sample_rate, shuffle=shuffle, seed=seed,
                **loader_kwargs(cfg),
            )
            for batch in loader:
                flat, mask = sequences_of(batch)
                out = {"flat": torch.from_numpy(flat).to(dev),
                       "mask": torch.from_numpy(mask).to(dev)}
                if xv_embed is not None:
                    out["spk_emb"] = spk_emb_of(batch)
                if rows_too:
                    out.update(rows=batch["rows"], ids=batch["ids"],
                               sig=batch["sig"], length=batch["length"])
                yield out
        return gen

    def valid_loss(model, split):
        tot, n = 0.0, 0
        with torch.no_grad():
            for b in make_batches(split, False)():
                tot += float(tts_nll(model, b["flat"], b["mask"], lcfg,
                                     b.get("spk_emb")))
                n += 1
        return tot / max(n, 1)

    trainer = Trainer(loss_fn, model, lr=float(cfg.get("lr", 1e-3)),
                      output_folder=out_dir, **trainer_kwargs(cfg))
    trainer.fit(
        int(cfg.get("epochs", 5)),
        make_batches("train", True),
        valid_fn=lambda m: valid_loss(m, "valid"),
        generator=torch.Generator(dev).manual_seed(seed),
    )
    cache.save()
    model = trainer.load_checkpoint("best")
    summary = {"test_loss": valid_loss(model, "test")}

    # Speech for the test transcripts, vocoded and scored by UTMOS/DNSMOS
    # on it, dWER and SpkSim against the reference speech (reference
    # train_tts.py:205-211; Rec/Ref control rows :216-230); the DSP rows
    # are off: generated speech is not time-aligned with the reference
    if cfg.get("generate", True):
        battery = PairBattery(cfg, sample_rate, dsp=False, device=dev)
        compute_ref = bool(cfg.get("compute_ref_metrics", False))
        gen_len = prompt_len + 1  # text + BOS
        gen_frames = int(cfg.get("gen_frames", 12))
        gen_dir = os.path.join(out_dir, "generated")
        os.makedirs(gen_dir, exist_ok=True)
        max_batches = int(cfg.get("gen_batches", 0)) or (1 << 30)
        n_dump = total_gen = 0
        for bi, batch in enumerate(make_batches("test", False,
                                                rows_too=True)()):
            if bi >= max_batches:
                break
            prompt = batch["flat"][:, :gen_len]
            emb_add = None
            if "spk_emb" in batch:
                # condition position 0 exactly as in training
                with torch.no_grad():
                    cond = speaker_condition(model, batch["spk_emb"])
                emb_add = torch.zeros(prompt.shape[0], gen_len,
                                      lcfg.hidden_size, device=dev)
                emb_add[:, 0] = cond
            toks, _ = llama_generate(
                model, lcfg, prompt, gen_frames * K,
                torch.Generator(dev).manual_seed(2 + bi),
                top_p=float(cfg.get("top_p", 0.9)),
                temperature=float(cfg.get("temperature", 1.0)),
                prompt_emb_add=emb_add)
            grid = torch.clamp(toks, 0, C - 1).reshape(toks.shape[0], -1, K)
            sig = codec.toks_to_sig(grid).cpu().numpy()
            ref_np = np.asarray(batch["sig"])
            lens = np.asarray(batch["length"])
            rec_np = None
            if compute_ref:
                rec = codec.toks_to_sig(cache.get_batch(batch["ids"]),
                                        lens).cpu().numpy()
                rec_np = reconcile_length(rec, ref_np.shape[1])
            for i, r in enumerate(batch["rows"]):
                total_gen += 1
                uid = r["ID"]
                h = sig[i]
                s = trim_row(ref_np[i], lens[i])
                # UTMOS/DNSMOS on h alone, dWER and SpkSim against the
                # reference speech, untruncated (the lengths differ)
                battery.score_single(h, uid=uid)
                if battery.quality["dwer"] is not None:
                    battery.add("dWER", battery.quality["dwer"].metric(
                        [h], [s], sample_rate)[0])
                if battery.quality["spk"] is not None:
                    battery.add("SpkSim", battery.quality["spk"].metric(
                        h[None], s[None], sample_rate)[0])
                if n_dump < int(cfg.get("save_gen_audios", 4)):
                    write_wav(os.path.join(gen_dir, f"{uid}_tts.wav"), h,
                              sample_rate)
                    n_dump += 1
                if compute_ref:
                    rc = trim_row(rec_np[i], lens[i])
                    battery.score_pair(rc, s, prefix="Rec", uid=uid)
                    battery.score_single(s, prefix="Ref", uid=uid)
        summary["generated"] = total_gen
        summary.update(battery.summary())
        battery.write_stats(out_dir)

    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None):
    """``task.yaml codec.yaml dataset.yaml [--key value ...]``; ``--device
    cpu`` runs on the CPU (the card otherwise)."""
    from audiocodecs_tpu_torch.downstream.recipes.common import run_cli

    return run_cli(run_tts, argv)


if __name__ == "__main__":
    sys.exit(main())
