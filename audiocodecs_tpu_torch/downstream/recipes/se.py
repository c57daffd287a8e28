"""Speech enhancement (SE): token-to-token denoising.

Counterpart of ``audiocodecs_tpu/downstream/recipes/se.py`` (the reference's
``train_se.py``: noisy tokens → encoder → ``MultiHeadLinear`` → CE against
the clean tokens; at test time the argmax is vocoded and scored against the
clean signal, reference ``train_se.py:58-129,153-182``). The encoder is the
non-causal transformer stack (``encoder_type: transformer``, the default)
or the Conformer (``encoder_type: conformer``, :mod:`...nn.conformer`).

Noisy and clean audio are encoded together, in one codec call of 2B rows
(reference ``train_se.py:58-66``). SE keeps no token cache, so every batch
is encoded again in every epoch. The model is a :class:`TokenModel` (an
``nn.Module`` in the reference's tree: ``embedding``, ``pool``,
``encoder`` or ``conformer``, ``head``), trained by :class:`.trainer.
Trainer`; its checkpoints load in the JAX package and back.

Run (``--device cpu`` for the CPU):
    python -m audiocodecs_tpu_torch.downstream.recipes.se \\
        hparams/tasks/se.yaml hparams/codecs/encodec.yaml \\
        hparams/datasets/synthetic.yaml [--encoder_type conformer]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.downstream.models.multihead import (
    _vocab_list,
    init_multihead_embedding,
    init_multihead_linear,
    multihead_embed,
    multihead_logits,
)
from audiocodecs_tpu_torch.downstream.models.pooling import weighted_pooling
from audiocodecs_tpu_torch.nn.conformer import (
    Conformer,
    ConformerConfig,
    apply_conformer,
    init_conformer_params,
)
from audiocodecs_tpu_torch.nn.transformer import (
    Transformer,
    TransformerConfig,
    apply_transformer,
    init_transformer_params,
)
from audiocodecs_tpu_torch.utils.masking import length_mask

__all__ = ["TokenModel", "encoder_config", "init_token_model", "main",
           "run_se", "se_forward", "se_loss", "token_ce", "token_logits",
           "token_model_from_jax"]


class _Leaves(nn.Module):
    """Named parameter tensors of given shapes (``table``, ``logits``,
    ``w`` and ``b``): a leaf node of the reference's tree."""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(shape)))


class TokenModel(nn.Module):
    """Token grid in, per-codebook logits out: ``embedding.table``
    [ΣC, H], ``pool.logits`` [K], ``encoder`` (a :class:`...nn.transformer.
    Transformer`) or ``conformer`` (a :class:`...nn.conformer.Conformer`),
    ``head.w`` [H, Σ head vocabs] and ``head.b``. The SE model, and with
    S·K heads the SS one."""

    def __init__(self, num_codebooks: int, vocab_size, cfg_t,
                 num_heads: int | None = None, head_vocab=None):
        super().__init__()
        H = cfg_t.hidden_size
        num_heads = num_heads or num_codebooks
        head_vocab = vocab_size if head_vocab is None else head_vocab
        self.cfg_t = cfg_t
        self.embedding = _Leaves(
            table=(sum(_vocab_list(vocab_size, num_codebooks)), H))
        self.pool = _Leaves(logits=(num_codebooks,))
        if isinstance(cfg_t, ConformerConfig):
            self.conformer = Conformer(cfg_t)
        else:
            self.encoder = Transformer(cfg_t)
        out = sum(_vocab_list(head_vocab, num_heads))
        self.head = _Leaves(w=(H, out), b=(out,))


def encoder_config(cfg: dict):
    """The recipe's encoder config from the task's keys: a
    :class:`ConformerConfig` under ``encoder_type: conformer``, else the
    non-causal gelu/LayerNorm :class:`TransformerConfig`."""
    d_model = int(cfg.get("d_model", 256))
    heads = int(cfg.get("num_heads", 4))
    if cfg.get("encoder_type", "transformer") == "conformer":
        return ConformerConfig(
            hidden_size=d_model, num_layers=int(cfg.get("num_layers", 4)),
            num_heads=heads, conv_kernel=int(cfg.get("conv_kernel", 31)))
    return TransformerConfig(
        hidden_size=d_model, num_layers=int(cfg.get("num_layers", 4)),
        num_heads=heads, num_kv_heads=heads, head_dim=d_model // heads,
        intermediate_size=int(cfg.get("ffn_dim", 1024)), act="gelu",
        norm="layernorm", causal=False)


def init_token_model(generator: torch.Generator, num_codebooks: int,
                     vocab_size, cfg_t, num_heads: int | None = None,
                     head_vocab=None) -> TokenModel:
    """A :class:`TokenModel` on the CPU in the reference's distributions
    (the draws differ from ``jax.random``'s): the embedding N(0, 0.02²),
    the pool's logits 0, the encoder's own init, the head N(0, 1/H)."""
    model = TokenModel(num_codebooks, vocab_size, cfg_t, num_heads,
                       head_vocab)
    H = cfg_t.hidden_size
    sd = {"embedding.table": init_multihead_embedding(
        generator, num_codebooks, vocab_size, H)["table"],
        "pool.logits": torch.zeros(num_codebooks)}
    if isinstance(cfg_t, ConformerConfig):
        sd.update(init_conformer_params(generator, cfg_t, "conformer."))
    else:
        sd.update(init_transformer_params(generator, cfg_t, "encoder."))
    head = init_multihead_linear(
        generator, H, num_heads or num_codebooks,
        vocab_size if head_vocab is None else head_vocab)
    sd.update({"head.w": head["w"], "head.b": head["b"]})
    model.load_state_dict(sd, strict=True)
    return model


def token_model_from_jax(tree, num_codebooks: int, vocab_size, cfg_t,
                         num_heads: int | None = None, head_vocab=None,
                         device=None) -> TokenModel:
    """The reference's tree (numpy arrays) as a :class:`TokenModel` on
    ``device``."""
    from audiocodecs_tpu_torch.params import from_jax_params

    model = TokenModel(num_codebooks, vocab_size, cfg_t, num_heads,
                       head_vocab)
    model.load_state_dict(from_jax_params(tree, model), strict=True)
    return model.to(device)


def token_logits(model: TokenModel, toks: torch.Tensor, *, vocab_size,
                 num_heads: int, head_vocab) -> torch.Tensor:
    """``toks`` [B, N, K] → logits [B, N, num_heads, C]: embed, pool the
    codebooks, encode, the fused head."""
    x = multihead_embed({"table": model.embedding.table}, toks,
                        vocab_size=vocab_size)
    x = weighted_pooling({"logits": model.pool.logits}, x)  # [B, N, H]
    if isinstance(model.cfg_t, ConformerConfig):
        x = apply_conformer(model.conformer, x, model.cfg_t)
    else:
        x = apply_transformer(model.encoder, x, model.cfg_t)
    return multihead_logits({"w": model.head.w, "b": model.head.b}, x,
                            num_heads=num_heads, vocab_size=head_vocab)


def se_forward(model: TokenModel, toks, *, vocab_size, num_codebooks):
    """``toks`` [B, N, K] → per-codebook logits [B, N, K, C]."""
    return token_logits(model, toks, vocab_size=vocab_size,
                        num_heads=num_codebooks, head_vocab=vocab_size)


def token_ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Cross-entropy ``[...]`` of logits ``[..., C]`` against integer
    targets ``[...]`` (optax's ``softmax_cross_entropy_with_integer_
    labels``)."""
    C = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, C), target.reshape(-1).to(
        torch.int64), reduction="none").reshape(target.shape)


def se_loss(model, batch, generator, *, vocab_size, num_codebooks):
    """Masked mean CE of the clean tokens; aux is empty."""
    logits = se_forward(model, batch["in_toks"], vocab_size=vocab_size,
                        num_codebooks=num_codebooks)
    ce = token_ce(logits, batch["out_toks"])  # [B, N, K]
    mask = length_mask(batch["length"], ce.shape[1],
                       dtype=ce.dtype)[..., None]
    loss = (ce * mask).sum() / torch.clamp(mask.sum() * num_codebooks,
                                           min=1.0)
    return loss, {}


def run_se(cfg: dict, device=None, init_params=None) -> dict:
    """Train and test the SE recipe of ``cfg`` (task, codec and dataset
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
    from audiocodecs_tpu_torch.downstream.recipes.quality import (
        PairBattery,
        trim_row,
    )
    from audiocodecs_tpu_torch.downstream.recipes.trainer import (
        Trainer,
        trainer_kwargs,
    )
    from audiocodecs_tpu_torch.utils.audio import read_wav

    dev = resolve_device(device)
    sample_rate = int(cfg["sample_rate"])
    out_dir = cfg.get("output_folder", "results/se")
    os.makedirs(out_dir, exist_ok=True)
    dump_config(cfg, out_dir)
    seed = int(cfg.get("seed", 0))

    rows = read_split_manifests(cfg)
    codec = build_codec(cfg, sample_rate, device=dev)
    K, C = codec.config.num_codebooks, vocab_spec(codec)
    cfg_t = encoder_config(cfg)
    if init_params is not None:
        model = token_model_from_jax(init_params, K, C, cfg_t, device=dev)
    else:
        model = init_token_model(torch.Generator().manual_seed(seed), K, C,
                                 cfg_t).to(dev)

    def encode_pair_batch(batch):
        """Noisy and clean in ONE codec call of 2B rows (reference
        ``train_se.py:58-66``) → (noisy toks, clean toks, clean audio)."""
        noisy = batch["sig"]
        clean = read_field_signals(batch, "wav")
        both = np.concatenate([noisy, clean], axis=0)
        lens = np.concatenate([batch["length"], batch["length"]])
        toks = codec.sig_to_toks(both, lens).clone()
        B = noisy.shape[0]
        return toks[:B], toks[B:], clean

    def loss_fn(model, batch, generator):
        return se_loss(model, batch, generator, vocab_size=C,
                       num_codebooks=K)

    def make_batches(split, shuffle, with_audio=False):
        def gen():
            loader = BucketedLoader(
                rows[split], sample_rate, shuffle=shuffle, seed=seed,
                read_fn=lambda r: read_wav(r["noisy_wav"])[0][0],
                **loader_kwargs(cfg),
            )
            for batch in loader:
                in_toks, out_toks, clean = encode_pair_batch(batch)
                out = {"in_toks": in_toks, "out_toks": out_toks,
                       "length": torch.from_numpy(
                           np.asarray(batch["length"])).to(dev)}
                if with_audio:
                    out["clean"] = clean
                    out["ids"] = batch["ids"]
                yield out
        return gen

    def enhance(model, toks):
        with torch.no_grad():
            return torch.argmax(se_forward(model, toks, vocab_size=C,
                                           num_codebooks=K), dim=-1)

    def token_error_rate(model, split):
        correct = total = 0
        for batch in make_batches(split, False)():
            pred = enhance(model, batch["in_toks"]).cpu().numpy()
            want = batch["out_toks"].cpu().numpy()
            N = want.shape[1]
            # float32 compare, as the reference's mask
            m = (np.arange(N)[None, :, None]
                 < batch["length"].cpu().numpy()[:, None, None] * N)
            correct += int((pred == want)[np.broadcast_to(m, pred.shape)]
                           .sum())
            total += int(m.sum() * K)
        return 1.0 - correct / max(total, 1)

    trainer = Trainer(loss_fn, model, lr=float(cfg.get("lr", 1e-3)),
                      output_folder=out_dir, **trainer_kwargs(cfg))
    trainer.fit(
        int(cfg.get("epochs", 5)),
        make_batches("train", True),
        valid_fn=lambda m: token_error_rate(m, "valid"),
        generator=torch.Generator(dev).manual_seed(seed),
    )
    model = trainer.load_checkpoint("best")

    # Test: vocode the enhanced tokens, score the battery against clean
    # (reference train_se.py:153-161; Rec rows on the clean tokens' decode
    # and Ref rows on the clean signal under compute_ref_metrics, :164-182)
    battery = PairBattery(cfg, sample_rate, device=dev)
    compute_ref = bool(cfg.get("compute_ref_metrics", False))
    sisnrs = []
    for batch in make_batches("test", False, with_audio=True)():
        sig = codec.toks_to_sig(enhance(model, batch["in_toks"]))
        T = min(sig.shape[1], batch["clean"].shape[1])
        sisnrs.extend(si_snr(sig[:, :T], torch.from_numpy(
            batch["clean"][:, :T]).to(dev)).tolist())
        sig = sig.cpu().numpy()
        rec = (codec.toks_to_sig(batch["out_toks"]).cpu().numpy()
               if compute_ref else None)
        lens = batch["length"].cpu().numpy()
        for i in range(sig.shape[0]):
            uid = batch["ids"][i]
            h = trim_row(sig[i], lens[i])
            c = trim_row(batch["clean"][i], lens[i])
            battery.score_pair(h, c, uid=uid)
            if compute_ref:
                battery.score_pair(trim_row(rec[i], lens[i]), c,
                                   prefix="Rec", uid=uid)
                battery.score_single(c, prefix="Ref", uid=uid)
    summary = {
        "test_TER": token_error_rate(model, "test"),
        "test_SISNR": float(np.mean(sisnrs)) if sisnrs else float("nan"),
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

    return run_cli(run_se, argv)


if __name__ == "__main__":
    sys.exit(main())
