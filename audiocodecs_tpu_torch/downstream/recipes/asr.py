"""ASR recipe: CTC over codec tokens.

Counterpart of ``audiocodecs_tpu/downstream/recipes/asr.py`` (the
reference's ``train_asr.py``: a BiLSTM over pooled token embeddings → CTC →
greedy decoding → WER/CER, embedding pretraining from ``codec.embs()``, the
token cache and the token→character frequency matrix,
``train_asr.py:40-198,235-238``). The text tokenizer is ``char``, ``bpe``
or ``unigram`` (:mod:`..text`), trained on the train manifest.

The bidirectional LSTM is two one-layer LSTMs through
:func:`.classification.probe_lstm`: the forward one over the sequence, the
backward one over each row's valid frames reversed (:func:`masked_flip`);
each launches the LSTM kernel on the card. :func:`ctc_loss` is
``optax.ctc_loss``'s recursion in log space with its ``log_epsilon`` of
-1e5, so a row whose label cannot fit its frames has a large finite loss
(``torch.nn.functional.ctc_loss`` gives ``inf`` there, or 0 with
``zero_infinity``, and the trainer would skip the step or train on another
loss).

Run (``--device cpu`` for the CPU):
    python -m audiocodecs_tpu_torch.downstream.recipes.asr \\
        hparams/tasks/asr.yaml hparams/codecs/encodec.yaml \\
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
from audiocodecs_tpu_torch.downstream.recipes.classification import (
    encode_batch_fn,
    probe_lstm,
    probe_params_from_jax,
)
from audiocodecs_tpu_torch.downstream.recipes.trainer import (
    Trainer,
    trainer_kwargs,
    tree_map,
)
from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.nn.lstm import init_lstm_params

__all__ = ["asr_forward", "asr_loss", "asr_params_from_jax",
           "build_asr_params", "ctc_loss", "greedy_ctc_decode", "main",
           "masked_flip", "run_asr"]

asr_params_from_jax = probe_params_from_jax


def masked_flip(x: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Reverse each row of ``x`` [B, N, ...] within its valid length
    ``round(length · N)``; the padded tail stays in place."""
    B, N = x.shape[:2]
    abs_len = torch.round(length * N).to(torch.int64)[:, None]  # [B, 1]
    idx = torch.arange(N, device=x.device)[None, :]
    src = torch.where(idx < abs_len, abs_len - 1 - idx, idx)
    src = src.reshape(B, N, *([1] * (x.ndim - 2))).expand_as(x)
    return torch.gather(x, 1, src)


def build_asr_params(generator: torch.Generator, num_codebooks, vocab_size,
                     emb_dim, hidden, num_chars, codec_embs=None):
    """The recipe's param tree in the reference's layout (``embedding``,
    ``pool``, ``lstm_fwd``, ``lstm_bwd``, ``head``), float32 on the CPU;
    the embedding is the codec's codebooks when ``codec_embs`` is given.
    The draws differ from ``jax.random``'s."""
    if codec_embs is not None:
        emb = {"table": torch.from_numpy(
            fused_table_from_embs(codec_embs, vocab_size, emb_dim))}
    else:
        emb = init_multihead_embedding(generator, num_codebooks, vocab_size,
                                       emb_dim)
    return {
        "embedding": emb,
        "pool": init_weighted_pooling(generator, num_codebooks),
        "lstm_fwd": init_lstm_params(generator, 1, emb_dim, hidden),
        "lstm_bwd": init_lstm_params(generator, 1, emb_dim, hidden),
        "head": {
            "w": torch.randn(2 * hidden, num_chars, generator=generator)
            * hidden**-0.5,
            "b": torch.zeros(num_chars),
        },
    }


def asr_forward(params, toks, length, *, vocab_size):
    """``toks`` [B, N, K] → CTC logits [B, N, num_chars]."""
    x = multihead_embed(params["embedding"], toks, vocab_size=vocab_size)
    x = weighted_pooling(params["pool"], x)
    fwd = probe_lstm(x, params["lstm_fwd"])
    bwd = probe_lstm(masked_flip(x, length), params["lstm_bwd"])
    y = torch.cat([fwd, masked_flip(bwd, length)], dim=-1)
    with exact_fp32():
        return y @ params["head"]["w"] + params["head"]["b"]


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor,
             labels: torch.Tensor, label_paddings: torch.Tensor,
             blank_id: int = 0, log_epsilon: float = -1e5) -> torch.Tensor:
    """Per-row CTC loss [B] of ``optax.ctc_loss`` (Graves et al. 2006).

    ``logits`` [B, T, V]; ``logit_paddings`` [B, T] 1.0 on padded frames;
    ``labels`` [B, N] right-padded, ``label_paddings`` [B, N] 1.0 on
    padding. The forward variables run over time in log space, ``alpha``
    of blank states [B, N + 1] and of label states [B, N], with
    ``log_epsilon`` standing in for log 0 and for the forbidden
    transitions; a padded frame carries them unchanged. The loss is minus
    the blank state after the last label once the last label state is
    folded in."""
    B, T, _ = logits.shape
    N = labels.shape[1]
    labels = labels.to(torch.int64)
    logprobs = F.log_softmax(logits, dim=-1)
    label_lens = N - label_paddings.sum(dim=1).to(torch.int64)
    # repeat[b, n] = 1 where label n equals label n + 1
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype),
                   (0, 1))
    lp_phi = logprobs[:, :, blank_id].transpose(0, 1)[..., None]  # [T, B, 1]
    lp_emit = torch.gather(logprobs, 2, labels[:, None, :].expand(
        B, T, N)).transpose(0, 1)  # [T, B, N]
    pads = logit_paddings.to(logprobs.dtype).transpose(0, 1)[..., None]

    def add_phi(phi, score):  # logaddexp into phi[:, 1:]
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], score)],
                         dim=-1)

    emit = torch.full((B, N), log_epsilon, dtype=logprobs.dtype,
                      device=logits.device)
    phi = F.pad(emit, (1, 0))  # the first blank state starts at log 1
    for t in range(T):
        # emit-to-phi epsilon transition, except before a repeated label
        phi_eps = add_phi(phi, emit + log_epsilon * repeat)
        next_emit = torch.logaddexp(phi_eps[:, :-1] + lp_emit[t],
                                    emit + lp_emit[t])
        # self-loop, then emit-to-phi blank only before a repeated label
        next_phi = add_phi(phi_eps + lp_phi[t],
                           emit + lp_phi[t] + log_epsilon * (1.0 - repeat))
        pad = pads[t]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * phi + (1.0 - pad) * next_phi
    phi_last = add_phi(phi, emit)
    return -torch.gather(phi_last, 1, label_lens[:, None])[:, 0]


def greedy_ctc_decode(logits, length, blank_id: int = 0) -> list[list[int]]:
    """Argmax → collapse repeats → drop blanks, on the host (``logits``
    [B, N, V] and ``length`` [B], numpy arrays or tensors)."""
    logits = (logits.detach().cpu().numpy() if hasattr(logits, "detach")
              else np.asarray(logits))
    length = (length.detach().cpu().numpy() if hasattr(length, "detach")
              else np.asarray(length))
    out = []
    N = logits.shape[1]
    for b in range(logits.shape[0]):
        n = int(round(float(length[b]) * N))
        path = logits[b, :n].argmax(-1)
        seq, prev = [], -1
        for t in path:
            if t != prev and t != blank_id:
                seq.append(int(t))
            prev = t
        out.append(seq)
    return out


def asr_loss(params, batch, generator, *, vocab_size, blank_id):
    """Mean CTC loss of a batch (frames beyond ``round(length · N)`` are
    padding); aux is empty."""
    logits = asr_forward(params, batch["toks"], batch["length"],
                         vocab_size=vocab_size)
    N = logits.shape[1]
    frames = torch.round(batch["length"] * N)
    logit_pad = (torch.arange(N, device=logits.device)[None]
                 >= frames[:, None]).to(torch.float32)
    loss = ctc_loss(logits, logit_pad, batch["labels"], batch["label_pad"],
                    blank_id=blank_id).mean()
    return loss, {}


def run_asr(cfg: dict, device=None, init_params=None) -> dict:
    """Train and test the CTC recipe of ``cfg`` (task, codec and dataset
    axes merged) with the codec and the model on ``device`` (the card when
    ``None``; without CUDA that raises). ``init_params``: the initial tree
    in the reference's layout (numpy arrays) in place of the seeded init.
    Writes the checkpoints, ``token_cache.npz``, ``summary.json``,
    ``wer.txt`` and the frequency matrix under ``output_folder`` and
    returns the summary."""
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
    from audiocodecs_tpu_torch.downstream.metrics.external import (
        word_error_rate,
    )
    from audiocodecs_tpu_torch.downstream.recipes.common import (
        loader_kwargs,
        read_split_manifests,
        vocab_spec,
    )
    from audiocodecs_tpu_torch.downstream.text import build_tokenizer

    dev = resolve_device(device)
    sample_rate = int(cfg["sample_rate"])
    out_dir = cfg.get("output_folder", "results/asr")
    os.makedirs(out_dir, exist_ok=True)
    dump_config(cfg, out_dir)
    seed = int(cfg.get("seed", 0))

    rows = read_split_manifests(cfg)
    # the reference's default is a 1000-piece BPE over the train manifest
    # (asr.yaml:54-55,97-103); char stays available
    tokenizer = build_tokenizer(
        [r["wrd"] for r in rows["train"]],
        token_type=cfg.get("token_type", "char"),
        num_tokens=int(cfg.get("num_tokens", 1000)),
        character_coverage=float(cfg.get("character_coverage", 1.0)),
    )

    codec = build_codec(cfg, sample_rate, mode="encode", device=dev)
    K, C = codec.config.num_codebooks, vocab_spec(codec)
    cache = TokenCache(os.path.join(out_dir, "token_cache.npz"))
    augmenter = build_augmenter(cfg) if cfg.get("augment", False) else None
    encode_toks = encode_batch_fn(
        codec, cache, augmenter,
        torch.Generator(dev).manual_seed(seed + 17))

    emb_dim = int(cfg.get("embedding_dim_probe", 128))
    hidden = int(cfg.get("probe_hidden", 128))
    if init_params is not None:
        params = asr_params_from_jax(init_params, dev)
    else:
        params = build_asr_params(
            torch.Generator().manual_seed(seed), K, C, emb_dim, hidden,
            tokenizer.vocab_size,
            codec_embs=(codec.embs() if cfg.get("pretrain_embeddings", True)
                        else None))
        params = tree_map(lambda t: t.to(dev), params)

    max_label = int(cfg.get("max_label_len", 64))

    def encode_labels(batch):
        labels = np.zeros((len(batch["ids"]), max_label), np.int64)
        label_pad = np.ones((len(batch["ids"]), max_label), np.float32)
        for i, r in enumerate(batch["rows"]):
            ids = tokenizer.encode(r["wrd"])[:max_label]
            labels[i, : len(ids)] = ids
            label_pad[i, : len(ids)] = 0.0
        return (torch.from_numpy(labels).to(dev),
                torch.from_numpy(label_pad).to(dev))

    def loss_fn(params, batch, generator):
        return asr_loss(params, batch, generator, vocab_size=C,
                        blank_id=tokenizer.blank_id)

    def make_batches(split, shuffle, train: bool = False, rows_too=False):
        epoch_counter = itertools.count()

        def gen():
            next(epoch_counter)
            loader = BucketedLoader(
                rows[split], sample_rate, shuffle=shuffle, seed=seed,
                **loader_kwargs(cfg),
            )
            for batch in loader:
                labels, label_pad = encode_labels(batch)
                out = {
                    "toks": encode_toks(batch, train),
                    "length": torch.from_numpy(
                        np.asarray(batch["length"])).to(dev),
                    "labels": labels,
                    "label_pad": label_pad,
                }
                if rows_too:
                    out["rows"] = batch["rows"]
                yield out
        return gen

    def infer(params, batch):
        with torch.no_grad():
            return asr_forward(params, batch["toks"], batch["length"],
                               vocab_size=C)

    def wer_of(params, split):
        hyps, refs = [], []
        for batch in make_batches(split, False, rows_too=True)():
            logits = infer(params, batch)
            for seq, r in zip(
                greedy_ctc_decode(logits, batch["length"],
                                  tokenizer.blank_id),
                batch["rows"],
            ):
                hyps.append(tokenizer.decode(seq))
                refs.append(r["wrd"])
        wer = word_error_rate(hyps, refs)
        cer = word_error_rate(
            [" ".join(h.replace(" ", "_")) for h in hyps],
            [" ".join(r.replace(" ", "_")) for r in refs],
        )
        return wer, cer

    trainer = Trainer(loss_fn, params, lr=float(cfg.get("lr", 1e-3)),
                      output_folder=out_dir, **trainer_kwargs(cfg))
    trainer.fit(
        int(cfg.get("epochs", 5)),
        make_batches("train", True, train=True),
        valid_fn=lambda p: wer_of(p, "valid")[0],
        generator=torch.Generator(dev).manual_seed(seed),
    )
    cache.save()
    params = trainer.load_checkpoint("best")
    wer, cer = wer_of(params, "test")
    summary = {"test_WER": wer, "test_CER": cer,
               "vocab_size": tokenizer.vocab_size}

    # token→character frequency matrix (reference artifact,
    # train_asr.py:115-117,171-198): co-occurrence of codebook-0 tokens
    # with the frame-wise argmax character
    C0 = C[0] if isinstance(C, tuple) else C  # codebook-0 vocab
    freq = np.zeros((C0, tokenizer.vocab_size), np.int64)
    for batch in make_batches("test", False)():
        chars = infer(params, batch).argmax(-1).cpu().numpy()  # [B, N]
        toks0 = batch["toks"][..., 0].cpu().numpy()  # codebook 0
        N = chars.shape[1]
        valid = (np.arange(N)[None]
                 < batch["length"].cpu().numpy()[:, None] * N)
        np.add.at(freq, (toks0[valid], chars[valid]), 1)
    np.save(os.path.join(out_dir, "freq_matrix.npy"), freq)
    with open(os.path.join(out_dir, "freq_matrix.txt"), "w") as f:
        used = freq.sum(1) > 0
        f.write(f"# token->char frequency; {int(used.sum())}/{C} tokens seen\n")
        for t in np.nonzero(used)[0][:200]:
            top = freq[t].argmax()
            f.write(f"{t}\t{tokenizer.itos[top]}\t{int(freq[t, top])}\n")
    summary["tokens_seen"] = int(used.sum())
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    with open(os.path.join(out_dir, "wer.txt"), "w") as f:
        f.write(json.dumps(summary) + "\n")
    return summary


def main(argv=None):
    """``task.yaml codec.yaml dataset.yaml [--key value ...]``; ``--device
    cpu`` runs on the CPU (the card otherwise)."""
    from audiocodecs_tpu_torch.downstream.recipes.common import run_cli

    return run_cli(run_asr, argv)


if __name__ == "__main__":
    sys.exit(main())
