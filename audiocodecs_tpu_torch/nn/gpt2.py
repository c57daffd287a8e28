"""GPT-2 causal LM (the ASR-perplexity scorer), PyTorch.

Counterpart of ``audiocodecs_tpu/nn/gpt2.py``. The reference scores
transcripts with the perplexity of a downloaded HF causal LM (default
``gpt2-large``, reference ``downstream/metrics/perplexity.py:33-57``); here
the GPT-2 architecture runs on the card from a converted checkpoint
(:func:`..convert.gpt2.convert_gpt2_state_dict`): pre-LN blocks of fused
``qkv`` attention (:func:`..nn.transformer.attention`, causal) and a
tanh-GELU MLP, the LM head tied to the token embedding. Every product runs
with TF32 off.

Weights keep the reference's names: ``wte``, ``wpe``,
``layers.<i>.{ln1, attn.qkv, attn.o, ln2, mlp.fc1, mlp.fc2}``, ``ln_f``
(linears ``w [in, out]`` with ``b``, as HF's ``Conv1D`` stores them).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.nn.transformer import (
    Linear,
    Norm,
    _linear,
    _norm,
    attention,
    causal_mask,
)

__all__ = ["GPT2Config", "GPT2", "init_gpt2_params", "gpt2_logits",
           "gpt2_nll"]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """Mirrors the HF ``GPT2Config`` fields the forward needs."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    # shared by the checkpoint converter and the metric's config.json
    # loader
    _HF_FIELDS = {
        "vocab_size": "vocab_size",
        "n_positions": "n_positions",
        "n_embd": "n_embd",
        "n_layer": "n_layer",
        "n_head": "n_head",
        "norm_eps": "layer_norm_epsilon",
    }

    @classmethod
    def from_hf_dict(cls, d: dict) -> "GPT2Config":
        """Build from an HF ``config.json`` dict (KeyError on missing
        architecture fields; the norm eps defaults as HF's)."""
        kw = {ours: d[hf] for ours, hf in cls._HF_FIELDS.items()
              if ours != "norm_eps"}
        kw["norm_eps"] = d.get("layer_norm_epsilon", 1e-5)
        return cls(**kw)


class _Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.qkv, self.o = Linear(d, 3 * d, True), Linear(d, d, True)


class _MLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.fc1, self.fc2 = Linear(d, 4 * d, True), Linear(4 * d, d, True)


class _Block(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.ln1, self.attn = Norm(d, "layernorm"), _Attention(d)
        self.ln2, self.mlp = Norm(d, "layernorm"), _MLP(d)


class GPT2(nn.Module):
    """The LM's weights and its config; :func:`gpt2_logits` runs it."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        D = cfg.n_embd
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, D))
        self.wpe = nn.Parameter(torch.empty(cfg.n_positions, D))
        self.layers = nn.ModuleList(_Block(D) for _ in range(cfg.n_layer))
        self.ln_f = Norm(D, "layernorm")


def init_gpt2_params(generator: torch.Generator, cfg: GPT2Config) -> dict:
    """Random weights of :class:`GPT2` as a state dict on the generator's
    device, in the reference's distributions (linears and ``wte``
    N(0, 0.02²), ``wpe`` N(0, 0.01²), zero biases, norms 1 and 0); the
    draws differ from the reference's."""
    dev = generator.device
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in GPT2(cfg).state_dict().items()}
    out = {}
    for k, shape in shapes.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "g":
            out[k] = torch.ones(shape, device=dev)
        elif leaf == "b":
            out[k] = torch.zeros(shape, device=dev)
        else:
            scale = 0.01 if k == "wpe" else 0.02
            out[k] = torch.randn(shape, generator=generator,
                                 device=dev) * scale
    return out


def gpt2_logits(model: GPT2, tokens: torch.Tensor) -> torch.Tensor:
    """``tokens`` [B, L] → next-token logits [B, L, V] (tied LM head)."""
    cfg = model.cfg
    B, L = tokens.shape
    Hd, Dd, eps = cfg.n_head, cfg.head_dim, cfg.norm_eps
    x = model.wte[tokens] + model.wpe[None, :L]
    mask = causal_mask(L, L, device=x.device)
    for p in model.layers:
        h = _norm(x, p.ln1, "layernorm", eps)
        qkv = _linear(h, p.attn.qkv).reshape(B, L, 3, Hd, Dd)
        a = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask=mask)
        x = x + _linear(a.reshape(B, L, Hd * Dd), p.attn.o)
        h = _norm(x, p.ln2, "layernorm", eps)
        x = x + _linear(F.gelu(_linear(h, p.mlp.fc1), approximate="tanh"),
                        p.mlp.fc2)
    x = _norm(x, model.ln_f, "layernorm", eps)
    with exact_fp32():
        return torch.matmul(x, model.wte.T)


def gpt2_nll(model: GPT2, tokens: torch.Tensor,
             lengths: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL of each sequence (HF's ``labels=input_ids``
    loss): ``tokens`` [B, L] padded, ``lengths`` [B] the true lengths; the
    mean is over each row's ``lengths - 1`` shifted positions."""
    logits = gpt2_logits(model, tokens)
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    tgt = tokens[:, 1:]
    tok_lp = torch.gather(logp, -1, tgt[..., None])[..., 0]
    pos = torch.arange(tgt.shape[1], device=tokens.device)[None]
    valid = pos < (lengths.to(tokens.device)[:, None] - 1)
    n = torch.clamp(valid.sum(dim=1), min=1)
    return -torch.where(valid, tok_lp, 0.0).sum(dim=1) / n
