"""UTMOS (UTMOS22 strong) predicted MOS, PyTorch.

Counterpart of ``audiocodecs_tpu/downstream/metrics/utmos.py``. The
reference downloads ``tarepan/SpeechMOS`` ``utmos22_strong`` through
torch.hub (reference ``metrics/utmos.py:30-54``); here the architecture
runs on the card from a converted checkpoint:

  wav [B, T] at 16 kHz → wav2vec2-base features [B, N, 768] (the port's
  WavLM tower, ``gated_rel_pos=False``)
    ⊕ domain embedding (id 0) [128] ⊕ judge embedding (the mean
    listener) [128]
  → BiLSTM(1024 → 2 · 512) → Linear(1024 → 2048) → ReLU → Linear(2048 → 1)
  → mean over frames → × 2 + 3.

The BiLSTM's recurrences run through the LSTM kernel
(``ops/lstm_recurrence.py``) on the card, two launches a layer (or more
where the rows exceed one launch). Every product runs in exact fp32 (TF32
off). :func:`apply_utmos_padded` scores zero-padded rows through
:func:`..nn.lstm.bilstm_masked` and a masked frame mean, so a few padded
shapes serve every length (``bucket_seconds``).

Weights keep the reference's names: ``ssl.*`` (:class:`..nn.wavlm.WavLM`),
``domain_emb [domains, 128]``, ``judge_emb [judges, 128]``,
``blstm.0.{fwd,bwd}.{w_ih,w_hh,b}``, ``head_in`` and ``head_out``
(``w [in, out]``, ``b``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.nn.lstm import BiLSTM, bilstm, bilstm_masked
from audiocodecs_tpu_torch.nn.transformer import Linear, _linear
from audiocodecs_tpu_torch.nn.wavlm import (
    WavLM,
    WavLMConfig,
    apply_wavlm,
    init_wavlm_params,
)

__all__ = ["UTMOSConfig", "UTMOS", "init_utmos_params", "score_from_feats",
           "apply_utmos", "conv_frames", "apply_utmos_padded",
           "utmos_schema", "convert_utmos_state_dict", "load_utmos",
           "make_utmos_checkpoint_metric"]


def _w2v2_base() -> WavLMConfig:
    # facebook/wav2vec2-base: plain softmax attention (no gated rel-pos),
    # post-norm encoder, group-norm feature extractor, no conv bias.
    return WavLMConfig(gated_rel_pos=False)


@dataclasses.dataclass(frozen=True)
class UTMOSConfig:
    ssl: WavLMConfig = dataclasses.field(default_factory=_w2v2_base)
    emb_dim: int = 128
    num_domains: int = 3
    num_judges: int = 3380
    blstm_hidden: int = 512
    proj_hidden: int = 2048
    domain_id: int = 0
    judge_id: int = 288  # mean-listener id used at inference (speechmos)

    @property
    def feat_dim(self) -> int:
        return self.ssl.hidden_size + 2 * self.emb_dim


class UTMOS(nn.Module):
    """The predictor's weights; :func:`apply_utmos` runs it."""

    def __init__(self, cfg: UTMOSConfig):
        super().__init__()
        self.cfg = cfg
        self.ssl = WavLM(cfg.ssl)
        self.domain_emb = nn.Parameter(torch.empty(cfg.num_domains,
                                                   cfg.emb_dim))
        self.judge_emb = nn.Parameter(torch.empty(cfg.num_judges,
                                                  cfg.emb_dim))
        self.blstm = BiLSTM(1, cfg.feat_dim, cfg.blstm_hidden)
        self.head_in = Linear(2 * cfg.blstm_hidden, cfg.proj_hidden, True)
        self.head_out = Linear(cfg.proj_hidden, 1, True)


def init_utmos_params(generator: torch.Generator, cfg: UTMOSConfig) -> dict:
    """Random weights of :class:`UTMOS` as a state dict, in the reference's
    distributions (the tower's as :func:`..nn.wavlm.init_wavlm_params`,
    embeddings N(0, 0.02²), the LSTM U(±1/√H) with zero bias, the head
    N(0, 1/in) with zero biases); the draws differ from the reference's."""
    from audiocodecs_tpu_torch.nn.lstm import init_bilstm_params
    from audiocodecs_tpu_torch.params import flatten_tree

    h2 = 2 * cfg.blstm_hidden
    out = init_wavlm_params(generator, cfg.ssl, prefix="ssl.")
    out["domain_emb"] = torch.randn(cfg.num_domains, cfg.emb_dim,
                                    generator=generator) * 0.02
    out["judge_emb"] = torch.randn(cfg.num_judges, cfg.emb_dim,
                                   generator=generator) * 0.02
    lstm = init_bilstm_params(generator, 1, cfg.feat_dim, cfg.blstm_hidden)
    out.update({f"blstm.{k}": v for k, v in flatten_tree(lstm).items()})
    out["head_in.w"] = torch.randn(h2, cfg.proj_hidden,
                                   generator=generator) * h2 ** -0.5
    out["head_in.b"] = torch.zeros(cfg.proj_hidden)
    out["head_out.w"] = torch.randn(cfg.proj_hidden, 1, generator=generator
                                    ) * cfg.proj_hidden ** -0.5
    out["head_out.b"] = torch.zeros(1)
    return out


def _features(model: UTMOS, feats: torch.Tensor) -> torch.Tensor:
    """SSL features [B, N, H] ⊕ the domain and judge embeddings."""
    cfg = model.cfg
    B, N = feats.shape[:2]
    cond = torch.cat([model.domain_emb[cfg.domain_id],
                      model.judge_emb[cfg.judge_id]])
    return torch.cat([feats, cond.expand(B, N, -1)], dim=-1)


def _head(model: UTMOS, x: torch.Tensor) -> torch.Tensor:
    """[B, N, 2H] → frame scores [B, N]."""
    x = torch.relu(_linear(x, model.head_in))
    return _linear(x, model.head_out)[..., 0]


def score_from_feats(model: UTMOS, feats: torch.Tensor) -> torch.Tensor:
    """SSL features [B, N, H] → predicted MOS [B]."""
    x = bilstm(_features(model, feats), [p.params() for p in model.blstm])
    return torch.mean(_head(model, x), dim=1) * 2.0 + 3.0


def apply_utmos(model: UTMOS, wav: torch.Tensor) -> torch.Tensor:
    """``wav`` [B, T] at 16 kHz → predicted MOS [B] (1-5 scale)."""
    with exact_fp32():
        return score_from_feats(model, apply_wavlm(model.ssl, wav,
                                                   model.cfg.ssl))


def conv_frames(n_samples, cfg: UTMOSConfig):
    """Valid-frame count of the SSL feature extractor for a waveform of
    ``n_samples`` (n = (n - k) // s + 1 a conv); ints or an int tensor."""
    n = n_samples
    for k, s in zip(cfg.ssl.conv_kernel, cfg.ssl.conv_stride):
        n = (n - k) // s + 1
    return n


def apply_utmos_padded(model: UTMOS, wav: torch.Tensor,
                       n_samples: torch.Tensor) -> torch.Tensor:
    """MOS over zero-padded rows ``wav`` [B, Tb] of ``n_samples`` [B]
    valid samples: the head runs :func:`..nn.lstm.bilstm_masked` and a
    masked frame mean over the valid frames only (equal to the unpadded
    head on the same features). The SSL tower attends over the padded
    frames too, as the reference's does."""
    cfg = model.cfg
    with exact_fp32():
        feats = apply_wavlm(model.ssl, wav, cfg.ssl)  # [B, Nb, H]
        Nb = feats.shape[1]
        n_valid = torch.clamp(conv_frames(n_samples.to(torch.long), cfg),
                              max=Nb)
        x = bilstm_masked(_features(model, feats),
                          [p.params() for p in model.blstm], n_valid)
        frames = _head(model, x)
    mask = (torch.arange(Nb, device=wav.device)[None]
            < n_valid[:, None]).to(frames.dtype)
    mean = (frames * mask).sum(1) / torch.clamp(n_valid, min=1)
    return mean * 2.0 + 3.0


def utmos_schema(cfg: UTMOSConfig, layout: str = "hub") -> dict:
    """Torch key → shape map of the two vendor layouts, as the reference's
    ``utmos_schema``: ``"hub"`` (``tarepan/SpeechMOS``'s ``utmos22_strong``,
    what the reference loads: ``wav2vec2.*``, single-vector
    ``domain_emb``/``judge_emb``, a ``projection`` head) and
    ``"lightning"`` (the sarulab-speech/UTMOS22 training checkpoint:
    ``ssl.*``, full embedding tables, a ``head``)."""
    from audiocodecs_tpu_torch.convert.zoo import wavlm_schema

    E, h = cfg.emb_dim, cfg.blstm_hidden
    if layout == "hub":
        s = dict(wavlm_schema(cfg.ssl, prefix="wav2vec2."))
        s["domain_emb"] = (E,)
        s["judge_emb"] = (E,)
        head = "projection"
    elif layout == "lightning":
        s = dict(wavlm_schema(cfg.ssl, prefix="ssl."))
        s["domain_emb.weight"] = (cfg.num_domains, E)
        s["judge_emb.weight"] = (cfg.num_judges, E)
        head = "head"
    else:
        raise ValueError(f"unknown utmos layout {layout!r}")
    for suffix in ("", "_reverse"):
        s[f"blstm.weight_ih_l0{suffix}"] = (4 * h, cfg.feat_dim)
        s[f"blstm.weight_hh_l0{suffix}"] = (4 * h, h)
        s[f"blstm.bias_ih_l0{suffix}"] = (4 * h,)
        s[f"blstm.bias_hh_l0{suffix}"] = (4 * h,)
    s[f"{head}.0.weight"] = (cfg.proj_hidden, 2 * h)
    s[f"{head}.0.bias"] = (cfg.proj_hidden,)
    s[f"{head}.3.weight"] = (1, cfg.proj_hidden)
    s[f"{head}.3.bias"] = (1,)
    return s


def convert_utmos_state_dict(sd, cfg: UTMOSConfig, key_map=None) -> dict:
    """A vendor checkpoint (hub or lightning, detected) → :class:`UTMOS`'s
    state dict, strict as the reference's: a key it does not read raises.
    The hub layout's single embedding vectors are tiled into the tables so
    any ``domain_id``/``judge_id`` reads them. ``key_map`` is an overlay
    (``convert/overlay.py``) applied first."""
    from audiocodecs_tpu_torch.convert.overlay import apply_key_map
    from audiocodecs_tpu_torch.convert.torch_utils import (
        as_state_dict,
        put_lstm,
        to_np,
    )
    from audiocodecs_tpu_torch.convert.wavlm import convert_wavlm_state_dict
    from audiocodecs_tpu_torch.convert.zoo import (
        _TrackingDict,
        _unmapped,
        wavlm_schema,
    )

    sd = _TrackingDict(apply_key_map(sd, key_map))
    hub = "projection.0.weight" in sd or any(
        k.startswith("wav2vec2.") for k in sd)
    ssl_prefix = "wav2vec2." if hub else "ssl."
    head = "projection" if hub else "head"

    def f32(k):
        return to_np(sd[k]).astype(np.float32)

    out = {}
    if "domain_emb.weight" in sd:  # lightning: full tables
        out["domain_emb"] = f32("domain_emb.weight")
        out["judge_emb"] = f32("judge_emb.weight")
    else:  # hub: the inference vectors, tiled into the tables
        out["domain_emb"] = np.tile(f32("domain_emb").reshape(-1),
                                    (cfg.num_domains, 1))
        out["judge_emb"] = np.tile(f32("judge_emb").reshape(-1),
                                   (cfg.num_judges, 1))
    put_lstm(out, "blstm", sd, "blstm", 1, (("fwd", ""), ("bwd", "_reverse")))
    for dst, src in (("head_in", f"{head}.0"), ("head_out", f"{head}.3")):
        out[f"{dst}.w"] = np.ascontiguousarray(f32(f"{src}.weight").T)
        out[f"{dst}.b"] = f32(f"{src}.bias")
    state = {f"ssl.{k}": v for k, v in convert_wavlm_state_dict(
        sd, cfg.ssl, prefix=ssl_prefix).items()}
    sd.read.update(k for k in wavlm_schema(cfg.ssl, prefix=ssl_prefix)
                   if k in sd)
    extra = _unmapped(sd, sd.read)
    if extra:
        raise ValueError(
            f"utmos: {len(extra)} unmapped checkpoint keys — schema drift "
            f"from the documented layouts (hub/lightning, see "
            f"utmos_schema). First few: {extra[:8]}")
    state.update(as_state_dict(out))
    return state


def load_utmos(path: str, cfg: UTMOSConfig | None = None,
               device=None) -> UTMOS:
    """:class:`UTMOS` with the weights of ``path`` (a converted ``.npz``
    param tree, the reference's format, or a ``.pt`` state dict) on
    ``device`` (the card when ``None``)."""
    from audiocodecs_tpu_torch.codec import resolve_device
    from audiocodecs_tpu_torch.utils.checkpoint import load_model_state

    dev = resolve_device(device)
    model = UTMOS(cfg or UTMOSConfig())
    model.load_state_dict(load_model_state(path, model), strict=True)
    return model.to(dev).eval()


def make_utmos_checkpoint_metric(params_path: str,
                                 cfg: UTMOSConfig | None = None,
                                 bucket_seconds: float = 0.0, device=None):
    """UTMOS ``MetricStats`` from a converted checkpoint, on ``device``
    (the card when ``None``); the reference's ``make_utmos_jax_metric``.

    ``bucket_seconds > 0`` pads each utterance up to the next multiple and
    scores it through :func:`apply_utmos_padded`, so a few shapes serve
    every length (the head's masking is exact; the tower sees the zero
    padding). The default 0 scores each utterance at its own length."""
    from audiocodecs_tpu_torch.downstream.metrics.base import MetricStats
    from audiocodecs_tpu_torch.resample import resample

    model = load_utmos(params_path, cfg, device)
    dev = next(model.parameters()).device

    def one(s: np.ndarray) -> float:
        s = np.asarray(s, np.float32)
        with torch.inference_mode():
            if bucket_seconds > 0:
                step = max(1, int(round(bucket_seconds * 16000)))
                pad_to = ((s.shape[-1] + step - 1) // step) * step
                padded = np.zeros((1, pad_to), np.float32)
                padded[0, : s.shape[-1]] = s
                n = torch.tensor([s.shape[-1]], device=dev)
                return float(apply_utmos_padded(
                    model, torch.from_numpy(padded).to(dev), n)[0])
            return float(apply_utmos(model,
                                     torch.from_numpy(s).to(dev)[None])[0])

    def metric(sigs, sample_rate: int):
        if sample_rate != 16000:
            sigs = [resample(torch.as_tensor(np.asarray(s, np.float32))[None],
                             sample_rate, 16000)[0].numpy() for s in sigs]
        return [one(s) for s in sigs]

    stats = MetricStats(metric, name="UTMOS")
    stats.model = model
    return stats
