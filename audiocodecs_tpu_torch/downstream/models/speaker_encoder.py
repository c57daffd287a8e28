"""Speaker embedding model: the WavLM x-vector, PyTorch.

Counterpart of ``audiocodecs_tpu/downstream/models/speaker_encoder.py``
(reference ``downstream/models/speaker_encoder.py:31-68`` wraps HF
``AutoModelForAudioXVector``): the WavLM tower (:mod:`..nn.wavlm`) → a
softmax-weighted sum of its hidden states → projector → five dilated TDNN
layers (valid convs, ReLU) → statistics pooling (mean and unbiased std) →
linear → the x-vector. Weight-compatible with HF ``WavLMForXVector``
(``microsoft/wavlm-base-plus-sv``) through
:func:`convert_xvector_state_dict`; used by the speaker-similarity metric.
Every product and conv runs in exact fp32 (TF32 off).

Weights keep the reference's names: ``wavlm.*``, ``layer_weights [L+1]``,
``projector`` and ``feature_extractor`` (``w [in, out]``, ``b``) and
``tdnn.<i>`` (a conv, ``w [Cout, Cin, k]`` here).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from audiocodecs_tpu_torch.nn.layers import Conv1d, conv1d, exact_fp32
from audiocodecs_tpu_torch.nn.transformer import Linear, _linear
from audiocodecs_tpu_torch.nn.wavlm import WavLM, WavLMConfig, apply_wavlm

__all__ = ["XVectorConfig", "XVector", "apply_xvector",
           "convert_xvector_state_dict", "init_xvector_params",
           "load_xvector", "xvector_schema"]


@dataclasses.dataclass(frozen=True)
class XVectorConfig:
    wavlm: WavLMConfig = dataclasses.field(default_factory=WavLMConfig)
    tdnn_dim: tuple[int, ...] = (512, 512, 512, 512, 1500)
    tdnn_kernel: tuple[int, ...] = (5, 3, 3, 1, 1)
    tdnn_dilation: tuple[int, ...] = (1, 2, 3, 1, 1)
    xvector_dim: int = 512
    use_weighted_layer_sum: bool = True


class XVector(nn.Module):
    """The encoder's weights; :func:`apply_xvector` runs it."""

    def __init__(self, cfg: XVectorConfig):
        super().__init__()
        self.cfg = cfg
        self.wavlm = WavLM(cfg.wavlm)
        if cfg.use_weighted_layer_sum:
            self.layer_weights = nn.Parameter(
                torch.empty(cfg.wavlm.num_layers + 1))
        self.projector = Linear(cfg.wavlm.hidden_size, cfg.tdnn_dim[0], True)
        cins = (cfg.tdnn_dim[0], *cfg.tdnn_dim[:-1])
        self.tdnn = nn.ModuleList(
            Conv1d(cin, cout, k)
            for cin, cout, k in zip(cins, cfg.tdnn_dim, cfg.tdnn_kernel))
        self.feature_extractor = Linear(2 * cfg.tdnn_dim[-1],
                                        cfg.xvector_dim, True)


def apply_xvector(model: XVector, sig: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` waveform at 16 kHz → x-vector embeddings
    ``[B, xvector_dim]``."""
    cfg = model.cfg
    with exact_fp32():
        if cfg.use_weighted_layer_sum:
            hidden = apply_wavlm(model.wavlm, sig, cfg.wavlm,
                                 output_hidden_states=True)  # [L+1,B,N,H]
            w = torch.softmax(model.layer_weights, dim=0)
            x = torch.einsum("l,lbnh->bnh", w, hidden)
        else:
            x = apply_wavlm(model.wavlm, sig, cfg.wavlm)
        x = _linear(x, model.projector).transpose(1, 2)  # [B, C, N]
        for p, d in zip(model.tdnn, cfg.tdnn_dilation):
            x = torch.relu(conv1d(x, p.w, p.b, dilation=d))
        mean = torch.mean(x, dim=2)
        n = x.shape[2]
        # unbiased std (torch's .std default)
        var = torch.sum((x - mean[..., None]) ** 2, dim=2) / max(n - 1, 1)
        stats = torch.cat([mean, torch.sqrt(var)], dim=-1)
        return _linear(stats, model.feature_extractor)


def init_xvector_params(generator: torch.Generator,
                        cfg: XVectorConfig) -> dict:
    """Seeded random weights of :class:`XVector` as a state dict: the
    tower's as :func:`..nn.wavlm.init_wavlm_params`, linears and convs
    N(0, 1/fan-in), biases N(0, 0.1²), layer weights N(0, 1)."""
    from audiocodecs_tpu_torch.nn.wavlm import init_wavlm_params

    out = init_wavlm_params(generator, cfg.wavlm, prefix="wavlm.")
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in XVector(cfg).state_dict().items()
                  if not k.startswith("wavlm.")}
    for k, shape in shapes.items():
        t = torch.randn(shape, generator=generator)
        if k.startswith("tdnn.") and k.endswith(".w"):  # [Cout, Cin, k]
            t = t * int(np.prod(shape[1:])) ** -0.5
        elif k.endswith(".w"):  # a linear [in, out]
            t = t * shape[0] ** -0.5
        elif k.endswith(".b"):
            t = t * 0.1
        out[k] = t
    return out


def xvector_schema(cfg: XVectorConfig) -> dict:
    """HF ``WavLMForXVector``'s key → shape map (the parts the encoder
    reads, ``objective.weight`` of the training loss beside them)."""
    from audiocodecs_tpu_torch.convert.zoo import wavlm_schema

    s = dict(wavlm_schema(cfg.wavlm, prefix="wavlm."))
    if cfg.use_weighted_layer_sum:
        s["layer_weights"] = (cfg.wavlm.num_layers + 1,)
    s["projector.weight"] = (cfg.tdnn_dim[0], cfg.wavlm.hidden_size)
    s["projector.bias"] = (cfg.tdnn_dim[0],)
    cins = (cfg.tdnn_dim[0], *cfg.tdnn_dim[:-1])
    for i, (cin, cout, k) in enumerate(zip(cins, cfg.tdnn_dim,
                                           cfg.tdnn_kernel)):
        s[f"tdnn.{i}.kernel.weight"] = (cout, k * cin)
        s[f"tdnn.{i}.kernel.bias"] = (cout,)
    s["feature_extractor.weight"] = (cfg.xvector_dim, 2 * cfg.tdnn_dim[-1])
    s["feature_extractor.bias"] = (cfg.xvector_dim,)
    return s


def convert_xvector_state_dict(sd, cfg: XVectorConfig) -> dict:
    """HF ``WavLMForXVector`` state dict → :class:`XVector`'s (keys it
    does not read are ignored, as the reference ignores them)."""
    from audiocodecs_tpu_torch.convert.torch_utils import (
        as_state_dict,
        put_linear,
        to_np,
    )
    from audiocodecs_tpu_torch.convert.wavlm import convert_wavlm_state_dict

    out = {}
    put_linear(out, "projector", sd, "projector")
    put_linear(out, "feature_extractor", sd, "feature_extractor")
    if cfg.use_weighted_layer_sum:
        out["layer_weights"] = to_np(sd["layer_weights"]).astype(np.float32)
    cins = (cfg.tdnn_dim[0], *cfg.tdnn_dim[:-1])
    for i, (cin, cout, k) in enumerate(zip(cins, cfg.tdnn_dim,
                                           cfg.tdnn_kernel)):
        # a linear [Cout, k·Cin] in (k, Cin) order → a conv [Cout, Cin, k]
        w = to_np(sd[f"tdnn.{i}.kernel.weight"]).astype(np.float32)
        out[f"tdnn.{i}.w"] = np.ascontiguousarray(
            w.reshape(cout, k, cin).transpose(0, 2, 1))
        out[f"tdnn.{i}.b"] = to_np(sd[f"tdnn.{i}.kernel.bias"]).astype(
            np.float32)
    state = {f"wavlm.{k}": v for k, v in convert_wavlm_state_dict(
        sd, cfg.wavlm, prefix="wavlm.").items()}
    state.update(as_state_dict(out))
    return state


def load_xvector(checkpoint: str, config: dict | None = None, device=None):
    """A converted ``wavlm_xvector`` checkpoint (the reference's ``.npz``
    param tree, or a ``.pt`` state dict) → ``(model, cfg, embed_fn)`` on
    ``device`` (the card when ``None``), ``embed_fn`` a ``[B, T] → [B, D]``
    embedder (inference mode).

    ``config`` holds :class:`XVectorConfig` field overrides as plain dicts
    and lists (yaml-friendly); the nested ``wavlm`` dict maps to
    :class:`..nn.wavlm.WavLMConfig`."""
    from audiocodecs_tpu_torch.codec import resolve_device
    from audiocodecs_tpu_torch.utils.checkpoint import load_model_state

    def _tup(d):
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in d.items()}

    dev = resolve_device(device)
    over = dict(config or {})
    cfg = XVectorConfig(
        wavlm=WavLMConfig(**_tup(over.pop("wavlm", {}))), **_tup(over))
    model = XVector(cfg)
    model.load_state_dict(load_model_state(checkpoint, model), strict=True)
    model = model.to(dev).eval()

    def embed_fn(sig) -> torch.Tensor:
        with torch.inference_mode():
            return apply_xvector(model, torch.as_tensor(
                sig, dtype=torch.float32, device=dev))

    return model, cfg, embed_fn
