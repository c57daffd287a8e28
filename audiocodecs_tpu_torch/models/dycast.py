"""DyCAST (a dynamic character-aligned speech tokenizer), PyTorch.

Counterpart of ``audiocodecs_tpu/models/dycast.py``, weight-compatible with
its param tree through :func:`audiocodecs_tpu_torch.params.from_jax_params`.
A token is a segment of frames, not a frame, so N varies with the
utterance; the reference pads every shape to a fixed segment capacity with
validity masks, and so does this port:

* encode: WavLM-base's hidden state 6 (50 Hz) → a boundary head (a linear
  to one logit a frame; ``logits > 0`` starts a segment, and frame 0
  always does) → segment ids by cumulative sum, clipped to the
  ``max_segments`` − 1 = 127th (every later frame pools into it) → mean
  pooling a segment (one-hot product) → ``proj`` to 2 × 32 dims → a
  level-2 FSQ a pair (codes in {−1, 0}), two bits a channel: 32 tokens of
  vocab 4 a segment, plus the duration channel (frames a segment, clipped
  to ``max_duration`` − 1 = 31); segments past the utterance's count are 0;
* decode: the bits back to the {−1, 0} lattice → ``unproj`` → each segment
  repeated by its duration into a fixed budget of ``max_segments`` · 4
  frames (frame t takes the first segment whose cumulative end exceeds t;
  frames past the total are zeroed) → optionally the kNN retriever (each
  frame replaced by its nearest clean-bank entry, by cosine, where the
  similarity clears ``sim_threshold``) → the SEANet vocoder. The decode
  is ``max_segments · 4 · 320`` samples whatever the input.

The tower, the boundary head, the pooling and the FSQ run in exact fp32
(TF32 off): they set the tokens. The vocoder computes in a
:class:`..nn.layers.DecodeForm` (``decode_dtype``, ``decode_precision``),
the reference's SEANet decoder under its switches, so the EnCodec-style
tier decodes in bf16; its non-causal blocks run cuDNN in the form.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.codec import Codec, CodecConfig
from audiocodecs_tpu_torch.models.wavlm_kmeans import seanet_vocoder_config
from audiocodecs_tpu_torch.nn.layers import DecodeForm, exact_fp32
from audiocodecs_tpu_torch.nn.seanet import (
    SEANet,
    SEANetConfig,
    init_seanet_params,
    seanet_decoder_plan,
)
from audiocodecs_tpu_torch.nn.wavlm import (
    WavLM,
    WavLMConfig,
    apply_wavlm,
    init_wavlm_params,
)
from audiocodecs_tpu_torch.quant.fsq import fsq_quantize

__all__ = ["DyCAST", "DyCASTModelConfig", "init_dycast_params"]


@dataclasses.dataclass(frozen=True)
class DyCASTModelConfig:
    sampling_rate: int = 16000
    num_channels: int = 32  # two-bit channels (vocab 4 each)
    use_duration_channel: bool = True
    max_segments: int = 128  # the segment capacity
    max_duration: int = 32  # the duration channel's vocab
    wavlm: WavLMConfig = dataclasses.field(default_factory=WavLMConfig)
    wavlm_layer: int = 6
    boundary_threshold: float = 0.0
    vocoder_filters: int = 32
    vocoder_ratios: tuple[int, ...] = (8, 5, 4, 2)
    use_retriever: bool = False
    sim_threshold: float = 0.97
    blend: float = 1.0
    retriever_bank_size: int = 512

    def vocoder(self) -> SEANetConfig:
        return seanet_vocoder_config(self.wavlm.hidden_size,
                                     self.vocoder_filters,
                                     self.vocoder_ratios)


class _Boundary(nn.Module):
    """The boundary head: ``w [H]`` and a scalar ``b``."""

    def __init__(self, hidden: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(hidden))
        self.b = nn.Parameter(torch.empty(()))


class DyCAST(Codec):
    """DyCAST with the standardized contract: ``[B, T]`` ↔ ``[B, S, K]``
    with S = ``max_segments`` and K = 32 channels (+ the duration).

    ``sig_to_feats`` is the pooled segment features ``[B, S, H]``;
    ``feats_to_sig`` vocodes them as they are. ``state_dict`` is loaded
    strictly; without it the weights are drawn by
    :func:`init_dycast_params` from ``generator`` (seed 0 by default).
    Encode mode drops the vocoder, ``unproj`` and the retriever's bank;
    decode mode the tower, the boundary head and ``proj``.
    ``device=None`` means the card."""

    @classmethod
    def default_model_config(cls, orig_sample_rate: int = 16000):
        return DyCASTModelConfig(sampling_rate=orig_sample_rate)

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: int = 16000,
        mode: str = "reconstruct",
        num_codebooks: Optional[int] = None,
        model_config: Optional[DyCASTModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
    ):
        form = DecodeForm(decode_dtype, decode_precision)
        mc = model_config or DyCASTModelConfig(sampling_rate=orig_sample_rate)
        K = mc.num_channels + (1 if mc.use_duration_channel else 0)
        if num_codebooks is not None and num_codebooks != K:
            raise ValueError(f"num_codebooks must be {K} "
                             f"({mc.num_channels} channels + duration)")
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=K, vocab_size=max(4, mc.max_duration)),
            device=device)
        self.model_config = mc
        self.decode_form = form
        H, D = mc.wavlm.hidden_size, 2 * mc.num_channels
        if mode != "decode":
            self.wavlm = WavLM(mc.wavlm)
            self.boundary = _Boundary(H)
            self.proj = nn.Parameter(torch.empty(H, D))
        if mode != "encode":
            self.unproj = nn.Parameter(torch.empty(D, H))
            voc = mc.vocoder()
            self.vocoder = SEANet(voc, seanet_decoder_plan(voc), form)
            if mc.use_retriever:
                self.retriever_bank = nn.Parameter(
                    torch.empty(mc.retriever_bank_size, H))
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_dycast_params(generator, mc)
        drop = {"encode": ("vocoder.", "unproj", "retriever_bank"),
                "decode": ("wavlm.", "boundary.", "proj")}.get(mode, ())
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if not k.startswith(drop)}, strict=True)
        self.to(self.device)
        self.eval()

    # Encode --------------------------------------------------------------- #

    def _boundary_logits(self, feats):
        """A boundary logit a frame, ``[B, T]``."""
        with exact_fp32():
            return torch.matmul(feats, self.boundary.w) + self.boundary.b

    def _segments(self, sig):
        """``[B, T]`` → (segment features ``[B, S, H]``, frames a segment
        ``[B, S]``, segments an utterance ``[B]``)."""
        mc = self.model_config
        feats = apply_wavlm(self.wavlm, sig, mc.wavlm,
                            output_layer=mc.wavlm_layer)  # [B, T, H]
        S = mc.max_segments
        boundary = self._boundary_logits(feats) > mc.boundary_threshold
        boundary[:, 0] = True  # frame 0 starts a segment
        seg_id = torch.clamp(torch.cumsum(boundary.long(), dim=1) - 1,
                             max=S - 1)
        onehot = F.one_hot(seg_id, S).to(feats.dtype)  # [B, T, S]
        counts = onehot.sum(dim=1)  # [B, S]
        with exact_fp32():
            pooled = torch.matmul(onehot.transpose(1, 2), feats)
        pooled = pooled / torch.clamp(counts[..., None], min=1.0)
        return pooled, counts.long(), seg_id.max(dim=1).values + 1

    def _sig_to_feats(self, sig, length):
        del length
        return self._segments(sig)[0]

    def _sig_to_toks(self, sig, length):
        del length
        mc = self.model_config
        pooled, durations, num_segments = self._segments(sig)
        with exact_fp32():
            z = torch.matmul(pooled, self.proj)  # [B, S, 2·channels]
        B, S, _ = z.shape
        codes = fsq_quantize(z.reshape(B, S, mc.num_channels, 2), (2, 2))
        bits = (codes >= 0).long()  # code 0 → bit 1, −1 → bit 0
        chan = bits[..., 0] + 2 * bits[..., 1]  # [B, S, channels] ∈ 0..3
        valid = (torch.arange(S, device=z.device)[None]
                 < num_segments[:, None])
        chan = torch.where(valid[..., None], chan, 0)
        if not mc.use_duration_channel:
            return chan
        dur = torch.where(valid, torch.clamp(durations, 0,
                                             mc.max_duration - 1), 0)
        return torch.cat([chan, dur[..., None]], dim=-1)

    # Decode --------------------------------------------------------------- #

    def _toks_to_qfeats(self, toks, length):
        mc = self.model_config
        ch = toks[..., : mc.num_channels]
        codes = torch.stack([(ch % 2).float() - 1.0,
                             (ch // 2).float() - 1.0], dim=-1)
        B, S = codes.shape[:2]
        with exact_fp32():
            return torch.matmul(codes.reshape(B, S, 2 * mc.num_channels),
                                self.unproj)

    def _sig_to_qfeats(self, sig, length):
        return self._toks_to_qfeats(self._sig_to_toks(sig, length), length)

    def _expand(self, h, durations):
        """Segments ``[B, S, H]`` repeated by their durations into the
        budget of S · 4 frames: frame t takes the first segment whose
        cumulative end exceeds t (the last one past them all); frames past
        the total are zero."""
        B, S, _ = h.shape
        csum = torch.cumsum(durations, dim=1)  # segment end frames
        t = torch.arange(S * 4, device=h.device)
        seg = (t[None, :, None] >= csum[:, None, :]).sum(-1)  # [B, S·4]
        seg = torch.clamp(seg, max=S - 1)
        frames = torch.take_along_dim(h, seg[..., None], dim=1)
        return frames, t[None] < csum[:, -1:]

    def _retrieve(self, feats):
        """The kNN cleanup: the nearest bank entry by cosine replaces (by
        ``blend``) each frame whose similarity clears ``sim_threshold``."""
        mc = self.model_config
        bank = self.retriever_bank
        fn = feats / torch.clamp(torch.linalg.vector_norm(
            feats, dim=-1, keepdim=True), min=1e-8)
        bn = bank / torch.clamp(torch.linalg.vector_norm(
            bank, dim=-1, keepdim=True), min=1e-8)
        with exact_fp32():
            sim = torch.matmul(fn, bn.T)  # [B, T, M]
        best = torch.argmax(sim, dim=-1)  # the first maximum on ties
        best_sim = torch.take_along_dim(sim, best[..., None], dim=-1)[..., 0]
        blended = mc.blend * bank[best] + (1.0 - mc.blend) * feats
        return torch.where((best_sim >= mc.sim_threshold)[..., None],
                           blended, feats)

    def _vocode(self, h):
        return self.vocoder(h.transpose(1, 2))[:, 0]

    def _toks_to_sig(self, toks, length):
        mc = self.model_config
        h = self._toks_to_qfeats(toks, length)
        if mc.use_duration_channel:
            durations = torch.clamp(toks[..., -1], min=0)
        else:
            durations = torch.full(h.shape[:2], 4, dtype=torch.long,
                                   device=h.device)
        frames, valid = self._expand(h, durations)
        if mc.use_retriever:
            frames = self._retrieve(frames)
        return self._vocode(frames * valid[..., None])

    def _feats_to_sig(self, feats, length):
        if self.model_config.use_retriever:
            feats = self._retrieve(feats)
        return self._vocode(feats)

    def embs(self) -> torch.Tensor:
        """``[K, C, H]``: each channel's four lattice points through its two
        ``unproj`` rows (zero rows past them), and for the duration channel
        the index in column 0."""
        mc = self.model_config
        C = self.config.vocab_size
        unproj = self.unproj.detach()
        lattice = torch.tensor([[(c % 2) - 1.0, (c // 2) - 1.0]
                                for c in range(4)], device=unproj.device)
        out = []
        with exact_fp32():
            for k in range(mc.num_channels):
                e = torch.matmul(lattice, unproj[2 * k: 2 * k + 2])
                out.append(F.pad(e, (0, 0, 0, C - 4)))
        if mc.use_duration_channel:
            dur = torch.zeros(C, unproj.shape[1], device=unproj.device)
            dur[:, 0] = torch.arange(C, dtype=torch.float32)
            out.append(dur)
        return torch.stack(out)


def init_dycast_params(generator: torch.Generator,
                       cfg: DyCASTModelConfig) -> dict:
    """Random weights of :class:`DyCAST` as a flat state dict, in the
    reference's distributions (the tower's :func:`..nn.wavlm.
    init_wavlm_params`, the boundary head and ``proj`` N(0, 1/H) with a
    zero bias, ``unproj`` N(0, 1/(2·channels)), the bank N(0, 1), the
    vocoder's SEANet init); the draws differ from the reference's."""
    H, D = cfg.wavlm.hidden_size, 2 * cfg.num_channels

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=generator) * scale

    out = init_wavlm_params(generator, cfg.wavlm, "wavlm.")
    out["boundary.w"] = randn(H, scale=H ** -0.5)
    out["boundary.b"] = torch.zeros(())
    out["proj"] = randn(H, D, scale=H ** -0.5)
    out["unproj"] = randn(D, H, scale=D ** -0.5)
    if cfg.use_retriever:
        out["retriever_bank"] = randn(cfg.retriever_bank_size, H)
    voc = cfg.vocoder()
    out.update({f"vocoder.{k}": v for k, v in init_seanet_params(
        generator, voc, seanet_decoder_plan(voc)).items()})
    return out
