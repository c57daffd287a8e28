"""SemantiCodec (AudioMAE tokens, a latent-diffusion decoder), PyTorch.

Counterpart of ``audiocodecs_tpu/models/semanticodec.py``, weight-compatible
with its param tree through :func:`audiocodecs_tpu_torch.params.
from_jax_params`. Two codebooks a frame (semantic, acoustic):

* encode: the kaldi fbank (128 bins, 10 ms shift; :mod:`..nn.kaldi_fbank`)
  normalized as AudioMAE's, zero-padded to whole 1024-frame windows folded
  into the batch → AudioMAE's ViT-B (:mod:`..nn.audiomae`, 512 patches a
  window) → ``stack_factor`` adjacent patches concatenated (token rate
  100/50/25 → 1/2/4) → trimmed to ``ceil(freq_patches · (T // 2560 + 1) /
  sf)`` tokens → the semantic VQ, then the acoustic VQ on the residual
  (:mod:`..quant.vq`);
* decode (``decoder_variant="ldm"``, the default): ``cat([acoustic,
  semantic])`` in overlapping token windows of 512 / sf (overlap
  ``round(Wt · 0.0625)``, the last window padded with −1), decoded as one
  batch: DDIM over the latent-diffusion UNet (:mod:`..nn.ldm_unet`) with
  classifier-free guidance (the conditional and unconditional branches, the
  context zeroed, ride one doubled batch), the AudioLDM linear beta
  schedule (0.0015 → 0.0195 over 1000 steps, float64, then ``cumprod``),
  ``times = arange(0, 1000, 1000 // S)[:S] + 1`` with ``a_prev[0] =
  acum[0]``, the update in float32; the latents divided by
  ``latent_scale`` and decoded by the VAE (:mod:`..nn.ldm_vae`) to a
  ``[1024, 64]`` mel a window, vocoded by HiFi-GAN (:mod:`..nn.hifigan`),
  cropped or padded to 163,840 samples, overlap-added with linear ramps and
  trimmed to the tokens' duration;
* ``decoder_variant="analog"``: a transformer denoiser and a Vocos head
  over the same windows (cosine schedule without the t = 1 endpoint, the
  same CFG doubling).

**The start noise differs from the reference's.** The reference draws
``x_T`` from ``jax.random.PRNGKey(0)``, which PyTorch cannot reproduce.
Here ``x_T`` is drawn from a ``torch.Generator`` seeded 0 on the CPU, in
float32, in the reference's ``(B', Tl, Fl, C)`` order (``(B', N, H)`` for
``"analog"``), then permuted to NCHW and moved to the codec's device: the
card and the CPU start from the same noise, and a decode is deterministic
given its tokens, as the reference's is. Only the tests pass the
reference's own draw (``noise=`` of :meth:`SemantiCodec._windows_to_sig`).

Numerics. The fbank, AudioMAE and both VQ searches set the tokens and run
in exact float32 (TF32 off). The decoder computes in ``decode_dtype``: in
float32 everything is exact; in bfloat16 (the serving tier's
``ACX_ACT_DTYPE=decoder-bfloat16``) the UNet's, the VAE's and the
vocoder's weights and the context are cast to bf16 (once), while the
norms' statistics, the softmax and the DDIM update stay float32, as the
reference's. ``decode_precision="default"`` with float32 activations
decodes exactly, bit for bit as ``"exact"``: the reference opens no
``conv_role("decoder")`` for SemantiCodec, so its HiFi-GAN convs read only
the encoder's precision and its 2-D convs and products take XLA's default,
exact on the CPU. The ``"analog"`` variant reads no activation dtype and
decodes exactly in every tier. Everything is a library call (cuDNN,
cuBLAS): no TPU kernel lies on this path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.codec import Codec, CodecConfig
from audiocodecs_tpu_torch.nn.audiomae import (
    AudioMAE,
    AudioMAEConfig,
    apply_audiomae,
    init_audiomae_params,
)
from audiocodecs_tpu_torch.nn.hifigan import (
    HiFiGAN,
    HiFiGANConfig,
    apply_hifigan,
    init_hifigan_params,
)
from audiocodecs_tpu_torch.nn.kaldi_fbank import (
    audiomae_normalize,
    kaldi_fbank,
)
from audiocodecs_tpu_torch.nn.layers import DecodeForm, exact_fp32
from audiocodecs_tpu_torch.nn.ldm_unet import (
    UNet,
    UNetConfig,
    apply_unet,
    init_unet_params,
)
from audiocodecs_tpu_torch.nn.ldm_vae import (
    AutoencoderKL,
    VAEConfig,
    apply_vae_decoder,
    init_vae_params,
)
from audiocodecs_tpu_torch.nn.transformer import (
    Linear,
    Transformer,
    TransformerConfig,
    _linear,
    apply_transformer,
    init_transformer_params,
)
from audiocodecs_tpu_torch.nn.vocos import (
    Vocos,
    VocosConfig,
    apply_vocos,
    init_vocos_params,
)
from audiocodecs_tpu_torch.quant.vq import vq_decode, vq_encode

__all__ = ["SemantiCodec", "SemantiCodecModelConfig", "ddim_schedule",
           "init_semanticodec_params"]


@dataclasses.dataclass(frozen=True)
class SemantiCodecModelConfig:
    sampling_rate: int = 16000
    mel_bins: int = 128
    mel_shift_ms: float = 10.0  # 100 mel frames / s (kaldi fbank)
    window_frames: int = 1024  # 10.24 s windows
    patch_size: int = 16
    vit_hidden: int = 768  # ViT-B (AudioMAE)
    vit_layers: int = 12
    vit_heads: int = 12
    stack_factor: int = 1  # 1 → 50 Hz tokens a codebook, 2 → 25 Hz
    semantic_vocab: int = 8192
    acoustic_vocab: int = 8192
    denoiser_hidden: int = 384
    denoiser_layers: int = 6
    denoiser_heads: int = 6
    ddim_steps: int = 50
    cfg_scale: float = 2.0
    segment_overlap_ratio: float = 0.0625
    decoder_variant: str = "ldm"  # or "analog"
    ldm_mel_bins: int = 64
    vae_cfg: VAEConfig = VAEConfig()
    unet_channels: int = 128
    unet_channel_mult: tuple = (1, 2, 3, 5)
    unet_num_res_blocks: int = 2
    unet_attention_resolutions: tuple = (8, 4, 2)
    unet_head_channels: int = 32
    vocoder_cfg: HiFiGANConfig = HiFiGANConfig()

    @property
    def mel_hop(self) -> int:
        return int(self.sampling_rate * self.mel_shift_ms / 1000.0)

    @property
    def patches_per_window(self) -> int:
        return (self.window_frames // self.patch_size) * (
            self.mel_bins // self.patch_size)

    @property
    def tokens_per_window(self) -> int:
        return self.patches_per_window // self.stack_factor

    @property
    def feature_dim(self) -> int:
        """Codebook and feature width: ViT width × stack_factor."""
        return self.vit_hidden * self.stack_factor

    @property
    def qfeat_dim(self) -> int:
        """``cat([acoustic, semantic])``: twice the feature width."""
        return 2 * self.feature_dim

    @property
    def freq_patches(self) -> int:
        return self.mel_bins // self.patch_size

    def audiomae(self) -> AudioMAEConfig:
        return AudioMAEConfig(
            mel_frames=self.window_frames, mel_bins=self.mel_bins,
            patch_size=self.patch_size, hidden_size=self.vit_hidden,
            num_layers=self.vit_layers, num_heads=self.vit_heads)

    def denoiser_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            hidden_size=self.denoiser_hidden,
            num_layers=self.denoiser_layers,
            num_heads=self.denoiser_heads,
            num_kv_heads=self.denoiser_heads,
            head_dim=self.denoiser_hidden // self.denoiser_heads,
            intermediate_size=self.denoiser_hidden * 4,
            act="gelu", norm="layernorm", causal=False)

    def unet(self) -> UNetConfig:
        return UNetConfig(
            in_channels=self.vae_cfg.embed_dim,
            out_channels=self.vae_cfg.embed_dim,
            model_channels=self.unet_channels,
            num_res_blocks=self.unet_num_res_blocks,
            attention_resolutions=self.unet_attention_resolutions,
            channel_mult=self.unet_channel_mult,
            num_head_channels=self.unet_head_channels,
            context_dim=self.qfeat_dim)

    def vocos(self) -> VocosConfig:
        return VocosConfig(
            input_channels=self.mel_bins, dim=self.denoiser_hidden,
            intermediate_dim=self.denoiser_hidden * 3, num_layers=4,
            n_fft=4 * self.mel_hop, hop_length=self.mel_hop,
            num_adanorm_embeddings=None)


# the parameters each variant's decoder holds (dropped in encode mode)
_DECODER_KEYS = {"ldm": ("vae", "unet", "vocoder", "latent_scale"),
                 "analog": ("denoiser", "time_emb", "cond_proj",
                            "latent_out", "vocos")}
TOKEN_RATES = {100: 1, 50: 2, 25: 4}  # tokens a second → stack_factor


def ddim_schedule(steps: int):
    """The LDM decoder's DDIM schedule: (times, a_t, a_prev), float32
    numpy arrays of ``steps`` entries, step ``i`` at ``times[i]``, applied
    from the last entry to the first. ``a_prev[0]`` is ``acum[0]``; a step
    count that does not divide 1000 keeps the reference's arithmetic."""
    betas = np.linspace(0.0015, 0.0195, 1000, dtype=np.float64)
    acum = np.cumprod(1.0 - betas)
    times = np.arange(0, 1000, 1000 // steps)[:steps] + 1
    a_t = acum[times].astype(np.float32)
    a_prev = np.concatenate([[acum[0]], acum[times[:-1]]]).astype(np.float32)
    return times.astype(np.float32), a_t, a_prev


def _start_noise(shape, noise, device) -> torch.Tensor:
    """``noise`` (the reference's draw, tests only) or the port's: N(0, 1)
    from a CPU generator seeded 0, float32, in ``shape``."""
    if noise is None:
        noise = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    noise = torch.as_tensor(np.asarray(noise), dtype=torch.float32)
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(f"noise of shape {tuple(noise.shape)}, want {shape}")
    return noise.to(device)


class SemantiCodec(Codec):
    """SemantiCodec with the standardized ``[B,T]`` ↔ ``[B,N,2]``
    contract (tokens: semantic, acoustic). ``token_rate``,
    ``semantic_vocab_size``, ``ddim_sample_step`` and ``cfg_scale`` mirror
    the reference's constructor. ``state_dict`` is loaded strictly; without
    it the weights are drawn by :func:`init_semanticodec_params` from
    ``generator`` (seed 0 by default). Encode mode drops the decoder's
    parameters, decode mode the encoder. ``decode_dtype`` and
    ``decode_precision`` are a serving tier's arguments (see the module's
    docstring). ``device=None`` means the card."""

    @classmethod
    def default_model_config(cls, orig_sample_rate: int = 16000):
        return SemantiCodecModelConfig(sampling_rate=orig_sample_rate)

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: int = 16000,
        mode: str = "reconstruct",
        num_codebooks: int = 2,
        model_config: Optional[SemantiCodecModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        token_rate: Optional[int] = None,
        semantic_vocab_size: Optional[int] = None,
        ddim_sample_step: Optional[int] = None,
        cfg_scale: Optional[float] = None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
    ):
        if num_codebooks != 2:
            raise ValueError(
                "SemantiCodec has 2 codebooks (semantic+acoustic)")
        form = DecodeForm(decode_dtype, decode_precision)
        mc = model_config or SemantiCodecModelConfig(
            sampling_rate=orig_sample_rate)
        if token_rate is not None:
            if token_rate not in TOKEN_RATES:
                raise ValueError(f"token_rate must be one of "
                                 f"{sorted(TOKEN_RATES)}, got {token_rate}")
            mc = dataclasses.replace(mc, stack_factor=TOKEN_RATES[token_rate])
        if semantic_vocab_size is not None:
            mc = dataclasses.replace(mc, semantic_vocab=semantic_vocab_size)
        if ddim_sample_step is not None:
            mc = dataclasses.replace(mc, ddim_steps=ddim_sample_step)
        if cfg_scale is not None:
            mc = dataclasses.replace(mc, cfg_scale=cfg_scale)
        if mc.decoder_variant not in _DECODER_KEYS:
            raise ValueError(f"unknown decoder_variant "
                             f"{mc.decoder_variant!r}")
        vocabs = (mc.semantic_vocab, mc.acoustic_vocab)
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=2, vocab_size=max(vocabs),
                        vocab_sizes=vocabs),
            device=device)
        self.model_config = mc
        self.decode_form = form
        # the LDM chain reads the activation dtype only; "analog" reads none
        self._ldm_form = (form if form.dtype == torch.bfloat16
                          and mc.decoder_variant == "ldm" else DecodeForm())
        H = mc.feature_dim
        if mode != "decode":
            self.encoder = AudioMAE(mc.audiomae())
        self.semantic_codebook = nn.Parameter(torch.empty(mc.semantic_vocab,
                                                          H))
        self.acoustic_codebook = nn.Parameter(torch.empty(mc.acoustic_vocab,
                                                          H))
        if mode != "encode":
            if mc.decoder_variant == "ldm":
                self.vae = AutoencoderKL(mc.vae_cfg)
                self.unet = UNet(mc.unet())
                self.vocoder = HiFiGAN(mc.vocoder_cfg)
                self.latent_scale = nn.Parameter(torch.empty(()))
            else:
                D = mc.denoiser_hidden
                self.denoiser = Transformer(mc.denoiser_cfg())
                self.time_emb = nn.Parameter(torch.empty(D))
                self.cond_proj = nn.Parameter(torch.empty(mc.qfeat_dim, D))
                self.latent_out = Linear(D, mc.mel_bins, bias=True)
                self.vocos = Vocos(mc.vocos())
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_semanticodec_params(generator, mc)
        drop = {"encode": _DECODER_KEYS[mc.decoder_variant],
                "decode": ("encoder",)}.get(mode, ())
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if k.split(".")[0] not in drop}, strict=True)
        self.to(self.device)
        self.eval()

    # Pure functions over tensors on the codec's device -------------------- #

    def _encode_latents(self, sig):
        """``[B, T]`` → stacked ViT features at the token rate ``[B, N,
        H·sf]``, trimmed to the tokens of the signal's duration."""
        mc = self.model_config
        mel = audiomae_normalize(kaldi_fbank(
            sig, mc.sampling_rate, num_mel_bins=mc.mel_bins,
            frame_shift_ms=mc.mel_shift_ms))  # [B, F, mel_bins]
        B, Fr, M = mel.shape
        W = mc.window_frames
        n_win = max(1, -(-Fr // W))
        mel = F.pad(mel, (0, 0, 0, n_win * W - Fr))
        feats = apply_audiomae(self.encoder, mel.reshape(B * n_win, W, M),
                               mc.audiomae())
        feats = feats.reshape(B, -1, mc.feature_dim)
        n_cols = sig.shape[1] // (mc.patch_size * mc.mel_hop) + 1
        n_target = -(-mc.freq_patches * n_cols // mc.stack_factor)
        return feats[:, :n_target]

    def _sig_to_feats(self, sig, length):
        del length
        return self._encode_latents(sig)

    def _feats_to_toks(self, feats):
        """The semantic VQ, then the acoustic VQ on its residual."""
        sem = vq_encode(feats, self.semantic_codebook)
        ac = vq_encode(feats - vq_decode(sem, self.semantic_codebook),
                       self.acoustic_codebook)
        return torch.stack([sem, ac], dim=-1)

    def _sig_to_toks(self, sig, length):
        del length
        return self._feats_to_toks(self._encode_latents(sig))

    def _toks_to_qfeats(self, toks, length):
        """``cat([acoustic, semantic])``: twice the feature width."""
        del length
        return torch.cat([vq_decode(toks[..., 1], self.acoustic_codebook),
                          vq_decode(toks[..., 0], self.semantic_codebook)],
                         dim=-1)

    def _sig_to_qfeats(self, sig, length):
        return self._toks_to_qfeats(self._sig_to_toks(sig, length), length)

    # DDIM ------------------------------------------------------------------ #

    def _ldm_ddim(self, cond, noise=None):
        """Conditioning windows ``[B', Wt, 2H]`` → mel ``[B', 1024, 64]``
        in the decoder's dtype."""
        mc = self.model_config
        # the DDIM state in the weights' dtype (float32; float64 for a
        # reference run on a ``.double()`` copy), the UNet and the VAE in
        # the tier's
        work = self.latent_scale.dtype
        dt = self._ldm_form.dtype if self._ldm_form.dtype == torch.bfloat16 \
            else work
        ucfg = mc.unet()
        B, ds = cond.shape[0], mc.vae_cfg.downsample_factor
        Tl, Fl = mc.window_frames // ds, mc.ldm_mel_bins // ds
        times, a_t, a_prev = ddim_schedule(mc.ddim_steps)
        x = _start_noise((B, Tl, Fl, mc.vae_cfg.embed_dim), noise,
                         self.device).permute(0, 3, 1, 2).to(work)
        cond = cond.to(dt)
        ctx2 = torch.cat([cond, torch.zeros_like(cond)], dim=0)
        one = np.float32(1.0)
        for i in reversed(range(mc.ddim_steps)):
            t = torch.full((2 * B,), float(times[i]), device=self.device)
            eps2 = apply_unet(self.unet, torch.cat([x, x], dim=0), t, ctx2,
                              ucfg, dt).to(work)
            eps_c, eps_u = torch.chunk(eps2, 2, dim=0)
            eps = eps_u + mc.cfg_scale * (eps_c - eps_u)
            x0 = (x - float(np.sqrt(one - a_t[i])) * eps) / float(
                np.sqrt(a_t[i]))
            x = (float(np.sqrt(a_prev[i])) * x0
                 + float(np.sqrt(one - a_prev[i])) * eps)
        mel = apply_vae_decoder(self.vae, x / self.latent_scale, mc.vae_cfg,
                                dt)
        return mel[:, 0]

    def _ddim_sample(self, cond, noise=None):
        """The ``"analog"`` decoder: windows ``[B', Wt, 2H]`` → mel
        features at the token rate ``[B', Wt, mel_bins]``."""
        mc = self.model_config
        B, N, _ = cond.shape
        steps = mc.ddim_steps
        ts = np.linspace(1.0, 0.0, steps + 2)[1:]
        alphas = (np.cos(ts * np.pi / 2) ** 2).astype(np.float32)
        x = _start_noise((B, N, mc.denoiser_hidden), noise, self.device)
        with exact_fp32():
            c = torch.matmul(cond, self.cond_proj)
        c2 = torch.cat([c, torch.zeros_like(c)], dim=0)
        one = np.float32(1.0)
        for i in range(steps):
            a, a_next = alphas[i], alphas[i + 1]
            t_val = np.float32(ts[0]) * (one - np.float32(i)
                                         / np.float32(steps))
            t_emb = float(t_val) * self.time_emb  # [D]
            h = torch.cat([x, x], dim=0) + t_emb + c2
            eps2 = apply_transformer(self.denoiser, h, mc.denoiser_cfg())
            eps_c, eps_u = torch.chunk(eps2, 2, dim=0)
            eps = eps_u + mc.cfg_scale * (eps_c - eps_u)
            x0 = (x - float(np.sqrt(one - a)) * eps) / float(
                np.sqrt(max(a, np.float32(1e-8))))
            x = (float(np.sqrt(a_next)) * x0
                 + float(np.sqrt(one - a_next)) * eps)
        return _linear(x, self.latent_out)

    def _decode_window(self, windows, noise=None):
        """Conditioning windows ``[B', Wt, 2H]`` → waveform ``[B',
        window_frames · hop]``."""
        mc = self.model_config
        win_samples = mc.window_frames * mc.mel_hop
        if mc.decoder_variant == "ldm":
            mel = self._ldm_ddim(windows, noise)
            wave = apply_hifigan(self.vocoder, mel.transpose(1, 2),
                                 mc.vocoder_cfg, self._ldm_form).to(
                                     self.latent_scale.dtype)
        else:
            up = mc.window_frames // mc.tokens_per_window
            mel = self._ddim_sample(windows, noise)
            wave = apply_vocos(self.vocos, torch.repeat_interleave(
                mel, up, dim=1), mc.vocos())
        wave = wave[:, :win_samples]
        return F.pad(wave, (0, win_samples - wave.shape[1]))

    def _windows_to_sig(self, cond, noise=None):
        """``cond`` [B, N, 2H] → waveform [B, N · up · hop]: overlapping
        token windows (the last padded with −1) decoded as one batch, then
        overlap-added with linear ramps. ``noise``: the start noise of the
        B · n_windows windows in the reference's order (tests only)."""
        mc = self.model_config
        B, N0, H = cond.shape
        Wt = mc.tokens_per_window
        if not 0.0 <= mc.segment_overlap_ratio <= 0.5:
            raise ValueError(
                "segment_overlap_ratio must be in [0, 0.5] (crossfade "
                f"weights sum to 1 only there), got "
                f"{mc.segment_overlap_ratio}")
        ov = int(round(Wt * mc.segment_overlap_ratio))
        step = max(1, Wt - ov)
        n_win = 1 if N0 <= Wt else -(-(N0 - Wt) // step) + 1
        total = (n_win - 1) * step + Wt
        cond = F.pad(cond, (0, 0, 0, total - N0), value=-1.0)
        windows = torch.stack([cond[:, i * step: i * step + Wt]
                               for i in range(n_win)], dim=1)
        wave = self._decode_window(windows.reshape(B * n_win, Wt, H), noise)
        up = mc.window_frames // Wt
        win_samples = mc.window_frames * mc.mel_hop
        waves = wave.reshape(B, n_win, win_samples)
        if n_win == 1:
            sig = waves[:, 0]
        else:
            ov_s = ov * up * mc.mel_hop
            step_s = win_samples - ov_s
            ramp = torch.linspace(0.0, 1.0, ov_s + 2,
                                  device=cond.device)[1:-1]
            sig = cond.new_zeros((B, (n_win - 1) * step_s + win_samples))
            for i in range(n_win):
                w = torch.ones(win_samples, device=cond.device)
                if ov_s and i > 0:
                    w[:ov_s] = ramp
                if ov_s and i < n_win - 1:
                    w[win_samples - ov_s:] = ramp.flip(0)
                sig[:, i * step_s: i * step_s + win_samples] += (
                    waves[:, i] * w)
        return sig[:, : N0 * up * mc.mel_hop]

    def _toks_to_sig(self, toks, length):
        return self._windows_to_sig(self._toks_to_qfeats(toks, length))

    def _feats_to_sig(self, feats, length):
        """The decode of unquantized features (the reference's own; the
        vendor has none): the encode's residual split, so that the
        conditioning tends to :meth:`_toks_to_qfeats`'s as the quantization
        error goes to 0."""
        del length
        sem_q = vq_decode(vq_encode(feats, self.semantic_codebook),
                          self.semantic_codebook)
        return self._windows_to_sig(torch.cat([feats - sem_q, sem_q],
                                              dim=-1))

    def embs(self) -> torch.Tensor:
        """``[2, C, H]``: each codebook zero-padded to the larger vocab."""
        C = self.config.vocab_size
        return torch.stack([
            F.pad(cb.detach(), (0, 0, 0, C - cb.shape[0]))
            for cb in (self.semantic_codebook, self.acoustic_codebook)])


def init_semanticodec_params(generator: torch.Generator,
                             cfg: SemantiCodecModelConfig) -> dict:
    """Random weights of :class:`SemantiCodec` as a flat state dict, in the
    reference's distributions (codebooks N(0, 1), ``latent_scale`` 1; each
    module's own init); the draws differ from ``jax.random``'s."""
    g, H = generator, cfg.feature_dim
    out = init_audiomae_params(g, cfg.audiomae(), "encoder.")
    out["semantic_codebook"] = torch.randn((cfg.semantic_vocab, H),
                                           generator=g)
    out["acoustic_codebook"] = torch.randn((cfg.acoustic_vocab, H),
                                           generator=g)
    if cfg.decoder_variant == "ldm":
        out.update(init_vae_params(g, cfg.vae_cfg, "vae."))
        out.update(init_unet_params(g, cfg.unet(), "unet."))
        out.update(init_hifigan_params(g, cfg.vocoder_cfg, "vocoder."))
        out["latent_scale"] = torch.tensor(1.0)
        return out
    D, M = cfg.denoiser_hidden, cfg.mel_bins
    out.update(init_transformer_params(g, cfg.denoiser_cfg(), "denoiser."))
    out["time_emb"] = torch.randn((D,), generator=g)
    out["cond_proj"] = (torch.randn((cfg.qfeat_dim, D), generator=g)
                        * cfg.qfeat_dim ** -0.5)
    out["latent_out.w"] = torch.randn((D, M), generator=g) * D ** -0.5
    out["latent_out.b"] = torch.zeros(M)
    out.update({f"vocos.{k}": v
                for k, v in init_vocos_params(g, cfg.vocos()).items()})
    return out
