"""AudioLDM-lineage checkpoint converters (SemantiCodec's decode chain).

Counterpart of ``audiocodecs_tpu/convert/ldm.py``: the three vendor
components of SemantiCodec's decoder into the port's modules:

* the HiFi-GAN vocoder (jik876's ``Generator`` naming: ``conv_pre``,
  ``ups.<i>``, flat ``resblocks.<i·nk+j>.convs{1,2}.<k>``, ``conv_post``,
  every conv weight-normed) → :class:`..nn.hifigan.HiFiGAN`;
* the AutoencoderKL (CompVis naming: ``encoder.``/``decoder.`` with
  ``mid.block_1``, ``up.<level>.block.<j>``, ``nin_shortcut``,
  ``quant_conv``/``post_quant_conv``) → :class:`..nn.ldm_vae.VAE`;
* the UNet (CompVis ``openaimodel`` naming: ``time_embed.{0,2}``,
  ``input_blocks.<n>.{0,1}``, ``middle_block.{0,1,2}``,
  ``output_blocks.<n>.*``, ``out.{0,2}``) → :class:`..nn.ldm_unet.UNet`.

The port's convs keep PyTorch's layouts (``Conv2d`` ``[Cout, Cin, kh,
kw]``, ``ConvTranspose1d`` ``[Cin, Cout, K]``), so a conv weight moves
only by its weight-norm fold; linears become ``[in, out]``; GroupNorm and
LayerNorm ``weight``/``bias`` become ``scale``/``bias``. Strict: a key a
converter does not read raises with its name.

:func:`split_ldm_checkpoint` carves a whole latent-diffusion checkpoint
(``first_stage_model.*``, ``model.diffusion_model.*``; the EMA, loss and
DDPM-schedule keys dropped) into the parts these converters take.
"""

from __future__ import annotations

from audiocodecs_tpu_torch.convert.torch_utils import (
    as_state_dict,
    put_conv,
    put_linear,
    to_np,
)
from audiocodecs_tpu_torch.convert.zoo import _strict, _TrackingDict
from audiocodecs_tpu_torch.nn.hifigan import HiFiGANConfig
from audiocodecs_tpu_torch.nn.ldm_unet import UNetConfig
from audiocodecs_tpu_torch.nn.ldm_vae import VAEConfig

__all__ = [
    "convert_hifigan_state_dict", "hifigan_schema",
    "convert_vae_state_dict", "vae_schema",
    "convert_unet_state_dict", "unet_schema",
    "split_ldm_checkpoint",
]


def _norm(out, dst, sd, prefix) -> None:
    out[f"{dst}.scale"] = to_np(sd[f"{prefix}.weight"]).astype("float32")
    out[f"{dst}.bias"] = to_np(sd[f"{prefix}.bias"]).astype("float32")


# ----------------------------- HiFi-GAN ------------------------------- #


def convert_hifigan_state_dict(sd, cfg: HiFiGANConfig = None) -> dict:
    """jik876's ``Generator`` state dict → :class:`HiFiGAN`'s."""
    cfg = cfg or HiFiGANConfig()
    sd = _TrackingDict(sd)
    nk = len(cfg.resblock_kernel_sizes)
    out = {}
    put_conv(out, "conv_pre", sd, "conv_pre")
    for i in range(len(cfg.upsample_rates)):
        put_conv(out, f"ups.{i}", sd, f"ups.{i}")
        for j, dil in enumerate(cfg.resblock_dilation_sizes):
            r = i * nk + j
            for k in range(len(dil)):
                for n in (1, 2):
                    put_conv(out, f"resblocks.{i}.{j}.{k}.c{n}", sd,
                             f"resblocks.{r}.convs{n}.{k}")
    put_conv(out, "conv_post", sd, "conv_post")
    _strict(sd, "hifigan")
    return as_state_dict(out)


def hifigan_schema(cfg: HiFiGANConfig = None) -> dict:
    """{key: shape} of the vendor checkpoint (weight-normed convs)."""
    cfg = cfg or HiFiGANConfig()
    nk = len(cfg.resblock_kernel_sizes)

    def wn_conv(prefix, cout, cin, k, out):
        out[f"{prefix}.weight_g"] = (cout, 1, 1)
        out[f"{prefix}.weight_v"] = (cout, cin, k)
        out[f"{prefix}.bias"] = (cout,)

    out = {}
    wn_conv("conv_pre", cfg.upsample_initial_channel, cfg.num_mels, 7, out)
    ch = cfg.upsample_initial_channel
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        cout = cfg.stage_channels(i)
        # ConvTranspose1d weight-norm: [Cin, Cout, K], g over dim 0
        out[f"ups.{i}.weight_g"] = (ch, 1, 1)
        out[f"ups.{i}.weight_v"] = (ch, cout, k)
        out[f"ups.{i}.bias"] = (cout,)
        for j, (rk, rd) in enumerate(
            zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)
        ):
            r = i * nk + j
            for d in range(len(rd)):
                wn_conv(f"resblocks.{r}.convs1.{d}", cout, cout, rk, out)
                wn_conv(f"resblocks.{r}.convs2.{d}", cout, cout, rk, out)
        ch = cout
    wn_conv("conv_post", 1, ch, 7, out)
    return out


# ------------------------------- VAE ---------------------------------- #


def _res_block(out, dst, sd, prefix) -> None:
    _norm(out, f"{dst}.norm1", sd, f"{prefix}.norm1")
    put_conv(out, f"{dst}.conv1", sd, f"{prefix}.conv1")
    _norm(out, f"{dst}.norm2", sd, f"{prefix}.norm2")
    put_conv(out, f"{dst}.conv2", sd, f"{prefix}.conv2")
    if f"{prefix}.nin_shortcut.weight" in sd:
        put_conv(out, f"{dst}.nin_shortcut", sd, f"{prefix}.nin_shortcut")


def _mid(out, dst, sd, prefix) -> None:
    _res_block(out, f"{dst}.block_1", sd, f"{prefix}.block_1")
    a, d = f"{prefix}.attn_1", f"{dst}.attn_1"
    _norm(out, f"{d}.norm", sd, f"{a}.norm")
    for q in ("q", "k", "v", "proj_out"):
        put_conv(out, f"{d}.{q}", sd, f"{a}.{q}")
    _res_block(out, f"{dst}.block_2", sd, f"{prefix}.block_2")


def convert_vae_state_dict(sd, cfg: VAEConfig = None) -> dict:
    """CompVis ``AutoencoderKL`` state dict → :class:`VAE`'s. The
    checkpoint's ``decoder.up`` is indexed outermost first (``up.0`` runs
    last); the port keeps the levels in the order they run, so its level
    ``m`` reads ``up.<L-1-m>``."""
    cfg = cfg or VAEConfig()
    sd = _TrackingDict(sd)
    L = len(cfg.ch_mult)
    out = {}
    put_conv(out, "encoder.conv_in", sd, "encoder.conv_in")
    for i in range(L):
        src, d = f"encoder.down.{i}", f"encoder.down.{i}"
        for j in range(cfg.num_res_blocks):
            _res_block(out, f"{d}.block.{j}", sd, f"{src}.block.{j}")
        if f"{src}.downsample.conv.weight" in sd:
            put_conv(out, f"{d}.downsample", sd, f"{src}.downsample.conv")
    _mid(out, "encoder.mid", sd, "encoder.mid")
    _norm(out, "encoder.norm_out", sd, "encoder.norm_out")
    put_conv(out, "encoder.conv_out", sd, "encoder.conv_out")
    put_conv(out, "decoder.conv_in", sd, "decoder.conv_in")
    _mid(out, "decoder.mid", sd, "decoder.mid")
    for m in range(L):
        src, d = f"decoder.up.{L - 1 - m}", f"decoder.up.{m}"
        for j in range(cfg.num_res_blocks + 1):
            _res_block(out, f"{d}.block.{j}", sd, f"{src}.block.{j}")
        if f"{src}.upsample.conv.weight" in sd:
            put_conv(out, f"{d}.upsample", sd, f"{src}.upsample.conv")
    _norm(out, "decoder.norm_out", sd, "decoder.norm_out")
    put_conv(out, "decoder.conv_out", sd, "decoder.conv_out")
    put_conv(out, "quant_conv", sd, "quant_conv")
    put_conv(out, "post_quant_conv", sd, "post_quant_conv")
    _strict(sd, "ldm_vae")
    return as_state_dict(out)


def vae_schema(cfg: VAEConfig = None) -> dict:
    cfg = cfg or VAEConfig()
    out = {}
    L = len(cfg.ch_mult)

    def conv(prefix, cout, cin, k):
        out[f"{prefix}.weight"] = (cout, cin, k, k)
        out[f"{prefix}.bias"] = (cout,)

    def norm(prefix, c):
        out[f"{prefix}.weight"] = (c,)
        out[f"{prefix}.bias"] = (c,)

    def res(prefix, cin, cout):
        norm(f"{prefix}.norm1", cin)
        conv(f"{prefix}.conv1", cout, cin, 3)
        norm(f"{prefix}.norm2", cout)
        conv(f"{prefix}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{prefix}.nin_shortcut", cout, cin, 1)

    def attn(prefix, c):
        norm(f"{prefix}.norm", c)
        for q in ("q", "k", "v", "proj_out"):
            conv(f"{prefix}.{q}", c, c, 1)

    conv("encoder.conv_in", cfg.ch, cfg.in_channels, 3)
    ch = cfg.ch
    for i, m in enumerate(cfg.ch_mult):
        cout = cfg.ch * m
        for j in range(cfg.num_res_blocks):
            res(f"encoder.down.{i}.block.{j}", ch, cout)
            ch = cout
        if i != L - 1:
            conv(f"encoder.down.{i}.downsample.conv", ch, ch, 3)
    res("encoder.mid.block_1", ch, ch)
    attn("encoder.mid.attn_1", ch)
    res("encoder.mid.block_2", ch, ch)
    norm("encoder.norm_out", ch)
    conv("encoder.conv_out", 2 * cfg.z_channels, ch, 3)

    block_in = cfg.ch * cfg.ch_mult[-1]
    conv("decoder.conv_in", block_in, cfg.z_channels, 3)
    res("decoder.mid.block_1", block_in, block_in)
    attn("decoder.mid.attn_1", block_in)
    res("decoder.mid.block_2", block_in, block_in)
    ch = block_in
    for i in reversed(range(L)):
        cout = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            res(f"decoder.up.{i}.block.{j}", ch, cout)
            ch = cout
        if i != 0:
            conv(f"decoder.up.{i}.upsample.conv", ch, ch, 3)
    norm("decoder.norm_out", ch)
    conv("decoder.conv_out", cfg.out_channels, ch, 3)
    conv("quant_conv", 2 * cfg.embed_dim, 2 * cfg.z_channels, 1)
    conv("post_quant_conv", cfg.z_channels, cfg.embed_dim, 1)
    return out


# ------------------------------- UNet --------------------------------- #


def _bare(out, dst, sd, prefix) -> None:
    """A bias-free linear as the port's bare ``[in, out]`` matrix."""
    out[dst] = to_np(sd[f"{prefix}.weight"]).astype("float32").T.copy()


def _spatial_transformer(out, dst, sd, prefix, depth) -> None:
    _norm(out, f"{dst}.norm", sd, f"{prefix}.norm")
    put_conv(out, f"{dst}.proj_in", sd, f"{prefix}.proj_in")
    for n in range(depth):
        b, d = f"{prefix}.transformer_blocks.{n}", f"{dst}.blocks.{n}"
        for attn in ("attn1", "attn2"):
            for q in ("to_q", "to_k", "to_v"):
                _bare(out, f"{d}.{attn}.{q}", sd, f"{b}.{attn}.{q}")
            put_linear(out, f"{d}.{attn}.to_out", sd, f"{b}.{attn}.to_out.0")
        put_linear(out, f"{d}.ff.proj", sd, f"{b}.ff.net.0.proj")
        put_linear(out, f"{d}.ff.out", sd, f"{b}.ff.net.2")
        for ln in ("norm1", "norm2", "norm3"):
            _norm(out, f"{d}.{ln}", sd, f"{b}.{ln}")
    put_conv(out, f"{dst}.proj_out", sd, f"{prefix}.proj_out")


def _unet_res(out, dst, sd, prefix) -> None:
    _norm(out, f"{dst}.in_norm", sd, f"{prefix}.in_layers.0")
    put_conv(out, f"{dst}.in_conv", sd, f"{prefix}.in_layers.2")
    put_linear(out, f"{dst}.emb", sd, f"{prefix}.emb_layers.1")
    _norm(out, f"{dst}.out_norm", sd, f"{prefix}.out_layers.0")
    put_conv(out, f"{dst}.out_conv", sd, f"{prefix}.out_layers.3")
    if f"{prefix}.skip_connection.weight" in sd:
        put_conv(out, f"{dst}.skip", sd, f"{prefix}.skip_connection")


def convert_unet_state_dict(sd, cfg: UNetConfig = None) -> dict:
    """CompVis ``UNetModel`` state dict → :class:`UNet`'s."""
    cfg = cfg or UNetConfig()
    sd = _TrackingDict(sd)
    depth = cfg.transformer_depth
    out = {}
    put_linear(out, "time_embed.l0", sd, "time_embed.0")
    put_linear(out, "time_embed.l2", sd, "time_embed.2")
    put_conv(out, "input_blocks.0.conv", sd, "input_blocks.0.0")
    ds, n = 1, 1
    for i in range(len(cfg.channel_mult)):
        for _ in range(cfg.num_res_blocks):
            d, src = f"input_blocks.{n}", f"input_blocks.{n}"
            _unet_res(out, f"{d}.res", sd, f"{src}.0")
            if ds in cfg.attention_resolutions:
                _spatial_transformer(out, f"{d}.attn", sd, f"{src}.1", depth)
            n += 1
        if i != len(cfg.channel_mult) - 1:
            put_conv(out, f"input_blocks.{n}.down", sd,
                     f"input_blocks.{n}.0.op")
            n += 1
            ds *= 2
    _unet_res(out, "middle.res1", sd, "middle_block.0")
    _spatial_transformer(out, "middle.attn", sd, "middle_block.1", depth)
    _unet_res(out, "middle.res2", sd, "middle_block.2")
    n = 0
    for i in reversed(range(len(cfg.channel_mult))):
        for j in range(cfg.num_res_blocks + 1):
            d, src = f"output_blocks.{n}", f"output_blocks.{n}"
            _unet_res(out, f"{d}.res", sd, f"{src}.0")
            idx = 1
            if ds in cfg.attention_resolutions:
                _spatial_transformer(out, f"{d}.attn", sd, f"{src}.{idx}",
                                     depth)
                idx += 1
            if i and j == cfg.num_res_blocks:
                put_conv(out, f"{d}.up", sd, f"{src}.{idx}.conv")
                ds //= 2
            n += 1
    _norm(out, "out.norm", sd, "out.0")
    put_conv(out, "out.conv", sd, "out.2")
    _strict(sd, "ldm_unet")
    return as_state_dict(out)


def unet_schema(cfg: UNetConfig = None) -> dict:
    cfg = cfg or UNetConfig()
    out = {}
    mc = cfg.model_channels

    def conv(prefix, cout, cin, k):
        out[f"{prefix}.weight"] = (cout, cin, k, k)
        out[f"{prefix}.bias"] = (cout,)

    def lin(prefix, dout, din, bias=True):
        out[f"{prefix}.weight"] = (dout, din)
        if bias:
            out[f"{prefix}.bias"] = (dout,)

    def norm(prefix, c):
        out[f"{prefix}.weight"] = (c,)
        out[f"{prefix}.bias"] = (c,)

    def res(prefix, cin, cout):
        norm(f"{prefix}.in_layers.0", cin)
        conv(f"{prefix}.in_layers.2", cout, cin, 3)
        lin(f"{prefix}.emb_layers.1", cout, cfg.emb_dim)
        norm(f"{prefix}.out_layers.0", cout)
        conv(f"{prefix}.out_layers.3", cout, cout, 3)
        if cin != cout:
            conv(f"{prefix}.skip_connection", cout, cin, 1)

    def st(prefix, c):
        norm(f"{prefix}.norm", c)
        conv(f"{prefix}.proj_in", c, c, 1)
        for d in range(cfg.transformer_depth):
            b = f"{prefix}.transformer_blocks.{d}"
            lin(f"{b}.attn1.to_q", c, c, bias=False)
            lin(f"{b}.attn1.to_k", c, c, bias=False)
            lin(f"{b}.attn1.to_v", c, c, bias=False)
            lin(f"{b}.attn1.to_out.0", c, c)
            lin(f"{b}.attn2.to_q", c, c, bias=False)
            lin(f"{b}.attn2.to_k", c, cfg.context_dim, bias=False)
            lin(f"{b}.attn2.to_v", c, cfg.context_dim, bias=False)
            lin(f"{b}.attn2.to_out.0", c, c)
            lin(f"{b}.ff.net.0.proj", c * 8, c)
            lin(f"{b}.ff.net.2", c, c * 4)
            norm(f"{b}.norm1", c)
            norm(f"{b}.norm2", c)
            norm(f"{b}.norm3", c)
        conv(f"{prefix}.proj_out", c, c, 1)

    lin("time_embed.0", cfg.emb_dim, mc)
    lin("time_embed.2", cfg.emb_dim, cfg.emb_dim)
    conv("input_blocks.0.0", mc, cfg.in_channels, 3)
    ch, ds, n = mc, 1, 1
    skip_chs = [mc]
    for i, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            res(f"input_blocks.{n}.0", ch, mult * mc)
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                st(f"input_blocks.{n}.1", ch)
            skip_chs.append(ch)
            n += 1
        if i != len(cfg.channel_mult) - 1:
            conv(f"input_blocks.{n}.0.op", ch, ch, 3)
            skip_chs.append(ch)
            n += 1
            ds *= 2
    res("middle_block.0", ch, ch)
    st("middle_block.1", ch)
    res("middle_block.2", ch, ch)
    n = 0
    for i, mult in reversed(list(enumerate(cfg.channel_mult))):
        for j in range(cfg.num_res_blocks + 1):
            res(f"output_blocks.{n}.0", ch + skip_chs.pop(), mult * mc)
            ch = mult * mc
            idx = 1
            if ds in cfg.attention_resolutions:
                st(f"output_blocks.{n}.{idx}", ch)
                idx += 1
            if i and j == cfg.num_res_blocks:
                conv(f"output_blocks.{n}.{idx}.conv", ch, ch, 3)
                ds //= 2
            n += 1
    norm("out.0", ch)
    conv("out.2", cfg.out_channels, ch, 3)
    return out


# --------------------------- full checkpoint --------------------------- #

_DROP_PREFIXES = (
    "model_ema.", "cond_stage_model.", "loss.", "first_stage_model.loss.",
    "scale_factor", "logvar", "betas", "alphas", "posterior", "sqrt_",
    "log_one_minus", "lvlb_weights",
)


def split_ldm_checkpoint(sd) -> dict:
    """Full LDM checkpoint → {"vae": sub_sd, "unet": sub_sd} with the
    training-only keys (EMA shadows, loss nets, registered DDPM-schedule
    buffers) dropped; the vocoder ships as a separate vendor file."""
    vae, unet = {}, {}
    for k, v in sd.items():
        if k.startswith("first_stage_model.loss."):
            continue
        if k.startswith("first_stage_model."):
            vae[k[len("first_stage_model."):]] = v
        elif k.startswith("model.diffusion_model."):
            unet[k[len("model.diffusion_model."):]] = v
        elif any(k.startswith(p) for p in _DROP_PREFIXES):
            continue
    return {"vae": vae, "unet": unet}
