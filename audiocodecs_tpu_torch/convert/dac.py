"""HF / descript DAC checkpoint → the port's :class:`..models.dac.DAC`.

Counterpart of ``audiocodecs_tpu/convert/dac.py``. Snake ``α`` is stored
``[1, C, 1]`` upstream and ``[C]`` in the port; each quantizer stage keeps
its 1×1 ``in_proj``/``out_proj`` convs and its codebook. Conv weights may
carry weight norm (descript's checkpoints) or not (``transformers``'
``DacModel``); either folds to the same weights. :func:`dac_schema` is the
``DacModel`` state dict's surface for a config.
"""

from __future__ import annotations

from audiocodecs_tpu_torch.convert.torch_utils import (
    as_state_dict,
    put_alpha,
    put_conv,
    to_np,
)
from audiocodecs_tpu_torch.models.dac import DACModelConfig

__all__ = ["convert_dac_state_dict", "dac_config_from_hf", "dac_schema"]

_FIELDS = ("sampling_rate", "encoder_hidden_size", "decoder_hidden_size",
           "hidden_size", "n_codebooks", "codebook_size", "codebook_dim")


def dac_config_from_hf(hf_config) -> DACModelConfig:
    """The architecture of any object with the attribute names of HF's
    ``DacConfig``."""
    return DACModelConfig(
        downsampling_ratios=tuple(hf_config.downsampling_ratios),
        upsampling_ratios=tuple(hf_config.upsampling_ratios),
        **{f: getattr(hf_config, f) for f in _FIELDS})


def _res_unit(out, dst, sd, src):
    put_alpha(out, f"{dst}.alpha1", sd, f"{src}.snake1.alpha")
    put_conv(out, f"{dst}.conv1", sd, f"{src}.conv1")
    put_alpha(out, f"{dst}.alpha2", sd, f"{src}.snake2.alpha")
    put_conv(out, f"{dst}.conv2", sd, f"{src}.conv2")


def convert_dac_state_dict(sd, cfg: DACModelConfig) -> dict:
    """A DAC state dict → :class:`DAC`'s (``encoder.*``, ``decoder.*``,
    ``quantizer.<k>.*``). Keys it does not read are ignored, as the
    reference ignores them."""
    out = {}
    put_conv(out, "encoder.conv_in", sd, "encoder.conv1")
    for i in range(len(cfg.downsampling_ratios)):
        src, dst = f"encoder.block.{i}", f"encoder.blocks.{i}"
        for j in range(3):
            _res_unit(out, f"{dst}.res.{j}", sd, f"{src}.res_unit{j + 1}")
        put_alpha(out, f"{dst}.alpha_down", sd, f"{src}.snake1.alpha")
        put_conv(out, f"{dst}.conv_down", sd, f"{src}.conv1")
    put_alpha(out, "encoder.alpha_out", sd, "encoder.snake1.alpha")
    put_conv(out, "encoder.conv_out", sd, "encoder.conv2")

    put_conv(out, "decoder.conv_in", sd, "decoder.conv1")
    for i in range(len(cfg.upsampling_ratios)):
        src, dst = f"decoder.block.{i}", f"decoder.blocks.{i}"
        put_alpha(out, f"{dst}.alpha_up", sd, f"{src}.snake1.alpha")
        put_conv(out, f"{dst}.convtr", sd, f"{src}.conv_t1")
        for j in range(3):
            _res_unit(out, f"{dst}.res.{j}", sd, f"{src}.res_unit{j + 1}")
    put_alpha(out, "decoder.alpha_out", sd, "decoder.snake1.alpha")
    put_conv(out, "decoder.conv_out", sd, "decoder.conv2")

    for k in range(cfg.n_codebooks):
        src = f"quantizer.quantizers.{k}"
        put_conv(out, f"quantizer.{k}.in_proj", sd, f"{src}.in_proj")
        put_conv(out, f"quantizer.{k}.out_proj", sd, f"{src}.out_proj")
        out[f"quantizer.{k}.codebook"] = to_np(
            sd[f"{src}.codebook.weight"]).astype("float32")
    return as_state_dict(out)


def _conv_schema(prefix, shape, cout):
    return {f"{prefix}.weight": shape, f"{prefix}.bias": (cout,)}


def _res_unit_schema(prefix, ch):
    return {f"{prefix}.snake1.alpha": (1, ch, 1),
            **_conv_schema(f"{prefix}.conv1", (ch, ch, 7), ch),
            f"{prefix}.snake2.alpha": (1, ch, 1),
            **_conv_schema(f"{prefix}.conv2", (ch, ch, 1), ch)}


def dac_schema(cfg: DACModelConfig) -> dict:
    """The HF ``DacModel`` state dict's keys and shapes for ``cfg``."""
    d = cfg.encoder_hidden_size
    s = _conv_schema("encoder.conv1", (d, 1, 7), d)
    for i, stride in enumerate(cfg.downsampling_ratios):
        p = f"encoder.block.{i}"
        for j in range(3):
            s.update(_res_unit_schema(f"{p}.res_unit{j + 1}", d))
        s[f"{p}.snake1.alpha"] = (1, d, 1)
        s.update(_conv_schema(f"{p}.conv1", (2 * d, d, 2 * stride), 2 * d))
        d *= 2
    s["encoder.snake1.alpha"] = (1, d, 1)
    s.update(_conv_schema("encoder.conv2", (cfg.hidden_size, d, 3),
                          cfg.hidden_size))
    d = cfg.decoder_hidden_size
    s.update(_conv_schema("decoder.conv1", (d, cfg.hidden_size, 7), d))
    for i, stride in enumerate(cfg.upsampling_ratios):
        p = f"decoder.block.{i}"
        s[f"{p}.snake1.alpha"] = (1, d, 1)
        s.update(_conv_schema(f"{p}.conv_t1", (d, d // 2, 2 * stride),
                              d // 2))
        d //= 2
        for j in range(3):
            s.update(_res_unit_schema(f"{p}.res_unit{j + 1}", d))
    s["decoder.snake1.alpha"] = (1, d, 1)
    s.update(_conv_schema("decoder.conv2", (1, d, 7), 1))
    H, D = cfg.hidden_size, cfg.codebook_dim
    for k in range(cfg.n_codebooks):
        p = f"quantizer.quantizers.{k}"
        s.update(_conv_schema(f"{p}.in_proj", (D, H, 1), D))
        s.update(_conv_schema(f"{p}.out_proj", (H, D, 1), H))
        s[f"{p}.codebook.weight"] = (cfg.codebook_size, D)
    return s
