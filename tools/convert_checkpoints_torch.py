"""Checkpoint conversion and codec warm-up for the PyTorch port.

The port's twin of ``tools/convert_checkpoints.py``: an upstream PyTorch
checkpoint → the port's own state dict, written with ``torch.save``, which
a codec takes as ``state_dict=`` after ``torch.load(path,
weights_only=True)``. No ``transformers`` and no JAX: an HF directory's
``config.json`` is read with ``json`` and its weights from
``model.safetensors`` (a plain reader of the format) or
``pytorch_model.bin``.

    # an HF directory (encodec, dac, mimi, wavlm)
    python tools/convert_checkpoints_torch.py convert encodec \\
        /path/to/encodec_24khz encodec_24khz.pt

    # a vendor file (torch.load-able; "state_dict" is unwrapped)
    python tools/convert_checkpoints_torch.py convert stablecodec \\
        model.ckpt stablecodec.pt [--key-map key_map.json]
    python tools/convert_checkpoints_torch.py convert bicodec \\
        BiCodec/model.pt bicodec.pt --w2v wav2vec2-large-xlsr-53/
    python tools/convert_checkpoints_torch.py convert hilcodec \\
        hilcodec.pt out.pt [--allow-partial]

    # the metric models: an HF directory (whisper, gpt2, wavlm_xvector),
    # a vendor file (utmos: hub or lightning layout, --key-map taken) or
    # DNSMOS's ONNX file (written as the npz the DNSMOS module reads)
    python tools/convert_checkpoints_torch.py convert whisper \\
        /path/to/whisper-large-v3 whisper.pt
    python tools/convert_checkpoints_torch.py convert utmos \\
        utmos22_strong.pt utmos.pt
    python tools/convert_checkpoints_torch.py convert dnsmos \\
        model_v8.onnx dnsmos.npz

    # build every registered codec once on the card
    python tools/convert_checkpoints_torch.py warmup

A vendor family converts at its codec's ``default_model_config()``.
``--key-map`` applies a rename overlay (``audiocodecs_tpu_torch/convert/
overlay.py``; ``tools/inspect_checkpoint_torch.py --emit-key-map`` drafts
one) before converting. ``--allow-partial`` lets HILCodec convert its
codebooks alone when its towers do not convert. ``semanticodec-ldm`` and
``semanticodec-vocoder`` write the decoder's part of SemantiCodec's state
dict; merge the parts with
``audiocodecs_tpu_torch.convert.zoo.convert_semanticodec_components``.

Then a codec at the checkpoint's config takes it, for example (EnCodec
24 kHz is the class's default config)::

    sd = torch.load("encodec_24khz.pt", weights_only=True)
    codec = get_codec_class("encodec")(24000, state_dict=sd)

and a metric takes its file, keeping the HF directory beside it for the
tokenizer and ``config.json``: ``make_dwer_metric(checkpoint="whisper.pt",
tokenizer_path=...)``, ``make_perplexity_metric(checkpoint="gpt2.pt",
tokenizer_path=...)``, ``make_utmos_checkpoint_metric("utmos.pt")``,
``make_speaker_similarity_metric(checkpoint="xvector.pt")`` (at the
default ``XVectorConfig``, or ``config=`` overrides).
"""

from __future__ import annotations

import importlib
import math
import sys
import traceback
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# HF families: (converter module, converter, config reader)
HF_CONVERTERS = {
    "encodec": ("encodec", "convert_encodec_state_dict",
                "encodec_config_from_hf"),
    "dac": ("dac", "convert_dac_state_dict", "dac_config_from_hf"),
    "mimi": ("mimi", "convert_mimi_state_dict", "mimi_config_from_hf"),
    "wavlm": ("wavlm", "convert_wavlm_state_dict", "wavlm_config_from_hf"),
    # the metric models' transcriber and language model
    "whisper": ("whisper", "convert_whisper_state_dict",
                "whisper_config_from_hf"),
    "gpt2": ("gpt2", "convert_gpt2_state_dict", "gpt2_config_from_hf"),
}

# the metric models that are no codec: (kind, converter of this module)
METRIC_CONVERTERS = ("utmos", "wavlm_xvector", "dnsmos")

# vendor families: (codec class, converter of convert.zoo)
VENDOR_CONVERTERS = {
    "speechtokenizer": ("speechtokenizer:SpeechTokenizer",
                        "convert_speechtokenizer_state_dict"),
    "past": ("past:PAST", "convert_past_state_dict"),
    "wavtokenizer": ("wavtokenizer:WavTokenizer",
                     "convert_wavtokenizer_state_dict"),
    # a dict of two state dicts, {"CodecEnc", "generator"}
    "bigcodec": ("bigcodec:BigCodec", "convert_bigcodec_state_dict"),
    "xcodec2": ("xcodec2:XCodec2", "convert_xcodec2_state_dict"),
    "stablecodec": ("stablecodec:StableCodec",
                    "convert_stablecodec_state_dict"),
    "nanocodec": ("nanocodec:NanoCodec", "convert_nanocodec_state_dict"),
    "audiodec": ("audiodec:AudioDec", "convert_audiodec_state_dict"),
    "focalcodec": ("focalcodec:FocalCodec", "convert_focalcodec_state_dict"),
    "magicodec": ("magicodec:MagiCodec", "convert_magicodec_state_dict"),
    # the wav2vec2-XLSR tower is a file of its own: --w2v
    "bicodec": ("bicodec:BiCodec", "convert_bicodec_state_dict"),
    "hilcodec": ("hilcodec:HILCodec", "convert_hilcodec_state_dict"),
    "dycast": ("dycast:DyCAST", "convert_dycast_state_dict"),
    # SemantiCodec's decoder: first_stage_model.* + model.diffusion_model.*
    # + scale_factor → vae.*, unet.*, latent_scale
    "semanticodec-ldm": ("semanticodec:SemantiCodec",
                         "convert_semanticodec_ldm_state_dict"),
    # its HiFi-GAN vocoder's file → vocoder.*
    "semanticodec-vocoder": ("semanticodec:SemantiCodec",
                             "convert_semanticodec_vocoder_state_dict"),
}

USAGE = ("usage: convert <family> <src> <out.pt> [--key-map overlay.json] "
         "[--allow-partial] [--w2v <xlsr dir or file>] | warmup")


def _model_config(family: str):
    module, cls = VENDOR_CONVERTERS[family][0].split(":")
    return getattr(importlib.import_module(
        f"audiocodecs_tpu_torch.models.{module}"), cls).default_model_config()


def hf_config(family: str, config: dict) -> SimpleNamespace:
    """``config.json`` as an object with the attributes of the family's HF
    config class, the ones HF derives (and does not save) included."""
    c = SimpleNamespace(**config)
    hop = math.prod(config.get("upsampling_ratios", [1]))
    if family == "encodec":
        frame_rate = math.ceil(c.sampling_rate / hop)
        c.num_quantizers = int(1000 * c.target_bandwidths[-1] // (
            frame_rate * math.ceil(math.log2(c.codebook_size))))
    elif family == "mimi":
        c.encodec_frame_rate = math.ceil(c.sampling_rate / hop)
        # HF's frame_size: the encoder's strides, and a last 2
        c.frame_rate = (config.get("frame_rate") or config.get("_frame_rate")
                        or c.sampling_rate / (2 * hop))
    return c


def _save(name: str, src: str, out: str, state: dict) -> int:
    import torch

    torch.save(state, out)
    n = sum(t.numel() for t in state.values())
    print(f"{name}: {src} -> {out} ({len(state)} tensors, "
          f"{n / 1e6:.2f} M parameters)")
    return 0


def convert_hf(family: str, src: str, out: str) -> int:
    """An HF model directory → the port's state dict, without
    ``transformers``."""
    from audiocodecs_tpu_torch.convert.checkpoint_files import (
        read_hf_directory)

    module, fn, cfg_fn = HF_CONVERTERS[family]
    mod = importlib.import_module(f"audiocodecs_tpu_torch.convert.{module}")
    config, sd = read_hf_directory(src)
    cfg = getattr(mod, cfg_fn)(hf_config(family, config))
    return _save(family, src, out, getattr(mod, fn)(sd, cfg))


def convert_vendor(family: str, src: str, out: str, key_map=None,
                   allow_partial: bool = False, w2v=None) -> int:
    """A vendor checkpoint file → the port's state dict, at the codec's
    published config."""
    from audiocodecs_tpu_torch.convert import zoo
    from audiocodecs_tpu_torch.convert.checkpoint_files import (
        load_checkpoint)
    from audiocodecs_tpu_torch.convert.overlay import apply_key_map

    sd = load_checkpoint(src)
    if key_map is not None:
        sd = apply_key_map(sd, key_map)
    kw = {}
    if family == "hilcodec":
        kw["allow_partial"] = allow_partial
    if family == "bicodec" and w2v is not None:
        kw["w2v_sd"] = load_checkpoint(w2v)
    convert = getattr(zoo, VENDOR_CONVERTERS[family][1])
    return _save(family, src, out, convert(sd, _model_config(family), **kw))


def convert_utmos(src: str, out: str, key_map=None) -> int:
    """A UTMOS22-strong file (the hub's or a lightning checkpoint, the
    layout detected) → :class:`UTMOS`'s state dict at the default
    config."""
    from audiocodecs_tpu_torch.convert.checkpoint_files import (
        load_checkpoint)
    from audiocodecs_tpu_torch.downstream.metrics.utmos import (
        UTMOSConfig, convert_utmos_state_dict)

    return _save("utmos", src, out, convert_utmos_state_dict(
        load_checkpoint(src), UTMOSConfig(), key_map=key_map))


def convert_xvector(src: str, out: str) -> int:
    """An HF ``WavLMForXVector`` directory → :class:`XVector`'s state dict
    at the directory's config."""
    from audiocodecs_tpu_torch.convert.checkpoint_files import (
        read_hf_directory)
    from audiocodecs_tpu_torch.convert.wavlm import wavlm_config_from_hf
    from audiocodecs_tpu_torch.downstream.models.speaker_encoder import (
        XVectorConfig, convert_xvector_state_dict)

    config, sd = read_hf_directory(src)
    cfg = XVectorConfig(
        wavlm=wavlm_config_from_hf(SimpleNamespace(**config)),
        tdnn_dim=tuple(config["tdnn_dim"]),
        tdnn_kernel=tuple(config["tdnn_kernel"]),
        tdnn_dilation=tuple(config["tdnn_dilation"]),
        xvector_dim=config["xvector_output_dim"],
        use_weighted_layer_sum=config["use_weighted_layer_sum"])
    return _save("wavlm_xvector", src, out,
                 convert_xvector_state_dict(sd, cfg))


def convert_dnsmos(src: str, out: str) -> int:
    """DNSMOS's ``model_v8.onnx`` → the npz of the port's DNSMOS
    (``dnsmos_p808(..., params_path=out)``)."""
    from audiocodecs_tpu_torch.downstream.metrics.dnsmos import (
        save_dnsmos_params)

    flat = save_dnsmos_params(src, out)
    n = sum(a.size for a in flat.values())
    print(f"dnsmos: {src} -> {out} ({n / 1e3:.1f} K parameters)")
    return 0


def warmup() -> int:
    """Build every registered codec once on the card (its published
    config, its own seeded weights); non-zero if any fails, each failure
    printed with its traceback."""
    from audiocodecs_tpu_torch.models import available_codecs, get_codec_class

    names = available_codecs()
    failed = []
    for name in names:
        try:
            codec = get_codec_class(name)(16000, mode="encode")
            print(f"  {name}: ok on {codec.device} "
                  f"(K={codec.config.num_codebooks}, "
                  f"C={codec.config.vocab_size})")
            del codec
        except Exception:
            failed.append(name)
            print(f"  {name}: FAILED")
            traceback.print_exc()
    print(f"warmup: {len(names) - len(failed)}/{len(names)} families built"
          + (f"; failed: {', '.join(failed)}" if failed else ""))
    return 1 if failed else 0


def _option(argv: list, name: str, flag: bool = False):
    """Take ``name`` (and its value unless ``flag``) out of ``argv``."""
    if name not in argv:
        return False if flag else None
    i = argv.index(name)
    if flag:
        del argv[i]
        return True
    if i + 1 >= len(argv):
        raise SystemExit(f"{name} requires a value")
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    if not argv or argv[0] not in ("convert", "warmup"):
        print(__doc__)
        return 2
    if argv[0] == "warmup":
        return warmup()
    key_map = _option(argv, "--key-map")
    allow_partial = _option(argv, "--allow-partial", flag=True)
    w2v = _option(argv, "--w2v")
    if len(argv) != 4:
        print(USAGE)
        return 2
    _, family, src, out = argv
    if family in HF_CONVERTERS or family in METRIC_CONVERTERS:
        if (key_map and family != "utmos") or allow_partial or w2v:
            print(f"--key-map, --allow-partial and --w2v are for vendor "
                  f"families (and --key-map for utmos), not {family!r}")
            return 2
        if family == "utmos":
            return convert_utmos(src, out, key_map)
        if family == "wavlm_xvector":
            return convert_xvector(src, out)
        if family == "dnsmos":
            return convert_dnsmos(src, out)
        return convert_hf(family, src, out)
    if family not in VENDOR_CONVERTERS:
        print(f"no converter for {family!r}; available: "
              f"{sorted(HF_CONVERTERS) + sorted(METRIC_CONVERTERS)}"
              f" + {sorted(VENDOR_CONVERTERS)}")
        return 2
    if allow_partial and family != "hilcodec":
        print("--allow-partial is for hilcodec")
        return 2
    if w2v and family != "bicodec":
        print("--w2v is for bicodec")
        return 2
    try:
        return convert_vendor(family, src, out, key_map=key_map,
                              allow_partial=allow_partial, w2v=w2v)
    except (KeyError, ValueError) as e:
        print(f"{family}: conversion failed: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
