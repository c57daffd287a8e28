"""The codec families, reached by the JAX package's registry names.

:func:`get_codec_class` resolves a name lazily (the module is imported on
first use), as ``audiocodecs_tpu.models.get_codec_class`` does. Every name
the reference registers is ported; names the reference registers but the
port has not ported (``_NOT_PORTED``, empty now) raise
``NotImplementedError``; names neither package knows raise ``ValueError``.
``SEANetRVQCodec`` has no registry name in the reference, so it has none
here either (import it from :mod:`.seanet_rvq`).
"""

__all__ = ["available_codecs", "get_codec_class"]

_CODEC_REGISTRY = {
    "encodec": ("audiocodecs_tpu_torch.models.encodec", "Encodec"),
    "dac": ("audiocodecs_tpu_torch.models.dac", "DAC"),
    "mimi": ("audiocodecs_tpu_torch.models.mimi", "Mimi"),
    "speechtokenizer": ("audiocodecs_tpu_torch.models.speechtokenizer",
                        "SpeechTokenizer"),
    "wavtokenizer": ("audiocodecs_tpu_torch.models.wavtokenizer",
                     "WavTokenizer"),
    "past": ("audiocodecs_tpu_torch.models.past", "PAST"),
    "bigcodec": ("audiocodecs_tpu_torch.models.bigcodec", "BigCodec"),
    "audiodec": ("audiocodecs_tpu_torch.models.audiodec", "AudioDec"),
    "hilcodec": ("audiocodecs_tpu_torch.models.hilcodec", "HILCodec"),
    "nanocodec": ("audiocodecs_tpu_torch.models.nanocodec", "NanoCodec"),
    "xcodec2": ("audiocodecs_tpu_torch.models.xcodec2", "XCodec2"),
    "stablecodec": ("audiocodecs_tpu_torch.models.stablecodec",
                    "StableCodec"),
    "magicodec": ("audiocodecs_tpu_torch.models.magicodec", "MagiCodec"),
    "wavlm_kmeans": ("audiocodecs_tpu_torch.models.wavlm_kmeans",
                     "WavLMKmeans"),
    "dycast": ("audiocodecs_tpu_torch.models.dycast", "DyCAST"),
    "focalcodec": ("audiocodecs_tpu_torch.models.focalcodec", "FocalCodec"),
    "bicodec": ("audiocodecs_tpu_torch.models.bicodec", "BiCodec"),
    "semanticodec": ("audiocodecs_tpu_torch.models.semanticodec",
                     "SemantiCodec"),
}

# registered by the reference package, not ported yet
_NOT_PORTED = ()


def get_codec_class(name: str):
    """The codec class registered under ``name`` (case-insensitive)."""
    import importlib

    key = name.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"codec {name!r} is registered in the reference package but not "
            f"ported to audiocodecs_tpu_torch yet; ported: "
            f"{', '.join(available_codecs())}")
    try:
        module, cls = _CODEC_REGISTRY[key]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; available: "
            f"{', '.join(available_codecs())}") from None
    return getattr(importlib.import_module(module), cls)


def available_codecs():
    """The registry names the port resolves, sorted."""
    return sorted(_CODEC_REGISTRY)
