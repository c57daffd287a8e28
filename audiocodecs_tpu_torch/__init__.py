"""audiocodecs_tpu_torch: the codec framework on PyTorch and CUDA (Hopper).

A port of ``audiocodecs_tpu`` that keeps its module names and its tensor
contract (``[B, T]`` waveforms ↔ ``[B, N, K]`` tokens ↔ ``[B, N, H]``
features). It imports ``torch``, never ``jax`` and nothing of
``audiocodecs_tpu``. Hand-written CUDA kernels live in ``csrc/`` and are
built at first use (:mod:`audiocodecs_tpu_torch.ops._build`).

Importing the package is light: the codec classes load on first access.
"""

__all__ = ["AudioDec", "AudioDecModelConfig", "BiCodec",
           "BiCodecModelConfig", "BigCodec", "BigCodecModelConfig", "Codec",
           "CodecConfig", "DAC", "DACModelConfig", "DyCAST",
           "DyCASTModelConfig", "Encodec", "EncodecModelConfig",
           "FocalCodec", "FocalCodecModelConfig", "HILCodec",
           "HILCodecModelConfig", "MagiCodec", "MagiCodecModelConfig",
           "Mimi", "MimiModelConfig", "NanoCodec", "NanoCodecModelConfig",
           "PAST", "SEANetRVQCodec", "SEANetRVQConfig", "SemantiCodec",
           "SemantiCodecModelConfig", "SpeechTokenizer",
           "SpeechTokenizerModelConfig", "StableCodec",
           "StableCodecModelConfig", "WavLMKmeans", "WavLMKmeansModelConfig",
           "WavTokenizer", "WavTokenizerModelConfig", "XCodec2",
           "XCodec2ModelConfig"]

_LAZY = {
    "SemantiCodec": "audiocodecs_tpu_torch.models.semanticodec",
    "SemantiCodecModelConfig": "audiocodecs_tpu_torch.models.semanticodec",
    "BiCodec": "audiocodecs_tpu_torch.models.bicodec",
    "BiCodecModelConfig": "audiocodecs_tpu_torch.models.bicodec",
    "DyCAST": "audiocodecs_tpu_torch.models.dycast",
    "DyCASTModelConfig": "audiocodecs_tpu_torch.models.dycast",
    "FocalCodec": "audiocodecs_tpu_torch.models.focalcodec",
    "FocalCodecModelConfig": "audiocodecs_tpu_torch.models.focalcodec",
    "WavLMKmeans": "audiocodecs_tpu_torch.models.wavlm_kmeans",
    "WavLMKmeansModelConfig": "audiocodecs_tpu_torch.models.wavlm_kmeans",
    "AudioDec": "audiocodecs_tpu_torch.models.audiodec",
    "AudioDecModelConfig": "audiocodecs_tpu_torch.models.audiodec",
    "HILCodec": "audiocodecs_tpu_torch.models.hilcodec",
    "HILCodecModelConfig": "audiocodecs_tpu_torch.models.hilcodec",
    "MagiCodec": "audiocodecs_tpu_torch.models.magicodec",
    "MagiCodecModelConfig": "audiocodecs_tpu_torch.models.magicodec",
    "NanoCodec": "audiocodecs_tpu_torch.models.nanocodec",
    "NanoCodecModelConfig": "audiocodecs_tpu_torch.models.nanocodec",
    "StableCodec": "audiocodecs_tpu_torch.models.stablecodec",
    "StableCodecModelConfig": "audiocodecs_tpu_torch.models.stablecodec",
    "XCodec2": "audiocodecs_tpu_torch.models.xcodec2",
    "XCodec2ModelConfig": "audiocodecs_tpu_torch.models.xcodec2",
    "BigCodec": "audiocodecs_tpu_torch.models.bigcodec",
    "BigCodecModelConfig": "audiocodecs_tpu_torch.models.bigcodec",
    "Codec": "audiocodecs_tpu_torch.codec",
    "CodecConfig": "audiocodecs_tpu_torch.codec",
    "DAC": "audiocodecs_tpu_torch.models.dac",
    "DACModelConfig": "audiocodecs_tpu_torch.models.dac",
    "Encodec": "audiocodecs_tpu_torch.models.encodec",
    "EncodecModelConfig": "audiocodecs_tpu_torch.models.encodec",
    "Mimi": "audiocodecs_tpu_torch.models.mimi",
    "MimiModelConfig": "audiocodecs_tpu_torch.models.mimi",
    "PAST": "audiocodecs_tpu_torch.models.past",
    "SEANetRVQCodec": "audiocodecs_tpu_torch.models.seanet_rvq",
    "SEANetRVQConfig": "audiocodecs_tpu_torch.models.seanet_rvq",
    "SpeechTokenizer": "audiocodecs_tpu_torch.models.speechtokenizer",
    "SpeechTokenizerModelConfig": "audiocodecs_tpu_torch.models.speechtokenizer",
    "WavTokenizer": "audiocodecs_tpu_torch.models.wavtokenizer",
    "WavTokenizerModelConfig": "audiocodecs_tpu_torch.models.wavtokenizer",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
