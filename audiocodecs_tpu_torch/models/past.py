"""PAST (Phonetic-Acoustic Speech Tokenizer), PyTorch.

Counterpart of ``audiocodecs_tpu/models/past.py``: at inference an
EnCodec-style SEANet and RVQ at 16 kHz (hop 320, 50 Hz; 8 × 1024 × 128
codebooks; LSTMs at H = 512). Its phonetic supervision belongs to training.
The ``streamable`` variant, the default, has causal convs, so its residual
blocks run the fused block kernel on the card and it streams
(:meth:`SEANetRVQCodec.encode_chunk`).
"""

from __future__ import annotations

from audiocodecs_tpu_torch.models.seanet_rvq import (
    SEANetRVQCodec,
    SEANetRVQConfig,
)

__all__ = ["PAST"]


class PAST(SEANetRVQCodec):
    DEFAULT_ORIG_SR = 16000

    @classmethod
    def default_model_config(cls, orig_sample_rate: int | None = None,
                             streamable: bool = True):
        return SEANetRVQConfig(
            sampling_rate=orig_sample_rate or cls.DEFAULT_ORIG_SR,
            num_filters=32,
            hidden_size=128,
            upsampling_ratios=(8, 5, 4, 2),
            codebook_size=1024,
            codebook_dim=128,
            num_quantizers=8,
            use_causal_conv=streamable,
        )
