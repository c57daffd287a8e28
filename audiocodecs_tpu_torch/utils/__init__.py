"""Host-side helpers: audio I/O, checkpoints, masks and windowed long-audio
reconstruction."""

from audiocodecs_tpu_torch.utils import (  # noqa: F401
    audio,
    checkpoint,
    masking,
    windowed,
)
