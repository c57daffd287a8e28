"""Runnable examples (``python -m audiocodecs_tpu_torch.examples.<name>``)."""
