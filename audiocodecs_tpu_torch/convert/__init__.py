"""Upstream PyTorch checkpoints → the port's own state dicts."""
