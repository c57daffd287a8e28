"""Host-side helpers: audio I/O and checkpoints."""
