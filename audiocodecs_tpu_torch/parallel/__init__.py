"""Training and, later, the parallel layer: so far the single-device codec
training step (:mod:`.train`)."""
