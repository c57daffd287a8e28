"""Downstream evaluation: the metrics ported so far."""
