"""Downstream models: the WavLM x-vector speaker encoder."""
