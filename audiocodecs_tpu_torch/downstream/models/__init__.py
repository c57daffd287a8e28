"""Downstream models: the WavLM x-vector speaker encoder, the multi-codebook
embedding and head, codebook pooling and the Llama-style decoder."""
