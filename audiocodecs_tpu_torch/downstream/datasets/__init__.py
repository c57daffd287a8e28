"""Manifests, corpora and the bucketed loader (host code)."""
