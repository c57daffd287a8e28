"""Codec families ported so far."""
