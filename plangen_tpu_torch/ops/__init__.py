"""Attention, sampling and the prefix decode-attention kernel wrapper."""
