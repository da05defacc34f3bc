"""Deterministic synthetic training data (host-side numpy)."""
