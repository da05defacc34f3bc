"""Optimizers of the port (AdamW, the PS-side update)."""
