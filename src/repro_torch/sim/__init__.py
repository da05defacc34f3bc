"""Copies of the discrete-event pricing engines (scalar and array), the
baselines and the per-batch simulator of the reference."""
