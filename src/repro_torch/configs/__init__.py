"""Copies of the architecture configurations."""
