"""Copies of the discrete-event pricing engine."""
