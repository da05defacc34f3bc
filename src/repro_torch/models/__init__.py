"""Dense decoder-only models in PyTorch (the GQA family)."""
