"""Batched Risk engine: state, rules and featurization (PyTorch)."""
