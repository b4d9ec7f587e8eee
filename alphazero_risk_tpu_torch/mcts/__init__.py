"""Batched array MCTS with exact chance nodes (PyTorch + CUDA kernels)."""
