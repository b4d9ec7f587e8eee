"""The benchmark of the PyTorch/CUDA port (``alphazero_risk_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; see ``README.md``.
"""
