"""The plain reference of the benchmark's cells.

A frozen copy of the port's plain PyTorch versions (rules, agents, search,
network), with the kernel dispatch removed: every function runs its plain
version on whatever device its tensors are on.  The copied docstrings are
the port's, kept as they were: where one names a kernel, this copy runs
the plain version it names beside it.  Tree reuse and the kernels' launch
code are left out.  It imports nothing of the program, and nothing of JAX.

``models/fast_infer.py``, ``params.py`` and ``play.py`` are the
benchmark's own: the inference network worked out from raw weights, the
weights, and the checks of the play cells.
"""
