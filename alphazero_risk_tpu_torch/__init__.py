"""alphazero_risk_tpu_torch: the PyTorch/CUDA port of ``alphazero_risk_tpu``.

The JAX package beside it is the reference.  This package imports torch,
numpy and the standard library only, never JAX nor any module of the JAX
package.  Module and public function names follow the JAX package, so each
counterpart is found under the same path.

Importing the package is side-effect free: kernels are built at first use
(``kernels.py``), never at import.
"""

from .config import Config, DEFAULT_CONFIG

__version__ = "0.1.0"
