"""Neo LS-SVM, rebuilt on JAX/XLA.

Public API parity with the reference package (``src/neo_ls_svm/__init__.py``): the one
exported symbol is ``NeoLSSVM``. The building blocks (feature maps, affine stack,
calibrators, solvers) are importable from their submodules.
"""

from neo_ls_svm_jax.models.estimator import NeoLSSVM

__all__ = ["NeoLSSVM"]
__version__ = "0.6.0"
