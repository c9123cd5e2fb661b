"""Model layer: estimator orchestration, solvers, and calibrators."""

from neo_ls_svm_jax.models.cqr import CoherentLinearQuantileRegressor
from neo_ls_svm_jax.models.estimator import NeoLSSVM
from neo_ls_svm_jax.models.isotonic import IsotonicCalibrator

__all__ = ["CoherentLinearQuantileRegressor", "IsotonicCalibrator", "NeoLSSVM"]
