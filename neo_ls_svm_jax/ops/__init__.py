"""Op layer: feature maps, affine stack, kernels, and statistics primitives."""

from neo_ls_svm_jax.ops.affine import AffineFeatureMap, AffineNormalizer, AffineSeparator
from neo_ls_svm_jax.ops.kernels import rbf_kernel, squared_distances
from neo_ls_svm_jax.ops.orff import (
    KernelApproximatingFeatureMap,
    OrthogonalRandomFourierFeatures,
    RandomFourierFeatures,
    complexity_sinc_matrix,
)
from neo_ls_svm_jax.ops.quantizer import (
    Quantizer,
    hist_quantized_ecdf,
    sample_bins_quantized_ecdf,
    sample_weights_quantized_ecdf,
)
from neo_ls_svm_jax.ops.weighted_quantile import weighted_quantile, weighted_quantile_jax

__all__ = [
    "AffineFeatureMap",
    "AffineNormalizer",
    "AffineSeparator",
    "KernelApproximatingFeatureMap",
    "OrthogonalRandomFourierFeatures",
    "Quantizer",
    "RandomFourierFeatures",
    "complexity_sinc_matrix",
    "hist_quantized_ecdf",
    "rbf_kernel",
    "sample_bins_quantized_ecdf",
    "sample_weights_quantized_ecdf",
    "squared_distances",
    "weighted_quantile",
    "weighted_quantile_jax",
]
