"""Shared array-type vocabulary.

JAX counterpart of the reference's type aliases (``src/neo_ls_svm/_typing.py:14-32``).
On the JAX side every device array is a ``jax.Array``; host-side staging uses NumPy. The
aliases below exist so signatures communicate intent (vector vs matrix, float vs int)
without constraining runtime behaviour.
"""

from typing import TypeAlias, Union

import jax
import numpy as np
import numpy.typing as npt

Array: TypeAlias = jax.Array

FloatVector: TypeAlias = Union[npt.NDArray[np.floating], jax.Array]
FloatMatrix: TypeAlias = Union[npt.NDArray[np.floating], jax.Array]
FloatTensor: TypeAlias = Union[npt.NDArray[np.floating], jax.Array]

ComplexVector: TypeAlias = Union[npt.NDArray[np.complexfloating], jax.Array]
ComplexMatrix: TypeAlias = Union[npt.NDArray[np.complexfloating], jax.Array]
ComplexTensor: TypeAlias = Union[npt.NDArray[np.complexfloating], jax.Array]

IntegerVector: TypeAlias = Union[npt.NDArray[np.integer], jax.Array]
IntegerMatrix: TypeAlias = Union[npt.NDArray[np.integer], jax.Array]
IntegerTensor: TypeAlias = Union[npt.NDArray[np.integer], jax.Array]

GenericVector: TypeAlias = npt.NDArray[np.generic]
GenericMatrix: TypeAlias = npt.NDArray[np.generic]

NumberVector: TypeAlias = Union[npt.NDArray[np.number], jax.Array]
NumberMatrix: TypeAlias = Union[npt.NDArray[np.number], jax.Array]
