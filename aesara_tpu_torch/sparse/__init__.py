"""Sparse matrices in the port (reference ``aesara_tpu/sparse``): the CSR
and CSC types, the ops a sparse-input model uses, ``shared`` of a SciPy
matrix, and the rewrites that put them on the CSR kernels (importing
this package registers them)."""

from aesara_tpu_torch.sparse import rewriting  # noqa: F401
from aesara_tpu_torch.sparse.basic import (  # noqa: F401
    DenseFromSparse, Dot, SparseFromDense, SparseVariable, StructuredDot, StructuredDotGradA,
    Transpose, Usmm, as_sparse_variable, csr_matrix, dense_from_sparse, dot, matrix,
    structured_dot, transpose,
)
from aesara_tpu_torch.sparse.sharedvar import SparseTensorSharedVariable, sparse_shared  # noqa: F401
from aesara_tpu_torch.sparse.type import SparseTensorType  # noqa: F401
