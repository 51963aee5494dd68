"""``CSRMat``: the device form of a sparse matrix (the counterpart of
``BSSMat`` / ``csr_to_bss``, ``aesara_tpu/link/jax/bss.py:60-177``).

The TPU needed the blocked segment-slot layout because Mosaic has one
gather shape; a GPU gathers freely, so the port keeps plain CSR: ``indptr``
(n + 1) and ``indices`` (nnz) as int32, ``data`` (nnz) in the matrix's own
dtype (float64 stays float64: the card has fp64), and the logical
``shape``.  ``t`` optionally holds the CSR of the transpose, built with the
matrix when the graph transposes it, so the gradient's ``xᵀ @ g`` runs as
a row-parallel product with no atomics.  ``plans`` keeps what the kernels
derive from the pattern alone (K6's chunk plan, by chunk size); the
wrappers that ``transpose()`` and ``with_data`` make share it with the
matrices they come from, so it is made once per pattern.

A matrix is built on the host from SciPy: duplicates are summed on a copy
(stored zeros stay stored, as in SciPy), then each array is uploaded once.
"""

from __future__ import annotations

import numpy as np


__all__ = ["CSRMat"]


class CSRMat:
    """A CSR matrix on one torch device, with an optional transposed twin."""

    __slots__ = ("indptr", "indices", "data", "shape", "t", "plans")

    def __init__(self, indptr, indices, data, shape, t=None, plans=None):
        self.indptr = indptr
        self.indices = indices
        self.data = data
        self.shape = tuple(int(s) for s in shape)
        self.t = t
        self.plans = {} if plans is None else plans

    @property
    def device(self):
        return self.data.device

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @classmethod
    def from_scipy(cls, x, device, with_transpose: bool = False) -> "CSRMat":
        """Upload the SciPy matrix ``x`` (any format); with
        ``with_transpose`` also the CSR of its transpose."""
        import torch

        csr = x.tocsr(copy=True)
        csr.sum_duplicates()
        if csr.nnz >= 2**31:
            raise ValueError(f"{csr.nnz} stored entries: int32 indices take fewer than 2**31")

        def upload(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

        t = cls.from_scipy(csr.T, device) if with_transpose else None
        return cls(upload(csr.indptr, np.int32), upload(csr.indices, np.int32), upload(csr.data),
                   csr.shape, t=t)

    def with_data(self, data) -> "CSRMat":
        """The same pattern with other values (no transposed twin)."""
        return CSRMat(self.indptr, self.indices, data, self.shape, plans=self.plans)

    def transpose(self) -> "CSRMat":
        """The transpose, relinked so that transposing again gives this
        matrix back."""
        if self.t is None:
            raise ValueError("this CSRMat has no transposed twin: the linker builds one only for "
                             "a graph input that the graph transposes")
        t = self.t
        return CSRMat(t.indptr, t.indices, t.data, t.shape, plans=t.plans,
                      t=CSRMat(self.indptr, self.indices, self.data, self.shape, plans=self.plans))

    def to_scipy(self, format: str = "csr"):
        """A SciPy matrix with exactly this pattern and these values."""
        import scipy.sparse as sp

        m = sp.csr_matrix((self.data.detach().cpu().numpy(), self.indices.cpu().numpy(),
                           self.indptr.cpu().numpy()), shape=self.shape)
        return m.asformat(format)

    def __repr__(self):
        return (f"CSRMat(shape={self.shape}, nnz={self.nnz}, dtype={self.dtype}, "
                f"device={self.device}, transposed_twin={self.t is not None})")
