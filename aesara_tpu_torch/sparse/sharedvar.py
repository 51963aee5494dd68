"""Sparse shared variables (reference ``aesara_tpu/sparse/sharedvar.py``):
``shared(scipy_matrix)`` holds the matrix on the host.

``get_value`` returns a copy of the SciPy matrix and ``set_value`` takes
one.  The linker builds the device CSR form (``link/torch/csr.py``) the
first time a compiled function reads the variable, keeps it while the
value object stays the same, and builds it again after ``set_value``.
"""

from __future__ import annotations

from aesara_tpu_torch.compile.sharedvalue import SharedVariable
from aesara_tpu_torch.link.basic import resolve_device
from aesara_tpu_torch.sparse.basic import SparseVariable
from aesara_tpu_torch.sparse.type import SparseTensorType


__all__ = ["SparseTensorSharedVariable", "sparse_shared"]


class SparseTensorSharedVariable(SparseVariable, SharedVariable):
    """A shared variable holding a SciPy sparse matrix; ``device`` is where
    the functions that read it run."""

    def __init__(self, type, value, name=None, device=None):
        SparseVariable.__init__(self, type=type, owner=None, index=None, name=name)
        self.device = resolve_device(device)
        self._value = None
        self.set_value(value)

    def get_value(self):
        return self._value.copy()

    def set_value(self, new_value) -> None:
        self._value = self.type.filter(new_value).copy()

    @property
    def value(self):
        """The SciPy matrix itself (read by the linker's sparse bridge)."""
        return self._value


def sparse_shared(value, name=None, device=None, format=None) -> SparseTensorSharedVariable:
    """A shared variable holding a copy of the SciPy matrix ``value``, in
    ``format`` (its own when it is CSR or CSC, else CSR)."""
    fmt = format or (value.format if value.format in ("csr", "csc") else "csr")
    stype = SparseTensorType(fmt, value.dtype.name, value.shape)
    return SparseTensorSharedVariable(stype, value, name=name, device=device)
