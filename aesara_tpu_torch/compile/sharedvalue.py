"""``SharedVariable``: a graph input whose value persists between calls
(reference ``aesara_tpu/compile/sharedvalue.py``).

The value is a ``torch.Tensor`` on one explicit device, chosen when the
variable is made (``device=``, else ``config.device``).  ``get_value``
returns a NumPy copy and ``set_value`` takes NumPy and writes it into the
variable's storage, which updates also write into: a compiled step
captured in a CUDA graph keeps reading that storage.  ``default_update``
(reference ``aesara_tpu/compile/sharedvalue.py:44``) is an update that
``function()`` applies without being asked.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.graph.ir import Variable
from aesara_tpu_torch.link.basic import resolve_device
from aesara_tpu_torch.tensor.type import TensorType
from aesara_tpu_torch.tensor.var import _tensor_operators


__all__ = ["SharedVariable", "TensorSharedVariable", "shared"]


class SharedVariable(Variable):
    """A Variable whose value lives on a device between function calls."""

    #: an expression of this variable's next value, applied by every
    #: function that reads it (unless ``no_default_updates``)
    default_update = None

    def __init__(self, type, value, name=None, device=None):
        super().__init__(type=type, owner=None, index=None, name=name)
        self.device = resolve_device(device)
        self._value = None
        self.set_value(value)

    def get_value(self) -> np.ndarray:
        return self._value.detach().cpu().numpy().copy()

    def set_value(self, new_value) -> None:
        import torch

        arr = torch.as_tensor(np.asarray(self.type.filter(np.asarray(new_value)), order="C"))
        if self._value is not None and self._value.shape == arr.shape and self._value.dtype == arr.dtype:
            self._value.copy_(arr)
        else:
            self._value = arr.to(self.device, copy=True)

    @property
    def value(self):
        """The device tensor itself (read by the linker)."""
        return self._value

    def clone(self, **kwargs):
        # a graph clone keeps the one storage cell: the variable itself
        return self

    def __str__(self):
        return self.name or f"<Shared:{self.type}>"


class TensorSharedVariable(_tensor_operators, SharedVariable):
    """Shared tensor with the full operator surface."""

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


def shared(value, name=None, device=None) -> TensorSharedVariable:
    """A shared tensor holding a copy of ``value`` on ``device``; a SciPy
    sparse matrix makes a sparse shared variable, a NumPy ``Generator`` or
    ``RandomState`` a PRNG key (``tensor/random/var.py``)."""
    import scipy.sparse

    if isinstance(value, Variable):
        raise TypeError("shared() takes a value, not a Variable")
    if isinstance(value, (np.random.Generator, np.random.RandomState)):
        from aesara_tpu_torch.tensor.random.var import generator_shared

        return generator_shared(value, name=name, device=device)
    if scipy.sparse.issparse(value):
        from aesara_tpu_torch.sparse.sharedvar import sparse_shared

        return sparse_shared(value, name=name, device=device)
    arr = np.asarray(value)
    return TensorSharedVariable(TensorType(arr.dtype.name, arr.shape), arr, name=name, device=device)
