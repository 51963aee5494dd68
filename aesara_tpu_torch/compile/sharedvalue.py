"""``SharedVariable``: a graph input whose value persists between calls
(reference ``aesara_tpu/compile/sharedvalue.py``).

The value is a ``torch.Tensor`` on one explicit device, chosen when the
variable is made (``device=``, else ``config.device``).  ``get_value``
returns a copy in the user form (``scalar.ops.from_host``: NumPy, a torch
tensor on the CPU for bfloat16, which NumPy lacks) and ``set_value`` takes
either form and writes it into the variable's storage, which updates also
write into: a compiled step
captured in a CUDA graph keeps reading that storage.  ``default_update``
(reference ``aesara_tpu/compile/sharedvalue.py:44``) is an update that
``function()`` applies without being asked.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.graph.ir import Variable
from aesara_tpu_torch.link.basic import resolve_device
from aesara_tpu_torch.scalar.ops import from_host, is_torch_tensor
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

    def get_value(self):
        """A copy in the user form (``scalar.ops.from_host``): a NumPy
        array, or for bfloat16 a torch.bfloat16 tensor on the CPU."""
        return from_host(self._value, self.type.dtype)

    def set_value(self, new_value) -> None:
        import torch

        if is_torch_tensor(new_value):
            # a tensor of the variable's dtype is copied as it is, not
            # through the host form that ``filter`` returns
            if str(new_value.dtype).split(".")[-1] != self.type.dtype:
                raise TypeError(f"{self.type} got a torch tensor of dtype {new_value.dtype}")
            self.type.check_shape(tuple(new_value.shape))
            value = new_value.detach()
        else:
            value = torch.as_tensor(from_host(self.type.filter(np.asarray(new_value)), self.type.dtype))
        if self._value is not None and self._value.shape == value.shape and self._value.dtype == value.dtype:
            self._value.copy_(value)
        else:
            self._value = value.to(self.device, copy=True).contiguous()

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
    if is_torch_tensor(value):
        return TensorSharedVariable(TensorType(str(value.dtype).split(".")[-1], tuple(value.shape)), value,
                                    name=name, device=device)
    arr = np.asarray(value)
    return TensorSharedVariable(TensorType(arr.dtype.name, arr.shape), arr, name=name, device=device)
