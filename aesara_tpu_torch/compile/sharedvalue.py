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

from functools import singledispatch

import numpy as np

from aesara_tpu_torch.config import config
from aesara_tpu_torch.graph.ir import Variable
from aesara_tpu_torch.link.basic import resolve_device
from aesara_tpu_torch.scalar.ops import from_host, is_torch_tensor
from aesara_tpu_torch.tensor.type import TensorType
from aesara_tpu_torch.tensor.var import _tensor_operators


__all__ = ["SharedVariable", "TensorSharedVariable", "shared", "shared_constructor"]


class SharedVariable(Variable):
    """A Variable whose value lives on a device between function calls."""

    #: an expression of this variable's next value, applied by every
    #: function that reads it (unless ``no_default_updates``)
    default_update = None

    def __init__(self, type, value, name=None, device=None, strict=False, allow_downcast=None):
        super().__init__(type=type, owner=None, index=None, name=name)
        self.device = resolve_device(device)
        #: how ``set_value`` admits a value (``TensorType.filter``)
        self.strict, self.allow_downcast = strict, allow_downcast
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
            value = torch.as_tensor(from_host(self.type.filter(np.asarray(new_value), strict=self.strict,
                                                               allow_downcast=self.allow_downcast),
                                              self.type.dtype))
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


@singledispatch
def shared_constructor(value, name=None, strict=False, allow_downcast=None, **kwargs):
    """The shared variable for a value of a registered type (register one
    with ``shared_constructor.register``); a TypeError hands the value to
    ``shared``'s own constructors."""
    raise TypeError(f"no shared constructor for {type(value)}")


def shared(value, name=None, strict=False, allow_downcast=None, device=None, **kwargs) -> TensorSharedVariable:
    """A shared variable holding a copy of ``value`` on ``device`` (default
    ``config.device``): a tensor of the value's dtype, where a Python
    float takes ``config.floatX``, an int int64 and a bool bool; a SciPy
    sparse matrix makes a sparse shared variable, a NumPy ``Generator`` or
    ``RandomState`` a PRNG key (``tensor/random/var.py``).  ``strict`` and
    ``allow_downcast`` say how ``set_value`` admits later values;
    ``shape`` or ``broadcastable`` give the static shape, ``borrow`` is
    accepted (the value is copied to the device either way)."""
    import scipy.sparse

    if isinstance(value, Variable):
        raise TypeError("shared() takes a value, not a Variable")
    try:
        return shared_constructor(value, name=name, strict=strict, allow_downcast=allow_downcast, device=device,
                                  **kwargs)
    except TypeError:
        pass
    if isinstance(value, (np.random.Generator, np.random.RandomState)):
        from aesara_tpu_torch.tensor.random.var import generator_shared

        return generator_shared(value, name=name, device=device)
    if scipy.sparse.issparse(value):
        from aesara_tpu_torch.sparse.sharedvar import sparse_shared

        return sparse_shared(value, name=name, device=device)
    return _tensor_shared(value, name, strict, allow_downcast, device, **kwargs)


def _tensor_shared(value, name, strict, allow_downcast, device, borrow=False, shape=None, broadcastable=None,
                   sharding=None):
    if sharding is not None:
        raise NotImplementedError("sharding= waits for the port's parallel layer (ROADMAP Queue 1 item 16)")
    if is_torch_tensor(value):
        dtype, value_shape = str(value.dtype).split(".")[-1], tuple(value.shape)
    else:
        if isinstance(value, (bool, int, float)) and not isinstance(value, np.generic):
            value = np.asarray(value, dtype="bool" if isinstance(value, bool) else "int64"
                               if isinstance(value, int) else config.floatX)
        value = np.asarray(value)
        dtype, value_shape = value.dtype.name, value.shape
    if shape is None and broadcastable is not None:
        shape = tuple(1 if b else s for b, s in zip(broadcastable, value_shape))
    return TensorSharedVariable(TensorType(dtype, value_shape if shape is None else shape), value, name=name,
                                device=device, strict=strict, allow_downcast=allow_downcast)
