"""dtype-stable asarray (reference ``aesara_tpu/misc/safe_asarray.py``).

NumPy has no bfloat16, and the port does not depend on ml_dtypes: a value
asked for in bfloat16 comes back in the port's user form of one, a
torch.bfloat16 tensor on the CPU (``scalar.ops.from_host``), with the bits
of the JAX package's ml_dtypes value.
"""

import numpy as np

from aesara_tpu_torch.scalar.ops import from_host

__all__ = ["_asarray"]


def _asarray(a, dtype, order=None):
    """``a`` in dtype ``dtype``: a NumPy array whose dtype is exactly that
    one, or for bfloat16 a torch tensor on the CPU."""
    if str(dtype) == "bfloat16":
        return from_host(a, "bfloat16")
    dtype = np.dtype(dtype)
    rval = np.asarray(a, dtype=dtype, order=order)
    if rval.dtype.num != dtype.num:
        rval = rval.view(dtype=dtype)
    return rval
