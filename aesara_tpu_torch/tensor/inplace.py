"""``tensor/inplace.py`` (reference ``aesara_tpu/tensor/inplace.py``): the
``*_inplace`` names of the reference's destructive ops resolve to the pure
ops, as in the JAX package.  The port writes into a storage where the
destroy handler allows it, decided when a function is compiled
(``blas_inplace``, the linker's donation of updated shared variables), not
by the op a user picks; so ``from aesara_tpu_torch.tensor.inplace import
neg_inplace`` gives ``neg``, with the same values."""

from __future__ import annotations

import aesara_tpu_torch.tensor.basic as _basic
import aesara_tpu_torch.tensor.math as _math


def __getattr__(name):
    if name.endswith("_inplace"):
        base = name[: -len("_inplace")]
        for mod in (_math, _basic):
            fn = getattr(mod, base, None)
            if fn is not None:
                return fn
        raise AttributeError(f"tensor.inplace: no base op {base!r} for {name!r}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted({n + "_inplace" for mod in (_math, _basic) for n in dir(mod)
                   if not n.startswith("_") and callable(getattr(mod, n, None))})
