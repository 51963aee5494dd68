"""The lowering of ``RandomVariable`` (the counterpart of
``aesara_tpu/link/jax/random_dispatch.py:16-37``).

The key is a ``torch.uint32`` tensor on the device, read there at run
time: one launch of the threefry kernel (``kernels/threefry.py``; its
plain version for a key on the CPU) splits it into the next key and the
draw's key and draws ``jax.random.uniform``'s floats; the distribution's
transform (``tensor/random/basic.py``) runs on them as torch ops.  The
next key is a new tensor, which the linker writes into the key's shared
variable after the call, so every replay of a captured step reads the
key its storage holds then and draws fresh values.  Nothing about a key
is folded on the host.

Sizes are static, as under XLA: ``size`` must be a host value (computed
from constants and shapes), and a distribution whose draw the port does
not compute yet refuses to compile.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.link.torch.dispatch import torch_funcify
from aesara_tpu_torch.tensor.random.op import RandomVariable


__all__ = ["draw"]


def draw(op, node, key, size, *params, bounds_cache=None):
    """(next key, draw) of ``node`` (an ``op`` node) from the device tensors
    ``key`` and ``params`` and the host ``size``.  ``bounds_cache`` keeps
    the uniform range's span and low end as device tensors, made at the
    first (eager) call: a tensor made from a host value inside a captured
    step would be a copy from pageable memory, which a capture refuses."""
    import torch

    from aesara_tpu_torch.link.torch.kernels.elemwise import torch_dtype
    from aesara_tpu_torch.link.torch.kernels.threefry import threefry_draw
    from aesara_tpu_torch.tensor.random.basic import fma

    size = np.asarray(size)
    shape = op.draw_shape(tuple(int(s) for s in size) if size.size else None, [tuple(p.shape) for p in params])
    dtype = op.draw_dtype([str(p.dtype).split(".")[-1] for p in params])
    next_key, u = threefry_draw(key, shape, dtype)
    bounds = op.uniform_range(dtype)
    if bounds is not None:
        # jax.random's _uniform: max(lo, u * (hi - lo) + lo), in the draw's dtype
        lo, hi = bounds
        cache = {} if bounds_cache is None else bounds_cache
        if (u.dtype, u.device) not in cache:
            cache[(u.dtype, u.device)] = tuple(torch.full((), float(v), dtype=u.dtype, device=u.device)
                                               for v in (hi - lo, lo))
        span, low = cache[(u.dtype, u.device)]
        u = torch.clamp_min(fma(u, span, low), float(lo))
    value = op.sample(u, *params)
    return next_key, value.to(torch_dtype(node.outputs[1].type.dtype))


@torch_funcify.register(RandomVariable)
def _torch_random_variable(op, node):
    if not op.ported:
        op.sample(None)     # raises, naming what the distribution waits for

    bounds_cache = {}

    def random_variable(rng, size, *params):
        return draw(op, node, rng, size, *params, bounds_cache=bounds_cache)

    random_variable.host_inputs = (1,)
    random_variable.needs_host = ((1,), "has a draw size computed on the device: random draw sizes must be static")
    return random_variable
