"""The lowerings of ``RandomVariable``, ``mrg_uniform`` and the sandbox's
uniform-to-multinomial converters (the counterpart of
``aesara_tpu/link/jax/random_dispatch.py``).

The key is a ``torch.uint32`` tensor on the device, read there at run
time: one launch of the threefry kernel (``kernels/threefry.py``; its
plain version for a key on the CPU) splits it into the next key and the
draw's key and draws ``jax.random.uniform``'s floats; the distribution's
transform (``tensor/random/basic.py``) runs on them as torch ops.  A
distribution that draws from a key (``sample_key``: the loop samplers, the
draws of several keys, sorts and integers) gets one launch that splits the
key into the next key and the draw's key, then runs as the JAX package's
``rng_fn`` does, launching the threefry kernel without a split and the
loop kernels (``kernels/random_loops.py``) on the keys it derives.  The
next key is a new tensor, which the linker writes into the key's shared
variable after the call, so every replay of a captured step reads the
key its storage holds then and draws fresh values.  Nothing about a key
is folded on the host.

``mrg_uniform`` is one launch of TM (``kernels/random_loops.py``) on the
stream states: the new states and the draws.  ``MultinomialFromUniform``
and ``ChoiceFromUniform`` run their torch forms with the draw count read
on the host.

Sizes are static, as under XLA: ``size`` must be a host value (computed
from constants and shapes), and a ``RandomVariable`` with no draw refuses
to compile.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.link.torch.dispatch import torch_funcify
from aesara_tpu_torch.sandbox.multinomial import MultinomialFromUniform
from aesara_tpu_torch.sandbox.rng_mrg import mrg_uniform
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
    if op.draws_by_key:
        _, keys = threefry_draw(key, (2,), "keys", split=False)
        size_tuple = tuple(int(s) for s in size) if size.size else None
        value = op.sample_key(keys[1], size_tuple, *params)
        return keys[0], value.to(torch_dtype(node.outputs[1].type.dtype))
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
        op.sample(None)     # raises: the distribution has no draw

    bounds_cache = {}

    def random_variable(rng, size, *params):
        return draw(op, node, rng, size, *params, bounds_cache=bounds_cache)

    random_variable.host_inputs = (1, *op.host_params)
    random_variable.needs_host = ((1, *op.host_params), "has a draw size or trip count computed on the device: "
                                                         "random draw sizes must be static")
    return random_variable


@torch_funcify.register(mrg_uniform)
def _torch_mrg_uniform(op, node):
    def mrg(rstate, size):
        return op.torch_forward(rstate, size)

    mrg.host_inputs = (1,)
    mrg.needs_host = ((1,), "has a draw size computed on the device: MRG draw sizes must be static")
    return mrg


@torch_funcify.register(MultinomialFromUniform)
def _torch_multinomial_from_uniform(op, node):
    from aesara_tpu_torch.link.torch.kernels.elemwise import torch_dtype

    out_dtype = torch_dtype(node.outputs[0].type.dtype)

    def from_uniform(pvals, unis, n):
        return op.torch_forward(pvals, unis, n, out_dtype)

    from_uniform.host_inputs = (2,)
    from_uniform.needs_host = ((2,), "has a draw count computed on the device")
    return from_uniform
