"""Random variables with functional PRNG state (the counterpart of
``aesara_tpu/tensor/random/op.py``).

A PRNG state is a threefry2x32 key, ``uint32[2]``, and every
``RandomVariable`` node maps ``(rng, size, *params)`` to ``(next_rng,
draw)``: the key is split, never mutated.  The key functions on the host
(:func:`prng_key`, :func:`fold_in`, :func:`split`, :func:`random_bits`)
are written from the algorithm of ``jax.random`` with
``jax_threefry_partitionable`` on (JAX's ``prng.py``: ``threefry_seed``,
``threefry_2x32``, ``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``), so a seed gives the JAX
package's keys bit for bit; they run the one threefry2x32 hash of the
port, the plain version's (``link/torch/kernels/threefry.py``), on NumPy
int64 carriers of the ``uint32`` words.  A draw on the device runs
the threefry kernel (``link/torch/kernels/threefry.py``) through the
lowering in ``link/torch/random_dispatch.py``.
"""

from __future__ import annotations

import copy as _copy
import itertools
import math
from typing import Optional

import numpy as np

from aesara_tpu_torch.config import config
from aesara_tpu_torch.graph.ir import Apply, Constant, Type, Variable
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.link.torch.kernels.threefry import M32, threefry2x32
from aesara_tpu_torch.tensor.basic import as_tensor_variable, cast, constant, get_vector_length
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["RandomGeneratorType", "random_generator_type", "RandomVariable", "RandomStateType", "RngConstant",
           "default_rng", "normalize_size_param", "prng_key", "fold_in", "split", "random_bits"]


# ---------------------------------------------------------------------------
# the key functions on the host
# ---------------------------------------------------------------------------

def _words(key):
    """A key's two ``uint32`` words as int64 carriers (``threefry2x32``'s)."""
    key = np.asarray(key, dtype=np.uint32).astype(np.int64)
    return key[0], key[1]


def _counters(n: int):
    """The counter pairs of flat indices ``0 .. n - 1``: high, low word."""
    i = np.arange(n, dtype=np.int64)
    return i >> 32, i & M32


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s data: the seed as a 64-bit integer
    (two's complement for a negative one), high word then low word."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 64):
        raise OverflowError(f"seed {seed} does not fit in 64 bits")
    s = seed & ((1 << 64) - 1)
    return np.asarray([s >> 32, s & M32], dtype=np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    ``(0, data)`` (``data`` as ``uint32``)."""
    y0, y1 = threefry2x32(*_words(key), np.int64(0), np.int64(int(data) & M32))
    return np.asarray([y0, y1], dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``'s data, shape (num, 2): key ``i`` is
    the hash of the counter pair ``(i >> 32, i & 0xFFFFFFFF)``."""
    y0, y1 = threefry2x32(*_words(key), *_counters(num))
    return np.stack([y0, y1], axis=-1).astype(np.uint32)


def random_bits(key, shape, width: int = 32) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32 or uint64)``: the hash of each
    element's flat index as a counter pair, its words xored (32 bits) or
    high then low (64 bits)."""
    b1, b2 = threefry2x32(*_words(key), *_counters(math.prod(shape)))
    if width == 32:
        return (b1 ^ b2).astype(np.uint32).reshape(shape)
    if width == 64:
        return ((b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)).reshape(shape)
    raise ValueError(f"random_bits: width {width} is not 32 or 64")


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------

class RandomGeneratorType(Type):
    """Type of PRNG states: raw threefry key data, ``uint32[2]``.  On a
    device the key is a ``torch.uint32`` tensor of shape (2,)."""

    dtype = "uint32"
    shape = (2,)
    ndim = 1

    def filter(self, data, strict=False, allow_downcast=None):
        arr = np.asarray(data)
        if arr.dtype != np.uint32 or arr.shape != (2,):
            if strict:
                raise TypeError(f"not a threefry key: {data!r}")
            try:
                arr = np.asarray(data, dtype=np.uint32).reshape(2)
            except (TypeError, ValueError) as e:
                raise TypeError(f"cannot interpret {data!r} as a threefry key") from e
        return arr

    def check_shape(self, shape) -> None:
        if tuple(shape) != (2,):
            raise ValueError(f"a threefry key has shape (2,), got {tuple(shape)}")

    def values_eq(self, a, b):
        return np.array_equal(a, b)

    def __eq__(self, other):
        return type(other) is RandomGeneratorType

    def __hash__(self):
        return hash(RandomGeneratorType)

    def __str__(self):
        return "RandomGeneratorType"


#: the reference's RandomStateType: the same key representation
RandomStateType = RandomGeneratorType
random_generator_type = RandomGeneratorType()


_implicit_rng_counter = itertools.count()


def default_rng(seed: Optional[int] = None) -> np.ndarray:
    """Fresh key data from a seed.  With no seed, each call folds a
    process-wide counter into ``config.seed``'s key, so every implicitly
    seeded node gets its own key (identical keys would make independent
    draws equal, and the merge pass would unify the nodes)."""
    if seed is None:
        return fold_in(prng_key(config.seed), next(_implicit_rng_counter))
    return prng_key(seed)


class RngConstant(Constant):
    """A constant PRNG key."""


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

class RandomVariable(Op):
    """A draw from a distribution (reference ``aesara_tpu/tensor/random/op.py:85``).

    ``name`` names the distribution, ``ndim_supp`` is the rank of one
    draw, ``ndims_params`` the core rank of each parameter, ``dtype`` the
    output dtype ("floatX" resolved when the node is built).  Node:
    ``(rng, size, *dist_params) -> (next_rng, draw)``.

    A subclass whose draw the port computes defines :meth:`sample`; the
    others raise when a function holding them is compiled."""

    __props__ = ("name", "ndim_supp", "ndims_params", "dtype")
    default_output = 1

    def __init__(self, name, ndim_supp, ndims_params, dtype=None):
        self.name = name
        self.ndim_supp = int(ndim_supp)
        self.ndims_params = tuple(ndims_params)
        self.dtype = dtype

    def _supp_shape_from_params(self, dist_params, param_shapes=None):
        """Static support shape (only needed for ndim_supp > 0)."""
        raise NotImplementedError(f"{self.name}: support shape rule not implemented")

    def make_node(self, rng, size, *dist_params) -> Apply:
        if rng is None:
            rng = RngConstant(random_generator_type, default_rng())
        if not isinstance(rng.type, RandomGeneratorType):
            raise TypeError("rng must be RandomGeneratorType")
        size = normalize_size_param(size)
        dist_params = [as_tensor_variable(p) for p in dist_params]

        dtype = self.dtype or config.floatX
        if dtype == "floatX":
            dtype = config.floatX

        # the static output shape
        try:
            n_size = get_vector_length(size)
        except ValueError:
            n_size = None
        if n_size == 0:
            # the broadcast of the params' batch shapes, then the support shape
            batch_ndim = 0
            for p, nd in zip(dist_params, self.ndims_params):
                batch_ndim = max(batch_ndim, p.type.ndim - nd)
            out_ndim = batch_ndim + self.ndim_supp
            static = [None] * out_ndim
            for d in range(batch_ndim):
                dims = []
                for p, nd in zip(dist_params, self.ndims_params):
                    bnd = p.type.ndim - nd
                    off = batch_ndim - bnd
                    if d >= off:
                        dims.append(p.type.shape[d - off])
                known = [x for x in dims if x is not None and x != 1]
                if known:
                    static[d] = known[0]
                elif dims and all(x == 1 for x in dims):
                    static[d] = 1
        else:
            from aesara_tpu_torch.tensor.basic import NotScalarConstantError, get_underlying_constant_vector

            out_ndim = (n_size if n_size is not None else 0) + self.ndim_supp
            static = [None] * out_ndim
            if n_size is not None:
                try:
                    vals = get_underlying_constant_vector(size)
                    for d, v in enumerate(vals):
                        static[d] = int(v)
                except NotScalarConstantError:
                    pass
        if self.ndim_supp:
            try:
                supp = self._supp_shape_from_params(dist_params)
                for i, s in enumerate(supp):
                    static[len(static) - self.ndim_supp + i] = s
            except NotImplementedError:
                pass

        out_type = TensorType(dtype, tuple(static))
        return Apply(self, [rng, size] + dist_params, [random_generator_type(), out_type()])

    def __call__(self, *dist_params, size=None, rng=None, name=None, dtype=None, **kwargs):
        # a per-call dtype rebuilds the op with that output dtype
        if dtype is not None and dtype != self.dtype:
            op = _copy.copy(self)
            op.dtype = "floatX" if dtype == "floatX" else str(np.dtype(dtype))
            return Op.__call__(op, rng, size, *dist_params, name=name, **kwargs)
        return super().__call__(rng, size, *dist_params, name=name, **kwargs)

    # -- the draw ------------------------------------------------------------

    #: the ROADMAP item a distribution without a port of its draw waits for
    waits_for = ("the rejection samplers and the discrete draws, "
                 "ROADMAP Queue 1 item 9 (the remaining distributions)")

    def draw_shape(self, size, param_shapes):
        """The draw's shape: ``size`` if given, else the params' broadcast."""
        if size is not None:
            return tuple(size)
        return tuple(np.broadcast_shapes(*param_shapes)) if param_shapes else ()

    def draw_dtype(self, param_dtypes) -> str:
        """The float dtype of the uniform draw (``jax.random``'s default
        float with 64-bit mode on, as the JAX package's tests and CPU runs
        have it)."""
        return "float64"

    #: the (minval, maxval) of ``jax.random``'s ``_uniform`` for this
    #: distribution, as a function of the draw's dtype; None is [0, 1)
    def uniform_range(self, dtype: str):
        return None

    def sample(self, u, *params):
        """The draw from ``u``, ``jax.random.uniform``'s floats on the
        range :meth:`uniform_range` gives, as torch ops."""
        raise NotImplementedError(f"{self.name}: the port has no draw of this distribution yet; it waits for "
                                  f"{self.waits_for}")

    @property
    def ported(self) -> bool:
        return type(self).sample is not RandomVariable.sample

    def infer_shape(self, fgraph, node, input_shapes):
        from aesara_tpu_torch.tensor.shape import shape as tshape

        out = node.outputs[1]
        return [(constant(2, dtype="int64"),), tuple(tshape(out)[d] for d in range(out.type.ndim))]

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import grad_undefined

        return [grad_undefined(self, i, inp, "random draws have no gradient") for i, inp in enumerate(inputs)]

    def do_constant_folding(self, fgraph, node):
        return False

    def __str__(self):
        return f"{self.name}_rv"


def normalize_size_param(size) -> Variable:
    """Coerce size into an int64 vector (empty: the params' shape)."""
    if size is None:
        return constant(np.asarray([], dtype="int64"))
    if isinstance(size, Variable):
        if size.type.ndim == 0:
            from aesara_tpu_torch.tensor.basic import stack

            return stack([cast(size, "int64")])
        return cast(size, "int64")
    if isinstance(size, (int, np.integer)):
        return constant(np.asarray([int(size)], dtype="int64"))
    if any(isinstance(s, Variable) for s in size):
        from aesara_tpu_torch.tensor.basic import stack

        return stack([cast(as_tensor_variable(s), "int64") for s in size])
    return constant(np.asarray([int(s) for s in size], dtype="int64"))
