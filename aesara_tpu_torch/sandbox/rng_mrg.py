"""MRG31k3p multi-stream random generator (the counterpart of
``aesara_tpu/sandbox/rng_mrg.py``): L'Ecuyer and Touzin's combined
multiple recursive generator, the reference's ``sandbox/rng_mrg.py:715``.
Same seeds give the JAX package's draws bit for bit, the 2^134 jump
between ops, the 2^72 spacing of substreams and the ``sample[i] <-
stream[i % n_streams]`` interleave included.

The recurrence (moduli m1 = 2^31-1, m2 = 2^31-21069):

    x1_n = (2^22·x1_{n-2} + (2^7+1)·x1_{n-3}) mod m1
    x2_n = (2^15·x2_{n-1} + (2^15+1)·x2_{n-3}) mod m2
    u_n  = ((x1_n - x2_n) mod m1) / 2^31        (0 excluded)

The host side (the jump matrices, ``multMatVect``, ``ff_2p134``,
``DotModulo``, ``guess_n_streams`` and the stream object) is exact NumPy
integer arithmetic, as the JAX package's.  ``mrg_uniform`` draws on the
device through TM (``link/torch/kernels/random_loops.py``: one thread a
stream, its plain version on the CPU), lowered in
``link/torch/random_dispatch.py``; its floats are the JAX package's
lowering's, the uint32 draw converted to the output dtype and scaled by
1/2^31 in it.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.compile.sharedvalue import shared
from aesara_tpu_torch.config import config
from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.tensor.basic import as_tensor_variable, cast
from aesara_tpu_torch.tensor.type import TensorType


__all__ = [
    "MRG_RandomStream", "MRG_RandomStreams", "mrg_uniform", "mrg_next_value",
    "multMatVect", "DotModulo", "guess_n_streams", "ff_2p134",
    "M1", "M2", "A1p72", "A2p72", "A1p134", "A2p134",
]

M1 = np.int32(2147483647)  # 2^31 - 1
M2 = np.int32(2147462579)  # 2^31 - 21069

# jump matrices from L'Ecuyer's stream-spacing construction: the
# recurrence matrix raised to 2^72 (substream spacing) and 2^134
# (per-op stream block), published constants
A1p72 = np.asarray(
    [[1516919229, 758510237, 499121365],
     [1884998244, 1516919229, 335398200],
     [601897748, 1884998244, 358115744]], dtype="int64",
)
A2p72 = np.asarray(
    [[1228857673, 1496414766, 954677935],
     [1133297478, 1407477216, 1496414766],
     [2002613992, 1639496704, 1407477216]], dtype="int64",
)
A1p134 = np.asarray(
    [[1702500920, 1849582496, 1656874625],
     [828554832, 1702500920, 1512419905],
     [1143731069, 828554832, 102237247]], dtype="int64",
)
A2p134 = np.asarray(
    [[796789021, 1464208080, 607337906],
     [1241679051, 1431130166, 1464208080],
     [1401213391, 1178684362, 1431130166]], dtype="int64",
)


def _mat_vec_mod(A, v, m) -> np.ndarray:
    """Exact (A @ v) mod m with Python-int arithmetic (3x3 · 3)."""
    m = int(m)
    out = [
        sum(int(A[i][j]) * int(v[j]) % m for j in range(3)) % m
        for i in range(3)
    ]
    return np.asarray(out, dtype="int64")


def multMatVect(v, A, m1, B, m2) -> np.ndarray:
    """Jump a 6-slot MRG state: (A@v[:3] mod m1, B@v[3:] mod m2)
    (reference ``rng_mrg.py:54``)."""
    v = np.asarray(v)
    return np.concatenate(
        [_mat_vec_mod(A, v[:3], m1), _mat_vec_mod(B, v[3:], m2)]
    ).astype("int32")


def ff_2p134(rstate):
    """Fast-forward a state 2^134 draws (reference ``rng_mrg.py:268``)."""
    return multMatVect(rstate, A1p134, M1, A2p134, M2)


class DotModulo(Op):
    """o = (A @ s) mod m ++ (A2 @ s2) mod m2 — the modular matrix-vector
    kernel behind stream jumping (reference ``DotModulo:95``, a COp; here
    an exact-int perform op)."""

    __props__ = ()

    def make_node(self, A, s, m, A2, s2, m2):
        return Apply(
            self,
            [as_tensor_variable(x) for x in (A, s, m, A2, s2, m2)],
            [TensorType("int64", (None,))()],
        )

    def perform(self, node, inputs, output_storage):
        A, s, m, A2, s2, m2 = inputs
        output_storage[0][0] = np.concatenate(
            [_mat_vec_mod(A, s, m), _mat_vec_mod(A2, s2, m2)]
        )


def _advance_state(x11, x12, x13, x21, x22, x23, np=np):  # noqa: A002
    """One MRG31k3p step on (possibly vector) components, int64 exact.

    Returns the new components; the fresh draws are (x11', x21')."""
    m1 = np.int64(2147483647)
    m2 = np.int64(2147462579)
    # component 1: (2^22·x12 + (2^7+1)·x13) mod m1
    y1 = (np.int64(4194304) * x12 + np.int64(129) * x13) % m1
    # component 2: (2^15·x21 + (2^15+1)·x23) mod m2
    y2 = (np.int64(32768) * x21 + np.int64(32769) * x23) % m2
    return y1, x11, x12, y2, x21, x22


def _sample_from_components(x11, x21, np=np):
    m1 = np.int64(2147483647)
    diff = (x11 - x21) % m1
    # the reference maps x11 == x21 to m1 (never exactly 0)
    diff = np.where(diff == 0, m1, diff)
    return diff


#: 1 / 2^31 — the reference's NORM constant
_NORM_F64 = 4.656612873077392578125e-10
_NORM_F32 = np.float32(4.6566126e-10)


def mrg_next_value(rstate, new_rstate=None, NORM=_NORM_F64, mask=None,
                   offset=None):
    """Advance one 6-slot state in place; return the next uniform draw
    (reference ``mrg_next_value``)."""
    s = np.asarray(rstate, dtype="int64")
    x11, x12, x13, x21, x22, x23 = (int(v) for v in s)
    n11, n12, n13, n21, n22, n23 = _advance_state(x11, x12, x13, x21, x22, x23)
    target = rstate if new_rstate is None else new_rstate
    target[...] = np.asarray([n11, n12, n13, n21, n22, n23], dtype=target.dtype)
    diff = int(_sample_from_components(np.int64(n11), np.int64(n21)))
    return diff * NORM


class mrg_uniform(Op):
    """(rstate (n_streams, 6) int32, size) -> (new_rstate, uniform samples):
    ``sample[i]`` is the next draw of stream ``i % n_streams``."""

    __props__ = ("output_type",)

    def __init__(self, output_type):
        self.output_type = output_type

    @classmethod
    def new(cls, rstate, ndim, dtype, size):
        from aesara_tpu_torch.tensor.basic import get_vector_length

        v_size = as_tensor_variable(size)
        if ndim is None:
            ndim = get_vector_length(v_size)
        op = cls(TensorType(dtype, (None,) * ndim))
        return op(rstate, cast(v_size, "int64"))

    def make_node(self, rstate, size):
        rstate = as_tensor_variable(rstate)
        size = as_tensor_variable(size)
        return Apply(self, [rstate, size], [rstate.type(), self.output_type()])

    def torch_forward(self, rstate, size):
        """(new state, samples) of the device tensor ``rstate`` and the host
        ``size``: TM on the card, its plain version on the CPU."""
        import torch

        from aesara_tpu_torch.link.torch.kernels.random_loops import mrg_draw

        shape = tuple(int(s) for s in np.asarray(size))
        n = int(np.prod(shape)) if shape else 1
        new_state, flat = mrg_draw(rstate.to(torch.int32), n, self.output_type.dtype)
        return new_state.to(rstate.dtype), flat.reshape(shape)

    def perform(self, node, inputs, output_storage):
        import torch

        rstate, size = inputs
        new_state, samples = self.torch_forward(torch.from_numpy(np.ascontiguousarray(rstate)), size)
        output_storage[0][0] = new_state.numpy().astype(rstate.dtype)
        output_storage[1][0] = samples.numpy()

    def infer_shape(self, fgraph, node, input_shapes):
        size_var = node.inputs[1]
        return [input_shapes[0], tuple(size_var[i] for i in range(self.output_type.ndim))]

    def connection_pattern(self, node):
        return [[True, True], [False, False]]

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import DisconnectedType, grad_undefined

        return [grad_undefined(self, 0, inputs[0], "random state"), DisconnectedType()()]


def guess_n_streams(size, warn=False) -> int:
    """Pick a substream count for a sample shape (reference ``:670``)."""
    if isinstance(size, (tuple, list)) and all(
        isinstance(i, (int, np.integer)) for i in size
    ):
        r = 1
        for s in size:
            r *= int(s)
        if r > 6:
            r = r // 6
        return min(r, 60 * 256)
    return 60 * 256


class MRG_RandomStream:
    """Multi-stream MRG31k3p RandomStream: same seeds, same draws as the
    reference (``rng_mrg.py:715``)."""

    def __init__(self, seed: int = 12345):
        self.state_updates = []
        self.default_instance_seed = seed
        self.set_rstate(seed)

    def updates(self):
        return list(self.state_updates)

    def set_rstate(self, seed):
        if isinstance(seed, (int, np.integer)):
            if seed == 0:
                raise ValueError("seed should not be 0")
            if seed >= int(M2):
                raise ValueError(f"seed should be less than {int(M2)}")
            self.rstate = np.asarray([seed] * 6, dtype="int32")
        elif len(seed) == 6:
            seed = [int(s) for s in seed]
            if seed[:3] == [0, 0, 0] or seed[3:] == [0, 0, 0]:
                raise ValueError("seed halves must not be all zero")
            if max(seed[:3]) >= int(M1) or max(seed[3:]) >= int(M2):
                raise ValueError("seed out of range")
            self.rstate = np.asarray(seed, dtype="int32")
        else:
            raise TypeError("seed should be 1 integer or 6 integers")

    def seed(self, seed=None):
        if seed is None:
            seed = self.default_instance_seed
        self.set_rstate(seed)
        for old_r, new_r, size, nstreams in self.state_updates:
            if nstreams is None:
                nstreams = self.n_streams(size)
            rstates = self.get_substream_rstates(nstreams)
            old_r.set_value(rstates)

    def inc_rstate(self):
        """Skip 2^134 draws to the next op's stream block."""
        self.rstate = ff_2p134(self.rstate)

    def get_substream_rstates(self, n_streams, dtype=None, inc_rstate=True):
        """(n_streams, 6) matrix of states spaced 2^72 draws apart."""
        assert n_streams > 0
        rval = np.zeros((n_streams, 6), dtype="int32")
        rval[0] = self.rstate
        for i in range(1, n_streams):
            rval[i] = multMatVect(rval[i - 1], A1p72, M1, A2p72, M2)
        if inc_rstate:
            self.inc_rstate()
        return rval

    def n_streams(self, size):
        return guess_n_streams(size)

    def pretty_return(self, node_rstate, new_rstate, sample, size, nstreams):
        sample.rstate = node_rstate
        sample.update = (node_rstate, new_rstate)
        self.state_updates.append((node_rstate, new_rstate, size, nstreams))
        node_rstate.default_update = new_rstate
        return sample

    # --- distributions ------------------------------------------------------
    def uniform(self, size, low=0.0, high=1.0, ndim=None, dtype=None,
                nstreams=None, **kwargs):
        from aesara_tpu_torch.scalar.ops import upcast

        low_v = as_tensor_variable(low)
        high_v = as_tensor_variable(high)
        if dtype is None:
            dtype = upcast(config.floatX, low_v.type.dtype, high_v.type.dtype)
        low_v = cast(low_v, dtype)
        high_v = cast(high_v, dtype)

        orig_nstreams = nstreams
        if nstreams is None:
            nstreams = self.n_streams(size)
        rstates = self.get_substream_rstates(nstreams)
        node_rstate = shared(rstates, name="mrg_rstate")
        new_rstate, sample = mrg_uniform.new(node_rstate, ndim, dtype, size)
        u = self.pretty_return(node_rstate, new_rstate, sample,
                               size=size, nstreams=orig_nstreams)
        return u * (high_v - low_v) + low_v

    def binomial(self, size=None, n=1, p=0.5, ndim=None, dtype="int64",
                 nstreams=None, **kwargs):
        if n != 1:
            raise NotImplementedError("MRG binomial with n > 1")
        x = self.uniform(size=size, nstreams=nstreams, **kwargs)
        from aesara_tpu_torch.tensor.math import lt

        return cast(lt(x, p), dtype)

    def normal(self, size, avg=0.0, std=1.0, ndim=None, dtype=None,
               nstreams=None, truncate=False, **kwargs):
        """Box-Muller over an even batch of uniforms, matching the
        reference's sample layout (z0 block then z1 block)."""
        import aesara_tpu_torch.tensor.basic as tb
        import aesara_tpu_torch.tensor.math as tmm
        from aesara_tpu_torch.scalar.ops import upcast

        if truncate:
            raise NotImplementedError(
                "truncated normal needs dynamic re-sampling (py-only in the "
                "reference); use normal() and clip"
            )
        avg_v = as_tensor_variable(avg)
        std_v = as_tensor_variable(std)
        if dtype is None:
            dtype = upcast(config.floatX, avg_v.type.dtype, std_v.type.dtype)
        size = tuple(int(s) for s in size)
        n_odd = int(np.prod(size)) if size else 1
        n_even = n_odd + n_odd % 2
        u = self.uniform((n_even,), low=0.0, high=1.0, ndim=1, dtype=dtype,
                         nstreams=nstreams, **kwargs)
        u1 = u[: n_even // 2]
        u2 = u[n_even // 2:]
        r = tmm.sqrt(-2.0 * tmm.log(u1))
        theta = np.asarray(2.0 * np.pi, dtype=dtype) * u2
        z0 = r * tmm.cos(theta)
        z1 = r * tmm.sin(theta)
        norm = tb.join(0, z0, z1)
        if n_odd % 2 == 1:
            norm = norm[:-1]
        from aesara_tpu_torch.tensor.shape import reshape as _reshape

        samples = _reshape(norm, size)
        return cast(samples * std_v + avg_v, dtype)

    def multinomial(self, size=None, n=1, pvals=None, ndim=None,
                    dtype="int64", nstreams=None, **kwargs):
        """One-of-N draws via the uniform inversion op (reference
        delegates to sandbox multinomial the same way)."""
        if pvals is None:
            raise TypeError("pvals required")
        if n != 1 or size is not None:
            raise NotImplementedError(
                "MRG multinomial supports n=1, size=None (row-wise draws)"
            )
        from aesara_tpu_torch.sandbox.multinomial import MultinomialFromUniform

        pvals = as_tensor_variable(pvals)
        unis = self.uniform(size=(pvals.type.shape[0],) if pvals.type.shape[0]
                            is not None else (1,), nstreams=nstreams,
                            ndim=1, **kwargs)
        if pvals.type.shape[0] is None:
            raise NotImplementedError(
                "MRG multinomial needs a static number of rows"
            )
        return cast(MultinomialFromUniform("auto")(pvals, unis), dtype)

    def choice(self, size=1, a=None, replace=True, p=None, ndim=None,
               dtype="int64", nstreams=None, **kwargs):
        if replace or p is None or a is not None:
            raise NotImplementedError(
                "MRG choice implements the reference's case: a=None, "
                "replace=False, explicit p"
            )
        from aesara_tpu_torch.sandbox.multinomial import ChoiceFromUniform

        p = as_tensor_variable(p)
        unis = self.uniform(size=(int(size) * (p.type.shape[0] or 1),),
                            ndim=1, nstreams=nstreams, **kwargs)
        return cast(ChoiceFromUniform("auto")(p, unis, int(size)), dtype)

    def multinomial_wo_replacement(self, *args, **kwargs):
        raise NotImplementedError(
            "use choice(replace=False) (reference deprecation path)"
        )

    def get_substream_rngs(self, n_streams):
        """Round-1 shim name, kept for compatibility."""
        return self.get_substream_rstates(n_streams)


MRG_RandomStreams = MRG_RandomStream


from aesara_tpu_torch.link.torch import random_dispatch  # noqa: F401,E402  (registers the lowerings)
