"""Fused multiply-accumulate products (the counterpart of
``aesara_tpu/tensor/blas.py``): ``Gemm``, ``Gemv``, ``Ger``, ``Dot22`` and
``Dot22Scalar``, the builders ``gemm``, ``gemv``, ``ger`` and
``batched_tensordot``, and the ``BlasOpt`` entry of the optdb (position
1.7, ``fast_run``), whose rewrites recover the fused forms from the
canonicalized mul/add graph: ``add(β·z, α·dot(x, y))`` becomes a
``Gemm`` (a ``Ger`` when the product is an outer product and β is 1),
``add(β·z, α·dot(A, x))`` a ``Gemv``, and ``α·dot(x, y)`` with no addend a
``Dot22Scalar``.

The linker lowers them to ``torch.addmm``, ``addmv``, ``addr`` and
``mm`` in full fp32, plain library products as the JAX package's are XLA
products (``link/torch/dispatch.py``).  The ops keep the ``inplace``
flag of the reference, but the port has no destroy handler yet, so no
rewrite sets it (``blas_inplace`` waits for it) and the lowering computes
the same value whatever it says.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.compile.mode import optdb
from aesara_tpu_torch.graph.ir import Apply, Constant
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.graph.rewriting.basic import copy_stack_trace, in2out, node_rewriter
from aesara_tpu_torch.scalar import ops as aes
from aesara_tpu_torch.tensor import math as tm
from aesara_tpu_torch.tensor.basic import as_tensor_variable, cast, constant
from aesara_tpu_torch.tensor.elemwise import DimShuffle, Elemwise
# BatchedDot is re-exported here, as the JAX package's blas module does
from aesara_tpu_torch.tensor.math import BatchedDot, Dot, batched_dot, dot  # noqa: F401
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["Gemm", "Gemv", "Ger", "Dot22", "Dot22Scalar", "gemm", "gemv", "ger", "outer",
           "batched_tensordot", "gemm_no_inplace", "gemv_no_inplace", "ger_no_inplace",
           "local_gemm_fusion", "local_gemv_fusion", "local_dot22scalar"]

_FLOATS = ("float16", "bfloat16", "float32", "float64")


def _np_out(node, value):
    return np.asarray(value).astype(node.outputs[0].type.dtype, copy=False)


def _check_dtypes(opname, *vars_):
    dt = vars_[0].type.dtype
    if any(v.type.dtype != dt for v in vars_[1:]):
        raise TypeError(f"{opname} requires a single dtype, got {[v.type.dtype for v in vars_]}; "
                        "cast the operands")
    return dt


def outer(x, y):
    """The outer product of two vectors, as one ``Dot`` of a column and a
    row (the JAX package's ``tensor.math.outer``)."""
    x, y = as_tensor_variable(x), as_tensor_variable(y)
    x = x if x.type.ndim == 1 else x.flatten()
    y = y if y.type.ndim == 1 else y.flatten()
    return dot(x.dimshuffle(0, "x"), y.dimshuffle("x", 0))


class _Accumulate(Op):
    """The ``inplace`` flag of Gemm, Gemv and Ger, and their output type:
    z's."""

    __props__ = ("inplace",)

    def __init__(self, inplace: bool = False):
        self.inplace = bool(inplace)
        if self.inplace:
            self.destroy_map = {0: [0]}

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def __str__(self):
        return f"{type(self).__name__}{{{'inplace' if self.inplace else 'no_inplace'}}}"


class Gemm(_Accumulate):
    """out = beta·z + alpha·(x @ y) with z, x, y matrices (reference
    ``blas.py:872``)."""

    def make_node(self, z, alpha, x, y, beta):
        z, alpha, x, y, beta = map(as_tensor_variable, (z, alpha, x, y, beta))
        if z.type.ndim != 2 or x.type.ndim != 2 or y.type.ndim != 2:
            raise TypeError("Gemm needs matrix z, x, y")
        if alpha.type.ndim != 0 or beta.type.ndim != 0:
            raise TypeError("Gemm needs scalar alpha, beta")
        dt = _check_dtypes("Gemm", z, alpha, x, y, beta)
        return Apply(self, [z, alpha, x, y, beta], [TensorType(dt, z.type.shape)()])

    def perform(self, node, inputs, output_storage):
        z, alpha, x, y, beta = inputs
        output_storage[0][0] = _np_out(node, beta * z + alpha * np.dot(x, y))

    def L_op(self, inputs, outputs, output_grads):
        z, alpha, x, y, beta = inputs
        (gz,) = output_grads
        return [cast(gz * beta, z.type.dtype), cast(tm.sum(gz * dot(x, y)), alpha.type.dtype),
                cast(dot(gz, y.T) * alpha, x.type.dtype), cast(dot(x.T, gz) * alpha, y.type.dtype),
                cast(tm.sum(gz * z), beta.type.dtype)]


class Gemv(_Accumulate):
    """out = beta·z + alpha·(A @ x) with z, x vectors (reference
    ``blas.py:231``)."""

    def make_node(self, z, alpha, A, x, beta):
        z, alpha, A, x, beta = map(as_tensor_variable, (z, alpha, A, x, beta))
        if z.type.ndim != 1 or A.type.ndim != 2 or x.type.ndim != 1:
            raise TypeError("Gemv needs vector z, matrix A, vector x")
        if alpha.type.ndim != 0 or beta.type.ndim != 0:
            raise TypeError("Gemv needs scalar alpha, beta")
        dt = _check_dtypes("Gemv", z, alpha, A, x, beta)
        return Apply(self, [z, alpha, A, x, beta], [TensorType(dt, z.type.shape)()])

    def perform(self, node, inputs, output_storage):
        z, alpha, A, x, beta = inputs
        output_storage[0][0] = _np_out(node, beta * z + alpha * np.dot(A, x))

    def L_op(self, inputs, outputs, output_grads):
        z, alpha, A, x, beta = inputs
        (gz,) = output_grads
        return [cast(gz * beta, z.type.dtype), cast(dot(gz, dot(A, x)), alpha.type.dtype),
                cast(outer(gz, x) * alpha, A.type.dtype), cast(dot(A.T, gz) * alpha, x.type.dtype),
                cast(dot(gz, z), beta.type.dtype)]


class Ger(_Accumulate):
    """out = z + alpha·outer(x, y), a rank-1 update (reference
    ``blas.py:330``)."""

    def make_node(self, z, alpha, x, y):
        z, alpha, x, y = map(as_tensor_variable, (z, alpha, x, y))
        if z.type.ndim != 2 or x.type.ndim != 1 or y.type.ndim != 1:
            raise TypeError("Ger needs matrix z, vectors x, y")
        if alpha.type.ndim != 0:
            raise TypeError("Ger needs scalar alpha")
        dt = _check_dtypes("Ger", z, alpha, x, y)
        return Apply(self, [z, alpha, x, y], [TensorType(dt, z.type.shape)()])

    def perform(self, node, inputs, output_storage):
        z, alpha, x, y = inputs
        output_storage[0][0] = _np_out(node, z + alpha * np.outer(x, y))

    def L_op(self, inputs, outputs, output_grads):
        z, alpha, x, y = inputs
        (gz,) = output_grads
        return [gz, cast(tm.sum(gz * outer(x, y)), alpha.type.dtype),
                cast(dot(gz, y) * alpha, x.type.dtype), cast(dot(gz.T, x) * alpha, y.type.dtype)]


gemm_no_inplace, gemv_no_inplace, ger_no_inplace = Gemm(), Gemv(), Ger()


class Dot22(Op):
    """The product of two matrices (reference ``blas.py:1659``)."""

    __props__ = ()

    def make_node(self, x, y):
        x, y = as_tensor_variable(x), as_tensor_variable(y)
        if x.type.ndim != 2 or y.type.ndim != 2:
            raise TypeError("Dot22 needs two matrices")
        dt = _check_dtypes("Dot22", x, y)
        return Apply(self, [x, y], [TensorType(dt, (x.type.shape[0], y.type.shape[1]))()])

    def perform(self, node, inputs, output_storage):
        x, y = inputs
        output_storage[0][0] = _np_out(node, np.dot(x, y))

    def infer_shape(self, fgraph, node, input_shapes):
        return [(input_shapes[0][0], input_shapes[1][1])]

    def L_op(self, inputs, outputs, output_grads):
        x, y = inputs
        (gz,) = output_grads
        return [cast(dot(gz, y.T), x.type.dtype), cast(dot(x.T, gz), y.type.dtype)]

    def __str__(self):
        return "Dot22"


class Dot22Scalar(Op):
    """a·(x @ y) for matrices x, y and a scalar a (reference
    ``blas.py:1954``)."""

    __props__ = ()

    def make_node(self, x, y, a):
        x, y, a = map(as_tensor_variable, (x, y, a))
        if x.type.ndim != 2 or y.type.ndim != 2 or a.type.ndim != 0:
            raise TypeError("Dot22Scalar needs two matrices and a scalar")
        dt = _check_dtypes("Dot22Scalar", x, y, a)
        return Apply(self, [x, y, a], [TensorType(dt, (x.type.shape[0], y.type.shape[1]))()])

    def perform(self, node, inputs, output_storage):
        x, y, a = inputs
        output_storage[0][0] = _np_out(node, a * np.dot(x, y))

    def infer_shape(self, fgraph, node, input_shapes):
        return [(input_shapes[0][0], input_shapes[1][1])]

    def L_op(self, inputs, outputs, output_grads):
        x, y, a = inputs
        (gz,) = output_grads
        return [cast(dot(gz, y.T) * a, x.type.dtype), cast(dot(x.T, gz) * a, y.type.dtype),
                cast(tm.sum(gz * dot(x, y)), a.type.dtype)]

    def __str__(self):
        return "Dot22Scalar"


_dot22, _dot22scalar = Dot22(), Dot22Scalar()


# --- the builders ------------------------------------------------------------

def _castall(dt, *args):
    return [a if a.type.dtype == dt else cast(a, dt) for a in args]


def _upcast_all(*args):
    """The operands as variables cast to their common dtype."""
    args = [as_tensor_variable(a) for a in args]
    return _castall(aes.upcast(*[a.type.dtype for a in args]), *args)


def gemm(z, alpha, x, y, beta):
    """β·z + α·(x @ y) as one node."""
    return gemm_no_inplace(*_upcast_all(z, alpha, x, y, beta))


def gemv(z, alpha, A, x, beta):
    """β·z + α·(A @ x) as one node."""
    return gemv_no_inplace(*_upcast_all(z, alpha, A, x, beta))


def ger(z, alpha, x, y):
    """z + α·outer(x, y) as one node."""
    return ger_no_inplace(*_upcast_all(z, alpha, x, y))


def batched_tensordot(x, y, axes=2):
    """``tensordot(x[i], y[i], axes)`` for every i of the leading axis; the
    axes count within one slice, as ``numpy.tensordot`` takes them.  The
    JAX package maps ``tensordot`` over the slices with Scan, which the port
    does not have yet; here the slices' free axes are broadcast against each
    other and the contracted ones summed, which is the same sum."""
    x, y = as_tensor_variable(x), as_tensor_variable(y)
    xn, yn = x.type.ndim - 1, y.type.ndim - 1
    if np.ndim(axes) == 0:
        ax, bx = list(range(xn - int(axes), xn)), list(range(int(axes)))
    else:
        ax = [int(a) % xn for a in np.atleast_1d(axes[0])]
        bx = [int(a) % yn for a in np.atleast_1d(axes[1])]
    if len(ax) != len(bx):
        raise ValueError("batched_tensordot axes must have equal length")
    free_x = [d for d in range(xn) if d not in ax]
    free_y = [d for d in range(yn) if d not in bx]
    xs = x.dimshuffle(0, *[d + 1 for d in free_x], *["x"] * len(free_y), *[d + 1 for d in ax])
    ys = y.dimshuffle(0, *["x"] * len(free_x), *[d + 1 for d in free_y], *[d + 1 for d in bx])
    prod = xs * ys
    ndim = prod.type.ndim
    return tm.sum(prod, axis=tuple(range(ndim - len(ax), ndim))) if ax else prod


# ---------------------------------------------------------------------------
# BlasOpt: recover the fused forms from the canonicalized mul/add graph
# (reference blas.py:1515, optdb position 1.7)
# ---------------------------------------------------------------------------

def _is_scalar_op(node, cls) -> bool:
    return node is not None and isinstance(node.op, Elemwise) and isinstance(node.op.scalar_op, cls)


def _as_scalar(v):
    """The 0-d variable behind a broadcast-to-ndim term, else None."""
    if isinstance(v, Constant):
        data = np.asarray(v.data)
        return constant(data.reshape(())[()], dtype=v.type.dtype) if data.size == 1 else None
    node = v.owner
    if (node is not None and isinstance(node.op, DimShuffle) and all(o == "x" for o in node.op.new_order)
            and node.inputs[0].type.ndim == 0):
        return node.inputs[0]
    return None


def _split_coeff(term):
    """(scalar coefficient or None, core variable): one level of Mul whose
    other factors are broadcast scalars peeled off."""
    node = term.owner
    if not _is_scalar_op(node, aes.Mul):
        return None, term
    scalars, cores = [], []
    for i in node.inputs:
        s = _as_scalar(i)
        (cores if s is None else scalars).append(i if s is None else s)
    if not scalars or len(cores) != 1:
        return None, term
    coeff = scalars[0]
    for s in scalars[1:]:
        coeff = coeff * s
    return coeff, cores[0]


def _densified(v) -> bool:
    """Whether ``v`` is DenseFromSparse(x), or its transpose: the sparse
    rewrites (specialize) make its product a StructuredDot, which a
    fused form would hide from them.  The JAX package fuses it, and the
    logistic-regression gradient then densifies x (a reference fault)."""
    from aesara_tpu_torch.sparse.basic import DenseFromSparse

    node = v.owner
    if node is not None and isinstance(node.op, DimShuffle) and node.op.new_order == (1, 0):
        node = node.inputs[0].owner
    return node is not None and isinstance(node.op, DenseFromSparse)


def _is_plain_dot(v, fgraph):
    """(x, y, the scalar it already carries or None) when ``v`` is a Dot,
    Dot22 or Dot22Scalar of dense matrices read only here, else None
    (another reader would have the product computed twice)."""
    node = v.owner
    if node is None or not isinstance(node.op, (Dot, Dot22, Dot22Scalar)):
        return None
    x, y = node.inputs[0], node.inputs[1]
    if (x.type.ndim != 2 or y.type.ndim != 2 or len(fgraph.clients.get(v, ())) != 1
            or _densified(x) or _densified(y)):
        return None
    return x, y, node.inputs[2] if isinstance(node.op, Dot22Scalar) else None


def _outer_operands(x, y):
    """(vx, vy) when Dot(x, y) is outer(vx, vy), else None."""
    def operand(v, order):
        n = v.owner
        if n is not None and isinstance(n.op, DimShuffle) and tuple(n.op.new_order) == order:
            return n.inputs[0]
        return None

    vx, vy = operand(x, (0, "x")), operand(y, ("x", 0))
    return (vx, vy) if vx is not None and vy is not None else None


def _one(dtype):
    return constant(1, dtype=dtype)


def _is_one(v) -> bool:
    return isinstance(v, Constant) and np.asarray(v.data).size == 1 and float(np.asarray(v.data)) == 1.0


def _z_not_broadcasting(zcore, out) -> bool:
    """Gemm and Gemv take their output's static shape from z, so a z that
    broadcasts against the product (a (1, n) z and an (m, n) product)
    does not fuse."""
    return all(not (zs == 1 and os != 1) for zs, os in zip(zcore.type.shape, out.type.shape))


def _addend(terms, i, out):
    """(β, z) of the terms other than the i-th, or None when they do not
    make an addend of ``out``'s rank."""
    rest = terms[:i] + terms[i + 1:]
    z = rest[0] if len(rest) == 1 else tm.add(*rest)
    if z.type.ndim != out.type.ndim:
        return None
    beta, zcore = _split_coeff(z)
    if beta is None:
        beta, zcore = _one(out.type.dtype), z
    if zcore.type.ndim != out.type.ndim or not _z_not_broadcasting(zcore, out):
        return None
    return beta, zcore


def _replace(out, new):
    conv = out.type.convert_variable(new)
    return False if conv is None else [copy_stack_trace(out, conv)]


def _float_add(node, ndim) -> bool:
    out = node.outputs[0]
    return (_is_scalar_op(node, aes.Add) and out.type.ndim == ndim and out.type.dtype in _FLOATS
            and len(node.inputs) >= 2)


@node_rewriter([Elemwise])
def local_gemm_fusion(fgraph, node):
    """add(β·z, α·dot(x, y)) → Gemm, or Ger for an outer product with β 1;
    the matrix case."""
    if not _float_add(node, 2):
        return False
    out, terms = node.outputs[0], list(node.inputs)
    dt = out.type.dtype
    for i, t in enumerate(terms):
        alpha, core = _split_coeff(t)
        xy = _is_plain_dot(core, fgraph)
        addend = None if xy is None else _addend(terms, i, out)
        if addend is None:
            continue
        beta, zcore = addend
        x, y, baked = xy
        alpha = _one(dt) if alpha is None else alpha
        if baked is not None:
            alpha = alpha * baked
        outer_ops = _outer_operands(x, y)
        if outer_ops is not None and _is_one(beta):
            new = ger_no_inplace(*_castall(dt, zcore, alpha, *outer_ops))
        else:
            new = gemm_no_inplace(*_castall(dt, zcore, alpha, x, y, beta))
        res = _replace(out, new)
        if res:
            return res
    return False


@node_rewriter([Elemwise])
def local_gemv_fusion(fgraph, node):
    """add(β·z, α·dot(A, x)) → Gemv; the vector case."""
    if not _float_add(node, 1):
        return False
    out, terms = node.outputs[0], list(node.inputs)
    for i, t in enumerate(terms):
        alpha, core = _split_coeff(t)
        n = core.owner
        if n is None or not isinstance(n.op, Dot):
            continue
        A, x = n.inputs
        if A.type.ndim != 2 or x.type.ndim != 1 or len(fgraph.clients.get(core, ())) != 1:
            continue
        addend = _addend(terms, i, out)
        if addend is None:
            continue
        beta, zcore = addend
        dt = out.type.dtype
        alpha = _one(dt) if alpha is None else alpha
        res = _replace(out, gemv_no_inplace(*_castall(dt, zcore, alpha, A, x, beta)))
        if res:
            return res
    return False


@node_rewriter([Elemwise])
def local_dot22scalar(fgraph, node):
    """α·dot(x, y) with no addend → Dot22Scalar, the scale inside the one
    product node."""
    out = node.outputs[0]
    if not _is_scalar_op(node, aes.Mul) or out.type.ndim != 2 or out.type.dtype not in _FLOATS:
        return False
    alpha, core = _split_coeff(out)
    xy = None if alpha is None else _is_plain_dot(core, fgraph)
    if xy is None:
        return False
    x, y, baked = xy
    if baked is not None:
        alpha = alpha * baked
    return _replace(out, _dot22scalar(*_castall(out.type.dtype, x, y, alpha)))


optdb.register("BlasOpt", in2out(local_gemm_fusion, local_gemv_fusion, local_dot22scalar, name="BlasOpt"),
               "fast_run", position=1.7)
