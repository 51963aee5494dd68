"""Shape rewrites and whole-graph symbolic shape inference (reference
``aesara_tpu/tensor/rewriting/shape.py``).

1. Static-shape folding: ``Shape``/``Shape_i`` of statically known dims
   fold to constants when the graph is canonicalized.
2. ``ShapeFeature``: a cache on the FunctionGraph that maps every variable
   to a tuple of symbolic int64 scalars, built by each op's
   ``infer_shape``, so that rewrites can ask for a shape that is not
   static.  ``ShapeOptimizer`` attaches it at optdb position 0.1 and
   ``UnShapeOptimizer`` detaches it at position 10.

An ``infer_shape`` that raises anything but ``NotImplementedError`` fails
the compile: the port swallows no rewrite failure.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.compile.mode import optdb, register_canonicalize, register_specialize
from aesara_tpu_torch.graph.features import AlreadyThere, Feature
from aesara_tpu_torch.graph.ir import Constant, equal_computations
from aesara_tpu_torch.graph.rewriting.basic import (
    GraphRewriter,
    copy_stack_trace,
    node_rewriter,
)
from aesara_tpu_torch.tensor.basic import MakeVector, NotScalarConstantError, constant, get_scalar_constant_value
from aesara_tpu_torch.tensor.shape import Reshape, Shape, Shape_i, SpecifyShape, shape_i
from aesara_tpu_torch.tensor.subtensor import SYM, Subtensor
from aesara_tpu_torch.tensor.type import TensorType



@node_rewriter([Shape])
def local_shape_to_constant(fgraph, node):
    """Shape(x) with fully-known static shape → constant vector; partially
    known → MakeVector mixing constants and Shape_i."""
    (x,) = node.inputs
    shp = x.type.shape
    if all(s is not None for s in shp):
        return [constant(np.asarray(shp, dtype="int64"))]
    if any(s is not None for s in shp):
        elems = [
            constant(s, dtype="int64") if s is not None else Shape_i(d)(x)
            for d, s in enumerate(shp)
        ]
        res = MakeVector("int64")(*elems)
        copy_stack_trace(node.outputs[0], res)
        return [res]
    return False


register_canonicalize(local_shape_to_constant)


@node_rewriter([Shape_i])
def local_shape_i_to_constant(fgraph, node):
    (x,) = node.inputs
    s = x.type.shape[node.op.i]
    if s is not None:
        return [constant(s, dtype="int64")]
    return False


register_canonicalize(local_shape_i_to_constant)


@node_rewriter([Subtensor])
def local_subtensor_of_shape(fgraph, node):
    """Shape(x)[i] (constant i) → Shape_i(x)"""
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, Shape):
        return False
    idx = node.op.idx_list
    if len(idx) != 1 or isinstance(idx[0], slice) or idx[0] is SYM:
        return False
    i = idx[0]
    x = inner.inputs[0]
    if i < 0:
        i += x.type.ndim
    if not (0 <= i < x.type.ndim):
        return False
    if x.type.shape[i] is not None:
        return [constant(x.type.shape[i], dtype="int64")]
    res = Shape_i(i)(x)
    copy_stack_trace(node.outputs[0], res)
    return [res]


register_canonicalize(local_subtensor_of_shape)


@node_rewriter([Shape])
def local_shape_of_specify_shape(fgraph, node):
    """Shape(SpecifyShape(x, *s)) → MakeVector mixing the specified
    dims (static where known) with Shape_i(x) for the rest, dropping
    the SpecifyShape indirection (reference ``local_Shape_of_SpecifyShape``,
    ``tensor/rewriting/shape.py:1013``)."""
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, SpecifyShape):
        return False
    x = inner.inputs[0]
    spec = inner.outputs[0].type.shape  # merged static knowledge
    elems = [
        constant(s, dtype="int64") if s is not None else Shape_i(d)(x)
        for d, s in enumerate(spec)
    ]
    if not elems:
        return [constant(np.zeros((0,), dtype="int64"))]
    res = MakeVector("int64")(*elems)
    copy_stack_trace(node.outputs[0], res)
    return [res]


register_canonicalize(local_shape_of_specify_shape)


@node_rewriter([Shape_i])
def local_shape_i_of_specify_shape(fgraph, node):
    """Shape_i(SpecifyShape(x)) → the specified constant dim, else
    Shape_i(x) — needed because ``local_shape_to_constant`` can build
    Shape_i over the SpecifyShape before ``local_shape_of_specify_shape``
    sees the Shape node (reference ``local_Shape_i_of_SpecifyShape``,
    ``tensor/rewriting/shape.py:1028``)."""
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, SpecifyShape):
        return False
    x = inner.inputs[0]
    s = inner.outputs[0].type.shape[node.op.i]
    if s is not None:
        return [constant(s, dtype="int64")]
    res = Shape_i(node.op.i)(x)
    copy_stack_trace(node.outputs[0], res)
    return [res]


register_canonicalize(local_shape_i_of_specify_shape)


@node_rewriter([SpecifyShape])
def local_merge_consecutive_specify_shape(fgraph, node):
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, SpecifyShape):
        return False
    from aesara_tpu_torch.tensor.shape import specify_shape

    merged = specify_shape(inner.inputs[0], node.outputs[0].type.shape)
    copy_stack_trace(node.outputs[0], merged)
    return [merged]


register_canonicalize(local_merge_consecutive_specify_shape)


# ---------------------------------------------------------------------------
# ShapeFeature: whole-graph symbolic shape inference
# ---------------------------------------------------------------------------

class ShapeFeature(Feature):
    """Track a symbolic shape tuple for every variable in an fgraph.

    ``shape_of[r]`` is a tuple of int64 scalar Variables (one per dim)
    or ``None`` for non-tensor types.  Entries prefer, in order: the
    static dim from ``r.type.shape``, a constant propagated through the
    op's ``infer_shape`` rule, then a symbolic graph over *input*
    shapes, and only as a last resort ``Shape_i(r)`` itself.  Rewrites
    query it via ``fgraph.shape_feature.get_shape(var, idx)`` /
    ``same_shape(x, y)``.  Reference: ``tensor/rewriting/shape.py:76``.
    """

    def __init__(self):
        self.shape_of = {}
        self.fgraph = None

    # -- plugin protocol ----------------------------------------------------
    def on_attach(self, fgraph):
        if hasattr(fgraph, "shape_feature"):
            raise AlreadyThere("ShapeFeature already present")
        fgraph.shape_feature = self
        self.fgraph = fgraph
        for v in fgraph.inputs:
            self.init_r(v)
        for node in fgraph.toposort():
            self.on_import(fgraph, node, "on_attach")
        for v in fgraph.outputs:
            self.init_r(v)

    def on_detach(self, fgraph):
        self.shape_of = {}
        self.fgraph = None
        if getattr(fgraph, "shape_feature", None) is self:
            del fgraph.shape_feature

    def clone(self):
        return type(self)()

    # -- canonical shape elements --------------------------------------------
    def shape_ir(self, i, r):
        """Best-known symbolic value of ``r.shape[i]`` from the type alone."""
        return shape_i(r, i)  # folds to a constant when static

    def shape_tuple(self, r):
        if not isinstance(r.type, TensorType):
            return None
        return tuple(self.shape_ir(i, r) for i in range(r.type.ndim))

    def unpack(self, s_i, r, i):
        """Canonicalize one shape element to an int64 scalar Variable."""
        static = None
        if hasattr(r.type, "shape") and r.type.shape is not None:
            try:
                static = r.type.shape[i]
            except (IndexError, TypeError):
                static = None
        if static is not None:
            return constant(static, dtype="int64")
        if s_i is None:
            return self.shape_ir(i, r)
        if isinstance(s_i, (int, np.integer)):
            if s_i < 0:
                raise ValueError(f"negative shape element {s_i} for {r}")
            return constant(int(s_i), dtype="int64")
        from aesara_tpu_torch.tensor.basic import as_tensor_variable

        v = as_tensor_variable(s_i)
        if getattr(v.type, "ndim", None) != 0:
            raise TypeError(f"shape element must be scalar, got {v.type}")
        try:
            return constant(int(get_scalar_constant_value(v)), dtype="int64")
        except NotScalarConstantError:
            pass
        if v.type.dtype != "int64":
            from aesara_tpu_torch.tensor.basic import cast

            v = cast(v, "int64")
        return v

    def set_shape(self, r, s, override=True):
        if not override and r in self.shape_of:
            return
        if s is None:
            self.shape_of[r] = None
            return
        self.shape_of[r] = tuple(
            self.unpack(s_i, r, i) for i, s_i in enumerate(s)
        )

    def init_r(self, r):
        if r not in self.shape_of:
            self.set_shape(r, self.shape_tuple(r))

    def default_infer_shape(self, fgraph, node, input_shapes=None):
        return [self.shape_tuple(o) for o in node.outputs]

    # -- events ----------------------------------------------------------------
    def on_import(self, fgraph, node, reason):
        if node.outputs[0] in self.shape_of:
            return
        for r in node.inputs:
            self.init_r(r)
        shape_infer = getattr(node.op, "infer_shape", None)
        o_shapes = None
        if shape_infer is not None:
            try:
                o_shapes = shape_infer(
                    fgraph, node, [self.shape_of.get(r) for r in node.inputs]
                )
            except NotImplementedError:
                o_shapes = None
        if o_shapes is None:
            o_shapes = self.default_infer_shape(fgraph, node)
        if len(o_shapes) != len(node.outputs):
            raise ValueError(
                f"{node.op}.infer_shape returned {len(o_shapes)} shapes "
                f"for {len(node.outputs)} outputs"
            )
        for o, sh in zip(node.outputs, o_shapes):
            if not isinstance(o.type, TensorType):
                self.shape_of[o] = None
                continue
            if sh is None or len(sh) != o.type.ndim:
                self.set_shape(o, self.shape_tuple(o))
            else:
                self.set_shape(o, sh)

    def on_change_input(self, fgraph, node, i, old_var, new_var, reason=None):
        self.init_r(new_var)
        self.update_shape(new_var, old_var)

    # -- queries --------------------------------------------------------------
    def update_shape(self, new_r, old_r):
        """Adopt constant dims known for ``old_r`` onto its replacement."""
        old_s = self.shape_of.get(old_r)
        cur = self.shape_of.get(new_r)
        if old_s is None or cur is None or len(old_s) != len(cur):
            return
        merged = tuple(
            b if (not isinstance(a, Constant) and isinstance(b, Constant))
            else a
            for a, b in zip(cur, old_s)
        )
        self.shape_of[new_r] = merged

    def get_shape(self, var, idx):
        self.init_r(var)
        s = self.shape_of[var]
        if s is None:
            raise TypeError(f"{var} has no shape")
        return s[idx]

    def same_shape(self, x, y, dim_x=None, dim_y=None) -> bool:
        """True only when the shapes (or the given dims) PROVABLY match."""
        self.init_r(x)
        self.init_r(y)
        sx, sy = self.shape_of.get(x), self.shape_of.get(y)
        if sx is None or sy is None:
            return False
        if dim_x is not None:
            sx = (sx[dim_x],)
            sy = (sy[dim_y if dim_y is not None else dim_x],)
        elif dim_y is not None:
            return False
        if len(sx) != len(sy):
            return False
        for a, b in zip(sx, sy):
            if isinstance(a, Constant) and isinstance(b, Constant):
                if int(a.data) != int(b.data):
                    return False
            elif a is not b and not equal_computations([a], [b]):
                return False
        return True


class ShapeOptimizer(GraphRewriter):
    """Attach a ShapeFeature at the start of the pipeline (ref ``:729``)."""

    def add_requirements(self, fgraph):
        fgraph.attach_feature(ShapeFeature())

    def apply(self, fgraph):
        pass


class UnShapeOptimizer(GraphRewriter):
    """Detach ShapeFeatures after the shape-driven passes (ref ``:756``)."""

    def apply(self, fgraph):
        for feature in list(fgraph._features):
            if isinstance(feature, ShapeFeature):
                fgraph.remove_feature(feature)


optdb.register("ShapeOpt", ShapeOptimizer(), "fast_run", "fast_compile",
               position=0.1)
optdb.register("UnShapeOpt", UnShapeOptimizer(), "fast_run", "fast_compile",
               position=10)


@node_rewriter([Shape])
def local_shape_to_shape_i(fgraph, node):
    """Shape(x) → MakeVector of the ShapeFeature's cached symbolic dims,
    lifting shape graphs toward the inputs (reference ``:368``)."""
    shape_feature = getattr(fgraph, "shape_feature", None)
    if shape_feature is None:
        return False
    (x,) = node.inputs
    s = shape_feature.shape_of.get(x)
    if s is None:
        return False
    # only rewrite when it makes progress: some entry is a constant or
    # refers to a different variable than x itself
    trivial = all(
        v.owner is not None
        and isinstance(v.owner.op, Shape_i)
        and v.owner.inputs[0] is x
        for v in s
    )
    if trivial:
        return False
    if len(s) == 0:
        return [constant(np.zeros((0,), dtype="int64"))]
    res = MakeVector("int64")(*s)
    copy_stack_trace(node.outputs[0], res)
    return [res]


register_canonicalize(local_shape_to_shape_i)


# ---------------------------------------------------------------------------
# reshape family (reference tensor/rewriting/shape.py:759-1132)
# ---------------------------------------------------------------------------

def _shape_vector_elements(shp_var, ndim):
    """Elements of a symbolic shape vector: a list of scalar Variables
    (from MakeVector) or python ints (from a constant), else None."""
    if isinstance(shp_var, Constant):
        data = np.asarray(shp_var.data)
        if data.ndim == 1 and data.shape[0] == ndim:
            return [int(v) for v in data]
        return None
    if shp_var.owner is not None and isinstance(shp_var.owner.op, MakeVector):
        return list(shp_var.owner.inputs)
    return None


@node_rewriter([Reshape])
def local_reshape_to_dimshuffle(fgraph, node):
    """Reshape that only inserts/removes length-1 dims → DimShuffle
    (reference ``local_reshape_to_dimshuffle``, ``shape.py:907``).

    Recognized when, pairing the non-1 target dims with the non-1 input
    dims in order, every pair is provably the same extent (static match,
    or the target entry IS ``Shape_i(x, d)`` of that input dim) and the
    skipped dims on both sides are statically 1.
    """
    from aesara_tpu_torch.tensor.elemwise import DimShuffle

    x, shp = node.inputs
    out = node.outputs[0]
    elems = _shape_vector_elements(shp, out.type.ndim)
    if elems is None:
        return False

    x_shape = x.type.shape
    # indices of input dims that are not statically 1 (must all be kept)
    keep = [d for d in range(x.type.ndim) if x_shape[d] != 1]
    new_order = []
    ki = 0
    for e in elems:
        is_one = (isinstance(e, int) and e == 1) or (
            isinstance(e, Constant) and np.asarray(e.data).ndim == 0
            and int(e.data) == 1
        )
        if is_one:
            new_order.append("x")
            continue
        if ki >= len(keep):
            return False
        d = keep[ki]
        if isinstance(e, int):
            if x_shape[d] != e:
                return False
        elif isinstance(e, Constant):
            if x_shape[d] is None or x_shape[d] != int(e.data):
                return False
        else:
            # symbolic: accept only Shape_i(x) of exactly this dim
            o = e.owner
            if not (
                o is not None
                and isinstance(o.op, Shape_i)
                and o.op.i == d
                and o.inputs[0] is x
            ):
                return False
        new_order.append(d)
        ki += 1
    if ki != len(keep):
        return False
    res = DimShuffle(x.type.ndim, tuple(new_order))(x)
    conv = out.type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(out, conv)
    return [conv]


register_canonicalize(local_reshape_to_dimshuffle)


@node_rewriter([Reshape])
def local_useless_dimshuffle_in_reshape(fgraph, node):
    """Reshape(DimShuffle(x), shp) where the DimShuffle preserves the
    row-major element order (its non-'x' entries are increasing — it only
    inserts or drops length-1 dims) → Reshape(x, shp) (reference
    ``local_useless_dimshuffle_in_reshape``, ``shape.py:1092``)."""
    from aesara_tpu_torch.tensor.elemwise import DimShuffle

    x, shp = node.inputs
    inner = x.owner
    if inner is None or not isinstance(inner.op, DimShuffle):
        return False
    order = [d for d in inner.op.new_order if d != "x"]
    if order != sorted(order):
        return False
    # dropped dims are size-1 by DimShuffle legality; order is preserved,
    # so the flat element sequence is identical
    res = Reshape(node.op.ndim)(inner.inputs[0], shp)
    copy_stack_trace(node.outputs[0], res)
    return [res]


register_canonicalize(local_useless_dimshuffle_in_reshape)


@node_rewriter([Reshape])
def local_reshape_lift(fgraph, node):
    """Reshape(Elemwise{unary}(y), shp) → Elemwise(Reshape(y, shp)):
    lift reshapes toward the graph inputs so elemwise chains stay
    adjacent for fusion (reference ``local_reshape_lift``, ``shape.py:956``)."""
    from aesara_tpu_torch.tensor.elemwise import Elemwise

    x, shp = node.inputs
    inner = x.owner
    if (
        inner is None
        or not isinstance(inner.op, Elemwise)
        or len(inner.inputs) != 1
        or len(inner.outputs) != 1
    ):
        return False
    inner_reshaped = Reshape(node.op.ndim)(inner.inputs[0], shp)
    res = inner.op(inner_reshaped)
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_specialize(local_reshape_lift)


# ---------------------------------------------------------------------------
# Shape_i propagation and constant slices of shapes
# ---------------------------------------------------------------------------

@node_rewriter([Shape_i])
def local_track_shape_i(fgraph, node):
    """Replace ``Shape_i(r)`` with the ShapeFeature's cached symbolic
    entry — typically ``Shape_i`` of a graph *input* or a constant —
    so shape graphs detach from intermediate results (reference
    ``local_track_shape_i``, ``shape.py:1071``)."""
    sf = getattr(fgraph, "shape_feature", None)
    if sf is None:
        return False
    (x,) = node.inputs
    s = sf.shape_of.get(x)
    if s is None:
        return False
    e = s[node.op.i]
    if e is node.outputs[0]:
        return False
    # Convergence guard (the reference gates on its ``scheduled`` set,
    # shape.py:1071): only replace with provably-final forms — a ground
    # constant, or Shape_i of a *graph input* (which this rule can never
    # rewrite again).  General symbolic entries are fresh graphs per
    # query and would churn the equilibrium forever.
    if isinstance(e, Constant):
        copy_stack_trace(node.outputs[0], e)
        return [e]
    if (
        e.owner is not None
        and isinstance(e.owner.op, Shape_i)
        and e.owner.inputs[0] is not x
        and e.owner.inputs[0] in fgraph.inputs
    ):
        copy_stack_trace(node.outputs[0], e)
        return [e]
    return False


register_canonicalize(local_track_shape_i)


@node_rewriter([Subtensor])
def local_subtensor_shape_constant(fgraph, node):
    """``Shape(x)[a:b]`` where the sliced dims are all statically known
    → constant vector (reference ``local_subtensor_shape_constant``)."""
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, Shape):
        return False
    idx = node.op.idx_list
    if len(idx) != 1 or not isinstance(idx[0], slice) or any(
        e is SYM for e in (idx[0].start, idx[0].stop, idx[0].step)
    ):
        return False
    x = inner.inputs[0]
    dims = list(range(x.type.ndim))[idx[0]]
    vals = [x.type.shape[d] for d in dims]
    if any(v is None for v in vals):
        return False
    res = constant(np.asarray(vals, dtype="int64"))
    copy_stack_trace(node.outputs[0], res)
    return [res]


register_canonicalize(local_subtensor_shape_constant)


# ---------------------------------------------------------------------------
# Unbroadcast lifting (reference shape.py:1132-1205)
# ---------------------------------------------------------------------------

@node_rewriter(None)
def local_unbroadcast_lift(fgraph, node):
    """``Unbroadcast(Elemwise{unary}(x))`` → ``Elemwise(Unbroadcast(x))``
    and merge consecutive Unbroadcasts (reference
    ``local_unbroadcast_lift``, ``shape.py:1164``)."""
    from aesara_tpu_torch.tensor.elemwise import Elemwise
    from aesara_tpu_torch.tensor.shape import Unbroadcast, unbroadcast

    if not isinstance(node.op, Unbroadcast):
        return False
    inner = node.inputs[0].owner
    if inner is None:
        return False
    if isinstance(inner.op, Unbroadcast):
        merged = set(node.op.axes) | set(inner.op.axes)
        res = unbroadcast(inner.inputs[0], *sorted(merged))
        copy_stack_trace(node.outputs[0], res)
        return [res]
    if (
        isinstance(inner.op, Elemwise)
        and len(inner.inputs) == 1
        and len(inner.outputs) == 1
    ):
        res = inner.op(unbroadcast(inner.inputs[0], *node.op.axes))
        conv = node.outputs[0].type.convert_variable(res)
        if conv is None:
            return False
        copy_stack_trace(node.outputs[0], conv)
        return [conv]
    return False


register_canonicalize(local_unbroadcast_lift)
