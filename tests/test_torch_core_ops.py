"""The user API's core ops of the port (``aesara_tpu_torch/tensor/basic.py``:
``Eye``, ``Tri``, ``ExtractDiag``, ``AllocDiag``, ``Nonzero``,
``PermuteRowElements``, ``Choose``; ``compile/ops.py``: ``DeepCopyOp``,
``ViewOp``, ``FromFunctionOp``; ``extra_ops.FillDiagonalOffset``) and the
helpers built on them, against the JAX package on the CPU with inputs
from seeded NumPy generators.

These ops move or select data and compute nothing, so values are held
bitwise, with their dtypes and static shapes; gradients (sums of moved
values) too.  ``FAST_RUN`` graphs have the JAX package's op counts.  A
graph that holds ``Nonzero`` runs on the JAX package's PY linker (its XLA
lowering refuses the data-dependent length), so only values are compared
there.  ``Choose(mode="raise")`` clips an index out of range on both
packages' device paths (the JAX package's XLA lowering), while ``perform``
raises as NumPy does.
"""

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.compile.ops import DeepCopyOp, as_op as jas_op

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.compile.ops import as_op as pas_op
from aesara_tpu_torch.config import config

from tests.test_torch_rnn import op_counts


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, mode="FAST_RUN", as_op=jas_op)
PORT = dict(pkg=aesara_tpu_torch, at=pat, mode="TORCH", as_op=pas_op)


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _values(*shapes, dtype="float64", seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype) for s in shapes]


def run_both(build, values, jax_mode="FAST_RUN", counts=True):
    """Each package builds ``build(at) -> (inputs, outputs)``, compiles and
    runs it on ``values``; outputs are held bitwise, with dtype and static
    shape (where the JAX package's knows a dim, the port's has it), and
    with ``counts`` the two FAST_RUN graphs' op counts.  Returns the port's
    results."""
    results = []
    for m in (JAX, PORT):
        ins, outs = build(m["at"])
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        f = m["pkg"].function(ins, outs, mode=jax_mode if m is JAX else "TORCH", on_unused_input="ignore")
        results.append((outs, [_host(v) for v in f(*values)], f))
    (jo, jv, jf), (po, pv, pf) = results
    for a, b, av, bv in zip(po, jo, pv, jv):
        # the port's static shape may know a dim the JAX package's does not
        assert a.type.dtype == b.type.dtype and a.type.ndim == b.type.ndim, (a.type, b.type)
        assert all(j is None or j == p for p, j in zip(a.type.shape, b.type.shape)), (a.type, b.type)
        assert av.dtype == bv.dtype and av.shape == bv.shape, (av.dtype, av.shape, bv.dtype, bv.shape)
        np.testing.assert_array_equal(av, bv)
    if counts == "each":
        # one graph an output: the JAX package's merge misses some
        # duplicates of a larger graph (ROADMAP Queue 3)
        for i in range(len(po)):
            run_both(lambda at: (lambda ins, outs: (ins, [outs[i]]))(*build(at)), values, jax_mode)
    elif counts:
        assert op_counts(pf.maker.fgraph) == graph_counts(jf.maker.fgraph, pf.maker.fgraph)
    return pv


def graph_counts(jgraph, pgraph):
    """``op_counts`` of the JAX package's graph without the ``DeepCopyOp``
    its ``function`` puts on an output that is an input or a constant (the
    port's graph returns such an output as it is, and its linker copies
    it)."""
    counts = op_counts(jgraph)
    inserted = {j.owner for j, p in zip(jgraph.outputs, pgraph.outputs)
                if p.owner is None and j.owner is not None and isinstance(j.owner.op, DeepCopyOp)}
    if inserted:
        counts[0]["DeepCopyOp"] -= len(inserted)
        if not counts[0]["DeepCopyOp"]:
            del counts[0]["DeepCopyOp"]
    return counts


@pytest.mark.parametrize("dtype", ["float32", "float64", "int64", "bool"])
@pytest.mark.parametrize("n,m,k", [(4, 4, 0), (3, 5, 1), (5, 3, -2), (4, 6, 7)])
def test_eye_and_tri_of_constant_sizes(n, m, k, dtype):
    run_both(lambda at: ([], [at.eye(n, m, k, dtype=dtype), at.tri(n, m, k, dtype=dtype),
                              at.eye(n, dtype=dtype)]), [])


def test_eye_tri_tril_and_triu_of_symbolic_sizes():
    """Sizes from shapes (host values in the port) and a diagonal from an
    input (on the device); the JAX package's XLA lowering needs all three
    concrete, so it runs on its PY linker."""
    def build(at):
        k, x = at.lscalar("k"), at.matrix("x", dtype="float64")
        n, m = x.shape[0], x.shape[1]
        return [k, x], [at.eye(n, m, k), at.tri(m, n, k, dtype="int32"), at.tril(x, k), at.triu(x, -k),
                        at.identity_like(x), at.tril(x.dimshuffle("x", 0, 1) * 2.0)]

    run_both(build, [np.int64(1)] + _values((5, 3)), jax_mode="PY", counts=False)


def test_eye_of_a_size_on_the_device_refuses_to_compile():
    n = pat.lscalar("n")
    with pytest.raises(NotImplementedError, match="size computed on the device"):
        aesara_tpu_torch.function([n], pat.eye(n))


@pytest.mark.parametrize("offset,axis1,axis2", [(0, 0, 1), (2, 0, 1), (-1, 0, 1), (1, 1, 0), (0, 2, 0),
                                                (-2, 1, 2)])
def test_diagonal_of_matrices_and_tensor3(offset, axis1, axis2):
    def build(at):
        x3 = at.tensor3("x3", dtype="float64")
        outs = [at.diagonal(x3, offset, axis1, axis2), x3.diagonal(offset, axis1, axis2)]
        if max(axis1, axis2) < 2:
            x = at.matrix("x", dtype="float64")
            outs += [x.diagonal(offset, axis1, axis2), at.grad((x.diagonal(offset, axis1, axis2) * 3.0).sum(), x)]
            return [x3, x], outs
        return [x3], outs

    values = _values((3, 4, 5), (4, 6))
    run_both(build, values if axis1 < 2 and axis2 < 2 else values[:1])


def test_trace_diag_and_allocdiag_with_gradients():
    def build(at):
        v, x, y = at.vector("v", dtype="float64"), at.matrix("x", dtype="float64"), at.matrix("y", dtype="float64")
        d1, d2 = at.diag(v, 2), at.diag(x)
        batch = at.AllocDiag(-1)(x)
        cost = (d1 * 2.0).sum() + x.trace() + (at.diag(y, -1) ** 2).sum()
        return [v, x, y], [d1, d2, x.trace(), batch, at.extract_diag(x)] + at.grad(cost, [v, x, y])

    run_both(build, _values((3,), (4, 4), (5, 3)))


def test_static_shapes_of_the_diagonal_ops():
    for at in (jat, pat):
        assert at.diagonal(at.tensor("x", shape=(3, 7)), 2).type.shape == (3,)
        assert at.diagonal(at.tensor("x", shape=(3, 7)), -5).type.shape == (0,)
        assert at.diag(at.tensor("v", shape=(4,)), -1).type.shape == (5, 5)
        assert at.eye(3, 4).type.shape == (3, 4) and at.tri(at.lscalar(), 2).type.shape == (None, 2)


def test_nonzero_and_the_index_helpers_give_the_jax_packages_values():
    """Run on the JAX package's PY linker (its XLA lowering of Nonzero
    refuses)."""
    def build(at):
        x, n = at.matrix("x", dtype="float64"), at.lscalar("n")
        outs = list(at.nonzero(x > 0.3)) + [at.nonzero(x > 0, return_matrix=True), at.flatnonzero(x > 0.5),
                                            at.nonzero_values(x * (x > 0)), (x > 0).nonzero()[1],
                                            x.nonzero_values()]
        outs += list(at.tril_indices(n, 1)) + list(at.triu_indices(n, -1, 3)) + list(at.tril_indices_from(x))
        outs += list(at.triu_indices_from(x, 2))
        return [x, n], outs

    run_both(build, _values((5, 4)) + [np.int64(4)], jax_mode="PY", counts=False)


def test_a_nonzero_graph_compiles_uncaptured_and_names_why():
    x = pat.vector("x")
    f = aesara_tpu_torch.function([x], pat.nonzero(x)[0], mode="TORCH")
    assert f.fn.program.blocker is not None
    assert "length the data decides" in f.fn.program.blocker_reason


@pytest.mark.parametrize("inverse", [False, True])
def test_permute_row_elements_broadcast_and_gradient(inverse):
    rng = np.random.default_rng(3)
    perms = np.stack([rng.permutation(5) for _ in range(4)]).astype("int64")

    def build(at):
        x, y, p = at.matrix("x", dtype="float64"), at.vector("y", dtype="float64"), at.lmatrix("p")
        out = at.permute_row_elements(x, p, inverse=inverse)
        row = at.permute_row_elements(y, p, inverse=inverse)
        g = at.grad((out * at.arange(5).astype("float64")).sum() + (row ** 2).sum(), [x, y])
        return [x, y, p], [out, row, at.inverse_permutation(p[0])] + g

    run_both(build, _values((4, 5), (5,)) + [perms])


@pytest.mark.parametrize("mode", ["raise", "clip", "wrap"])
def test_choose_in_and_out_of_range_is_the_jax_packages_lowering(mode):
    rng = np.random.default_rng(4)
    inside = rng.integers(0, 3, size=(4, 5)).astype("int64")
    outside = rng.integers(-4, 7, size=(4, 5)).astype("int64")

    def build(at):
        a, c = at.lmatrix("a"), at.tensor3("c", dtype="float64")
        return [a, c], [at.choose(a, c, mode), a.choose(c, mode), at.choose(a[0], c, mode)]

    for index in (inside, outside):
        run_both(build, [index] + _values((3, 4, 5)))


def test_choose_perform_raises_out_of_range_as_numpy():
    node = pat.choose(pat.lvector("a"), pat.matrix("c")).owner
    with pytest.raises(ValueError):
        node.op.perform(node, [np.array([0, 5]), np.zeros((2, 2), "float32")], [[None]])


@pytest.mark.parametrize("static", [True, False], ids=["static", "unknown_shapes"])
def test_roll_tile_flatten_and_the_shape_helpers(static):
    """Op counts where the shapes are static; with unknown shapes the
    port builds ``x.shape`` as ``Shape_i`` nodes where the JAX package
    builds ``Shape`` and rewrites it (``tensor/rewriting/shape.py``, not
    ported yet), so there the values alone are compared."""
    def build(at):
        x = at.tensor("x", dtype="float64", shape=(2, 3, 4) if static else (None,) * 3)
        v = at.tensor("v", dtype="float64", shape=(5,) if static else (None,))
        s = at.lscalar("s")
        outs = [at.roll(x, 2), at.roll(x, s), at.roll(x, -1, axis=0), at.tile(v, 3), at.tile(x, (2, 1, 3)),
                at.tile(v, (2, 0)), x.flatten(2), at.flatten(x, 3), x.flatten(), at.expand_dims(x, (0, 3)),
                at.swapaxes(x, 0, 2), at.moveaxis(x, 0, -1), at.moveaxis(x, [0, 1], [2, 0]), at.atleast_1d(s),
                at.atleast_2d(v), at.atleast_3d(v), at.atleast_Nd(v, 4), at.horizontal_stack(v, v),
                at.vertical_stack(v, v * 2.0), at.stacklists([[s, s], [s, s]]), at.full_like(v, 7.5),
                at.full_like(x, 2, dtype="int32"), at.tensor_copy(x), x.copy(name="c"), at.make_vector(s, s),
                at.transpose(x, (1, 2, 0)), x.transpose(2, 0, 1), x.T, at.shape_padaxis(v, 1), x.squeeze(),
                at.transfer(v, "cpu")]
        return [x, v, s], outs

    run_both(build, _values((2, 3, 4), (5,)) + [np.int64(3)], counts="each" if static else False)


def test_flatten_of_a_tensor_with_unknown_leading_dims_and_a_bad_ndim():
    run_both(lambda at: ([x := at.tensor3("x")], [x.flatten(2), at.flatten(x, 1)]),
             _values((2, 3, 4), dtype="float32"), counts=False)
    for at in (jat, pat):
        with pytest.raises(ValueError):
            at.flatten(at.matrix("x"), 3)


def test_grids_constants_and_conversions():
    run_both(lambda at: ([], list(at.mgrid[0:3, 1:5:2]) + list(at.ogrid[0:4, 0:2]) + [at.mgrid[2:6]]), [])
    for at in (jat, pat):
        assert at.extract_constant(at.constant(3) + 4) == 7
        v = at.vector("v")
        assert at.extract_constant(v) is v and at.as_tensor is at.as_tensor_variable
        assert at.is_flat(v) and not at.is_flat(at.matrix(), 1)
        assert at.squeeze(at.tensor("x", shape=(1, 3, 1))).type.shape == (3,)
        assert at.empty_like(at.tensor("x", shape=(2, 3), dtype="int32")).type.dtype == "int32"


def test_empty_like_has_the_shape_and_dtype():
    f = aesara_tpu_torch.function([x := pat.matrix("x")], pat.empty_like(x, dtype="int16"))
    out = f(np.zeros((2, 5), "float32"))
    assert out.shape == (2, 5) and out.dtype == torch.int16


def test_deep_copy_view_and_as_op():
    def build(at, as_op):
        # the JAX package's pure_callback needs static output shapes
        @as_op(itypes=[at.TensorType("float64", (6,)), at.dscalar], otypes=[at.TensorType("float64", (6,))])
        def scale(v, s):
            return v * s + np.arange(v.shape[0])

        v, s = at.tensor("v", dtype="float64", shape=(6,)), at.dscalar("s")
        from importlib import import_module

        ops = import_module(f"{at.__name__.split('.')[0]}.compile.ops")
        return [v, s], [scale(v, s), ops.deep_copy_op(v), ops.view_op(v) * 2.0, scale(scale(v, s), s)]

    run_both(lambda at: build(at, jas_op if at is jat else pas_op), _values((6,)) + [np.float64(1.5)],
             counts=False)


def test_as_op_runs_uncaptured_and_its_errors_propagate():
    @pas_op(itypes=[pat.dvector], otypes=[pat.dvector])
    def fail(v):
        raise RuntimeError("from the user's function")

    v = pat.dvector("v")
    f = aesara_tpu_torch.function([v], fail(v))
    assert "Python function on the host" in f.fn.program.blocker_reason
    with pytest.raises(RuntimeError, match="user's function"):
        f(np.zeros(3))


def test_an_output_that_views_an_updated_shared_variable_is_the_value_before_the_update():
    """``w.diagonal()`` is a view of ``w``'s storage, which the update
    overwrites after the graph has run: the returned value is the one from
    before the update, as the JAX package's."""
    outs = []
    for m in (JAX, PORT):
        w = m["pkg"].shared(np.arange(9.0).reshape(3, 3), name="w")
        f = m["pkg"].function([], [w.diagonal(), m["at"].tensor_copy(w)[0]],
                              updates={w: 2 * w}, mode=m["mode"])
        outs.append([[_host(v) for v in f()] for _ in range(2)] + [_host(w.get_value())])
    np.testing.assert_array_equal(outs[1][0][0], [0.0, 4.0, 8.0])
    np.testing.assert_array_equal(outs[1][1][0], [0.0, 8.0, 16.0])
    for got, want in zip(outs[1][:2], outs[0][:2]):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(outs[1][2], outs[0][2])


def test_fill_diagonal_offset_and_its_gradient():
    from aesara_tpu.tensor.extra_ops import fill_diagonal_offset as jfill
    from aesara_tpu_torch.tensor.extra_ops import fill_diagonal_offset as pfill

    def build(at):
        fill = jfill if at is jat else pfill
        a, d = at.matrix("a", dtype="float64"), at.vector("d", dtype="float64")
        out = fill(a, d, 1)
        return [a, d], [out, fill(a, at.constant(5.0), -2)] + at.grad((out ** 2).sum(), [a, d])

    run_both(build, _values((4, 6), (4,)))
