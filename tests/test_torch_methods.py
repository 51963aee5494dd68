"""``TensorVariable``'s methods, the ``at.*`` math helpers, the type
constructors and the compile API of the port against the JAX package's on
the CPU, with inputs from seeded NumPy generators.

Each method calls the function the JAX package's method calls, so the
graphs agree: their ``FAST_RUN`` op counts are compared.  Values that
move data (indexing, sorting, casting, arg-reductions) are held bitwise;
values that sum or take roots within 1e-12 relative and absolute in
float64, 1e-6 in float32 (the packages may sum in another order).  A
graph that reshapes a tensor of unknown shape is compared by its values
alone: the port builds such shape arithmetic from ``Shape_i`` nodes where
the JAX package's rewrites keep a ``Shape`` (``tensor/rewriting/shape.py``
is not ported yet).
"""

import pickle

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config

from tests.test_torch_core_ops import graph_counts
from tests.test_torch_rnn import op_counts


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


PKGS = ((aesara_tpu, jat, "FAST_RUN"), (aesara_tpu_torch, pat, "TORCH"))
TOL = dict(rtol=1e-12, atol=1e-12)
TOL32 = dict(rtol=1e-6, atol=1e-6)


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def compare(build, values, exact=False, counts=True):
    """Both packages build ``build(at) -> (inputs, outputs)`` and run it
    on ``values``: dtypes, shapes and values (bitwise with ``exact``, else
    within TOL), and the FAST_RUN op counts.  Returns the port's values."""
    runs = []
    for pkg, at, mode in PKGS:
        ins, outs = build(at)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        f = pkg.function(ins, outs, mode=mode, on_unused_input="ignore")
        runs.append((outs, [_host(v) for v in f(*values)], f))
    (jo, jv, jf), (po, pv, pf) = runs
    for a, b, av, bv in zip(po, jo, pv, jv):
        assert a.type.dtype == b.type.dtype and a.type.ndim == b.type.ndim, (a.type, b.type)
        assert av.dtype == bv.dtype and av.shape == bv.shape, (av.dtype, av.shape, bv.dtype, bv.shape)
        if exact:
            np.testing.assert_array_equal(av, bv)
        else:
            np.testing.assert_allclose(av, bv, **(TOL if av.dtype != np.float32 else TOL32))
    if counts:
        assert op_counts(pf.maker.fgraph) == graph_counts(jf.maker.fgraph, pf.maker.fgraph)
    return pv


XV = np.random.default_rng(0).normal(size=(4, 6))
IV = np.random.default_rng(1).integers(-5, 6, size=(4, 6)).astype("int32")

#: (id, method call on x, exact): reductions and roots within TOL
METHODS = [
    ("sum", lambda x: x.sum(), False), ("sum_axis", lambda x: x.sum(axis=1, keepdims=True), False),
    ("sum_dtype", lambda x: x.sum(dtype="float32"), False), ("mean", lambda x: x.mean(axis=0), False),
    ("mean_all", lambda x: x.mean(), False), ("prod", lambda x: x.prod(axis=1), False),
    ("var", lambda x: x.var(axis=1, ddof=1), False), ("std", lambda x: x.std(), False),
    ("std_keep", lambda x: x.std(axis=0, keepdims=True), False), ("max", lambda x: x.max(axis=1), True),
    ("min", lambda x: x.min(keepdims=True), True), ("argmax", lambda x: x.argmax(axis=1), True),
    ("argmax_keep", lambda x: x.argmax(axis=0, keepdims=True), True), ("argmin", lambda x: x.argmin(), True),
    ("argmin_axis", lambda x: x.argmin(axis=1, keepdims=True), True),
    ("all", lambda x: (x > -3).all(axis=0), True), ("any", lambda x: (x > 1).any(), True),
    ("norm1", lambda x: x.norm(1, axis=1), False), ("norm2", lambda x: x.norm(2), False),
    ("norm_inf", lambda x: x.norm(np.inf, axis=0), True), ("norm_ninf", lambda x: x.norm(-np.inf), True),
    ("norm3", lambda x: x.norm(3, axis=1, keepdims=True), False),
    ("dot", lambda x: x.dot(x.T), False), ("clip", lambda x: x.clip(-0.5, 0.7), True),
    ("astype", lambda x: x.astype("int32"), True), ("astype_same", lambda x: x.astype("float64"), True),
    ("transpose", lambda x: x.transpose(), True), ("transpose_axes", lambda x: x.transpose(1, 0), True),
    ("ravel", lambda x: x.ravel(), True), ("flatten", lambda x: x.flatten(), True),
    ("squeeze", lambda x: x.dimshuffle(0, "x", 1).squeeze(), True),
    ("take", lambda x: x.take([3, 0, 5]), True), ("take_axis0", lambda x: x.take([2, 2, 0], axis=0), True),
    ("take_2d", lambda x: x.take(np.array([[1, 2], [0, 3]])), True),
    ("diagonal", lambda x: x.diagonal(1), True), ("trace", lambda x: x.trace(), False),
    ("copy", lambda x: x.copy(), True), ("repeat", lambda x: x.repeat(2, axis=0), True),
    ("round", lambda x: (x * 3).round(), True), ("round_away", lambda x: (x * 3).round("half_away_from_zero"), True),
    ("cumsum", lambda x: x.cumsum(axis=1), False), ("cumprod", lambda x: x.cumprod(), False),
    ("sort", lambda x: x.sort(), True), ("argsort", lambda x: x.argsort(axis=0), True),
    ("choose", lambda x: (x > 0).astype("int64").choose([x, -x]), True),
    ("fill", lambda x: x.fill(2.5), True), ("zeros_like", lambda x: x.zeros_like(), True),
    ("ones_like", lambda x: x.ones_like(dtype="int8"), True), ("size", lambda x: x.size, True),
    ("matmul_op", lambda x: x @ x.T, False), ("rmatmul_op", lambda x: np.ones((2, 4)) @ x, False),
    ("T", lambda x: x.T, True),
]


#: methods that reshape by the input's unknown shape (see the docstring)
SHAPE_ARITHMETIC = ("ravel", "flatten", "take", "take_2d", "size")


@pytest.mark.parametrize("name,call,exact", METHODS, ids=[m[0] for m in METHODS])
def test_each_method_builds_the_jax_packages_graph_and_values(name, call, exact):
    compare(lambda at: ([x := at.matrix("x", dtype="float64")], [call(x)]), [XV], exact=exact,
            counts=name not in SHAPE_ARITHMETIC)
    if name in SHAPE_ARITHMETIC:
        compare(lambda at: ([x := at.tensor("x", dtype="float64", shape=XV.shape)], [call(x)]), [XV],
                exact=exact)


def test_methods_of_integer_tensors():
    compare(lambda at: ([x := at.matrix("x", dtype="int32")],
                        [x.sum(), x.mean(), x.argmin(axis=1), x.max(), x.prod(axis=0), x.astype("float32"),
                         x.clip(-2, 2), x.sort(axis=1), x.cumsum(axis=0)]),
            [IV], exact=True)


def test_the_shape_only_methods_and_properties():
    for at in (jat, pat):
        x = at.tensor("x", shape=(1, 3, 1), dtype="float64")
        assert x.broadcastable == (True, False, True)
        assert x.squeeze().type.shape == (3,) and x.squeeze(0).type.shape == (3, 1)
        assert x.ndim == 3 and x.dtype == "float64"
        total = x.sum()
        assert x.get_parents() == [] and total.get_parents() == [total.owner]
        assert total.owner.get_parents() == [x]


MATH = [
    ("round", lambda at, x, y: at.round(x * 2.5), True), ("iround", lambda at, x, y: at.iround(x * 2.5), True),
    ("isclose", lambda at, x, y: at.isclose(x, x + 1e-6, rtol=1e-5), True),
    ("isclose_nan", lambda at, x, y: at.isclose(x / 0.0, y / 0.0, equal_nan=True), True),
    ("allclose", lambda at, x, y: at.allclose(x, y), True), ("ptp", lambda at, x, y: at.ptp(x, axis=1), True),
    ("norm", lambda at, x, y: at.norm(x, 2, axis=0), False),
    ("max_and_argmax", lambda at, x, y: at.max_and_argmax(x, axis=1), True),
    ("argmin", lambda at, x, y: at.argmin(x, axis=0), True),
    ("matmul_2d", lambda at, x, y: at.matmul(x, y.T), False),
    ("matmul_1d", lambda at, x, y: at.matmul(x[0], y.T), False),
    ("largest", lambda at, x, y: at.largest(x, y, x * 0.5), True),
    ("smallest", lambda at, x, y: at.smallest(x, y), True), ("cov", lambda at, x, y: at.cov(x), False),
    ("cov_y", lambda at, x, y: at.cov(x, y, rowvar=False, bias=True), False),
    ("divmod", lambda at, x, y: at.divmod(x * 10, 3), True),
    ("aliases", lambda at, x, y: [at.true_divide(x, y), at.floor_divide(x, y), at.square(x), at.sign(x),
                                  at.power(abs(x), 0.5)], True),
    ("bitwise", lambda at, x, y: [at.bitwise_and(x > 0, y > 0), at.bitwise_or(x > 0, y > 0),
                                  at.bitwise_xor(x > 0, y > 0), at.bitwise_not(x > 0),
                                  at.invert_bool(x > 0)], True),
    ("ceil_intdiv", lambda at, x, y: at.ceil_intdiv((x * 10).astype("int64"), 3), True),
    ("prod_no_zeros", lambda at, x, y: at.grad(at.prod(x, axis=1, no_zeros_in_input=True).sum(), x), True),
    ("argmax_keepdims", lambda at, x, y: at.argmax(x, axis=1, keepdims=True), True),
    ("tensordot", lambda at, x, y: at.tensordot(x, y.T, 1), False),
    ("logsumexp", lambda at, x, y: at.logsumexp(x, axis=1), False),
]


@pytest.mark.parametrize("name,fn,exact", MATH, ids=[m[0] for m in MATH])
def test_each_math_helper_is_the_jax_packages(name, fn, exact):
    yv = np.random.default_rng(2).normal(size=(4, 6))

    def build(at):
        x, y = at.matrix("x", dtype="float64"), at.matrix("y", dtype="float64")
        return [x, y], fn(at, x, y)

    # tensordot reshapes by unknown shapes (see the docstring)
    compare(build, [XV, yv], exact=exact, counts=name != "tensordot")


def test_matmul_of_stacked_operands():
    a, b, c = (np.random.default_rng(i).normal(size=s) for i, s in enumerate([(2, 3, 4), (2, 4, 5), (4,)]))
    compare(lambda at: ([x := at.tensor3("x", dtype="float64"), y := at.tensor3("y", dtype="float64"),
                         v := at.vector("v", dtype="float64")],
                        [at.matmul(x, y), at.matmul(x.dimshuffle("x", 0, 1, 2), y), at.matmul(x, v),
                         x @ y]), [a, b, c], counts=False)


def test_convolve_is_numpys():
    """Against ``numpy.convolve`` alone: the JAX package's ``convolve``
    drops a conv2d output dim its static shape does not know to be 1, and
    raises (ROADMAP Queue 3)."""
    a, k = np.random.default_rng(6).normal(size=9), np.random.default_rng(7).normal(size=4)
    x, y = pat.vector("x", dtype="float64"), pat.vector("y", dtype="float64")
    modes = ("full", "valid", "same")
    f = aesara_tpu_torch.function([x, y], [pat.convolve(x, y, m) for m in modes])
    for got, m in zip(f(a, k), modes):
        np.testing.assert_allclose(_host(got), np.convolve(a, k, m), **TOL)


def test_the_type_constructors():
    for at in (jat, pat):
        assert at.tensor("t", shape=(2, None), dtype="int16").type == at.TensorType("int16", (2, None))
        assert at.tensor(broadcastable=(True, False)).type.shape == (1, None)
        assert at.tensor().type.dtype == config.floatX
        assert [v.type.ndim for v in (at.tensor5(), at.tensor6(), at.tensor7())] == [5, 6, 7]
        for prefix, dtype in (("b", "int8"), ("w", "int16"), ("i", "int32"), ("l", "int64"), ("f", "float32"),
                              ("d", "float64")):
            for base, nd in (("scalar", 0), ("vector", 1), ("matrix", 2), ("tensor5", 5), ("tensor7", 7)):
                assert getattr(at, prefix + base).ndim == nd and getattr(at, prefix + base).dtype == dtype
            a, b = getattr(at, prefix + "matrices")("a", "b")
            assert (a.name, b.name, a.type.dtype) == ("a", "b", dtype)
            assert getattr(at, prefix + "rows")("r")[0].type.shape == (1, None)
        for name, nd in (("scalars", 0), ("vectors", 1), ("matrices", 2), ("tensor3s", 3), ("tensor4s", 4),
                         ("tensor5s", 5)):
            xs = getattr(at, name)("p", "q", dtype="float64")
            assert [x.name for x in xs] == ["p", "q"] and xs[0].type == at.TensorType("float64", (None,) * nd)


def test_eval_keeps_one_function_per_set_of_inputs_and_looks_up_names():
    for pkg, at, _ in PKGS:
        x, y = at.vector("x", dtype="float64"), at.vector("y", dtype="float64")
        z = (x * 2 + y).sum()
        assert float(_host(z.eval({x: np.ones(3), y: np.arange(3.0)}))) == 9.0
        assert float(_host(z.eval({"x": np.zeros(3), "y": np.ones(3)}))) == 3.0
        assert len(z._fn_cache) == 1
        assert float(_host(at.constant(2.0).eval())) == 2.0
        with pytest.raises(ValueError):
            z.eval({"w": np.ones(3)})


def test_pfunc_function_dump_and_the_accepted_parameters(tmp_path):
    x = pat.vector("x", dtype="float64")
    f = aesara_tpu_torch.pfunc([x], x * 2, accept_inplace=True, rebuild_strict=False)
    np.testing.assert_array_equal(_host(f(np.arange(3.0))), [0.0, 2.0, 4.0])
    aesara_tpu_torch.function_dump(tmp_path / "dump.pkl", [1, 2], mode="TORCH")
    assert pickle.loads((tmp_path / "dump.pkl").read_bytes()) == {"args": ([1, 2],), "kwargs": {"mode": "TORCH"}}


def test_shared_strict_allow_downcast_and_python_scalars():
    for pkg, at, _ in PKGS:
        assert pkg.shared(0.5).type.dtype == config.floatX and pkg.shared(3).type.dtype == "int64"
        assert pkg.shared(True).type.dtype == "bool"
        assert pkg.shared(np.zeros((1, 3)), broadcastable=(True, False)).type.shape == (1, 3)
    s = aesara_tpu_torch.shared(np.zeros(3, dtype="float32"), strict=True)
    with pytest.raises(TypeError):
        s.set_value(np.zeros(3, dtype="float64"))
    d = aesara_tpu_torch.shared(np.zeros(3, dtype="float32"), allow_downcast=True)
    d.set_value(np.full(3, 1.5, dtype="float64"))
    np.testing.assert_array_equal(d.get_value(), np.full(3, 1.5, dtype="float32"))


def test_fast_compile_runs_the_canonical_rewrites_alone():
    x = pat.vector("x", dtype="float64")
    out = pat.exp(x) * 2.0 + 1.0
    fc = aesara_tpu_torch.function([x], out, mode="FAST_COMPILE")
    fr = aesara_tpu_torch.function([x], out, mode="FAST_RUN")
    np.testing.assert_allclose(_host(fc(np.arange(3.0))), _host(fr(np.arange(3.0))), **TOL)
    assert "Composite" not in str(op_counts(fc.maker.fgraph)) and "Composite" in str(op_counts(fr.maker.fgraph))
    assert set(aesara_tpu_torch.predefined_modes) == {"TORCH", "FAST_RUN", "FAST_COMPILE"}
    assert "fast_run" in aesara_tpu_torch.predefined_optimizers


def test_top_level_names_run():
    x = pat.vector("x", dtype="float64")
    assert aesara_tpu_torch.as_symbolic(x) is x and aesara_tpu_torch.as_symbolic(2.0, name="c").name == "c"
    assert aesara_tpu_torch.get_scalar_constant_value(pat.constant(3) * 2) == 6
    ys, _ = aesara_tpu_torch.map(lambda v: v * 2, sequences=[x])
    total, _ = aesara_tpu_torch.foldl(lambda v, acc: acc + v, sequences=[x], outputs_info=[pat.constant(0.0, dtype="float64")])
    f = aesara_tpu_torch.function([x], [ys, total])
    out = [_host(v) for v in f(np.arange(4.0))]
    np.testing.assert_array_equal(out[0], [0.0, 2.0, 4.0, 6.0])
    assert float(out[1]) == 6.0
    assert aesara_tpu_torch.clone_replace(x * 2, {x: x + 1}).owner is not None
    with aesara_tpu_torch.change_flags(floatX="float64"):
        assert pat.vector().type.dtype == "float64"
    aesara_tpu_torch.verify_grad(lambda m: pat.tanh(m).sum(), [np.random.default_rng(0).normal(size=(3, 3))],
                                 out_type=None, cast_to_output_type=True, no_debug_ref=False)
