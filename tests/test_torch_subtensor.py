"""The port's slice family (``tensor/subtensor.py``: Subtensor,
IncSubtensor, AdvancedSubtensor1, AdvancedIncSubtensor1, DynamicSlice,
DynamicIncSubtensor, set_subtensor/inc_subtensor, basic indexing in
``__getitem__``) and its rewrites against the JAX package, on the CPU.

Each graph is built by both packages from the same code and compiled with
JAX ``FAST_RUN`` and the port's ``TORCH``; values and gradients are held
to each other exactly for gathers and scatters of float32 values (a sum
of squares' gradient: atol/rtol 1e-6) and to NumPy.  ``DynamicSlice``
clamps its start as ``lax.dynamic_slice`` does (a negative start wrapped
once, then clamped into [0, dim - length]); the clamped cases are held to
the JAX package and to that rule.
"""

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.tensor import subtensor as jst

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.tensor import subtensor as pst


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, st=jst, mode="FAST_RUN")
PORT = dict(pkg=aesara_tpu_torch, at=pat, st=pst, mode="TORCH")
TOL = dict(rtol=1e-6, atol=1e-6)
X = np.random.default_rng(0).normal(size=(5, 6, 7)).astype("float32")


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _both(build, args, **kwargs):
    """The outputs of ``build(m) -> (inputs, outputs)`` compiled by each
    package on ``args``: (jax, port), lists of arrays."""
    res = []
    for m in (JAX, PORT):
        inputs, outputs = build(m)
        f = m["pkg"].function(inputs, outputs, mode=m["mode"], **kwargs)
        res.append([_host(o) for o in f(*args)])
    return res


#: basic indices: (x, i) -> x[...] with i an int32 scalar input
BASIC = {
    "slice": lambda x, i: x[1:4], "step": lambda x, i: x[::2], "negative": lambda x, i: x[-3:],
    "reversed": lambda x, i: x[1:4, ::-1], "int": lambda x, i: x[2], "int_slice": lambda x, i: x[-1, 1:3],
    "newaxis": lambda x, i: x[None, 1:3], "ellipsis": lambda x, i: x[..., 0],
    "mixed_none": lambda x, i: x[:, None, 2], "past_the_end": lambda x, i: x[3:50, -50:2],
    "symbolic_int": lambda x, i: x[i], "symbolic_int_inner": lambda x, i: x[1, i],
    "symbolic_int_slice": lambda x, i: x[i, :, 1:3], "symbolic_negative": lambda x, i: x[:, -i],
}


@pytest.mark.parametrize("which", sorted(BASIC))
def test_basic_indexing_and_its_gradient_match_jax(which):
    def build(m):
        at = m["at"]
        x, i = at.tensor3("x"), at.iscalar("i")
        y = BASIC[which](x, i)
        return [x, i], [y, m["pkg"].grad(at.sum(at.sqr(y)), x)]

    (jy, jg), (py, pg) = _both(build, [X, np.int32(2)], on_unused_input="ignore")
    ref = BASIC[which](X, 2)
    assert py.shape == jy.shape == ref.shape and py.dtype == jy.dtype
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_array_equal(py, ref)
    np.testing.assert_allclose(pg, jg, **TOL)


INC = {
    "set_slice": lambda st, x, y, i: st.set_subtensor(x[1:3], y),
    "inc_slice_int": lambda st, x, y, i: st.inc_subtensor(x[1:3, 2], y[:, 0]),
    "inc_symbolic_int": lambda st, x, y, i: st.inc_subtensor(x[i], y[0]),
    "set_symbolic_int": lambda st, x, y, i: st.set_subtensor(x[i, 1:3], y[0, :2]),
}


@pytest.mark.parametrize("which", sorted(INC))
def test_inc_and_set_subtensor_and_their_gradients_match_jax(which):
    yv = np.random.default_rng(1).normal(size=(2, 6, 7)).astype("float32")

    def build(m):
        at = m["at"]
        x, y, i = at.tensor3("x"), at.tensor3("y"), at.iscalar("i")
        z = INC[which](m["st"], x, y, i)
        cost = at.sum(at.sqr(z) * np.float32(0.5))
        return [x, y, i], [z] + m["pkg"].grad(cost, [x, y])

    jax_out, port_out = _both(build, [X, yv, np.int32(3)], on_unused_input="ignore")
    for p, j in zip(port_out, jax_out):
        np.testing.assert_allclose(p, j, **TOL)


@pytest.mark.parametrize("ilist", [[0, 2, 2, 4], [-1, 0, -5], [3]])
@pytest.mark.parametrize("setting", [False, True], ids=["inc", "set"])
def test_advanced_subtensor1_and_inc_match_jax(ilist, setting):
    """x[ilist] along axis 0 (AdvancedSubtensor1), duplicates and negative
    indices included, its gradient (AdvancedIncSubtensor1: duplicates
    accumulate), and inc/set_subtensor of it."""
    iv = np.asarray(ilist, dtype="int64")
    yv = np.random.default_rng(2).normal(size=(len(ilist), 6, 7)).astype("float32")

    def build(m):
        at, st = m["at"], m["st"]
        x, y, il = at.tensor3("x"), at.tensor3("y"), at.lvector("il")
        g = x[il]
        assert type(g.owner.op).__name__ == "AdvancedSubtensor1"
        z = st.set_subtensor(g, y) if setting else st.inc_subtensor(g, y)
        return [x, y, il], [g, z, m["pkg"].grad(at.sum(at.sqr(g)), x)] + m["pkg"].grad(at.sum(at.sqr(z)), [x, y])

    jax_out, port_out = _both(build, [X, yv, iv])
    np.testing.assert_array_equal(port_out[0], X[iv])
    for p, j in zip(port_out, jax_out):
        np.testing.assert_allclose(p, j, **TOL)


def _window_graph(m, B):
    at = m["at"]
    data, i = at.matrix("data"), at.iscalar("i")
    window = data[i * B:(i + 1) * B]
    return [data, i], [window, m["pkg"].grad(at.sum(at.sqr(window)), data)]


@pytest.mark.parametrize("index", [0, 3, 9, 10, 15, -1, -4, -40])
def test_minibatch_window_becomes_dynamic_slice_and_clamps_as_jax(index):
    """data[i*B:(i+1)*B] with a symbolic i: both packages rewrite it into a
    DynamicSlice (and its gradient into a DynamicIncSubtensor); an index
    past the end or before the start is clamped, as lax.dynamic_slice
    clamps it."""
    B = 4
    data = np.random.default_rng(3).normal(size=(10 * B, 3)).astype("float32")
    for m in (JAX, PORT):
        inputs, outputs = _window_graph(m, B)
        f = m["pkg"].function(inputs, outputs, mode=m["mode"])
        names = [type(n.op).__name__ for n in f.maker.fgraph.toposort()]
        assert "DynamicSlice" in names and "DynamicIncSubtensor" in names and "Subtensor" not in names
    (jw, jg), (pw, pg) = _both(lambda m: _window_graph(m, B), [data, np.int32(index)])
    start = index * B + len(data) if index * B < 0 else index * B
    start = min(max(start, 0), len(data) - B)
    np.testing.assert_array_equal(pw, data[start:start + B])
    np.testing.assert_array_equal(pw, jw)
    np.testing.assert_allclose(pg, jg, **TOL)


@pytest.mark.parametrize("lengths,starts", [((2,), (3,)), ((None, 3), (5,)), ((2, 4), (-1, 2)),
                                            ((5, 6, 7), (0, 0, 0)), ((2,), (99,))])
@pytest.mark.parametrize("setting", [False, True], ids=["inc", "set"])
def test_dynamic_slice_and_inc_ops_match_jax(lengths, starts, setting):
    """The ops built directly: DynamicSlice and DynamicIncSubtensor with
    whole axes, several windows and clamped starts, and their gradients."""
    window = [n if n is not None else X.shape[d] for d, n in enumerate(lengths)] + list(X.shape[len(lengths):])
    yv = np.random.default_rng(4).normal(size=window).astype("float32")

    def build(m):
        at, st = m["at"], m["st"]
        x, y = at.tensor3("x"), at.tensor3("y")
        ss = [at.lscalar(f"s{k}") for k in range(len(starts))]
        w = st.DynamicSlice(lengths)(x, *ss)
        z = st.DynamicIncSubtensor(lengths, set_instead_of_inc=setting)(x, y, *ss)
        grads = m["pkg"].grad(at.sum(at.sqr(w)) + at.sum(at.sqr(z)), [x, y])
        return [x, y] + ss, [w, z] + grads

    args = [X, yv] + [np.int64(s) for s in starts]
    jax_out, port_out = _both(build, args)
    idx = pst.DynamicSlice(lengths).clamped_index(X.shape, starts)
    np.testing.assert_array_equal(port_out[0], X[idx])
    for p, j in zip(port_out, jax_out):
        np.testing.assert_allclose(p, j, **TOL)


def test_window_longer_than_its_axis_raises():
    x = pat.matrix("x")
    f = aesara_tpu_torch.function([x], pst.DynamicSlice((4,))(x, np.int64(0)))
    with pytest.raises(ValueError, match="does not fit"):
        f(np.zeros((3, 2), "float32"))


def test_subtensor_with_symbolic_bounds_raises_when_compiled():
    """x[i:j] has a length computed at run time from data: the port reads
    the bounds on the host and runs the function eagerly, naming the
    blocker, where the JAX package sends the node to its Python fallback;
    both give NumPy's slice."""
    x, i, j = pat.vector("x"), pat.iscalar("i"), pat.iscalar("j")
    f = aesara_tpu_torch.function([x, i, j], x[i:j])
    assert "slice bound computed from data" in f.fn.program.blocker_reason
    jx, ji, jj = jat.vector("x"), jat.iscalar("i"), jat.iscalar("j")
    with pytest.warns(UserWarning, match="py path"):
        g = aesara_tpu.function([jx, ji, jj], jx[ji:jj])
    data = np.arange(5, dtype="float32")
    for a, b in ((1, 3), (-4, 5), (3, 1)):
        np.testing.assert_array_equal(_host(f(data, a, b)), g(data, a, b))
        np.testing.assert_array_equal(_host(f(data, a, b)), data[a:b])


def test_full_slice_is_removed():
    """x[:] is x (local_useless_slice), and no Subtensor is left."""
    x = pat.matrix("x")
    y = pst.Subtensor((slice(None), slice(None)))(x)
    f = aesara_tpu_torch.function([x], y * 2.0)
    assert "Subtensor" not in [type(n.op).__name__ for n in f.maker.fgraph.toposort()]
    np.testing.assert_array_equal(f(X[0]).numpy(), X[0] * 2)
    assert x[:] is x


def test_arrays_mixed_with_slices_are_not_ported():
    """An integer array beside a slice is an ``AdvancedSubtensor`` with the
    JAX package's result; more indices than dims raise."""
    def build(m):
        x = m["at"].matrix("x")
        return [x], [x[np.array([0, 1]), 1:2], x[1:3, np.array([2, 0, 2])]]

    jax_out, port_out = _both(build, [X[0]])
    for p, j in zip(port_out, jax_out):
        np.testing.assert_array_equal(p, j)
    np.testing.assert_array_equal(port_out[0], X[0][np.array([0, 1]), 1:2])
    x = pat.matrix("x")
    with pytest.raises(IndexError):
        x[0, 0, 0]
