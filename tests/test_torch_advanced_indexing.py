"""The port's fancy indexing against the JAX package's, on the CPU:
``AdvancedSubtensor``/``AdvancedIncSubtensor`` with slices, integers and
integer or boolean arrays mixed, ``take`` and ``roll`` along every axis,
slices with bounds computed from data, and the lowerings' capture flags.

Data-moving results (gathers, sets, sets and incs without duplicates) are
compared bitwise; sums (incs with duplicates, gradients) within rtol/atol
1e-6 in float32.  Where the JAX package lowers a graph only through its
Python path (a boolean mask computed from data, a slice bound computed from
data), the port is held to that path (``mode="PY"``) and to NumPy.
Out-of-range indices follow the JAX package's XLA lowering: a gather by
``AdvancedSubtensor1`` fills (NaN, the least integer), ``AdvancedSubtensor``
clamps, and an inc or set drops the update.
"""

import itertools
import warnings

import numpy as np
import pytest

import aesara_tpu
import aesara_tpu.tensor as jat

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.tensor import subtensor as pst
from aesara_tpu_torch.tensor.type_other import make_slice


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, mode="FAST_RUN")
JAX_PY = dict(pkg=aesara_tpu, at=jat, mode="PY")
PORT = dict(pkg=aesara_tpu_torch, at=pat, mode="TORCH")
SUMS = dict(rtol=1e-6, atol=1e-6)
RNG = np.random.default_rng(0)


def _host(v):
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


def _run(m, build, args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ins, outs = build(m["at"], m)
        f = m["pkg"].function(ins, outs, mode=m["mode"], on_unused_input="ignore")
        res = f(*args)
    return [_host(o) for o in (res if isinstance(res, (list, tuple)) else [res])], f


def _hold(build, args, ref=JAX, exact=True):
    """The port's outputs against ``ref``'s (bitwise or within SUMS); the
    port's function is returned."""
    want, _ = _run(ref, build, args)
    got, f = _run(PORT, build, args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **SUMS)
    return got, f


def _placements(ndim):
    """Every placement of 1-3 arrays among slices and integers over
    ``ndim`` dims: strings over "a" (an index array), "s" (a slice) and "i"
    (an integer)."""
    for combo in itertools.product("asi", repeat=ndim):
        if 1 <= combo.count("a") <= 3:
            yield "".join(combo)


PLACEMENTS = [p for n in (2, 3, 4) for p in _placements(n)]
SHAPES = {2: (5, 6), 3: (4, 5, 6), 4: (4, 3, 5, 6)}


def _index(at, spec, arrays):
    it = iter(arrays)
    return tuple(next(it) if c == "a" else slice(1, 4) if c == "s" else 2 for c in spec)


@pytest.mark.parametrize("spec", PLACEMENTS)
def test_every_placement_of_arrays_among_slices_and_integers(spec):
    """x[idx] and inc_subtensor(x[idx], 1) for the placement ``spec``, the
    arrays non-adjacent or adjacent, with duplicates: NumPy's placement of
    the broadcast dims, bitwise for the gather, within SUMS for the inc."""
    shape = SHAPES[len(spec)]
    x = RNG.normal(size=shape).astype("float32")
    n_arr = spec.count("a")
    arrays = [np.array([2, 0, 2]) % shape[d] for d, c in enumerate(spec) if c == "a"]

    def build(at, m):
        xv = at.tensor("x", dtype="float32", shape=(None,) * len(spec))
        iv = [at.lvector(f"i{k}") for k in range(n_arr)]
        idx = _index(at, spec, iv)
        return [xv] + iv, [xv[idx], at.inc_subtensor(xv[idx], 1.5)]

    got, _ = _hold(lambda at, m: build(at, m), [x] + arrays, exact=False)
    np.testing.assert_array_equal(got[0], x[_index(None, spec, arrays)])
    ref = x.copy()
    np.add.at(ref, _index(None, spec, arrays), np.float32(1.5))
    np.testing.assert_allclose(got[1], ref, **SUMS)


X = RNG.normal(size=(6, 7)).astype("float32")
T = RNG.normal(size=(3, 5, 6)).astype("float32")
COLS = np.array([1, 6, 0, 6, 3])
ROWS = np.array([5, 0, 2])


#: (name, build(at, x, t, cols, rows) -> output) of (n1)'s cases at small shapes
N1 = {
    "x[:, cols]": lambda at, x, t, c, r: x[:, c],
    "x[rows, 2:6]": lambda at, x, t, c, r: x[r, 2:6],
    "t[i0, :, i1] non-adjacent": lambda at, x, t, c, r: t[r % 3, :, (r + 1) % 6],
    "t[:, i0, i1] adjacent": lambda at, x, t, c, r: t[:, r % 5, r],
    "x[rows, 3]": lambda at, x, t, c, r: x[r, 3],
    "take axis 1": lambda at, x, t, c, r: at.take(x, c, axis=1),
    "roll axis 1": lambda at, x, t, c, r: at.roll(x, 7, axis=1),
    "set x[:, cols] (rows unique)": lambda at, x, t, c, r: at.set_subtensor(x[r, :], 0.0),
}


@pytest.mark.parametrize("name", sorted(N1))
def test_n1_cases_move_data_bitwise(name):
    def build(at, m):
        x, t = at.matrix("x"), at.tensor3("t")
        c, r = at.lvector("c"), at.lvector("r")
        return [x, t, c, r], [N1[name](at, x, t, c, r)]

    _hold(build, [X, T, COLS, ROWS])


def test_inc_with_duplicated_columns_and_its_gradients():
    """inc_subtensor(x[:, cols], y) with duplicated columns, and the
    gradients of a sum of squares with respect to x and y."""
    def build(at, m):
        x, y, c = at.matrix("x"), at.matrix("y"), at.lvector("c")
        out = at.inc_subtensor(x[:, c], y)
        cost = at.sum(out ** 2)
        return [x, y, c], [out] + m["pkg"].grad(cost, [x, y])

    _hold(build, [X, RNG.normal(size=(6, 5)).astype("float32"), COLS], exact=False)


def test_set_with_unique_indices_moves_data_bitwise():
    def build(at, m):
        x, y = at.matrix("x"), at.matrix("y")
        return [x, y], [at.set_subtensor(x[np.array([4, 1]), 1:5], y)]

    _hold(build, [X, RNG.normal(size=(2, 4)).astype("float32")])


def test_mask_read_from_data_is_eager_with_its_blocker():
    """x[x > 0.5]: its length is the data's; the JAX package runs it only
    on its Python path."""
    def build(at, m):
        x = at.matrix("x")
        return [x], [x[x > 0.5]]

    got, f = _hold(build, [X], ref=JAX_PY)
    np.testing.assert_array_equal(got[0], X[X > 0.5])
    assert "boolean mask computed from data" in f.fn.program.blocker_reason


def test_mask_set_with_a_broadcast_value_captures():
    """set_subtensor(x[x < 0], 0) has x's shape: a torch.where, no host read
    (the JAX package's XLA lowering refuses it; its Python path runs it)."""
    def build(at, m):
        x = at.matrix("x")
        rows = x[:, 0] < 0
        return [x], [at.set_subtensor(x[x < 0], 0.0), at.inc_subtensor(x[rows], at.arange(7).astype("float32"))]

    got, f = _hold(build, [X], ref=JAX_PY)
    np.testing.assert_array_equal(got[0], np.where(X < 0, 0, X))
    assert f.fn.program.blocker is None


def test_constant_mask_captures_and_matches():
    mask = RNG.normal(size=(6, 7)) > 0

    def build(at, m):
        x = at.matrix("x")
        return [x], [x[mask], at.set_subtensor(x[mask], x[mask] * 2.0)]

    got, f = _hold(build, [X])
    np.testing.assert_array_equal(got[0], X[mask])
    assert f.fn.program.blocker is None


def test_slice_bound_from_data_is_eager_with_its_blocker():
    """x[:n] with n = (y > 0).sum(): the JAX package sends it to its Python
    path (a warning); the port reads n on the host."""
    y = RNG.normal(size=9).astype("float32")

    def build(at, m):
        x, yv = at.matrix("x"), at.vector("y")
        n = (yv > 0).sum()
        return [x, yv], [x[:n], at.set_subtensor(x[1:n], 0.0)]

    got, f = _hold(build, [X, y])
    np.testing.assert_array_equal(got[0], X[: int((y > 0).sum())])
    assert "slice bound computed from data" in f.fn.program.blocker_reason


INNER_BLOCKERS = {
    "mask": (lambda r: r[r > 0].sum(), "boolean mask computed from data"),
    "bound": (lambda r: r[: (r > 0).sum()].sum(), "slice bound computed from data"),
}


@pytest.mark.parametrize("holder", ["scan", "op_from_graph"])
@pytest.mark.parametrize("body", sorted(INNER_BLOCKERS))
def test_a_data_blocker_in_an_inner_graph_blocks_the_outer_step(body, holder):
    """A mask or a slice bound from data in a Scan's body or an
    OpFromGraph's subgraph is read each time the inner graph runs: the
    outer function names that node as its blocker, so on the card it runs
    eagerly instead of capturing the host read.  The values are the JAX
    package's Python path's (its XLA lowering refuses the mask)."""
    read, why = INNER_BLOCKERS[body]

    def build(at, m):
        x = at.matrix("x")
        if holder == "scan":
            out, _ = m["pkg"].scan(read, sequences=[x])
        else:
            r = at.vector("r")
            out = m["pkg"].OpFromGraph([r], [read(r)])(x[1])
        return [x], [out]

    _, f = _hold(build, [X], ref=JAX_PY, exact=False)
    reason = f.fn.program.blocker_reason
    assert "in its inner graph" in reason and why in reason, reason


MASKS = {
    "rank1 leading": ((5, 4, 3), lambda x, m: x[m], lambda s: s[:1]),
    "rank1 after slice": ((5, 4, 3), lambda x, m: x[1:4, m], lambda s: s[1:2]),
    "rank2 leading": ((5, 4, 3), lambda x, m: x[m], lambda s: s[:2]),
    "rank2 trailing": ((5, 4, 3), lambda x, m: x[:, m], lambda s: s[1:]),
    "rank2 with ellipsis": ((5, 4, 3), lambda x, m: x[..., m], lambda s: s[1:]),
    "rank3": ((5, 4, 3), lambda x, m: x[m], lambda s: s),
    "rank1 with ellipsis and slice": ((5, 4, 3), lambda x, m: x[m, ..., 1:], lambda s: s[:1]),
    "rank2 then index": ((5, 4, 3), lambda x, m: x[m, 2], lambda s: s[:2]),
}


@pytest.mark.parametrize("name", sorted(MASKS))
def test_masks_of_rank_1_to_3_among_slices_and_ellipsis(name):
    shape, index, mshape = MASKS[name]
    x = RNG.normal(size=shape).astype("float32")
    mask = RNG.normal(size=mshape(shape)) > 0

    def build(at, m):
        xv = at.tensor3("x")
        mv = at.tensor("m", dtype="bool", shape=(None,) * mask.ndim)
        return [xv, mv], [index(xv, mv), at.inc_subtensor(index(xv, mv), 1.0)]

    got, _ = _hold(build, [x, mask], ref=JAX_PY)
    np.testing.assert_array_equal(got[0], index(x, mask))


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_take_and_roll_along_every_axis(axis):
    t = RNG.normal(size=(4, 5, 6)).astype("float32")
    idx = np.array([[3, 0], [1, 3]])

    def build(at, m):
        tv, iv = at.tensor3("t"), at.lmatrix("i")
        s = at.lscalar("s")
        return [tv, iv, s], [at.take(tv, iv, axis=axis), at.roll(tv, s, axis=axis),
                             m["pkg"].grad(at.sum(at.take(tv, iv, axis=axis) ** 2), tv)]

    got, _ = _hold(build, [t, idx, np.int64(-2)], exact=False)
    np.testing.assert_array_equal(got[0], np.take(t, idx, axis=axis))
    np.testing.assert_array_equal(got[1], np.roll(t, -2, axis=axis))


@pytest.mark.parametrize("setting", ["set", "inc"])
def test_duplicates_and_gradients_of_advanced_inc(setting):
    """AdvancedIncSubtensor over t[i0, :, i1] with duplicated index pairs:
    an inc sums them (within SUMS), a set keeps the JAX package's value
    where the duplicates agree; and both gradients."""
    i0, i1 = np.array([0, 2, 0, 1]), np.array([5, 1, 5, 0])
    y = RNG.normal(size=(4, 5)).astype("float32")
    if setting == "set":
        y[2] = y[0]   # a set with duplicates is ordered only where they agree

    def build(at, m):
        tv, yv = at.tensor3("t"), at.matrix("y")
        a, b = at.lvector("a"), at.lvector("b")
        fn = at.set_subtensor if setting == "set" else at.inc_subtensor
        out = fn(tv[a, :, b], yv)
        return [tv, yv, a, b], [out] + m["pkg"].grad(at.sum(out * out), [tv, yv])

    _hold(build, [T, y, i0, i1], exact=False)


def test_out_of_range_indices_follow_the_jax_packages_lowering():
    """Out-of-range indices, as the JAX package's XLA lowering reads them:
    AdvancedSubtensor1 fills (NaN; the least int64), AdvancedSubtensor
    clamps after wrapping once, an inc or set drops the update.  The JAX
    package's Python path raises IndexError instead."""
    idx = np.array([0, 5, -1, -7])
    xi = np.arange(12).reshape(4, 3)

    def build(at, m):
        x, i, xint = at.matrix("x"), at.lvector("i"), at.lmatrix("xi")
        return [x, i, xint], [x[i], x[i, 1], x[:, i], at.inc_subtensor(x[i], 1.0),
                              at.inc_subtensor(x[:, i], 1.0), at.set_subtensor(x[i], 5.0), xint[i],
                              at.inc_subtensor(x[i, 1:], 2.0)]

    got, _ = _hold(build, [X[:4, :3], idx, xi])
    assert np.isnan(got[0][1]).all() and np.isnan(got[0][3]).all()
    assert (got[6][1] == np.iinfo(np.int64).min).all()
    with pytest.raises(IndexError):
        _run(JAX_PY, build, [X[:4, :3], idx, xi])


def test_a_symbolic_slice_indexes_as_its_parts():
    """make_slice(i, j) unwraps into the slice it makes; a SliceConstant
    into its Python slice."""
    from aesara_tpu_torch.tensor.type_other import as_symbolic_slice

    x, i = pat.vector("x"), pat.lscalar("i")
    f = aesara_tpu_torch.function([x, i], [x[make_slice(i, 5)], x[make_slice(2)],
                                           x[as_symbolic_slice(slice(1, None, 2))]])
    data = np.arange(8, dtype="float32")
    out = [_host(o) for o in f(data, 1)]
    np.testing.assert_array_equal(out[0], data[1:5])
    np.testing.assert_array_equal(out[1], data[2:])
    np.testing.assert_array_equal(out[2], data[1::2])


def test_static_layout_of_the_fancy_ops():
    """The output rank follows NumPy; a constant mask's length is static."""
    t = pat.tensor3("t")
    i = pat.lvector("i")
    assert t[i, :, i].type.ndim == 2 and t[:, i, i].type.ndim == 2
    mask = np.array([True, False, True])
    assert t[mask].type.shape[0] == 2
    assert pst._fancy_output_ndim(t, (pst.ARRAY, slice(None), pst.ARRAY), [i, i]) == 2
    with pytest.raises(TypeError, match="integer"):
        t[pat.vector("f")]
    with pytest.raises(TypeError, match="integer or boolean"):
        t[:, pat.vector("f")]
