"""Shape bucketing of the port (``aesara_tpu_torch/compile/bucketing.py``
and the hooks of ``compile/function.py``) against the JAX package's
(``aesara_tpu/compile/bucketing.py``), on the CPU.

- The ladder helpers (``parse_buckets``, ``bucket_for``, ``pad_leading``,
  ``pad_axis_zero``) give the JAX package's values.
- Under ``config.shape_buckets`` a call pads its batched inputs (the
  leading dim, by replicating the last row) or its ``In(seq_bucketed=)``
  axis (with zeros) up to the rung, so each rung is one key of the
  function (``keys_made``, the counterpart of ``xla_compile_count``), and
  the results are cut back: equal to the JAX package's bucketed function
  and to the unbucketed one.
- The safety analysis gives the JAX package's verdict on each graph, and a
  function whose graph folds pad rows into real results raises
  ``BucketingError`` (or, with ``shape_buckets_check="warn"``, runs
  unpadded with a warning; with "off", pads as told).
"""

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.compile import bucketing as jb
from aesara_tpu.compile.io import In as JIn
from aesara_tpu.scan import scan as jscan
from aesara_tpu.tensor.special import softmax as jsoftmax

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.compile import bucketing as pb
from aesara_tpu_torch.compile.io import In as PIn
from aesara_tpu_torch.config import config
from aesara_tpu_torch.scan.basic import scan as pscan
from aesara_tpu_torch.tensor.special import softmax as psoftmax


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, In=JIn, b=jb, scan=jscan, softmax=jsoftmax, config=aesara_tpu.config)
PORT = dict(pkg=aesara_tpu_torch, at=pat, In=PIn, b=pb, scan=pscan, softmax=psoftmax, config=config)


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("spec", ["off", "", "pow2", "64,8,256,8", "8,frog", "0,8"])
def test_parse_buckets_as_the_jax_package(spec):
    try:
        want = jb.parse_buckets(spec)
    except ValueError:
        with pytest.raises(ValueError):
            pb.parse_buckets(spec)
        with pytest.raises(ValueError):
            config.shape_buckets = spec
        return
    assert pb.parse_buckets(spec) == want


@pytest.mark.parametrize("n", [0, 1, 3, 8, 9, 65])
@pytest.mark.parametrize("policy", ["pow2", (8, 64)])
def test_bucket_for_as_the_jax_package(n, policy):
    assert pb.bucket_for(n, policy) == jb.bucket_for(n, policy)


def test_padding_as_the_jax_package():
    a = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(pb.pad_leading(a, 5), jb.pad_leading(a, 5))
    assert pb.pad_leading(a, 3) is a
    for axis, b in ((0, 4), (1, 7)):
        got = pb.pad_axis_zero(a, axis, b)
        np.testing.assert_array_equal(got, jb.pad_axis_zero(a, axis, b))
        assert got.shape[axis] == b


def _rowwise(m):
    """tanh(x @ w) + 1 over a float64 batch x, w shared from seed 7 (a
    graph no test of the JAX package compiles: its functions of one graph
    share their jitted program, and with it the count of its shapes)."""
    at = m["at"]
    w = m["pkg"].shared(np.random.default_rng(7).normal(size=(5, 3)), name="w")
    x = at.matrix("x", dtype="float64")
    return m["pkg"].function([x], at.tanh(at.dot(x, w)) + 1.0)


@pytest.mark.parametrize("spec, lengths, keys", [("pow2", (1, 3, 5, 6, 9), 4), ("8,32", (2, 5, 8, 9, 20, 31), 2)])
def test_batched_rows_pad_to_the_rung_and_match_the_jax_package(spec, lengths, keys):
    fj, fp = _rowwise(JAX), _rowwise(PORT)
    plain = _rowwise(PORT)
    rng = np.random.default_rng(3)
    for n in lengths:
        xv = rng.normal(size=(n, 5))
        with JAX["config"].change_flags(shape_buckets=spec), config.change_flags(shape_buckets=spec):
            want, got = np.asarray(fj(xv)), _host(fp(xv))
        assert got.shape == (n, 3)
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
        np.testing.assert_allclose(got, _host(plain(xv)), atol=1e-12, rtol=0)
    assert fp.keys_made == keys
    assert plain.keys_made == len(lengths)


def test_only_marked_inputs_pad_and_a_marked_out_one_stays():
    at = pat
    x, b = at.matrix("x", dtype="float64"), at.vector("b", dtype="float64")
    f = aesara_tpu_torch.function([PIn(x, batched=True), PIn(b)], at.tanh(x) * b.dimshuffle("x", 0))
    g = aesara_tpu_torch.function([PIn(x), PIn(b, batched=False)], at.tanh(x) * b.dimshuffle("x", 0))
    assert f._bucket_positions == [0] and g._bucket_positions == [0]
    xv, bv = np.random.default_rng(1).normal(size=(3, 4)), np.random.default_rng(2).normal(size=4)
    with config.change_flags(shape_buckets="pow2"):
        for fn in (f, g):
            np.testing.assert_allclose(_host(fn(xv, bv)), np.tanh(xv) * bv, atol=1e-12, rtol=0)
            assert [k[0][0] for k in fn.fn._keys] == [(4, 4)]


def test_gather_indices_pad_in_range_and_updates_ride_through():
    table = aesara_tpu_torch.shared(np.arange(20.0).reshape(10, 2), name="table")
    c = aesara_tpu_torch.shared(np.int64(0), name="c")
    idx = pat.lvector("idx")
    f = aesara_tpu_torch.function([idx], table[idx], updates={c: c + 1})
    iv = np.array([9, 0, 3], dtype="int64")
    with config.change_flags(shape_buckets="pow2"):
        np.testing.assert_array_equal(_host(f(iv)), np.arange(20.0).reshape(10, 2)[iv])
    assert int(c.get_value()) == 1
    assert [k[0][0] for k in f.fn._keys] == [(4,)]


def test_disagreeing_lengths_and_static_shapes_run_unpadded():
    x, y = pat.matrix("x", dtype="float64"), pat.matrix("y", dtype="float64")
    f = aesara_tpu_torch.function([x, y], pat.dot(x, y))
    s = pat.TensorType("float64", (3, 2))("s")
    g = aesara_tpu_torch.function([s], s * 2.0)
    xv, yv = np.ones((3, 5)), np.ones((5, 2))
    with config.change_flags(shape_buckets="pow2"):
        np.testing.assert_allclose(_host(f(xv, yv)), xv @ yv)
        assert _host(g(np.ones((3, 2)))).shape == (3, 2)
    assert [k[0][0] for k in f.fn._keys] == [(3, 5)]


def _verdicts(m):
    """The safety verdict (None or a reason) of each graph, built by ``m``."""
    pkg, at = m["pkg"], m["at"]
    w = pkg.shared(np.random.default_rng(7).normal(size=(4, 3)), name="w")
    table = pkg.shared(np.random.default_rng(8).normal(size=(16, 4)), name="tab")
    builds = {
        "rowwise elemwise": lambda x: at.tanh(x) * 2.0 + 1.0,
        "feature-axis sum": lambda x: at.sum(x, axis=1),
        "batch mean": lambda x: at.mean(x, axis=0),
        "sum of all": lambda x: at.sum(x),
        "rowwise dot": lambda x: at.dot(x, w),
        "gram matrix": lambda x: at.dot(x.T, x),
        "feature softmax": lambda x: m["softmax"](x, axis=-1),
        "batch softmax": lambda x: m["softmax"](x, axis=0),
        "scalar rows": lambda x: x[0] + x[-1],
        "batch slice": lambda x: at.sum(x[1:3], axis=1),
    }
    out = {}
    for name, build in builds.items():
        x = at.matrix("x", dtype="float64")
        f = pkg.function([x], build(x))
        out[name] = m["b"].batch_axis_safety(f.fgraph, f.fgraph.inputs[:1])
    idx = at.lvector("idx")
    f = pkg.function([idx], at.tanh(table[idx]))
    out["embedding gather"] = m["b"].batch_axis_safety(f.fgraph, f.fgraph.inputs[:1])
    x = at.matrix("x", dtype="float64")
    ys, _ = m["scan"](fn=lambda row: row * 2.0, sequences=[x], outputs_info=[None], n_steps=4)
    f = pkg.function([x], ys)
    out["scan consumer"] = m["b"].batch_axis_safety(f.fgraph, f.fgraph.inputs[:1])
    return out


def test_safety_verdicts_are_the_jax_packages():
    want, got = _verdicts(JAX), _verdicts(PORT)
    assert {k: v is None for k, v in got.items()} == {k: v is None for k, v in want.items()}
    assert [k for k, v in got.items() if v is None] == ["rowwise elemwise", "feature-axis sum", "rowwise dot",
                                                          "feature softmax", "scalar rows", "embedding gather"]
    assert "batch" in got["batch mean"] and "contracts" in got["gram matrix"]


def test_an_unsafe_graph_raises_warns_or_pads_as_told():
    x = pat.matrix("x", dtype="float64")
    f = aesara_tpu_torch.function([x], pat.mean(x, axis=0))
    xv = np.random.default_rng(4).normal(size=(3, 4))
    with config.change_flags(shape_buckets="pow2"):
        with pytest.raises(pb.BucketingError, match="batch"):
            f(xv)
        # a length on a rung needs no padding: exact, no error
        x4 = np.random.default_rng(5).normal(size=(4, 4))
        np.testing.assert_allclose(_host(f(x4)), x4.mean(axis=0), rtol=1e-12)
    g = aesara_tpu_torch.function([x], pat.mean(x, axis=0))
    with config.change_flags(shape_buckets="pow2", shape_buckets_check="warn"):
        with pytest.warns(UserWarning, match="unbucketed"):
            np.testing.assert_allclose(_host(g(xv)), xv.mean(axis=0), rtol=1e-12)
    h = aesara_tpu_torch.function([x], pat.sum(x, axis=0))
    with config.change_flags(shape_buckets="pow2", shape_buckets_check="off"):
        np.testing.assert_allclose(_host(h(np.ones((3, 2)))), np.full(2, 4.0))
    # an update that carries the batch would grow the stored state
    s = aesara_tpu_torch.shared(np.zeros(4), name="s")
    u = aesara_tpu_torch.function([x], [], updates=[(s, s + pat.sum(x, axis=0))])
    with config.change_flags(shape_buckets="pow2"):
        with pytest.raises(pb.BucketingError):
            u(xv)


def test_sequence_axis_pads_with_zeros_and_is_cut_back():
    x = pat.matrix("x", dtype="float64")
    tlen = pat.lscalar("tlen")
    mask = pat.cast(pat.lt(pat.arange(x.shape[1]), tlen), "float64")
    f = aesara_tpu_torch.function([PIn(x, seq_bucketed=1)], pat.tanh(x) * 2.0)
    g = aesara_tpu_torch.function([PIn(x, seq_bucketed=1), tlen], pat.sum(x * mask.dimshuffle("x", 0), axis=1))
    assert f._bucket_positions == [] and f._bucket_seq_positions == [(0, 1)]
    rng = np.random.default_rng(6)
    with config.change_flags(shape_buckets="pow2"):
        for t in (3, 5, 9):
            xv = rng.normal(size=(2, t))
            got = _host(f(xv))
            assert got.shape == (2, t)
            np.testing.assert_allclose(got, np.tanh(xv) * 2.0, rtol=1e-12)
            np.testing.assert_allclose(_host(g(xv, t)), xv.sum(axis=1), rtol=1e-12)
    assert f.keys_made == 3 and [k[0][0] for k in f.fn._keys] == [(2, 8), (2, 16)]


def test_sequence_lengths_make_a_key_a_rung_as_the_jax_package_compiles():
    def build(m):
        pkg, at = m["pkg"], m["at"]
        table = pkg.shared(np.random.default_rng(9).normal(size=(32, 4)), name="tab")
        prompt = at.lvector("prompt")
        return pkg.function([m["In"](prompt, seq_bucketed=0)], at.sum(table[prompt], axis=0) * 2.0)

    fj, fp = build(JAX), build(PORT)
    rng = np.random.default_rng(3)
    with JAX["config"].change_flags(shape_buckets="pow2"), config.change_flags(shape_buckets="pow2"):
        for t in range(1, 33):
            pv = rng.integers(1, 32, size=t).astype("int64")
            np.testing.assert_allclose(_host(fp(pv)), np.asarray(fj(pv)), atol=1e-12, rtol=0)
    # lengths 1..32: rungs 1, 2, 4, 8, 16, 32
    assert fp.keys_made == 6
    assert fj.xla_compile_count is None or fj.xla_compile_count == 6


def test_disagreeing_sequence_lengths_run_unpadded():
    a, b = pat.matrix("a", dtype="float64"), pat.matrix("b", dtype="float64")
    f = aesara_tpu_torch.function([PIn(a, seq_bucketed=1), PIn(b, seq_bucketed=1)],
                                  pat.sum(a, axis=1) + pat.sum(b, axis=1))
    av, bv = np.ones((2, 3)), np.ones((2, 5))
    with config.change_flags(shape_buckets="pow2"):
        np.testing.assert_allclose(_host(f(av, bv)), av.sum(1) + bv.sum(1))
    assert [k[0][0] for k in f.fn._keys] == [(2, 3)]
