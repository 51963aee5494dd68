"""Control flow of the port against the JAX package's JAX linker, on the
CPU: ``IfElse`` (forward, gradient, ``cond_remove_identical`` and
``CondMerge``), ``CheckAndRaise``/``Assert`` on a constant, a shape and a
device condition, ``local_useless_split``'s inserted ``Assert``,
``local_remove_useless_assert`` and ``local_remove_all_assert``, and
``Print`` (its line and its capture blocker).  Then the linker's cuDNN
refusals, whose flag logic needs no card.  Values are float64 from
seeded numpy; the two packages agree within 1e-12.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.graph.fg import FunctionGraph as JFunctionGraph
from aesara_tpu.ifelse import CondMerge as JCondMerge, ifelse as jifelse
from aesara_tpu.printing import Print as JPrint
from aesara_tpu.raise_op import Assert as JAssert, CheckAndRaise as JCheckAndRaise

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.graph.fg import FunctionGraph as PFunctionGraph
from aesara_tpu_torch.ifelse import CondMerge as PCondMerge, IfElse, ifelse as pifelse
from aesara_tpu_torch.link.torch import linker as plinker
from aesara_tpu_torch.link.torch.linker import TorchLinker
from aesara_tpu_torch.printing import Print as PPrint
from aesara_tpu_torch.raise_op import Assert as PAssert, CheckAndRaise as PCheckAndRaise
from aesara_tpu_torch.tensor.nnet import conv2d


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, ifelse=jifelse, Assert=JAssert, CheckAndRaise=JCheckAndRaise, Print=JPrint,
           FunctionGraph=JFunctionGraph, CondMerge=JCondMerge, mode="FAST_RUN")
PORT = dict(pkg=aesara_tpu_torch, at=pat, ifelse=pifelse, Assert=PAssert, CheckAndRaise=PCheckAndRaise,
            Print=PPrint, FunctionGraph=PFunctionGraph, CondMerge=PCondMerge, mode="TORCH")
TOL = dict(atol=1e-12, rtol=1e-12)


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _ops(fn) -> Counter:
    return Counter(type(n.op).__name__ for n in fn.maker.fgraph.toposort())


def _both(build, *args):
    """``build(m)`` -> function in each package, called on ``args``: its
    outputs, a list in each package."""
    outs = []
    for m in (JAX, PORT):
        res = build(m)(*args)
        outs.append([_host(v) for v in (res if isinstance(res, (list, tuple)) else [res])])
    return outs


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    return rng.normal(size=(3, 4)), rng.normal(size=(3, 4))


# -- IfElse ---------------------------------------------------------------------------


@pytest.mark.parametrize("taken", [1.0, 0.0, np.nan])
def test_ifelse_on_a_device_condition_selects_like_lax_cond(data, taken):
    """A condition that is an input (on the device): both branches are
    computed, the taken one returned, two outputs at once; NaN is true."""
    x, y = data

    def build(m):
        at = m["at"]
        c, a, b = at.dscalar("c"), at.dmatrix("a"), at.dmatrix("b")
        outs = m["ifelse"](c, [a * 2.0, at.exp(b)], [a - b, b])
        return m["pkg"].function([c, a, b], outs, mode=m["mode"])

    want, got = _both(build, np.float64(taken), x, y)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(got[0], x * 2.0 if taken != 0 else x - y, **TOL)


@pytest.mark.parametrize("which", ["constant", "shape"])
def test_ifelse_on_a_host_condition_picks_its_branch(data, which):
    """A constant condition picks its branch when the function is compiled,
    one computed from shapes at the call: no select on the device."""
    x, _ = data

    def build(m):
        at = m["at"]
        a = at.dmatrix("a")
        cond = at.constant(np.int8(0)) if which == "constant" else at.eq(a.shape[0], 3)
        return m["pkg"].function([a], m["ifelse"](cond, a + 1.0, a * 3.0), mode=m["mode"])

    want, got = _both(build, x)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[0], x * 3.0 if which == "constant" else x + 1.0, **TOL)


@pytest.mark.parametrize("taken", [1.0, 0.0])
def test_ifelse_gradient_goes_to_the_taken_branch(data, taken):
    x, y = data

    def build(m):
        at, pkg = m["at"], m["pkg"]
        c, a, b = at.dscalar("c"), at.dmatrix("a"), at.dmatrix("b")
        cost = at.sum(m["ifelse"](c, at.sqr(a) * b, at.tanh(b)))
        return pkg.function([c, a, b], pkg.grad(cost, [a, b]), mode=m["mode"])

    want, got = _both(build, np.float64(taken), x, y)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(got[0], 2 * x * y if taken else 0 * x, **TOL)


def test_cond_remove_identical_drops_an_ifelse_of_one_value(data):
    x, _ = data

    def build(m):
        at = m["at"]
        c, a = at.dscalar("c"), at.dmatrix("a")
        return m["pkg"].function([c, a], m["ifelse"](c, a * 2.0, a * 2.0), mode=m["mode"])

    fns = [build(m) for m in (JAX, PORT)]
    assert [_ops(f)["IfElse"] for f in fns] == [0, 0]
    np.testing.assert_allclose(_host(fns[1](np.float64(0.0), x)), x * 2.0, **TOL)


def test_cond_merge_makes_one_ifelse_of_two_on_one_condition():
    """Two IfElse nodes on the same condition, independent of each other,
    become one of 3 outputs; one that reads the other's output does not
    merge."""
    counts = []
    for m in (JAX, PORT):
        at = m["at"]
        c, a, b = at.dscalar("c"), at.dvector("a"), at.dvector("b")
        first = m["ifelse"](c, [a, b], [b, a])
        second = m["ifelse"](c, a * 2.0, b * 2.0)
        chained = m["ifelse"](c, first[0] + 1.0, b)
        fgraph = m["FunctionGraph"]([c, a, b], first + [second, chained])
        m["CondMerge"]().rewrite(fgraph)
        ifs = sorted(n.op.n_outs for n in fgraph.toposort() if type(n.op).__name__ == "IfElse")
        counts.append(ifs)
    assert counts[0] == counts[1] == [1, 3]


def test_ifelse_refuses_branches_of_different_shapes():
    """lax.cond refuses them; the port when compiling where both static
    shapes are known, else at the call."""
    c, a, b = pat.dscalar("c"), pat.dvector("a"), pat.dvector("b")
    with pytest.raises(ValueError, match="shapes differ"):
        aesara_tpu_torch.function([c], pifelse(c, pat.zeros((3,)), pat.zeros((4,))))
    f = aesara_tpu_torch.function([c, a, b], pifelse(c, a, b))
    np.testing.assert_allclose(_host(f(np.float64(1.0), np.ones(2), np.zeros(2))), np.ones(2))
    with pytest.raises(ValueError, match="shapes differ"):
        f(np.float64(1.0), np.ones(2), np.zeros(3))
    jc, ja, jb = jat.dscalar("c"), jat.dvector("a"), jat.dvector("b")
    jf = aesara_tpu.function([jc, ja, jb], jifelse(jc, ja, jb))
    with pytest.raises(Exception):
        jf(np.float64(1.0), np.ones(2), np.zeros(3))


# -- CheckAndRaise / Assert -----------------------------------------------------------


@pytest.mark.parametrize("holds", [True, False])
def test_assert_on_a_constant_condition(data, holds):
    """A true constant condition goes (local_remove_useless_assert); a false
    one stays and raises at every call, with its message."""
    x, _ = data
    fns = []
    for m in (JAX, PORT):
        at = m["at"]
        a = at.dmatrix("a")
        out = m["Assert"]("constant check")(a * 2.0, at.constant(np.asarray(holds)))
        fns.append(m["pkg"].function([a], out, mode=m["mode"]))
    if holds:
        assert [_ops(f)["Assert"] for f in fns] == [0, 0]
        np.testing.assert_allclose(_host(fns[1](x)), x * 2.0, **TOL)
        return
    for f in fns:
        for _ in range(2):
            with pytest.raises(AssertionError, match="constant check"):
                f(x)


def test_check_and_raise_on_a_shape_condition_raises_its_exception(data):
    """A condition computed from shapes is a host value: checked at every
    call, raising the op's exception type."""
    x, _ = data
    for m in (JAX, PORT):
        at = m["at"]
        a = at.dmatrix("a")
        out = m["CheckAndRaise"](ValueError, "three rows")(a + 1.0, at.eq(a.shape[0], 3))
        f = m["pkg"].function([a], out, mode=m["mode"])
        np.testing.assert_allclose(_host(f(x)), x + 1.0, **TOL)
        with pytest.raises(ValueError, match="three rows"):
            f(np.ones((4, 4)))
        np.testing.assert_allclose(_host(f(x)), x + 1.0, **TOL)


def test_assert_on_a_device_condition_passes_the_value_unread(data):
    """A condition computed from data lives on the device: the value passes
    through, as under XLA, even where the condition is false."""
    x, _ = data
    outs = []
    for m in (JAX, PORT):
        at = m["at"]
        a = at.dmatrix("a")
        out = m["Assert"]("positive sum")(a * 3.0, at.gt(at.sum(a), 1e9))
        outs.append(_host(m["pkg"].function([a], out, mode=m["mode"])(x)))
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    np.testing.assert_allclose(outs[1], x * 3.0, **TOL)


def test_assert_grad_passes_to_the_value_only(data):
    x, _ = data
    grads = []
    for m in (JAX, PORT):
        at, pkg = m["at"], m["pkg"]
        a = at.dmatrix("a")
        cost = at.sum(at.sqr(m["Assert"]("rows")(a, at.eq(a.shape[0], 3))))
        grads.append(_host(pkg.function([a], pkg.grad(cost, a), mode=m["mode"])(x)))
    np.testing.assert_allclose(grads[1], grads[0], **TOL)
    np.testing.assert_allclose(grads[1], 2 * x, **TOL)


def test_local_useless_split_inserts_an_assert_of_the_size():
    """A split into one piece becomes its input behind Assert("Split{1}:
    ..."), which checks the axis length where the split size is a constant
    and the length is not known until the call; the piece keeps its static
    length behind a SpecifyShape in both packages."""
    counts = []
    for m in (JAX, PORT):
        at = m["at"]
        v = at.dvector("v")
        (piece,) = at.split(v, np.asarray([4]), 1)
        f = m["pkg"].function([v], piece * 2.0, mode=m["mode"])
        ops = _ops(f)
        counts.append(ops)
        assert ops["Split"] == 0 and ops["Assert"] == 1, ops
        np.testing.assert_allclose(_host(f(np.arange(4.0))), np.arange(4.0) * 2.0)
        with pytest.raises(AssertionError, match="split size must equal the axis length"):
            f(np.arange(5.0))
    assert [(c["Assert"], c["SpecifyShape"]) for c in counts] == [(1, 1), (1, 1)]


def test_local_useless_split_needs_no_assert_where_static():
    for m in (JAX, PORT):
        at = m["at"]
        v = at.TensorType("float64", shape=(4,))("v")
        (piece,) = at.split(v, np.asarray([4]), 1)
        ops = _ops(m["pkg"].function([v], piece * 2.0, mode=m["mode"]))
        assert ops["Split"] == 0 and ops["Assert"] == 0, ops


def test_local_remove_useless_assert_keeps_the_other_conditions(data):
    x, _ = data
    kept = []
    for m in (JAX, PORT):
        at = m["at"]
        a = at.dmatrix("a")
        out = m["Assert"]("mixed")(a + 1.0, at.constant(np.asarray(True)), at.eq(a.shape[0], 3))
        f = m["pkg"].function([a], out, mode=m["mode"])
        (node,) = [n for n in f.maker.fgraph.toposort() if type(n.op).__name__ == "Assert"]
        kept.append(len(node.inputs))
        with pytest.raises(AssertionError, match="mixed"):
            f(np.ones((2, 4)))
    assert kept == [2, 2]


def test_local_remove_all_assert_only_under_unsafe(data):
    x, _ = data
    for m, unsafe in ((JAX, aesara_tpu.compile.mode.get_mode("FAST_RUN").including("unsafe")),
                      (PORT, aesara_tpu_torch.get_mode("TORCH").including("unsafe"))):
        at = m["at"]
        a = at.dmatrix("a")
        out = m["Assert"]("never checked")(a + 1.0, at.eq(a.shape[0], 5))
        f = m["pkg"].function([a], out, mode=unsafe)
        assert _ops(f)["Assert"] == 0
        np.testing.assert_allclose(_host(f(x)), x + 1.0, **TOL)
        assert _ops(m["pkg"].function([a], out, mode=m["mode"]))["Assert"] == 1


# -- Print ------------------------------------------------------------------------------


def test_print_prints_each_call_as_jax_debug_print(capsys):
    """The port prints the line the JAX package's jax.debug.print prints,
    once a call, and its program names the Print as what keeps it from
    being captured."""
    x = np.arange(6.0).reshape(2, 3) / 4
    lines = []
    for m in (JAX, PORT):
        at = m["at"]
        a = at.dmatrix("a")
        f = m["pkg"].function([a], m["Print"]("the value")(a * 2.0) + 1.0, mode=m["mode"])
        capsys.readouterr()
        for _ in range(2):
            np.testing.assert_allclose(_host(f(x)), x * 2.0 + 1.0)
        if m is JAX:
            import jax

            jax.effects_barrier()
        lines.append(capsys.readouterr().out.splitlines())
    assert lines[0] == lines[1]
    assert len(lines[1]) == 4 and lines[1][0].startswith("the value [[0.")
    assert f.fn.program.blocker_reason == "Print prints on the host"


def test_print_blocks_the_capture_of_a_cuda_function(monkeypatch):
    """Compiled for the card (no card is needed to compile), a function
    holding a Print says that it runs eagerly and why."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    a = pat.dmatrix("a")
    cuda = aesara_tpu_torch.Mode(TorchLinker(device=torch.device("cuda", 0)))
    f = aesara_tpu_torch.function([a], PPrint("p")(a) * 2.0, mode=cuda)
    assert "Print prints on the host" in f.fn.capture_blocker and "Print" in f.fn.capture_blocker
    g = aesara_tpu_torch.function([a], a * 2.0, mode=cuda)
    assert g.fn.capture_blocker is None


def test_ifelse_on_a_device_condition_stays_capturable(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    c, a = pat.dscalar("c"), pat.dmatrix("a")
    cuda = aesara_tpu_torch.Mode(TorchLinker(device=torch.device("cuda", 0)))
    f = aesara_tpu_torch.function([c, a], pifelse(c, a * 2.0, a), mode=cuda)
    assert f.fn.capture_blocker is None
    assert sum(isinstance(n.op, IfElse) for n in f.maker.fgraph.toposort()) == 1


# -- the linker's cuDNN refusals --------------------------------------------------------


@pytest.fixture
def cudnn_flags():
    """Restore cuDNN's settings after the test."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, cudnn.benchmark)
    yield cudnn
    cudnn.allow_tf32, cudnn.benchmark = saved


def _conv_function(dtype, mode):
    img, kern = pat.tensor4("img", dtype=dtype), pat.tensor4("kern", dtype=dtype)
    return aesara_tpu_torch.function([img, kern], conv2d(img, kern, border_mode="half"), mode=mode)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_linker_refuses_a_conv_while_cudnn_may_use_tf32(monkeypatch, cudnn_flags, dtype):
    """Compiled for the card, an fp32 or fp64 convolution raises before any
    launch while cuDNN may round to TF32 (PyTorch's default), and compiles
    once the caller has turned it off."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda = aesara_tpu_torch.Mode(TorchLinker(device=torch.device("cuda", 0)))
    cudnn_flags.benchmark = False
    cudnn_flags.allow_tf32 = True
    with pytest.raises(RuntimeError, match="TF32"):
        _conv_function(dtype, cuda)
    cudnn_flags.allow_tf32 = False
    assert _conv_function(dtype, cuda).fn.device.type == "cuda"
    # a graph without convolutions is not refused
    x = pat.matrix("x", dtype=dtype)
    cudnn_flags.allow_tf32 = True
    aesara_tpu_torch.function([x], x * 2.0, mode=cuda)


def test_linker_refuses_a_conv_while_cudnn_autotunes(monkeypatch, cudnn_flags):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda = aesara_tpu_torch.Mode(TorchLinker(device=torch.device("cuda", 0)))
    cudnn_flags.allow_tf32 = False
    cudnn_flags.benchmark = True
    with pytest.raises(RuntimeError, match="benchmark"):
        _conv_function("float32", cuda)
    # the gradients' convolutions too, and on the CPU nothing is refused
    img, kern = pat.tensor4("img"), pat.tensor4("kern")
    g = aesara_tpu_torch.grad(pat.sum(conv2d(img, kern)), kern)
    with pytest.raises(RuntimeError, match="benchmark"):
        aesara_tpu_torch.function([img, kern], g, mode=cuda)
    aesara_tpu_torch.function([img, kern], g)


@pytest.mark.skipif(not hasattr(torch.backends.cudnn, "conv"), reason="this torch has no fp32_precision settings")
@pytest.mark.parametrize("conv, parent, tf32", [("tf32", "none", True), ("ieee", "tf32", False),
                                                ("none", "tf32", True), ("none", "none", False),
                                                ("none", "ieee", False)])
def test_cudnn_tf32_flag_reads_the_convolutions_precision(monkeypatch, conv, parent, tf32):
    """Where torch has per-operator precisions, the convolutions' decides,
    or where "none" its parent's."""

    class Setting:
        def __init__(self, value):
            self.fp32_precision = value

    monkeypatch.setattr(torch.backends.cudnn, "conv", Setting(conv))
    monkeypatch.setattr(torch.backends.cudnn, "fp32_precision", parent, raising=False)
    monkeypatch.setattr(torch.backends, "fp32_precision", "none", raising=False)
    assert (plinker.cudnn_tf32_flag() is not None) == tf32
