"""The port's graph layer and linker on their own: transactional
replacement, merge, the canonicalize rules the forward relies on, and the
linker's checks of what it is given."""

import numpy as np
import pytest
import torch

import aesara_tpu_torch as ptp
import aesara_tpu_torch.tensor as pt
from aesara_tpu_torch.compile.mode import optdb, OPT_FAST_RUN
from aesara_tpu_torch.graph.fg import FunctionGraph
from aesara_tpu_torch.graph.features import ReplaceValidate
from aesara_tpu_torch.graph.rewriting.basic import (
    GraphRewriter, MergeOptimizer, SequentialGraphRewriter,
)
from aesara_tpu_torch.link.torch import linker as linker_module
from aesara_tpu_torch.tensor import math as ptm
from aesara_tpu_torch.tensor.shape import Shape_i
from aesara_tpu_torch.config import config


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


def _ops(fgraph):
    return [type(n.op).__name__ + ("(" + str(n.op.scalar_op) + ")" if hasattr(n.op, "scalar_op") else "")
            for n in fgraph.toposort()]


def test_replace_all_validate_undoes_a_failed_transaction():
    x, y = pt.vector("x"), pt.vector("y")
    a, b = ptm.add(x, y), ptm.mul(x, y)
    fg = FunctionGraph([x, y], [a, b], clone=False)
    fg.attach_feature(ReplaceValidate())
    bad = pt.matrix("z")                      # wrong type: the second replace raises
    with pytest.raises(TypeError):
        fg.replace_all_validate([(a, ptm.sub(x, y)), (b, bad)])
    assert fg.outputs == [a, b]
    assert sorted(_ops(fg)) == ["Elemwise(add)", "Elemwise(mul)"]
    assert [o.owner for o in fg.outputs] == [a.owner, b.owner]


def test_merge_joins_equal_nodes_and_constants():
    x = pt.vector("x")
    out = ptm.add(ptm.mul(x, 2.0), ptm.mul(x, 2.0))
    fg = FunctionGraph([x], [out], clone=False)
    MergeOptimizer().rewrite(fg)
    assert _ops(fg).count("Elemwise(mul)") == 1


def test_canonicalize_folds_static_shapes_and_lifts_shape_i():
    x = pt.TensorType("float32", (None, None, 8))("x")
    y = ptm.sqr(x - ptm.mean(x, axis=-1, keepdims=True))
    n = ptm.mul(y.shape[0], y.shape[2])       # Shape_i of a computed value, and a static dim
    fg = FunctionGraph([x], [n])
    optdb.query(OPT_FAST_RUN).rewrite(fg)
    shape_i, node = fg.toposort()             # mul(Shape_i{0}(x), 8): y's ops are gone
    assert isinstance(shape_i.op, Shape_i) and shape_i.inputs[0] is fg.inputs[0]
    assert node.inputs[0] is shape_i.outputs[0]
    assert int(node.inputs[1].data) == 8
    f = ptp.function([x], n)
    assert int(f(np.zeros((3, 2, 8), "float32"))) == 24


def test_add_chains_flatten_before_fusion():
    x, y, z = pt.matrix("x"), pt.matrix("y"), pt.matrix("z")
    h = x + ptm.add(y, z)                     # h + (dot + b2) in the encoder
    f = ptp.function([x, y, z], [h, ptm.sqr(h)])
    assert "Elemwise(add)" in _ops(f.maker.fgraph)
    v = np.arange(6, dtype="float32").reshape(2, 3)
    got = f(v, v, v)
    np.testing.assert_array_equal(got[0].numpy(), 3 * v)


@pytest.mark.parametrize("rule", ["constant_folding", "useless_dimshuffle", "reshape_chain"])
def test_canonicalize_rule_removes_its_nodes(rule):
    x = pt.matrix("x")
    if rule == "constant_folding":
        out, want = x * ptm.sqrt(pt.constant(np.float32(4.0))), ["Elemwise(mul)"]
    elif rule == "useless_dimshuffle":
        out, want = ptm.sqrt(x.dimshuffle(0, 1)), ["Elemwise(sqrt)"]
    else:
        out, want = x.reshape((6,)).reshape((3, 2)), ["Reshape"]
    f = ptp.function([x], out)
    assert _ops(f.maker.fgraph) == want
    v = np.arange(6, dtype="float32").reshape(2, 3)
    expected = {"constant_folding": 2 * v, "useless_dimshuffle": np.sqrt(v),
                "reshape_chain": v.reshape(3, 2)}[rule]
    np.testing.assert_allclose(f(v).numpy(), expected, rtol=1e-6)


def test_linker_checks_its_inputs():
    x = pt.TensorType("float32", (None, 3))("x")
    f = ptp.function([x], ptm.sqrt(x))
    np.testing.assert_allclose(f(np.full((2, 3), 4.0, "float32")).numpy(), 2.0)
    with pytest.raises(TypeError):
        f(np.zeros((2, 4), "float32"))        # static dim 3
    with pytest.raises(TypeError):
        f(np.zeros((2, 3), "float64"))        # no silent downcast
    with pytest.raises(TypeError):
        f(torch.zeros((2, 3), dtype=torch.float64))
    with pytest.raises(TypeError):
        f()


class _Failing(GraphRewriter):
    def apply(self, fgraph):
        raise ValueError("broken rewrite")


def test_a_failing_rewrite_fails_the_compile():
    x = pt.vector("x")
    fg = FunctionGraph([x], [ptm.sqrt(ptm.sqr(x))])
    with pytest.raises(ValueError, match="broken rewrite"):
        SequentialGraphRewriter(MergeOptimizer(), _Failing()).rewrite(fg)


def test_linker_refuses_tf32_on_cuda(monkeypatch):
    monkeypatch.setattr(linker_module, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    x = pt.matrix("x")
    with pytest.raises(RuntimeError, match="allow_tf32"):
        ptp.function([x], ptm.dot(x, x), mode=ptp.Mode(ptp.TorchLinker(device="cuda")))


def test_shared_on_another_device_is_refused(monkeypatch):
    w = ptp.shared(np.ones(3, dtype="float32"), name="w")
    x = pt.vector("x")
    f = ptp.function([x], x * w)
    monkeypatch.setattr(w, "_value", torch.ones(3, device="meta"))
    with pytest.raises(ValueError, match="lives on"):
        f(np.ones(3, "float32"))
