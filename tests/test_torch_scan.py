"""Scan in the port (``aesara_tpu_torch/scan``, ``link/torch/
scan_dispatch.py``) against the JAX package, on the CPU: the same graph
built by both packages from the same code, the same inputs made from a
numpy seed, float64 at atol 1e-10 (float32 at atol and rtol 1e-5).

The JAX side runs ``mode="JAX"``; where the JAX package runs a graph on
its Python path (a data-dependent ``n_steps``, a while-Scan with stacked
outputs) it runs ``mode="PY"``.  Forms: sit-sot, mit-sot taps, nit-sot,
non-sequences, a shared variable updated in the body, ``go_backwards``,
``truncate_gradient``, explicit, shape-derived and data-dependent
``n_steps``, ``until`` (eager on the card, its capture blocker named),
``padded_while`` and the ``map``/``reduce``/``foldl``/``foldr`` views, and
the gradient of each; ``jacobian``, ``hessian`` and
``function(steps_per_call=3)``.

``padded_while``'s gradient is a known reference fault: the JAX package
raises a TypeError building it (``tests/scan/test_padded_while.py:66``),
so the port's is held to the analytic gradient ``[2, 1, 0, 0]``.
"""

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.gradient import hessian as jhessian, jacobian as jjacobian
from aesara_tpu.scan.basic import scan as jscan, until as juntil
from aesara_tpu.scan.views import foldl as jfoldl, foldr as jfoldr, map as jmap, reduce as jreduce

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.gradient import hessian as phessian, jacobian as pjacobian
from aesara_tpu_torch.link.torch.scan_dispatch import fused_inner_graph
from aesara_tpu_torch.scan import Scan
from aesara_tpu_torch.scan.basic import scan as pscan, until as puntil
from aesara_tpu_torch.scan.views import foldl as pfoldl, foldr as pfoldr, map as pmap, reduce as preduce


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, scan=jscan, until=juntil, map=jmap, reduce=jreduce, foldl=jfoldl,
           foldr=jfoldr, jacobian=jjacobian, hessian=jhessian, mode="JAX")
PORT = dict(pkg=aesara_tpu_torch, at=pat, scan=pscan, until=puntil, map=pmap, reduce=preduce, foldl=pfoldl,
            foldr=pfoldr, jacobian=pjacobian, hessian=phessian, mode="TORCH")
TOL = {"float64": dict(atol=1e-10, rtol=0), "float32": dict(atol=1e-5, rtol=1e-5)}


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _compare(build, args, dtype="float64", jax_mode=None):
    """Compile ``build(m) -> (inputs, outputs)`` with both packages, call
    both with ``args`` and hold the port to the JAX package; the port's
    function is returned."""
    fns = []
    for m, mode in ((JAX, jax_mode or JAX["mode"]), (PORT, "TORCH")):
        ins, outs = build(m)
        fns.append(m["pkg"].function(ins, outs, mode=mode))
    want, got = fns[0](*args), fns[1](*args)
    if not isinstance(want, (list, tuple)):
        want, got = [want], [got]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        g = _host(g)
        assert g.shape == np.shape(w) and g.dtype == np.asarray(w).dtype
        np.testing.assert_allclose(g, np.asarray(w), **TOL[dtype])
    return fns[1]


RNG = np.random.default_rng(7)
XS = RNG.normal(size=(6, 3))
W = RNG.normal(size=(3, 3)) * 0.5
H0 = RNG.normal(size=3)


@pytest.mark.parametrize("go_backwards", [False, True])
def test_sit_sot_nit_sot_and_non_sequences_with_their_gradients(go_backwards):
    def build(m):
        at = m["at"]
        x, w, h0 = at.matrix("x", dtype="float64"), at.matrix("w", dtype="float64"), at.vector("h0", dtype="float64")
        (h, y), _ = m["scan"](lambda xt, hp, w: (at.tanh(at.dot(hp, w) + xt), at.sum(hp * xt)),
                              sequences=[x], outputs_info=[h0, None], non_sequences=[w],
                              go_backwards=go_backwards)
        cost = at.sum(h ** 2) + at.sum(y)
        return [x, w, h0], [h, y] + m["pkg"].grad(cost, [x, w, h0])

    f = _compare(build, [XS, W, H0])
    assert f.capture_blocker == "runs on cpu" and f.fn.program.blocker is None


def test_mit_sot_taps_and_their_gradient():
    def build(m):
        at = m["at"]
        init, x = at.matrix("init", dtype="float64"), at.matrix("x", dtype="float64")
        h, _ = m["scan"](lambda xt, h2, h1: 0.5 * h2 - 0.3 * at.tanh(h1) + xt, sequences=[x],
                         outputs_info=[{"initial": init, "taps": [-2, -1]}])
        return [init, x], [h] + m["pkg"].grad(at.sum(h * h), [init, x])

    _compare(build, [RNG.normal(size=(2, 3)), XS])


def test_sequence_taps():
    def build(m):
        at = m["at"]
        x = at.vector("x", dtype="float64")
        y, _ = m["scan"](lambda a, b, c: a * b - c, sequences=[{"input": x, "taps": [-1, 0, 2]}])
        return [x], [y, m["pkg"].grad(at.sum(y ** 2), x)]

    _compare(build, [RNG.normal(size=8)])


def test_shared_variable_updated_in_the_body():
    def build(m):
        at = m["at"]
        acc = m["pkg"].shared(np.zeros(3), name="acc")
        x = at.matrix("x", dtype="float64")
        h, upd = m["scan"](lambda xt: (at.sum(xt * acc), {acc: acc + xt}), sequences=[x])
        return [x], [h, upd[acc]]

    _compare(build, [XS])


def test_shared_updates_applied_by_function():
    outs = []
    for m in (JAX, PORT):
        at = m["at"]
        acc = m["pkg"].shared(np.ones(3), name="acc")
        x = at.matrix("x", dtype="float64")
        _, upd = m["scan"](lambda xt: (at.sum(xt * acc), {acc: acc * 0.5 + xt}), sequences=[x])
        f = m["pkg"].function([x], [], updates=upd, mode="TORCH" if m is PORT else "JAX")
        f(XS)
        f(XS)
        outs.append(np.asarray(acc.get_value()))
    np.testing.assert_allclose(outs[1], outs[0], **TOL["float64"])


def test_truncate_gradient():
    def build(m):
        at = m["at"]
        x, h0 = at.matrix("x", dtype="float64"), at.vector("h0", dtype="float64")
        h, _ = m["scan"](lambda xt, hp: at.tanh(hp * 0.9 + xt), sequences=[x], outputs_info=[h0],
                         truncate_gradient=2)
        return [x, h0], [h] + m["pkg"].grad(at.sum(h), [x, h0])

    _compare(build, [XS, H0])


@pytest.mark.parametrize("how", ["constant", "shape"])
def test_n_steps_explicit_and_from_shapes(how):
    def build(m):
        at = m["at"]
        x, h0 = at.matrix("x", dtype="float64"), at.vector("h0", dtype="float64")
        n = 4 if how == "constant" else x.shape[0] - 2
        h, _ = m["scan"](lambda xt, hp: hp * xt + 1.0, sequences=[x], outputs_info=[h0], n_steps=n)
        return [x, h0], [h] + m["pkg"].grad(at.sum(h), [x, h0])

    f = _compare(build, [XS, H0])
    assert f.fn.program.blocker is None


def test_data_dependent_n_steps_runs_eagerly_and_says_so():
    def build(m):
        at = m["at"]
        x, h0, n = at.matrix("x", dtype="float64"), at.vector("h0", dtype="float64"), at.iscalar("n")
        h, _ = m["scan"](lambda xt, hp: hp * xt + 1.0, sequences=[x], outputs_info=[h0], n_steps=n)
        # (its gradient slices x[:n], a bound computed from data, which
        # the port refuses when compiled)
        return [x, h0, n], [h, h[-1] * 2.0]

    f = _compare(build, [XS, H0, np.int32(3)], jax_mode="PY")
    assert type(f.fn.program.blocker.op).__name__ == "Scan"
    assert f.fn.program.blocker_reason == "reads its trip count on the host"


def test_until_runs_eagerly_and_cuts_its_stacks():
    def build(m):
        at = m["at"]
        x = at.vector("x", dtype="float64")
        (h, y), _ = m["scan"](lambda xt, acc: ((acc + xt, acc * xt), m["until"](acc + xt > 2.0)),
                              sequences=[x], outputs_info=[at.constant(np.float64(0.0)), None])
        return [x], [h, y]

    f = _compare(build, [np.array([1.0, 1.5, 1.0, 1.0, 3.0])], jax_mode="PY")
    assert f.fn.program.blocker_reason == "reads its until condition on the host each step"
    assert _host(f(np.array([1.0, 1.5, 1.0]))[0]).shape == (2,)


def test_until_final_value_only():
    def build(m):
        at = m["at"]
        p0 = at.scalar("p0", dtype="float64")
        k, _ = m["scan"](lambda p: (p * 2.0, m["until"](p * 2.0 > 10)), outputs_info=[p0], n_steps=100)
        return [p0], k[-1]

    _compare(build, [np.float64(1.0)])


def test_padded_while_values_mask_and_the_analytic_gradient():
    def build(m, grad=False):
        at = m["at"]
        x = at.vector("x", dtype="float64")
        (h, valid), _ = m["scan"](lambda xt, acc: (acc + xt, m["until"](acc + xt > 2.0)), sequences=[x],
                                  outputs_info=[at.constant(np.float64(0.0))], n_steps=4, padded_while=True)
        outs = [h, valid]
        if grad:
            outs.append(m["pkg"].grad(at.sum(h * valid), x))
        return [x], outs

    xv = np.array([1.0, 1.5, 1.0, 1.0])     # stops at step 2 (cumsum 2.5 > 2)
    f = _compare(build, [xv])
    assert f.fn.program.blocker is None
    # the JAX package cannot build this gradient (its known fault): the
    # valid rows are h1 = x0 and h2 = x0 + x1, so d/dx = [2, 1, 0, 0]
    ins, outs = build(PORT, grad=True)
    h, valid, g = aesara_tpu_torch.function(ins, outs)(xv)
    np.testing.assert_allclose(_host(h), [1.0, 2.5, 2.5, 2.5])
    np.testing.assert_array_equal(_host(valid), [1, 1, 0, 0])
    np.testing.assert_allclose(_host(g), [2.0, 1.0, 0.0, 0.0], **TOL["float64"])


@pytest.mark.parametrize("view", ["map", "reduce", "foldl", "foldr"])
def test_views(view):
    def build(m):
        at = m["at"]
        x, w = at.matrix("x", dtype="float64"), at.matrix("w", dtype="float64")
        if view == "map":
            out, _ = m["map"](lambda xt, w: at.tanh(at.dot(xt, w)), sequences=[x], non_sequences=[w])
        else:
            out, _ = m[view](lambda xt, acc, w: at.tanh(at.dot(acc, w) + xt), sequences=[x],
                             outputs_info=[at.zeros_like(x[0])], non_sequences=[w])
        return [x, w], [out, m["pkg"].grad(at.sum(out), w)]

    _compare(build, [XS, W])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_elman_body_float32_and_float64(dtype):
    def build(m):
        at = m["at"]
        x, wx, wh = at.tensor3("x", dtype=dtype), at.matrix("wx", dtype=dtype), at.matrix("wh", dtype=dtype)
        h0 = at.zeros((3, 4), dtype=dtype)
        h, _ = m["scan"](lambda xt, hp, wx, wh: at.tanh(at.dot(xt, wx) + at.dot(hp, wh)), sequences=[x],
                         outputs_info=[h0], non_sequences=[wx, wh])
        return [x, wx, wh], [h] + m["pkg"].grad(at.sum(h ** 2), [x, wx, wh])

    rng = np.random.default_rng(2)
    args = [rng.normal(size=(5, 3, 2)).astype(dtype), (rng.normal(size=(2, 4)) * 0.4).astype(dtype),
            (rng.normal(size=(4, 4)) * 0.4).astype(dtype)]
    _compare(build, args, dtype=dtype)


def test_jacobian_and_hessian():
    def build(m):
        at = m["at"]
        x, w = at.vector("x", dtype="float64"), at.vector("w", dtype="float64")
        y = at.tanh(x) * x[::-1] * w
        cost = at.sum(at.sin(x) * x * w)
        jx, jw = m["jacobian"](y, [x, w])
        return [x, w], [jx, jw, m["jacobian"](at.sum(y), x), m["hessian"](cost, x)]

    _compare(build, [np.linspace(-1, 1, 4), RNG.normal(size=4)])


@pytest.mark.parametrize("use_op_rop", [False, True], ids=["lop_of_lop", "op_rop"])
def test_rop_waits_for_r_op(use_op_rop):
    """Rop through a Scan, by the Lop-of-Lop construction and through
    ``Scan.R_op``, against the JAX package's."""
    def build(m):
        at = m["at"]
        xs, v = at.matrix("xs", dtype="float64"), at.matrix("v", dtype="float64")
        h0 = at.vector("h0", dtype="float64")
        hs, _ = m["scan"](lambda x, h: at.tanh(x + 0.5 * h), sequences=[xs], outputs_info=[h0])
        grad_mod = aesara_tpu.gradient if m is JAX else aesara_tpu_torch.gradient
        return [xs, h0, v], [grad_mod.Rop(hs, xs, v, use_op_rop=use_op_rop)]

    _compare(build, [XS, H0, RNG.normal(size=XS.shape)])


def test_steps_per_call_equals_that_many_calls():
    def build():
        w = aesara_tpu_torch.shared(np.array([1.0, -2.0, 0.5]), name="w")
        x = pat.vector("x", dtype="float64")
        loss = pat.sum((w * x - 1.0) ** 2)
        return w, x, loss, [(w, w - 0.1 * aesara_tpu_torch.grad(loss, w))]

    w1, x1, loss1, up1 = build()
    w3, x3, loss3, up3 = build()
    one = aesara_tpu_torch.function([x1], loss1, updates=up1)
    three = aesara_tpu_torch.function([x3], loss3, updates=up3, steps_per_call=3)
    assert three.steps_per_call == 3
    xv = RNG.normal(size=3)
    want = [float(_host(one(xv))) for _ in range(3)]
    got = _host(three(xv))
    assert got.shape == (3,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(w3.get_value(), w1.get_value())


def _structure(fgraph):
    """The inner graph as (op, its inputs) in topological order, an input
    position naming an inner input, an earlier node's output or a
    constant's value."""
    where = {v: ("in", k) for k, v in enumerate(fgraph.inputs)}
    nodes = []
    for k, node in enumerate(fgraph.toposort()):
        ins = []
        for v in node.inputs:
            ins.append(where[v] if v in where else ("const", str(v.type), np.asarray(v.data).tolist()))
        # the op's class and what its name shows past the class name (the
        # JAX package prints IncSubtensor as "Inctensor{...}")
        text = str(node.op)
        nodes.append((type(node.op).__name__, text.split("{", 1)[1] if "{" in text else text, tuple(ins)))
        for j, o in enumerate(node.outputs):
            where[o] = ("node", k, j)
    return nodes, [where.get(o) for o in fgraph.outputs]


def test_unfused_inner_graph_is_the_jax_packages_node_for_node():
    """The Scan op's own inner graph is the JAX package's (the fusion runs
    on the copy the lowering compiles, whose chain is one Composite)."""
    from tests.test_torch_rnn import JAX as RJAX, PORT as RPORT, build_config4

    scans = []
    for m, mode in ((RJAX, "FAST_RUN"), (RPORT, "TORCH")):
        f = build_config4(m, "float32", mode)[0]
        scans.append([n.op for n in f.maker.fgraph.toposort() if type(n.op).__name__ == "Scan"])
    assert len(scans[0]) == len(scans[1]) == 2
    for jop, pop in zip(*scans):
        assert str(pop.info) == str(jop.info)
        assert _structure(pop.fgraph) == _structure(jop.fgraph)
    fused = fused_inner_graph(scans[1][0])
    composites = [n for n in fused.toposort() if type(getattr(n.op, "scalar_op", None)).__name__ == "Composite"]
    assert len(composites) == 1 and len(scans[1][0].fgraph.toposort()) == 4


def test_scan_op_builds_the_jax_packages_info():
    x = pat.matrix("x")
    (h, y), _ = pscan(lambda xt, hp: (hp + xt, pat.sum(xt)), sequences=[x],
                      outputs_info=[pat.zeros_like(x[0]), None])
    op = h.owner.op
    assert isinstance(op, Scan)
    assert (op.info.n_seqs, op.info.n_sit_sot, op.info.n_nit_sot) == (1, 1, 1)
