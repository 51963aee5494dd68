"""``Rop`` on the port against the JAX package's, on the CPU.

The cases of ``tests/test_rop_sweep.py`` (an op zoo, a Scan) run through
both constructions: the Lop-of-Lop default and ``use_op_rop=True``, which
walks each op's ``R_op`` (``Scan.R_op`` for a Scan).  Each port result is
held to the JAX package's (same construction, ``FAST_RUN``) and to central
finite differences, in float64: the two packages within rtol 1e-9, the
finite differences within rtol 1e-4 (1e-3 through a Scan), and the two
constructions to each other within rtol 1e-8.  Then ``Scan.R_op`` on
config 4's Elman RNN at T 8 and its refusals, the Gauss-Newton-vector
product of a 2-layer MLP, and the disconnected-output policies.
"""

import warnings

import numpy as np
import pytest

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.gradient import Lop as jLop, Rop as jRop
from aesara_tpu.scan.basic import scan as jscan, until as juntil

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.gradient import DisconnectedInputError, Lop as pLop, Rop as pRop
from aesara_tpu_torch.scan.basic import scan as pscan, until as puntil


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, Rop=jRop, Lop=jLop, scan=jscan, until=juntil, mode="FAST_RUN")
PORT = dict(pkg=aesara_tpu_torch, at=pat, Rop=pRop, Lop=pLop, scan=pscan, until=puntil, mode="TORCH")


def _host(v):
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


def _rop_values(m, build, shapes, i, vals, vv, use_op_rop):
    at = m["at"]
    xs = [at.TensorType("float64", (None,) * len(s))(f"x{k}") for k, s in enumerate(shapes)]
    out = build(m, *xs)
    v = at.TensorType("float64", (None,) * len(shapes[i]))("v")
    rop = m["Rop"](out, xs[i], v, use_op_rop=use_op_rop)
    f = m["pkg"].function(xs + [v], rop, mode=m["mode"], on_unused_input="ignore")
    g = m["pkg"].function(xs, out, mode=m["mode"], on_unused_input="ignore")
    return _host(f(*vals, vv)), g


def check_rop(build, shapes, op_rop=True, rtol=1e-4, seed=0):
    """``build(m, *xs) -> output``; Rop with respect to every input."""
    r = np.random.default_rng(seed)
    vals = [r.normal(size=s) * 0.5 for s in shapes]
    for i, xv in enumerate(vals):
        vv = r.normal(size=xv.shape)
        got = {}
        for use_op in ([False, True] if op_rop else [False]):
            port, g = _rop_values(PORT, build, shapes, i, vals, vv, use_op)
            jax, _ = _rop_values(JAX, build, shapes, i, vals, vv, use_op)
            np.testing.assert_allclose(port, jax, rtol=1e-9, atol=1e-12, err_msg=f"use_op_rop={use_op}")
            eps = 1e-6
            vp, vm = list(vals), list(vals)
            vp[i], vm[i] = xv + eps * vv, xv - eps * vv
            fd = (_host(g(*vp)) - _host(g(*vm))) / (2 * eps)
            np.testing.assert_allclose(port, fd, rtol=rtol, atol=1e-6, err_msg=f"use_op_rop={use_op}")
            got[use_op] = port
        if len(got) == 2:
            np.testing.assert_allclose(got[False], got[True], rtol=1e-8, atol=1e-12)


def _rnn_final(m, W):
    at = m["at"]
    h0 = at.as_tensor_variable(np.array([0.1, -0.2, 0.3]))
    outs, _ = m["scan"](lambda h, WW: at.tanh(at.dot(WW, h)), outputs_info=[h0], non_sequences=[W], n_steps=3)
    return outs[-1]


CASES = {
    "tanh_chain": (lambda m, x: m["at"].tanh(x * 2.0) + m["at"].exp(x * 0.1), [(3, 4)], True),
    "sigmoid_mul": (lambda m, x, y: m["at"].sigmoid(x) * y, [(4,), (4,)], True),
    "broadcasted": (lambda m, x, y: x.dimshuffle(0, "x") * y.dimshuffle("x", 0), [(3,), (5,)], True),
    "log1p_sqr": (lambda m, x: m["at"].log(1.0 + m["at"].sqr(x)), [(6,)], True),
    "sum_all": (lambda m, x: x.sum(), [(3, 4)], True),
    "sum_0": (lambda m, x: x.sum(axis=0), [(3, 4)], True),
    "sum_1": (lambda m, x: x.sum(axis=1), [(3, 4)], True),
    "mean": (lambda m, x: x.mean(axis=1), [(3, 4)], True),
    "prod": (lambda m, x: (x + 3.0).prod(axis=0), [(2, 3)], False),
    "max": (lambda m, x: x.max(axis=1), [(3, 5)], False),
    "dot_mm": (lambda m, a, b: m["at"].dot(a, b), [(3, 4), (4, 5)], True),
    "dot_chain_cost": (lambda m, a, b: m["at"].sum(m["at"].dot(a, b) ** 2), [(3, 4), (4, 2)], True),
    "batched_dot": (lambda m, a, b: m["at"].batched_dot(a, b), [(2, 3, 4), (2, 4, 2)], True),
    "subtensor": (lambda m, x: x[1:, :2] * 3.0, [(4, 5)], True),
    "inc_subtensor": (lambda m, x, y: m["at"].inc_subtensor(x[1:3], y), [(5, 2), (2, 2)], True),
    "join": (lambda m, a, b: m["at"].concatenate([a, b], axis=0).sum(axis=1), [(2, 3), (4, 3)], True),
    "reshape_dimshuffle": (lambda m, x: x.reshape((6,)).dimshuffle("x", 0), [(2, 3)], True),
    "alloc": (lambda m, x: m["at"].alloc(x, 4, 3) * 2.0, [(3,)], True),
    "set_subtensor_constant": (lambda m, x: m["at"].set_subtensor(x[0], 0.0), [(4, 3)], True),
    "advanced_subtensor": (lambda m, x: x[:, np.array([2, 0, 2])] * x[np.array([1, 3]), 1:3].sum(), [(4, 3)], True),
    "advanced_inc": (lambda m, x, y: m["at"].inc_subtensor(x[np.array([0, 2, 0])], y), [(4, 3), (3, 3)], True),
    "scan_final_state": (_rnn_final, [(3, 3)], True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rop_sweep_holds_on_the_port(name):
    build, shapes, op_rop = CASES[name]
    check_rop(build, shapes, op_rop=op_rop, rtol=1e-3 if name.startswith("scan") else 1e-4)


def test_op_rop_refuses_an_op_without_a_rule_naming_it():
    x, v = pat.matrix("x", dtype="float64"), pat.matrix("v", dtype="float64")
    with pytest.raises(NotImplementedError, match="no R_op rule"):
        pRop(x.prod(axis=0), x, v, use_op_rop=True)


def _elman(m, T, B, H, D, seed=0):
    """Config 4's Elman RNN step over T steps: the logits of the last
    state; ``(inputs, logits, params)``."""
    at = m["at"]
    r = np.random.default_rng(seed)
    wx = at.constant(r.normal(scale=0.1, size=(D, H)))
    xs = at.tensor3("xs", dtype="float64")
    wh, b = at.matrix("wh", dtype="float64"), at.vector("b", dtype="float64")
    h0 = at.zeros((B, H), dtype="float64")
    hs, _ = m["scan"](lambda x, h, whh, bb: at.tanh(at.dot(x, wx) + at.dot(h, whh) + bb),
                      sequences=[xs], outputs_info=[h0], non_sequences=[wh, b])
    return [xs, wh, b], hs


@pytest.mark.parametrize("use_op_rop", [False, True], ids=["lop_of_lop", "scan_r_op"])
def test_scan_r_op_on_config_4_at_t_8(use_op_rop):
    """Jv of every hidden state through config 4's recurrence at T 8 (B 4,
    H 6, Din 5): the port's against the JAX package's within 1e-9, by each
    construction."""
    T, B, H, D = 8, 4, 6, 5
    r = np.random.default_rng(1)
    vals = [r.normal(size=(T, B, D)), r.normal(scale=0.3, size=(H, H)), r.normal(scale=0.1, size=H)]
    tangents = [r.normal(size=(H, H)), r.normal(size=H)]
    res = []
    for m in (JAX, PORT):
        ins, hs = _elman(m, T, B, H, D)
        vs = [m["at"].matrix("vw", dtype="float64"), m["at"].vector("vb", dtype="float64")]
        jv = m["Rop"](hs, ins[1:], vs, use_op_rop=use_op_rop)
        f = m["pkg"].function(ins + vs, jv, mode=m["mode"])
        res.append(_host(f(*vals, *tangents)))
        if m is PORT and use_op_rop:
            scans = [n for n in f.maker.fgraph.toposort() if type(n.op).__name__ == "Scan"]
            assert scans and any(n.op.name.endswith("_jvp") for n in scans)
    np.testing.assert_allclose(res[1], res[0], rtol=1e-9, atol=1e-12)


def test_scan_r_op_refuses_while_scans_and_save_mem_scans():
    """The JAX package's refusals, with its messages."""
    x = pat.vector("x", dtype="float64")

    def body(h):
        return h * 2.0, puntil(pat.sum(h) > 10.0)

    hs, _ = pscan(body, outputs_info=[x], n_steps=5)
    with pytest.raises(NotImplementedError, match="R_op"):
        pRop(hs, x, pat.vector("v", dtype="float64"), use_op_rop=True)
    scan_op = hs.owner.inputs[0].owner.op if hs.owner.inputs[0].owner is not None else None
    node = next(n for n in aesara_tpu_torch.graph.ir.io_toposort([x], [hs]) if type(n.op).__name__ == "Scan")
    with pytest.raises(NotImplementedError, match="while-Scan"):
        node.op.R_op(node.inputs, [None] * len(node.inputs))
    del scan_op
    ys, _ = pscan(lambda h: h * 0.5, outputs_info=[x], n_steps=4)
    snode = ys.owner if type(ys.owner.op).__name__ == "Scan" else next(
        n for n in aesara_tpu_torch.graph.ir.io_toposort([x], [ys]) if type(n.op).__name__ == "Scan")
    from dataclasses import replace

    saved = type(snode.op)(snode.op.fgraph, replace(snode.op.info, final_only=(True,)))
    with pytest.raises(NotImplementedError, match="save-mem"):
        saved.R_op(snode.inputs, [None] * len(snode.inputs))


def _mlp_gnv(m, sizes, n, seed=0):
    """The Gauss-Newton-vector product of an MLP with a softmax
    cross-entropy head: Jv = Rop(logits, params, vs), times the output
    Hessian (diag(p) - p p^T) / n as elementwise ops, then Lop(logits,
    params, .); ``(inputs, [Gv per parameter])``."""
    at = m["at"]
    x = at.matrix("x", dtype="float64")
    params, vs = [], []
    h = x
    for k, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        w, bias = at.matrix(f"w{k}", dtype="float64"), at.vector(f"b{k}", dtype="float64")
        params += [w, bias]
        vs += [at.matrix(f"vw{k}", dtype="float64"), at.vector(f"vb{k}", dtype="float64")]
        h = at.dot(h, w) + bias
        if k < len(sizes) - 2:
            h = at.tanh(h)
    logits = h
    return x, params, vs, logits


def _gnv_graph(m, sizes, n, use_op_rop):
    at = m["at"]
    x, params, vs, logits = _mlp_gnv(m, sizes, n)
    jv = m["Rop"](logits, params, vs, use_op_rop=use_op_rop)
    p = at.exp(logits - logits.max(axis=1, keepdims=True))
    p = p / p.sum(axis=1, keepdims=True)
    hjv = (p * jv - p * (p * jv).sum(axis=1, keepdims=True)) / n
    gv = m["Lop"](logits, params, hjv)
    return [x] + params + vs, gv


@pytest.mark.parametrize("use_op_rop", [False, True], ids=["lop_of_lop", "op_rop"])
def test_gauss_newton_vector_product_of_a_2_layer_mlp(use_op_rop):
    """Schraudolph's product on a 2-layer MLP (12-8-5, a batch of 6): the
    port's against the JAX package's within 1e-10, and against the dense
    Gauss-Newton matrix J^T H J v built from the Jacobian by NumPy."""
    sizes, n = (12, 8, 5), 6
    r = np.random.default_rng(4)
    vals = [r.normal(size=(n, sizes[0]))]
    for a, b in zip(sizes[:-1], sizes[1:]):
        vals += [r.normal(scale=0.4, size=(a, b)), r.normal(scale=0.1, size=b)]
    tang = [r.normal(size=v.shape) for v in vals[1:]]
    res = []
    for m in (JAX, PORT):
        ins, gv = _gnv_graph(m, sizes, n, use_op_rop)
        f = m["pkg"].function(ins, gv, mode=m["mode"])
        res.append([_host(g) for g in f(*vals, *tang)])
    for p, j in zip(res[1], res[0]):
        np.testing.assert_allclose(p, j, rtol=1e-10, atol=1e-13)
    # the dense product by finite differences of the logits
    x, w0, b0, w1, b1 = vals

    def logits(flat):
        k, out = 0, []
        for v in vals[1:]:
            out.append(flat[k:k + v.size].reshape(v.shape))
            k += v.size
        a0, c0, a1, c1 = out
        return (np.tanh(x @ a0 + c0) @ a1 + c1).ravel()

    theta = np.concatenate([v.ravel() for v in vals[1:]])
    vflat = np.concatenate([t.ravel() for t in tang])
    eps = 1e-6
    J = np.stack([(logits(theta + eps * e) - logits(theta - eps * e)) / (2 * eps)
                  for e in np.eye(theta.size)], axis=1)
    z = logits(theta).reshape(n, -1)
    pz = np.exp(z - z.max(1, keepdims=True))
    pz /= pz.sum(1, keepdims=True)
    Hblk = np.zeros((z.size, z.size))
    for i in range(n):
        s = slice(i * z.shape[1], (i + 1) * z.shape[1])
        Hblk[s, s] = (np.diag(pz[i]) - np.outer(pz[i], pz[i])) / n
    want = J.T @ Hblk @ J @ vflat
    got = np.concatenate([g.ravel() for g in res[1]])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("policy", ["raise", "warn", "ignore"])
@pytest.mark.parametrize("use_op_rop", [False, True], ids=["lop_of_lop", "op_rop"])
def test_disconnected_outputs_by_policy(policy, use_op_rop):
    """An output no tangent reaches raises, warns and gives zeros, or gives
    zeros, as the JAX package's."""
    outs = []
    for m in (JAX, PORT):
        at = m["at"]
        x, y = at.vector("x", dtype="float64"), at.vector("y", dtype="float64")
        v = at.vector("v", dtype="float64")
        fs = [at.tanh(x), y * 2.0]
        if policy == "raise":
            with pytest.raises(ValueError, match="not connected"):
                m["Rop"](fs, x, v, disconnected_outputs=policy, use_op_rop=use_op_rop)
            continue
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            r = m["Rop"](fs, x, v, disconnected_outputs=policy, use_op_rop=use_op_rop)
        if policy == "warn":
            assert any("not connected" in str(w.message) for w in seen)
        f = m["pkg"].function([x, y, v], r, mode=m["mode"], on_unused_input="ignore")
        outs.append([_host(o) for o in f(np.arange(3.0), np.ones(3), np.ones(3))])
    if policy == "raise":
        assert issubclass(DisconnectedInputError, ValueError)
        return
    for p, j in zip(outs[1], outs[0]):
        np.testing.assert_allclose(p, j, rtol=1e-12)
    np.testing.assert_array_equal(outs[1][1], np.zeros(3))


def test_rop_of_the_tutorial():
    """``doc/tutorial.md``'s ``Rop(f_out, x, v)``: the port's against the
    JAX package's."""
    res = []
    for m in (JAX, PORT):
        at = m["at"]
        x, v = at.vector("x"), at.vector("v")
        f_out = at.tanh(x) * 2
        jv = m["Rop"](f_out, x, v)
        f = m["pkg"].function([x, v], jv, mode=m["mode"])
        res.append(_host(f(np.linspace(-1, 1, 5).astype("float32"), np.ones(5, "float32"))))
    np.testing.assert_allclose(res[1], res[0], rtol=1e-6)
