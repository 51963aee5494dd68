"""The decoder LM and the recurrent models in bfloat16 and float16: the port
against the JAX package, built from the same code on the CPU.

- ``DecoderLM(100, 2, 64, 4, 128, seed=0)`` builds in either type (the
  gains' ones by the shared variable's dtype, not by a NumPy view of a
  torch tensor).  Greedy, prompt, batched and int8 (``quantize_decoder_int8``)
  tokens are the JAX package's under the tie rule: equal, or equal up to
  a first difference where the JAX model's top-2 logit gap is under the
  type's spacing of the logits' scale (2**-7 in bfloat16, 2**-10 in
  float16), where the comparison stops.  The full forward's logits agree
  within 2e-2 (bfloat16) or 1e-2 (float16) of their scale.
- The ``FAST_RUN`` graphs of greedy, prompt and batched decode have the
  JAX package's count of every op, outer and inner (with the JAX
  package's unmerged ``Reshape`` twins of the prompt graph counted out, as
  ``tests/test_torch_decoder.py`` does), and of every op by its outputs'
  dtypes: the graph turns float64 at the JAX package's nodes (the scores'
  ``/ np.sqrt(dh)``) and nowhere else.
- ``ElmanRNN``, ``LSTM`` and ``GRU``: the loss and the gradient of every
  parameter have the JAX package's op counts and values, within 2e-2
  (bfloat16) or 1e-2 (float16) of each tensor's scale plus the JAX
  package's own distance from the float64 model of the same seed.  With
  ``adam`` the port trains them in either type (6 steps at lr 5e-2, each
  held against a plain torch adam on the step's own gradients, the loss
  falls): the JAX package's ``adam`` refuses to (its update is
  float32, the bias corrections', for a 16-bit parameter); the port's keeps
  float32 moments for such a parameter and casts the update back to its
  type, as both packages' ``adamw`` do (in bfloat16 b2 = 0.999 rounds to
  1.0, and a bias correction of 0 stops every update).
"""

import os
import subprocess
import sys
from collections import Counter

import ml_dtypes
import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.models import adam as jadam, rnn as jrnn
from aesara_tpu.models.decoder import DecoderLM as JLM
from aesara_tpu.models.quant import quantize_decoder_int8 as jquant

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.misc.safe_asarray import _asarray
from aesara_tpu_torch.models import adam as padam, rnn as prnn
from aesara_tpu_torch.models.decoder import DecoderLM as PLM
from aesara_tpu_torch.models.quant import quantize_decoder_int8 as pquant
from aesara_tpu_torch.scalar.ops import to_host
from tests.test_torch_rnn import _name, op_counts


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


LOW = ["bfloat16", "float16"]
REL = {"bfloat16": 2e-2, "float16": 1e-2}
TIE = {"bfloat16": 2.0**-7, "float16": 2.0**-10}
SIZE = dict(vocab=100, n_layers=2, d_model=64, n_heads=4, d_ff=128, seed=0)
PROMPT = np.array([5, 9, 2, 7], dtype="int64")
FIRSTS = np.array([3, 7, 11], dtype="int64")


def _host(v):
    if isinstance(v, torch.Tensor):
        return to_host(v, str(v.dtype).split(".")[-1]).astype("float64") if v.is_floating_point() else v.numpy()
    v = np.asarray(v)
    return v.astype("float64") if v.dtype.kind == "V" or v.dtype.name == "bfloat16" else v


def _jax_value(x, dtype):
    return x.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)


@pytest.fixture(scope="module", params=LOW)
def lms(request):
    """(dtype, the JAX model, the port's), with their decode functions and
    last-token oracles, built under ``floatX = dtype``."""
    dtype = request.param
    with aesara_tpu.config.change_flags(floatX=dtype), config.change_flags(device="cpu", floatX=dtype):
        jlm, plm = JLM(**SIZE), PLM(**SIZE)
        built = {}
        for name, lm in (("jax", jlm), ("port", plm), ("jax_int8", jquant(jlm)), ("port_int8", pquant(plm))):
            built[name] = {"greedy": lm.generate_fn(8, 16, mode="FAST_RUN"),
                           "prompt": lm.generate_from_prompt_fn(4, 5, 16, mode="FAST_RUN"),
                           "batched": lm.generate_batched_fn(3, 6, 8, mode="FAST_RUN"),
                           "logits": _logits_fn(aesara_tpu if name.startswith("jax") else aesara_tpu_torch,
                                                jat if name.startswith("jax") else pat, lm)}
    return dtype, built


def _logits_fn(pkg, at, lm):
    """tokens -> the full forward's logits at every position."""
    toks = at.lvector("toks")
    h = lm.embed[toks]
    for layer in lm.layers:
        h = layer.full(h)
    return pkg.function([toks], at.dot(h, lm.embed.T), mode="FAST_RUN")


def _tie_rule(got, want, prefix, oracle, rel):
    """Tokens equal, or equal up to a first difference where the oracle's
    top-2 logit gap is under ``rel`` of the logits' scale."""
    got, want = [int(t) for t in got], [int(t) for t in want]
    if got == want:
        return
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    logits = _host(oracle(np.asarray(list(prefix) + want[:k], dtype="int64")))[-1]
    top = np.sort(logits)[-2:]
    assert top[1] - top[0] < rel * np.abs(logits).max(), f"token {k}: {got[k]} against {want[k]}, no tie"


@pytest.mark.parametrize("which", ["", "_int8"], ids=["weights", "int8"])
def test_decoder_tokens_are_the_jax_packages_under_the_tie_rule(lms, which):
    dtype, built = lms
    jax, port = built["jax" + which], built["port" + which]
    oracle = jax["logits"]
    for name, arg, prefixes in (("greedy", np.int64(3), [[3]]), ("prompt", PROMPT, [list(PROMPT)]),
                                ("batched", FIRSTS, [[t] for t in FIRSTS])):
        want, got = np.asarray(jax[name](arg)), _host(port[name](arg))
        assert got.shape == want.shape, name
        if name == "batched":
            for j, prefix in enumerate(prefixes):
                _tie_rule(got[:, j], want[:, j], prefix, oracle, TIE[dtype])
        else:
            _tie_rule(got, want, prefixes[0], oracle, TIE[dtype])


def test_decoder_logits_are_the_jax_packages(lms):
    dtype, built = lms
    seq = np.array([3, 17, 4, 40, 9, 22, 81, 5], dtype="int64")
    for which in ("", "_int8"):
        want, got = _host(built["jax" + which]["logits"](seq)), _host(built["port" + which]["logits"](seq))
        assert got.shape == want.shape == (len(seq), SIZE["vocab"])
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= REL[dtype] * scale, f"{which or 'weights'}: {err / scale:.3e} of the scale"


def _dtype_counts(fgraph):
    """{op name and its outputs' dtypes: count}, outer and inner graphs
    together."""
    nodes = list(fgraph.toposort())
    for n in list(nodes):
        if type(n.op).__name__ == "Scan":
            nodes += n.op.fgraph.toposort()
    return Counter(f"{_name(n)}:{','.join(o.type.dtype for o in n.outputs)}" for n in nodes)


@pytest.mark.parametrize("which", ["greedy", "prompt", "batched"])
def test_decoder_graphs_have_the_jax_packages_op_counts(lms, which):
    dtype, built = lms
    fj, fp = built["jax"][which], built["port"][which]
    want, got = op_counts(fj.maker.fgraph), op_counts(fp.maker.fgraph)
    dwant, dgot = _dtype_counts(fj.maker.fgraph), _dtype_counts(fp.maker.fgraph)
    if which == "prompt":
        # the JAX package's unmerged Reshape twins of each layer's K and V rows
        assert want[0]["Reshape"] == got[0]["Reshape"] + 2 * SIZE["n_layers"]
        want[0]["Reshape"] = got[0]["Reshape"]
        twins = {k: dwant[k] - dgot[k] for k in dwant if k.startswith("Reshape:") and dwant[k] != dgot[k]}
        assert sum(twins.values()) == 2 * SIZE["n_layers"]
        for k in twins:
            dwant[k] = dgot[k]
    assert got == want
    assert dgot == dwant
    assert any(k.endswith(":float64") for k in dgot) and any(k.endswith(f":{dtype}") for k in dgot)


# --- the recurrent models ---------------------------------------------------

T, B, DIN, H, NOUT = 5, 4, 3, 6, 10
MODELS = ["ElmanRNN", "LSTM", "GRU"]


def _loss_and_grads(pkg, at, rnn, config_, which, dtype, mode):
    with config_.change_flags(floatX=dtype):
        model = getattr(rnn, which)(DIN, H, NOUT, seed=0)
        X, y = at.tensor3("X", dtype=dtype), at.ivector("y")
        loss = model.loss(X, y)
        return pkg.function([X, y], [loss] + pkg.grad(loss, model.params), mode=mode)


def _rnn_data():
    rng = np.random.default_rng(1)
    return rng.normal(size=(T, B, DIN)), rng.integers(0, NOUT, size=B).astype("int32")


@pytest.mark.parametrize("dtype", LOW)
@pytest.mark.parametrize("which", MODELS)
def test_recurrent_model_loss_and_gradients_are_the_jax_packages(which, dtype):
    xv, yv = _rnn_data()
    jf = _loss_and_grads(aesara_tpu, jat, jrnn, aesara_tpu.config, which, dtype, "PY")
    pf = _loss_and_grads(aesara_tpu_torch, pat, prnn, config, which, dtype, "TORCH")
    exact = [np.asarray(v) for v in
             _loss_and_grads(aesara_tpu, jat, jrnn, aesara_tpu.config, which, "float64", "PY")(xv, yv)]
    want = [_host(v) for v in jf(_jax_value(xv, dtype), yv)]
    got = [_host(v) for v in pf(_asarray(xv.astype("float32"), dtype) if dtype == "bfloat16"
                                else xv.astype(dtype), yv)]
    assert len(got) == len(want) == len(exact)
    for k, (g, w, e) in enumerate(zip(got, want, exact)):
        scale = np.abs(w).max()
        own = np.abs(w - e).max()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= REL[dtype] * scale + own, (k, np.abs(g - w).max() / scale, own / scale)
    graphs = [op_counts(_loss_and_grads(aesara_tpu, jat, jrnn, aesara_tpu.config, which, dtype,
                                        "FAST_RUN").maker.fgraph), op_counts(pf.maker.fgraph)]
    assert graphs[1] == graphs[0]


MANTISSA = {"bfloat16": 7, "float16": 10}
SMALLEST = {"bfloat16": 2.0**-133, "float16": 2.0**-24}   # the types' smallest subnormals


def _ulp(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """The spacing of ``dtype`` at each entry of ``x``."""
    _, e = torch.frexp(x.double().abs())   # |x| = f 2^e, f in [0.5, 1)
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - 1 - MANTISSA[dtype]).clamp_min(SMALLEST[dtype])


def _adam_plain(p, m, v, g, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One adam step in plain torch for a 16-bit parameter: float32
    moments, bias corrections in float32, the update cast to ``p``'s
    type; (new p, new m, new v)."""
    g = g.float()
    m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
    bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(t)) for b in (b1, b2))
    return (p.float() - lr * (m / bc1) / ((v / bc2).sqrt() + eps)).to(p.dtype), m, v


@pytest.mark.parametrize("dtype", LOW)
@pytest.mark.parametrize("which", MODELS)
def test_the_port_trains_a_recurrent_model_with_adam_in_16_bits(which, dtype):
    """Six steps, each held against ``_adam_plain`` on the gradients that
    the step itself returns (the ones its updates take): every parameter
    within one spacing of its type at the larger of its start and the two
    results (the two compute the same float32 values in another order,
    then round ``start - update``), the moments within 1e-6 of
    their scale; a step that updates nothing, or with its sign flipped,
    is off by lr (2 lr), many spacings at these parameters' sizes."""
    xv, yv = _rnn_data()
    with aesara_tpu.config.change_flags(floatX=dtype):
        model = getattr(jrnn, which)(DIN, H, NOUT, seed=0)
        X, y = jat.tensor3("X", dtype=dtype), jat.ivector("y")
        loss = model.loss(X, y)
        with pytest.raises(TypeError, match="float32"):
            aesara_tpu.function([X, y], loss, updates=jadam(loss, model.params, lr=1e-2))
    lr = 5e-2
    with config.change_flags(floatX=dtype):
        model = getattr(prnn, which)(DIN, H, NOUT, seed=0)
        X, y = pat.tensor3("X", dtype=dtype), pat.ivector("y")
        loss = model.loss(X, y)
        updates = padam(loss, model.params, lr=lr)
        step = aesara_tpu_torch.function([X, y], [loss] + aesara_tpu_torch.grad(loss, model.params),
                                         updates=updates)
    moments = [(updates[1 + 3 * i][0], updates[2 + 3 * i][0]) for i in range(len(model.params))]
    assert all(m.type.dtype == v.type.dtype == "float32" for m, v in moments)
    x = _asarray(xv.astype("float32"), dtype) if dtype == "bfloat16" else xv.astype(dtype)
    losses = []
    for t in range(1, 7):
        before = [(p.value.clone(), m.value.clone(), v.value.clone())
                  for p, (m, v) in zip(model.params, moments)]
        loss_v, *grads = step(x, yv)
        losses.append(float(_host(loss_v)))
        for p, (m, v), (p0, m0, v0), g in zip(model.params, moments, before, grads):
            want_p, want_m, want_v = _adam_plain(p0, m0, v0, g, t, lr)
            got_p = p.value
            assert got_p.dtype == p0.dtype and str(got_p.dtype).endswith(dtype)
            off = (got_p.double() - want_p.double()).abs()
            ulp = _ulp(torch.maximum(torch.maximum(got_p.double().abs(), want_p.double().abs()), p0.double().abs()),
                       dtype)
            assert bool((off <= ulp).all()), (p.name, t, float((off / ulp).max()))
            for got, want in ((m.value, want_m), (v.value, want_v)):
                assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max()), (p.name, t)
        # the step moved the parameters: lr is many spacings at their size
        assert any(not torch.equal(p.value, p0) for p, (p0, _, _) in zip(model.params, before))
    assert all(np.isfinite(losses)) and min(losses[1:]) < losses[0], losses


def test_the_16_bit_models_build_and_run_without_ml_dtypes():
    """In a process that imports neither JAX nor ml_dtypes (as on the card's
    machine: NumPy has no bfloat16 there), the decoder builds, decodes,
    prefills and quantizes in bfloat16 and float16, and the LSTM trains with
    adam: the port names dtypes by string, never by a NumPy bfloat16."""
    code = """
import sys
import numpy as np
from aesara_tpu_torch.config import config
from aesara_tpu_torch.models.decoder import DecoderLM
from aesara_tpu_torch.models.quant import quantize_decoder_int8
from aesara_tpu_torch.models import LSTM, adam
from aesara_tpu_torch.misc.safe_asarray import _asarray
import aesara_tpu_torch as ptp, aesara_tpu_torch.tensor as pt
for dt in ("bfloat16", "float16"):
    with config.change_flags(device="cpu", floatX=dt):
        lm = DecoderLM(50, 1, 32, 4, 64, seed=0)
        toks = [lm.generate_fn(4, 8, mode="FAST_RUN")(np.int64(3)),
                lm.generate_from_prompt_fn(3, 2, 8, mode="FAST_RUN")(np.array([1, 2, 3])),
                lm.generate_batched_fn(2, 4, 8, mode="FAST_RUN")(np.array([1, 2])),
                quantize_decoder_int8(lm).generate_fn(4, 8, mode="FAST_RUN")(np.int64(3))]
        assert [tuple(t.shape) for t in toks] == [(4,), (2,), (4, 2), (4,)], toks
        model = LSTM(3, 4, 5, seed=0)
        X, y = pt.tensor3("X", dtype=dt), pt.ivector("y")
        step = ptp.function([X, y], model.loss(X, y), updates=adam(model.loss(X, y), model.params))
        x = _asarray(np.ones((2, 2, 3)), dt)
        assert np.isfinite(float(step(x, np.zeros(2, dtype="int32"))))
assert "ml_dtypes" not in sys.modules and "jax" not in sys.modules
print("ok")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=root)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
