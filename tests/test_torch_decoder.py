"""The decoder LM of the port (``aesara_tpu_torch/models/decoder.py``) and
the ops it brought (``BatchedDot``, ``Repeat``) against the JAX package's
(``aesara_tpu/models/decoder.py``), built from the same code at
``tests/models/test_decoder.py``'s size (vocab 50, 2 layers, d 32, 4
heads, d_ff 64; GQA with 2 KV heads) on the CPU.

- ``DecoderLM(..., seed=s)`` holds the JAX model's weights bit for bit.
- ``BatchedDot`` in each rank case and its gradient, in float32 and
  float64, to 1e-6; ``Repeat`` and its gradient exactly.
- ``loss`` and the gradient of every parameter to 1e-5.
- Greedy, prompt and batched decode give the JAX package's tokens, and a
  batched stream gives its single stream's; the cached decode's logits
  equal ``full()``'s at every position to 1e-5.
- The ``FAST_RUN`` graphs of greedy, prompt and batched decode have the
  JAX package's count of every op, outer and in each Scan's inner graph,
  and the same final-only states.  Two differences are the JAX package's
  (its merge pass walks ``fgraph.variables``, a set in which two equal
  constants are one entry, so a node over the second is never merged):
  ``generate_from_prompt_fn`` keeps a second ``Reshape`` of each layer's
  K and V rows (``prefill_kv_rows`` and ``full()`` reshape the same
  product to the same constant shape), and ``ContinuousBatcher._decode``
  a second ``Elemwise{EQ}`` (the write mask of each layer: ``arange`` of
  two caches' equal static length).  The port merges both.  The loss
  graph's counts are not compared: the JAX package's move with the hash
  seed.
- In the decode loop a final-only carried cache is written in place:
  its storage stays the same across steps, the caller's initial value is
  not written, and a state that is not final-only still clones.
- Sampling (``temperature`` > 0, with and without ``top_k``) gives the
  JAX package's tokens call for call: each call advances the key (the
  stream's default update draws once outside the loop), so calls differ,
  as the JAX package's do.  Speculative decoding (a one-layer draft, and
  the target as its own draft) gives the JAX package's tokens and the
  target's own greedy decode; beam search (beam 1, 3 and beam > V) its
  tokens, and its score to 1e-6 relative (the float32 projections before
  the scores turn float64 differ by summation order).  Their ``FAST_RUN``
  graphs have the JAX package's op counts but its known twins (above) and
  one ``Alloc`` the JAX package folds into a constant (the port's
  ``Alloc`` never folds: a fill on the device costs less than a host
  array copied there).
- A random stream drawn in a scan body steps its key every step (dropout
  in a loop), the JAX package's values; a loop state that starts as a
  ``broadcast_to`` view is copied before the loop writes it in place.
- The bounds raise.
"""

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.models.decoder import DecoderLM as JLM
from aesara_tpu.models.serve import ContinuousBatcher as JCB
from aesara_tpu.scan import scan as jscan
from aesara_tpu.tensor.extra_ops import repeat as jrepeat
from aesara_tpu.tensor.math import batched_dot as jbatched_dot
from aesara_tpu.tensor.subtensor import set_subtensor as jset_subtensor

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.models import load_state, named_state
from aesara_tpu_torch.models.decoder import DecoderLM as PLM
from aesara_tpu_torch.models.serve import ContinuousBatcher as PCB
from aesara_tpu_torch.scan.basic import scan as pscan
from aesara_tpu_torch.tensor.extra_ops import repeat as prepeat
from aesara_tpu_torch.tensor.math import batched_dot as pbatched_dot
from aesara_tpu_torch.tensor.subtensor import set_subtensor as pset_subtensor
from tests.test_torch_rnn import op_counts


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, LM=JLM, CB=JCB, scan=jscan, repeat=jrepeat, batched_dot=jbatched_dot,
           set_subtensor=jset_subtensor)
PORT = dict(pkg=aesara_tpu_torch, at=pat, LM=PLM, CB=PCB, scan=pscan, repeat=prepeat, batched_dot=pbatched_dot,
            set_subtensor=pset_subtensor)
SIZE = dict(vocab=50, n_layers=2, d_model=32, n_heads=4, d_ff=64, seed=0)
KV = [None, 2]      # multi-head, and grouped-query attention with 2 KV heads


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.fixture(scope="module", params=KV, ids=["mha", "gqa"])
def lms(request):
    with config.change_flags(device="cpu"):
        return JLM(**SIZE, n_kv_heads=request.param), PLM(**SIZE, n_kv_heads=request.param)


def _graph_fns(m, lm):
    """The decode functions whose op counts are compared."""
    return {"greedy": lm.generate_fn(6, 8), "prompt": lm.generate_from_prompt_fn(4, 5, 16),
            "batched": lm.generate_batched_fn(3, 6, 8)}


def test_the_seed_gives_the_jax_packages_weights(lms):
    jlm, plm = lms
    want, got = named_state(jlm), named_state(plm)
    assert list(got) == list(want) and len(got) == 1 + 12 * SIZE["n_layers"]
    for name in want:
        np.testing.assert_array_equal(got[name].get_value(), np.asarray(want[name].get_value()), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shapes", [((4, 3, 5), (4, 5, 2)), ((4, 3, 5), (4, 5)), ((4, 5), (4, 5, 2))],
                         ids=["3x3", "3x2", "2x3"])
def test_batched_dot_and_its_gradient_in_each_rank_case(shapes, dtype):
    rng = np.random.default_rng(11)
    xv, yv = (rng.normal(size=s).astype(dtype) for s in shapes)
    results = []
    for m in (JAX, PORT):
        at = m["at"]
        x = at.TensorType(dtype, (None,) * len(shapes[0]))("x")
        y = at.TensorType(dtype, (None,) * len(shapes[1]))("y")
        out = m["batched_dot"](x, y)
        cost = at.sum(out * out)
        results.append([_host(v) for v in m["pkg"].function([x, y], [out] + m["pkg"].grad(cost, [x, y]))(xv, yv)])
    want, got = results
    np.testing.assert_allclose(want[0], np.einsum({3: "bij,bjk->bik", 2: "bij,bj->bi"}[len(shapes[1])]
                                                  if len(shapes[0]) == 3 else "bi,bij->bj", xv, yv),
                               atol=1e-5, rtol=1e-5)
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)


def test_repeat_and_its_gradient():
    xv = np.random.default_rng(12).normal(size=(2, 3, 4))
    results = []
    for m in (JAX, PORT):
        at = m["at"]
        x = at.tensor3("x", dtype="float64")
        outs = [m["repeat"](x, 2, axis=0), m["repeat"](x, 3, axis=2), m["repeat"](x, np.array([1, 0, 2]), axis=1),
                m["repeat"](x[0, 0], 2)]
        cost = at.sum(outs[0] * outs[0]) + at.sum(outs[1])
        results.append([_host(v) for v in m["pkg"].function([x], outs + [m["pkg"].grad(cost, x)])(xv)])
    for w, g in zip(*results):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(results[1][2], np.repeat(xv, [1, 0, 2], axis=1))


def test_a_repeat_count_from_data_refuses_to_compile():
    x, n = pat.vector("x"), pat.lscalar("n")
    with pytest.raises(NotImplementedError, match="repeat count computed at run time"):
        aesara_tpu_torch.function([x, n], prepeat(x, n))


def test_loss_and_every_gradient(lms):
    tv = np.random.default_rng(0).integers(0, SIZE["vocab"], size=12).astype("int64")
    results = []
    for m, lm in zip((JAX, PORT), lms):
        toks = m["at"].lvector("toks")
        loss = lm.loss(toks)
        results.append([_host(v) for v in m["pkg"].function([toks], [loss] + m["pkg"].grad(loss, lm.params))(tv)])
    want, got = results
    assert len(got) == 1 + len(lms[1].params)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_greedy_prompt_and_batched_tokens_are_the_jax_packages(lms):
    jlm, plm = lms
    calls = [(lambda lm: lm.generate_fn(6, 8), np.int64(3)),
             (lambda lm: lm.generate_from_prompt_fn(4, 5, 16), np.array([5, 9, 2, 7], dtype="int64")),
             (lambda lm: lm.generate_from_prompt_fn(2, 1, 8), np.array([1, 2], dtype="int64")),
             (lambda lm: lm.generate_batched_fn(3, 6, 8), np.array([3, 7, 11], dtype="int64"))]
    for build, arg in calls:
        want = np.asarray(build(jlm)(arg))
        f = build(plm)
        got, again = _host(f(arg)), _host(f(arg))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(again, want)
    # each batched stream is its single stream
    single = plm.generate_fn(6, 8)
    batched = _host(plm.generate_batched_fn(3, 6, 8)(np.array([3, 7, 11], dtype="int64")))
    for j, t0 in enumerate([3, 7, 11]):
        np.testing.assert_array_equal(batched[:, j], _host(single(np.int64(t0))))


def test_decode_logits_are_full_forwards_at_each_position(lms):
    """The cached single-token step, run over a sequence position by
    position, gives at each position the logits the full-sequence forward
    gives there."""
    _, lm = lms
    seq = np.array([3, 17, 4, 40, 9, 22], dtype="int64")
    T = len(seq)
    Kv, dh = lm.layers[0].n_kv_heads, lm.layers[0].d_head
    toks = pat.lvector("toks")
    caches = [pat.zeros((T, Kv, dh), dtype="float32") for _ in range(2 * len(lm.layers))]
    steps = []
    for t in range(T):
        h = lm.embed[toks[t]]
        for i, layer in enumerate(lm.layers):
            h, caches[2 * i], caches[2 * i + 1] = layer.step(h, caches[2 * i], caches[2 * i + 1], np.int64(t))
        steps.append(pat.dot(h, lm.embed.T))
    h = lm.embed[toks]
    for layer in lm.layers:
        h = layer.full(h)
    f = aesara_tpu_torch.function([toks], [pat.stack(steps), pat.dot(h, lm.embed.T)])
    cached, full = (_host(v) for v in f(seq))
    assert cached.shape == full.shape == (T, SIZE["vocab"])
    np.testing.assert_allclose(cached, full, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("which", ["greedy", "prompt", "batched", "decode chunk 1", "decode chunk 3", "prefill"])
def test_fast_run_graphs_have_the_jax_packages_op_counts(lms, which):
    counts = []
    for m, lm in zip((JAX, PORT), lms):
        if which.startswith("decode") or which == "prefill":
            srv = m["CB"](lm, 2, 64, 8, chunk=int(which[-1]) if which.startswith("decode") else 1)
            f = srv._prefill if which == "prefill" else srv._decode
        else:
            f = _graph_fns(m, lm)[which]
        counts.append(op_counts(f.maker.fgraph))
    want, got = counts
    # the JAX package's unmerged twins (module docstring)
    if which == "prompt":
        assert want[0]["Reshape"] == got[0]["Reshape"] + 2 * SIZE["n_layers"]
        want[0]["Reshape"] = got[0]["Reshape"]
    if which == "decode chunk 1":
        assert want[0]["Elemwise{EQ}"] == SIZE["n_layers"] and got[0]["Elemwise{EQ}"] == 1
        want[0]["Elemwise{EQ}"] = 1
    assert got == want
    # the caches are final-only states, the tokens stacked
    for info, _ in got[1:]:
        assert "final_only=(False, True, True, True, True, True)" in info


def test_the_decode_loop_writes_its_caches_in_place(lms):
    """Each cache's storage stays the same across the steps of a call,
    and the initial value (the zeros the linker uploads once for the key)
    is not written: a second call gives the same tokens."""
    _, lm = lms
    f = lm.generate_fn(6, 8)
    program = f.fn.program
    scan_node = next(n for n in program.order if type(n.op).__name__ == "Scan")
    scan = program.fns[program.order.index(scan_node)]
    assert scan.owned == [2, 3, 4, 5]       # every cache; the token and the position are carried as they are
    inner = scan.program
    seen = []
    run = inner.run

    def spy(args, uploads):
        seen.append([a.untyped_storage().data_ptr() for a in args[2:6]])
        return run(args, uploads)

    inner.run = spy
    try:
        first = _host(f(np.int64(3)))
        ptrs_first = seen[:]
        seen.clear()
        second = _host(f(np.int64(3)))
    finally:
        inner.run = run
    np.testing.assert_array_equal(first, second)
    assert len(ptrs_first) == 6 and all(p == ptrs_first[0] for p in ptrs_first)
    assert len(set(ptrs_first[0])) == 4


def test_a_caller_given_state_is_not_written_and_a_stacked_state_clones():
    """An initial state that is a function input is left as the caller gave
    it; a recurrent state that is stacked (every step kept) is not owned
    by the loop, and its set_subtensor clones, as the JAX package's values
    show."""
    def build(m, stacked):
        at = m["at"]
        c0, v = at.matrix("c0", dtype="float64"), at.vector("v", dtype="float64")

        cs, _ = m["scan"](lambda i, c: m["set_subtensor"](c[i], v * (i + 1.0)), sequences=[at.arange(3)],
                          outputs_info=[c0])
        return m["pkg"].function([c0, v], cs if stacked else cs[-1])

    c0 = np.zeros((3, 2))
    vv = np.array([1.0, -2.0])
    for stacked in (False, True):
        fj, fp = build(JAX, stacked), build(PORT, stacked)
        arg = torch.zeros((3, 2), dtype=torch.float64)
        got = _host(fp(arg, vv))
        np.testing.assert_array_equal(got, np.asarray(fj(c0, vv)))
        assert not bool(arg.any())
        node = next(n for n in fp.fn.program.order if type(n.op).__name__ == "Scan")
        scan = fp.fn.program.fns[fp.fn.program.order.index(node)]
        assert scan.owned == ([] if stacked else [0])


def test_state_carries_across_packages_by_qualified_name(lms):
    """A trained or perturbed JAX model is carried into a port model of
    another seed by ``named_state``/``load_state``: the tokens follow."""
    jlm, _ = lms
    kv = jlm.layers[0].n_kv_heads if jlm.layers[0].n_kv_heads != jlm.layers[0].n_heads else None
    j2 = JLM(**dict(SIZE, seed=1), n_kv_heads=kv)
    rng = np.random.default_rng(5)
    for p in j2.params:
        v = np.asarray(p.get_value())
        p.set_value(v + rng.normal(size=v.shape).astype(v.dtype) * 0.5)
    p2 = PLM(**SIZE, n_kv_heads=kv)
    load_state(p2, named_state(j2))
    np.testing.assert_array_equal(_host(p2.generate_fn(6, 8)(np.int64(4))),
                                  np.asarray(j2.generate_fn(6, 8)(np.int64(4))))
    with pytest.raises(ValueError, match="names"):
        load_state(p2, dict(list(named_state(j2).items())[1:]))


def test_bounds_and_the_cut_features_raise(lms):
    """The bounds of every entry point, the sampling, speculative and beam
    ones among them, raise before anything is compiled."""
    _, lm = lms
    with pytest.raises(ValueError, match="t_max"):
        lm.generate_fn(n_steps=6, t_max=4)
    with pytest.raises(ValueError, match="t_max"):
        lm.generate_batched_fn(batch=2, n_steps=6, t_max=4)
    with pytest.raises(ValueError, match="t_max"):
        lm.generate_from_prompt_fn(prompt_len=6, n_new=4, t_max=8)
    with pytest.raises(ValueError, match="t_max"):
        lm.generate_fn(6, 4, temperature=1.0, top_k=3)
    with pytest.raises(ValueError, match="t_max"):
        lm.speculative_generate_fn(lm, 4, 4, 11, n_spec=4)
    with pytest.raises(ValueError, match="n_spec"):
        lm.speculative_generate_fn(lm, 4, 4, 16, n_spec=0)
    with pytest.raises(ValueError, match="vocabulary"):
        lm.speculative_generate_fn(PLM(**dict(SIZE, vocab=40)), 4, 4, 16)
    with pytest.raises(ValueError, match="t_max"):
        lm.beam_search_fn(4, 4, 7)
    with pytest.raises(ValueError, match="beam"):
        lm.beam_search_fn(4, 4, 16, beam=0)


SAMPLING = [(1.0, 0), (0.8, 5)]


@pytest.mark.parametrize("temperature,top_k", SAMPLING, ids=["t1", "t0.8-top5"])
def test_sampling_tokens_are_the_jax_packages_call_for_call(lms, temperature, top_k):
    jlm, plm = lms
    fj = jlm.generate_fn(8, 10, temperature=temperature, top_k=top_k)
    fp = plm.generate_fn(8, 10, temperature=temperature, top_k=top_k)
    calls = []
    for _ in range(3):
        want, got = np.asarray(fj(np.int64(3))), _host(fp(np.int64(3)))
        np.testing.assert_array_equal(got, want)
        calls.append(got)
    greedy = _host(plm.generate_fn(8, 10)(np.int64(3)))
    assert any(not np.array_equal(c, greedy) for c in calls)
    assert any(not np.array_equal(calls[0], c) for c in calls[1:])


def _spec_and_beam(m, lm):
    draft = m["LM"](**dict(SIZE, n_layers=1, seed=1), n_kv_heads=lm.layers[0].n_kv_heads
                    if lm.layers[0].n_kv_heads != lm.layers[0].n_heads else None)
    beam = lm.beam_search_fn(4, 3, 24, beam=3)
    return {"sample": lm.generate_fn(8, 10, temperature=1.0, top_k=5),
            "speculative": lm.speculative_generate_fn(draft, 4, 9, 24, n_spec=3),
            "beam": next(c.cell_contents for c in beam.__closure__ if hasattr(c.cell_contents, "maker"))}


@pytest.mark.parametrize("which", ["sample", "speculative", "beam"])
def test_cut_feature_graphs_have_the_jax_packages_op_counts(lms, which):
    want, got = (op_counts(_spec_and_beam(m, lm)[which].maker.fgraph) for m, lm in zip((JAX, PORT), lms))
    # the JAX package's unmerged Reshape twins of the target's prefill, and
    # the Alloc of the speculative buffer it folds (module docstring)
    if which in ("speculative", "beam"):
        assert want[0]["Reshape"] == got[0]["Reshape"] + 2 * SIZE["n_layers"]
        want[0]["Reshape"] = got[0]["Reshape"]
    if which == "speculative":
        assert (want[0]["Alloc"], got[0]["Alloc"]) == (1, 2)
        want[0]["Alloc"] = 2
    assert got == want


PROMPT = np.array([5, 9, 2, 7], dtype="int64")


def test_speculative_tokens_are_the_jax_packages_and_the_targets_greedy(lms):
    jlm, plm = lms
    kv = plm.layers[0].n_kv_heads if plm.layers[0].n_kv_heads != plm.layers[0].n_heads else None
    jd, pd = (LM(**dict(SIZE, n_layers=1, seed=1), n_kv_heads=kv) for LM in (JLM, PLM))
    greedy = _host(plm.generate_from_prompt_fn(4, 9, 24)(PROMPT))
    for n_spec in (1, 3):
        want = np.asarray(jlm.speculative_generate_fn(jd, 4, 9, 24, n_spec=n_spec)(PROMPT))
        got = _host(plm.speculative_generate_fn(pd, 4, 9, 24, n_spec=n_spec)(PROMPT))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, greedy)
    # the target as its own draft accepts every proposal
    f = plm.speculative_generate_fn(plm, 4, 9, 24, n_spec=4)
    np.testing.assert_array_equal(_host(f(PROMPT)), greedy)
    assert "until" in f.fn.capture_blocker or f.fn.capture_blocker.startswith("runs on")


@pytest.mark.parametrize("beam", [1, 3, 60])
def test_beam_search_is_the_jax_packages(lms, beam):
    jlm, plm = lms
    want, want_score = jlm.beam_search_fn(4, 3, 24, beam=beam)(PROMPT)
    got, got_score = plm.beam_search_fn(4, 3, 24, beam=beam)(PROMPT)
    assert got == want
    np.testing.assert_allclose(got_score, want_score, rtol=1e-6)
    if beam == 1:
        assert got == [int(t) for t in _host(plm.generate_from_prompt_fn(4, 3, 24)(PROMPT))]
    one, _ = plm.beam_search_fn(4, 1, 24, beam=beam)(PROMPT)
    assert one == want[:1]


def test_dropout_in_a_scan_draws_with_a_key_a_step():
    """A bernoulli mask drawn in the body: the key rides the loop, so every
    step's mask is new; two calls of the function, the JAX package's values."""
    x0 = np.random.default_rng(2).normal(size=(6, 16))
    results = []
    for m in (JAX, PORT):
        rs = __import__(f"{m['pkg'].__name__}.tensor.random.utils", fromlist=["RandomStream"]).RandomStream
        at = m["at"]
        srng = rs(seed=4)
        x = at.matrix("x", dtype="float64")

        def step(xt, h):
            return at.tanh(xt * srng.bernoulli(0.5, size=(16,)) + 0.5 * h)

        hs, ups = m["scan"](step, sequences=[x], outputs_info=[at.zeros((16,), dtype="float64")])
        f = m["pkg"].function([x], hs, updates=ups)
        results.append([_host(f(x0)) for _ in range(2)])
    for want, got in zip(*results):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    masks = (results[1][0] != np.tanh(0.5 * np.vstack([np.zeros(16), results[1][0][:-1]])))
    assert len({m.tobytes() for m in masks}) == len(masks)
    assert not np.array_equal(results[1][0], results[1][1])


def test_a_broadcast_loop_state_is_copied_before_it_is_written_in_place():
    """The beam's pattern: per-row states that start as ``broadcast_to`` of
    one row (``+ 0.0`` after it, which a rewrite may drop), written in place
    by the loop a row at a time; a write through the zero-stride view would
    change every row at once."""
    results = []
    for m in (JAX, PORT):
        at = m["at"]
        xo = __import__(f"{m['pkg'].__name__}.tensor.extra_ops", fromlist=["broadcast_to"])
        c = at.vector("c", dtype="float64")
        init = xo.broadcast_to(c.dimshuffle("x", 0), (3, 4)) + 0.0

        def step(t, state):
            return m["set_subtensor"](state[t], at.cast(t, "float64") * 10.0 + 1.0)

        out, _ = m["scan"](step, sequences=[at.arange(3)], outputs_info=[init])
        f = m["pkg"].function([c], out[-1])
        results.append(_host(f(np.arange(4.0))))
        if m is PORT:
            owned = [fn.owned for fn in f.fn.program.fns if hasattr(fn, "owned")]
            assert owned == [[0]]
    want, got = results
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.tile((np.arange(3.0) * 10 + 1)[:, None], (1, 4)))
