"""The decoder's serving modules of the port against the JAX package's,
on the CPU: int8 weights (``aesara_tpu_torch/models/quant.py`` against
``aesara_tpu/models/quant.py``) and continuous batching
(``aesara_tpu_torch/models/serve.py`` against ``aesara_tpu/models/
serve.py``), at the sizes of ``tests/models/test_quant.py`` and
``tests/models/test_continuous_batching.py``.

- ``quantize_array_int8`` gives the JAX package's int8 values and scales
  bit for bit; a quantized decoder decodes the JAX package's tokens, its
  state carries across by qualified name, and it does not follow the
  original model's later changes.
- ``ContinuousBatcher`` gives each request the JAX package's batcher's
  tokens, and its own per-request ``generate_from_prompt_fn``'s: with
  slot recycling, admission mid-flight, EOS retirement, ``chunk`` 1, 3,
  4 and 8; its prompt lengths 1-8 run on the 4 rungs of the bucket
  ladder (4 keys of ``_prefill``); its guards raise.
"""

import numpy as np
import pytest
import torch

from aesara_tpu.models.decoder import DecoderLM as JLM
from aesara_tpu.models.quant import quantize_array_int8 as jquantize, quantize_decoder_int8 as jquantize_lm
from aesara_tpu.models.serve import ContinuousBatcher as JCB

from aesara_tpu_torch.config import config
from aesara_tpu_torch.models import load_state, named_state
from aesara_tpu_torch.models.decoder import DecoderLM as PLM
from aesara_tpu_torch.models.quant import quantize_array_int8 as pquantize, quantize_decoder_int8 as pquantize_lm
from aesara_tpu_torch.models.serve import ContinuousBatcher as PCB


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


V = 50


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("shape", [(64, 32), (7, 5, 3), (16,)])
def test_quantize_array_int8_is_the_jax_packages_bit_for_bit(shape):
    w = np.random.default_rng(0).standard_normal(shape).astype("float32")
    (jq, js), (pq, ps) = jquantize(w), pquantize(w)
    assert pq.dtype == np.int8 and ps.dtype == np.float32
    np.testing.assert_array_equal(pq, jq)
    np.testing.assert_array_equal(ps.view("int32"), js.view("int32"))


@pytest.mark.parametrize("kv", [None, 2], ids=["mha", "gqa"])
def test_quantized_decode_is_the_jax_packages(kv):
    size = dict(vocab=V, n_layers=2, d_model=32, n_heads=4, d_ff=64, seed=0, n_kv_heads=kv)
    jq, pq = jquantize_lm(JLM(**size)), pquantize_lm(PLM(**size))
    assert pq.params == [] and len(pq.quantized_shareds) == 2 * (6 * 2 + 1)
    assert [v.type.dtype for v in pq.quantized_shareds[:2]] == ["int8", "float32"]
    want, got = named_state(jq), named_state(pq)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name].get_value(), np.asarray(want[name].get_value()), err_msg=name)
    for build, arg in ((lambda m: m.generate_fn(6, 8), np.int64(3)),
                       (lambda m: m.generate_batched_fn(2, 5, 8), np.array([1, 9], dtype="int64")),
                       (lambda m: m.generate_from_prompt_fn(3, 4, 12), np.array([2, 4, 6], dtype="int64"))):
        np.testing.assert_array_equal(_host(build(pq)(arg)), np.asarray(build(jq)(arg)))


def test_quantized_state_carries_and_the_copy_is_isolated():
    size = dict(vocab=20, n_layers=1, d_model=16, n_heads=2, d_ff=32)
    jlm = JLM(**size, seed=3)
    rng = np.random.default_rng(4)
    for p in jlm.params:
        v = np.asarray(p.get_value())
        p.set_value(v + rng.normal(size=v.shape).astype(v.dtype) * 0.3)
    jq = jquantize_lm(jlm)
    plm = PLM(**size, seed=0)
    pq = pquantize_lm(plm)
    load_state(pq, named_state(jq))
    gen = pq.generate_fn(5, 8)
    before = _host(gen(np.int64(2)))
    np.testing.assert_array_equal(before, np.asarray(jq.generate_fn(5, 8)(np.int64(2))))
    # the original keeps training: the serving copy does not follow
    w_before = plm.layers[0].wq.get_value().copy()
    plm.layers[0].ln1_g.set_value(plm.layers[0].ln1_g.get_value() * 5.0)
    plm.layers[0].b2.set_value(plm.layers[0].b2.get_value() + 3.0)
    np.testing.assert_array_equal(_host(gen(np.int64(2))), before)
    np.testing.assert_array_equal(plm.layers[0].wq.get_value(), w_before)
    assert plm.params


@pytest.fixture(scope="module")
def models():
    """The batcher tests' model, perturbed from seed 5 as the JAX
    package's test does, in both packages."""
    with config.change_flags(device="cpu"):
        j = JLM(V, n_layers=2, d_model=16, n_heads=4, d_ff=32, seed=0)
        r = np.random.default_rng(5)
        for p in j.params:
            v = np.asarray(p.get_value())
            p.set_value(v + r.normal(size=v.shape).astype(v.dtype) * 0.8)
        p = PLM(V, n_layers=2, d_model=16, n_heads=4, d_ff=32, seed=0)
        load_state(p, named_state(j))
        return j, p


def _drain(srv, queue, n_new, eos=None):
    rids, results = {}, {}
    while queue or srv.pending():
        while queue and srv.free_slots():
            i, p = queue.pop(0)
            rids[srv.submit(p, max_new=n_new, eos=eos)] = i
        srv.step()
        for rid in list(rids):
            if rid in srv._done:
                results[rids.pop(rid)] = srv.result(rid)
    return results


def _refs(lm, prompts, n_new):
    return {i: [int(t) for t in _host(lm.generate_from_prompt_fn(len(p), n_new, 64)(p))]
            for i, p in enumerate(prompts)}


@pytest.mark.parametrize("chunk", [1, 3, 4, 8])
def test_recycled_slots_give_each_request_the_jax_packages_tokens(models, chunk):
    jm, pm = models
    rng = np.random.default_rng(0 if chunk == 1 else 3)
    prompts = [rng.integers(0, V, size=n).astype("int64") for n in ((4, 6, 8, 5) if chunk == 1 else (4, 7))]
    n_new = 10 if chunk == 1 else 11        # 11: no multiple of the chunk
    # 2 slots for 4 requests: recycling and staggered depths
    want = _drain(JCB(jm, n_slots=2, t_max=64, t_pad=8, chunk=chunk), list(enumerate(prompts)), n_new)
    got = _drain(PCB(pm, n_slots=2, t_max=64, t_pad=8, chunk=chunk), list(enumerate(prompts)), n_new)
    assert got == want
    assert got == _refs(pm, prompts, n_new)


@pytest.mark.parametrize("chunk", [1, 4])
def test_admission_mid_flight_and_eos_as_the_jax_package(models, chunk):
    jm, pm = models
    rng = np.random.default_rng(1)
    p1, p2 = rng.integers(0, V, size=6).astype("int64"), rng.integers(0, V, size=4).astype("int64")
    outs = []
    for CB, lm in ((JCB, jm), (PCB, pm)):
        srv = CB(lm, n_slots=2, t_max=64, t_pad=8, chunk=chunk)
        r1 = srv.submit(p1, max_new=8)
        for _ in range(3):
            srv.step()
        r2 = srv.submit(p2, max_new=8)
        while srv.pending():
            srv.step()
        outs.append((srv.result(r1), srv.result(r2)))
    assert outs[1] == outs[0]
    assert list(outs[1]) == [_refs(pm, [p], 8)[0] for p in (p1, p2)]
    # EOS: retirement at its first occurrence, the slot returned
    p = np.random.default_rng(2).integers(0, V, size=5).astype("int64")
    ref = _refs(pm, [p], 12)[0]
    eos = ref[3]
    got = []
    for CB, lm in ((JCB, jm), (PCB, pm)):
        srv = CB(lm, n_slots=1, t_max=64, t_pad=8, chunk=chunk)
        rid = srv.submit(p, max_new=12, eos=eos)
        while srv.pending():
            srv.step()
        assert srv.free_slots() == 1
        got.append(srv.result(rid))
    assert got[1] == got[0] == ref[:ref.index(eos) + 1]


def test_prompt_lengths_run_on_the_rungs_of_the_ladder(models):
    jm, pm = models
    rng = np.random.default_rng(3)
    jsrv, psrv = JCB(jm, n_slots=1, t_max=64, t_pad=8), PCB(pm, n_slots=1, t_max=64, t_pad=8)
    assert psrv._prompt_buckets == jsrv._prompt_buckets == "1,2,4,8"
    for n in range(1, 9):
        p = rng.integers(0, V, size=n).astype("int64")
        got = []
        for srv in (jsrv, psrv):
            rid = srv.submit(p, max_new=3)
            while rid not in srv._done:
                srv.step()
            got.append(srv.result(rid))
        assert got[1] == got[0] == _refs(pm, [p], 3)[0], n
    # rungs 1, 2, 4, 8: one key each for lengths 1..8
    assert psrv._prefill.keys_made == 4


def test_submit_guards(models):
    _, pm = models
    srv = PCB(pm, n_slots=1, t_max=32, t_pad=8)
    with pytest.raises(ValueError, match="t_pad"):
        srv.submit(list(range(9)), max_new=4)
    with pytest.raises(ValueError, match="t_max"):
        srv.submit([1, 2], max_new=40)
    with pytest.raises(ValueError, match="empty"):
        srv.submit([], max_new=4)
    with pytest.raises(ValueError, match="max_new"):
        srv.submit([1, 2], max_new=0)
    rid = srv.submit([1, 2, 3], max_new=4)
    with pytest.raises(RuntimeError, match="free slot"):
        srv.submit([4, 5], max_new=4)
    while srv.pending():
        srv.step()
    assert len(srv.result(rid)) == 4
    with pytest.raises(ValueError, match="t_pad"):
        PCB(pm, n_slots=1, t_max=8, t_pad=16)
