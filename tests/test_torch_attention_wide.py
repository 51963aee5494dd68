"""K2 and K3 in float64 and at heads wider than 256.

The plain versions in float64 against the JAX package's ``_attention_ref``
and its ``jax.vjp`` with x64 (1e-12 of each reference's scale: both sum in
fp64, in other orders); in float32 at D 300 and 520 against the Pallas
kernels in interpret mode (1e-5 of the scale, as the narrower heads'
``WIDE_REL``).  On the card a head wider than 256 (128 in float64) takes
the D split: a torch model of its schedule, chunks of the output's columns
each recomputing the scores over the whole of D chunk by chunk, walked key
tiles with the online softmax and the backward's tiles, against the
unchunked plain versions (fp32 1e-6, fp64 1e-13 of the scale)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aesara_tpu.link.jax.pallas_kernels import flash_attention as jax_flash
from aesara_tpu.link.jax.pallas_kernels import flash_attention_grads as jax_flash_grads
from aesara_tpu.tensor.nnet.attention import _attention_ref

from aesara_tpu_torch.config import config
from aesara_tpu_torch.link.torch.kernels.attention import (
    attention_grads_plain, attention_plain, chunks, flash_attention, flash_attention_grads, split_chunk,
)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape) * s).astype(dtype) for s in (0.3, 0.3, 1.0, 1.0)]


def _close(got, want, rel, name):
    got, want = np.asarray(got, dtype="float64"), np.asarray(want, dtype="float64")
    assert got.shape == want.shape, name
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{name}: {err / scale:.3e} of the scale (tolerance {rel})"


FP64 = [((2, 70, 40), False), ((2, 70, 40), True), ((2, 33, 130), False), ((2, 33, 130), True)]
FP64_IDS = ["D40", "D40-causal", "D130", "D130-causal"]


@pytest.mark.parametrize("shape,causal", FP64, ids=FP64_IDS)
def test_plain_k2_k3_in_fp64_match_the_reference_with_x64(shape, causal):
    assert jax.config.jax_enable_x64
    q, k, v, do = _inputs(shape, "float64", seed=51)
    scale = float(1.0 / np.sqrt(shape[-1]))
    tq = [torch.from_numpy(a) for a in (q, k, v, do)]
    out, lse = flash_attention(*tq[:3], causal=causal, scale=scale, with_lse=True)
    grads = flash_attention_grads(*tq, causal=causal, scale=scale)
    assert out.dtype == lse.dtype == torch.float64
    jq = [jnp.asarray(a) for a in (q, k, v, do)]
    assert jq[0].dtype == jnp.float64
    _close(out, _attention_ref(*jq[:3], causal, scale), 1e-12, "out")
    s = np.einsum("btd,bsd->bts", q, k) * scale
    if causal:
        s = np.where(np.tril(np.ones(s.shape[1:], dtype=bool))[None], s, -np.inf)
    smax = s.max(-1, keepdims=True)
    _close(lse, (smax + np.log(np.exp(s - smax).sum(-1, keepdims=True)))[..., 0], 1e-12, "lse")
    _, vjp = jax.vjp(lambda q_, k_, v_: _attention_ref(q_, k_, v_, causal, scale), *jq[:3])
    for name, g, w in zip(("dq", "dk", "dv"), grads, vjp(jq[3])):
        assert g.dtype == torch.float64, name
        _close(g, w, 1e-12, name)


@pytest.mark.parametrize("D,causal", [(300, False), (300, True), (520, True)], ids=["D300", "D300-causal", "D520"])
def test_plain_k2_k3_past_256_match_pallas_interpret(D, causal):
    from jax.experimental.pallas import tpu as pltpu

    q, k, v, do = _inputs((2, 48, D), "float32", seed=53)
    scale = float(1.0 / np.sqrt(D))
    tq = [torch.from_numpy(a) for a in (q, k, v, do)]
    out = flash_attention(*tq[:3], causal=causal, scale=scale)
    grads = flash_attention_grads(*tq, causal=causal, scale=scale)
    jq = [jnp.asarray(a) for a in (q, k, v, do)]
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash(*jq[:3], causal=causal, scale=scale)
        want_grads = jax_flash_grads(*jq, causal=causal, scale=scale)
    _close(out, want, 1e-5, "out vs Pallas")
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        _close(g, w, 1e-5, f"{name} vs Pallas")


# --- a model of the D split's schedule ------------------------------------------

OWN, WALK = 64, 16


def _mask(s, q0, k0, T, causal):
    qr = torch.arange(q0, q0 + s.shape[-2])[:, None]
    kc = torch.arange(k0, k0 + s.shape[-1])[None, :]
    valid = (qr < T) & (kc < T) & ((kc <= qr) if causal else True)
    return s.masked_fill(~valid, float("-inf"))


def _scores(a, b, DC):
    """a bᵀ over the whole of D, taken chunk by chunk in one order, as each
    block of the split takes it."""
    s = torch.zeros(a.shape[:-1] + b.shape[-2:-1], dtype=a.dtype)
    for d0 in range(0, a.shape[-1], DC):
        s = s + a[..., d0:d0 + DC] @ b[..., d0:d0 + DC].transpose(-1, -2)
    return s


def split_forward(q, k, v, causal, scale, DC):
    """(O, lse) as the split's blocks compute them: for each block of 64
    rows and each chunk of DC output columns, the walked key tiles' scores
    over all of D, the online softmax (log2 units), O_c += P V_c."""
    BH, T, D = q.shape
    log2e = 1.0 / np.log(2.0)
    out = torch.zeros_like(q)
    lse = torch.zeros((BH, T), dtype=q.dtype)
    for q0 in range(0, T, OWN):
        qs = q[:, q0:q0 + OWN]
        for c0 in range(0, D, DC):
            m = torch.full(qs.shape[:2], float("-inf"), dtype=q.dtype)
            l = torch.zeros(qs.shape[:2], dtype=q.dtype)
            acc = torch.zeros(qs.shape[:2] + (min(DC, D - c0),), dtype=q.dtype)
            for k0 in range(0, min(T, q0 + OWN) if causal else T, WALK):
                s = _mask(_scores(qs, k[:, k0:k0 + WALK], DC) * (scale * log2e), q0, k0, T, causal)
                m_new = torch.maximum(m, s.amax(-1))
                mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
                alpha = torch.exp2(m - mu)
                p = torch.exp2(s - mu[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p @ v[:, k0:k0 + WALK, c0:c0 + DC]
                m = m_new
            out[:, q0:q0 + OWN, c0:c0 + DC] = acc / l[..., None]
            if c0 == 0:
                lse[:, q0:q0 + OWN] = (m + torch.log2(l)) / log2e
    return out, lse


def split_backward(q, k, v, do, causal, scale, DC):
    """(dQ, dK, dV) as the split's three kernels compute them: D from dO
    and O over the whole row; the dq blocks walk key tiles (S and dP over
    all of D, dQ_c += dS K_c); the dK and dV passes walk query tiles."""
    BH, T, D = q.shape
    o, lse = split_forward(q, k, v, causal, scale, DC)
    delta = (do * o).sum(-1)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    for r0 in range(0, T, OWN):
        rows = slice(r0, r0 + OWN)
        for c0 in range(0, D, DC):
            cols = slice(c0, c0 + DC)
            for k0 in range(0, min(T, r0 + OWN) if causal else T, WALK):
                keys = slice(k0, k0 + WALK)
                s = _mask(_scores(q[:, rows], k[:, keys], DC) * scale, r0, k0, T, causal)
                p = torch.exp(s - lse[:, rows, None])
                ds = p * (_scores(do[:, rows], v[:, keys], DC) - delta[:, rows, None])
                dq[:, rows, cols] += ds @ k[:, keys, cols] * scale
            for q0 in range((r0 // WALK) * WALK if causal else 0, T, WALK):
                qs = slice(q0, q0 + WALK)
                s = _mask(_scores(q[:, qs], k[:, rows], DC) * scale, q0, r0, T, causal)
                p = torch.exp(s - lse[:, qs, None])
                ds = p * (_scores(do[:, qs], v[:, rows], DC) - delta[:, qs, None])
                dk[:, rows, cols] += ds.transpose(-1, -2) @ q[:, qs, cols] * scale
                dv[:, rows, cols] += p.transpose(-1, -2) @ do[:, qs, cols]
    return dq, dk, dv


@pytest.mark.parametrize("dtype,D,causal,rel", [
    (torch.float32, 300, False, 1e-6), (torch.float32, 520, True, 1e-6),
    (torch.float64, 200, True, 1e-13), (torch.float64, 300, False, 1e-13)],
    ids=["fp32-D300", "fp32-D520-causal", "fp64-D200-causal", "fp64-D300"])
def test_the_d_split_schedule_matches_the_unchunked_plain_versions(dtype, D, causal, rel):
    DC = split_chunk(dtype)
    assert chunks(D, dtype) == -(-D // DC) > 1
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _inputs((2, 90, D), "float64", seed=55))
    scale = float(1.0 / np.sqrt(D))
    out, lse = split_forward(q, k, v, causal, scale, DC)
    want, want_lse = attention_plain(q, k, v, causal, scale, with_lse=True)
    _close(out, want, rel, "out")
    _close(lse, want_lse, rel, "lse")
    for name, g, w in zip(("dq", "dk", "dv"), split_backward(q, k, v, do, causal, scale, DC),
                          attention_grads_plain(q, k, v, do, causal, scale)):
        _close(g, w, rel, name)


def test_split_chunk_and_chunks():
    assert (split_chunk(torch.float32), split_chunk(torch.bfloat16), split_chunk(torch.float64)) == (256, 256, 128)
    assert [chunks(D, torch.float32) for D in (64, 256, 257, 384, 512, 1024)] == [1, 1, 2, 2, 2, 4]
    assert [chunks(D, torch.float64) for D in (64, 128, 129, 256, 384)] == [1, 1, 2, 2, 3]
