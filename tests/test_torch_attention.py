"""K2, the flash-attention forward, and K3, its backward.  K2's plain
PyTorch version against the JAX package's Pallas flash kernel
(interpret mode) and ``_attention_ref``, and its row logsumexp against
scipy's: atol 2e-5, rtol 1e-4 (the three sum in different orders).
K3's plain version against ``flash_attention_grads`` in interpret mode
and ``jax.vjp`` of ``_attention_ref``: atol 5e-4, rtol 1e-3, the JAX
package's own tolerance for its backward kernel
(``tests/link/test_pallas.py:92-95``)."""

import numpy as np
import pytest
import torch
from scipy.special import logsumexp

import jax
import jax.numpy as jnp

from aesara_tpu.link.jax.pallas_kernels import flash_attention as jax_flash
from aesara_tpu.link.jax.pallas_kernels import flash_attention_grads as jax_flash_grads
from aesara_tpu.tensor.nnet.attention import _attention_ref

from aesara_tpu_torch.link.torch.kernels.attention import flash_attention, flash_attention_grads
from aesara_tpu_torch.tensor.nnet.attention import attention_grads_ref_numpy, attention_ref_numpy
from aesara_tpu_torch.config import config


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


SHAPES = [((2, 96, 64), False), ((2, 96, 64), True), ((1, 160, 40), True),
          ((1, 1100, 64), True)]
IDS = ["plain", "causal", "oddshape", "multitile-causal"]


def _qkv(shape, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=shape).astype("float32") * 0.3
    k = rng.normal(size=shape).astype("float32") * 0.3
    v = rng.normal(size=shape).astype("float32")
    return q, k, v


@pytest.mark.parametrize("shape,causal", SHAPES, ids=IDS)
def test_plain_k2_matches_pallas_interpret_and_reference(shape, causal):
    from jax.experimental.pallas import tpu as pltpu

    q, k, v = _qkv(shape)
    scale = float(1.0 / np.sqrt(shape[-1]))
    before = flash_attention.plain_calls
    got, lse = flash_attention(*[torch.from_numpy(a) for a in (q, k, v)],
                               causal=causal, scale=scale, with_lse=True)
    assert flash_attention.plain_calls == before + 1
    got = got.numpy()
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=causal, scale=scale))
    want_ref = np.asarray(_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal, scale))
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want_pallas, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, want_ref, atol=2e-5, rtol=1e-4)

    s = np.einsum("btd,bsd->bts", q.astype("float64"), k.astype("float64")) * scale
    if causal:
        s = np.where(np.tril(np.ones(s.shape[1:], dtype=bool))[None], s, -np.inf)
    assert lse.shape == shape[:2] and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), logsumexp(s, axis=-1), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True], ids=["plain", "causal"])
def test_op_perform_matches_plain_k2(causal):
    q, k, v = _qkv((3, 33, 16), seed=5)
    want = attention_ref_numpy(q, k, v, causal, 0.25)
    got = flash_attention(*[torch.from_numpy(a) for a in (q, k, v)], causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_plain_k2_bfloat16_runs_in_fp32():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 40, 32), seed=9))
    got = flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=True)
    want = flash_attention(q.bfloat16().float(), k.bfloat16().float(), v.bfloat16().float(),
                           causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2, rtol=0)


GRAD_SHAPES = [((2, 96, 64), False), ((2, 96, 64), True), ((1, 160, 40), False),
               ((1, 160, 40), True)]
GRAD_IDS = ["plain", "causal", "oddshape", "oddshape-causal"]


@pytest.mark.parametrize("shape,causal", GRAD_SHAPES, ids=GRAD_IDS)
def test_plain_k3_matches_pallas_interpret_and_vjp(shape, causal):
    from jax.experimental.pallas import tpu as pltpu

    q, k, v = _qkv(shape, seed=11)
    do = np.random.default_rng(12).normal(size=shape).astype("float32")
    scale = float(1.0 / np.sqrt(shape[-1]))
    before = flash_attention_grads.plain_calls
    got = flash_attention_grads(*[torch.from_numpy(a) for a in (q, k, v, do)],
                                causal=causal, scale=scale)
    assert flash_attention_grads.plain_calls == before + 1

    _, vjp = jax.vjp(lambda q_, k_, v_: _attention_ref(q_, k_, v_, causal, scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_vjp = vjp(jnp.asarray(do))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = jax_flash_grads(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(do), causal=causal, scale=scale)
    for name, g, wp, wv in zip(("dq", "dk", "dv"), got, want_pallas, want_vjp):
        assert g.shape == shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(wp), atol=5e-4, rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=5e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("causal", [False, True], ids=["plain", "causal"])
def test_grad_op_perform_matches_plain_k3(causal):
    q, k, v = _qkv((3, 33, 16), seed=13)
    do = np.random.default_rng(14).normal(size=q.shape).astype("float32")
    want = attention_grads_ref_numpy(q, k, v, do, causal, 0.25)
    got = flash_attention_grads(*[torch.from_numpy(a) for a in (q, k, v, do)], causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5, rtol=1e-4)


def test_plain_k3_bfloat16_runs_in_fp32_and_casts_dout():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 40, 32), seed=15))
    do = torch.from_numpy(np.random.default_rng(16).normal(size=(2, 40, 32)).astype("float32"))
    got = flash_attention_grads(q.bfloat16(), k.bfloat16(), v.bfloat16(), do, causal=True)
    want = flash_attention_grads(q.bfloat16().float(), k.bfloat16().float(), v.bfloat16().float(),
                                 do.bfloat16().float(), causal=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), atol=2e-2, rtol=0)
