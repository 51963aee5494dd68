"""K2, the flash-attention forward: its plain PyTorch version against the
JAX package's Pallas flash kernel (interpret mode) and ``_attention_ref``,
and its row logsumexp against scipy's.  Tolerance atol 2e-5, rtol 1e-4
(the three sum in different orders)."""

import numpy as np
import pytest
import torch
from scipy.special import logsumexp

import jax.numpy as jnp

from aesara_tpu.link.jax.pallas_kernels import flash_attention as jax_flash
from aesara_tpu.tensor.nnet.attention import _attention_ref

from aesara_tpu_torch.link.torch.kernels.attention import flash_attention
from aesara_tpu_torch.tensor.nnet.attention import attention_ref_numpy

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
