"""K2, the flash-attention forward, and K3, its backward.  K2's plain
PyTorch version against the JAX package's Pallas flash kernel
(interpret mode) and ``_attention_ref``, and its row logsumexp against
scipy's: atol 2e-5, rtol 1e-4 (the three sum in different orders).
K3's plain version against ``flash_attention_grads`` in interpret mode
and ``jax.vjp`` of ``_attention_ref``: atol 5e-4, rtol 1e-3, the JAX
package's own tolerance for its backward kernel
(``tests/link/test_pallas.py:92-95``).  On the card K2 and K3 take their
products on the tensor cores in 3xTF32: a torch model of that scheme is
held against the same references (K2's at 1e-4, output and lse) and
against fp64."""

import numpy as np
import pytest
import torch
from scipy.special import logsumexp

import jax
import jax.numpy as jnp

from aesara_tpu.link.jax.pallas_kernels import _flash_forward, _flash_tiling
from aesara_tpu.link.jax.pallas_kernels import flash_attention as jax_flash
from aesara_tpu.link.jax.pallas_kernels import flash_attention_grads as jax_flash_grads
from aesara_tpu.tensor.nnet.attention import _attention_ref

from aesara_tpu_torch.link.torch.kernels.attention import (
    attention_grads_plain, attention_plain, cp_async_rows, cp_async_width, flash_attention,
    flash_attention_grads,
)
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


# --- K3's numerical scheme on the card: 3xTF32 -----------------------------


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away) as the
    kernel's split rounds it: add half a TF32 ulp to the bits, clear the 13
    low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as three TF32 products, the small terms first: hi = tf32(x),
    lo = tf32(x - hi), a_lo b_hi + a_hi b_lo + a_hi b_hi, fp32 sums."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _k3_model(q, k, v, do, causal, scale, mm):
    """K3's formulas (those of ``attention_grads_plain``) with the five
    products of its backward kernels taken by ``mm``; O and the lse come in
    fp32 from the forward, as K2 gives them on the card."""
    o, lse = attention_plain(q, k, v, causal, scale, with_lse=True)
    s = mm(q, k.transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        T = q.shape[1]
        p = p * torch.ones((T, T), dtype=torch.bool).tril()
    ds = p * (mm(do, v.transpose(1, 2)) - (do * o).sum(-1, keepdim=True))
    return mm(ds, k) * scale, mm(ds.transpose(1, 2), q) * scale, mm(p.transpose(1, 2), do)


TF32_SHAPES = [((2, 1024, 64), False), ((2, 1024, 64), True), ((1, 160, 40), False),
               ((1, 160, 40), True)]
TF32_IDS = ["flagship-d", "flagship-d-causal", "oddshape", "oddshape-causal"]


def _grad_inputs(shape, seed):
    q, k, v = _qkv(shape, seed=seed)
    do = np.random.default_rng(seed + 1).normal(size=shape).astype("float32")
    return q, k, v, do


@pytest.mark.parametrize("shape,causal", TF32_SHAPES, ids=TF32_IDS)
def test_3xtf32_model_of_k3_matches_pallas_interpret(shape, causal):
    from jax.experimental.pallas import tpu as pltpu

    arrays = _grad_inputs(shape, seed=21)
    scale = float(1.0 / np.sqrt(shape[-1]))
    got = _k3_model(*[torch.from_numpy(a) for a in arrays], causal, scale, _mm_3xtf32)
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash_grads(*[jnp.asarray(a) for a in arrays], causal=causal, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("shape,causal", TF32_SHAPES, ids=TF32_IDS)
def test_3xtf32_split_is_needed_and_enough(shape, causal):
    # against fp64: 3xTF32 stays within 4x of fp32's error, while one TF32
    # product (no split) is at least 10x worse than 3xTF32
    q, k, v, do = (torch.from_numpy(a) for a in _grad_inputs(shape, seed=23))
    scale = float(1.0 / np.sqrt(shape[-1]))
    exact = attention_grads_plain(q.double(), k.double(), v.double(), do.double(), causal, scale)
    fp32 = attention_grads_plain(q, k, v, do, causal, scale)
    three = _k3_model(q, k, v, do, causal, scale, _mm_3xtf32)
    one = _k3_model(q, k, v, do, causal, scale, _mm_1xtf32)

    def err(grads):
        return [(g.double() - e).abs().max().item() for g, e in zip(grads, exact)]

    for name, e32, e3, e1 in zip(("dq", "dk", "dv"), err(fp32), err(three), err(one)):
        assert e3 <= 4 * e32, (name, e3, e32)
        assert e1 >= 10 * e3, (name, e1, e3)


# --- K3's staging on the card: rows of 16 bytes ------------------------------


@pytest.mark.parametrize("D,dtype,offset", [(33, torch.float32, 0), (64, torch.float32, 1),
                                            (20, torch.bfloat16, 0), (37, torch.bfloat16, 0),
                                            (64, torch.bfloat16, 0)],
                         ids=["fp32-odd", "fp32-misaligned", "bf16-20", "bf16-odd", "bf16-aligned"])
def test_k3_rows_padded_to_16_bytes_change_no_gradient(D, dtype, offset):
    # the wrapper pads panels that 16-byte cp.async cannot stage with zero
    # columns; offset > 0 starts the panel off a 16-byte boundary
    shape = (2, 37, D)
    arrays = _grad_inputs(shape, seed=25)
    panels = []
    for a in arrays:
        base = torch.zeros(offset + a.size, dtype=dtype)
        base[offset:] = torch.from_numpy(a).reshape(-1).to(dtype)
        panels.append(base[offset:].view(shape))
    width = cp_async_width(D, panels[0].element_size())
    assert width >= D and (width * panels[0].element_size()) % 16 == 0
    assert width - D < 16 // panels[0].element_size()
    padded = [cp_async_rows(t, width) for t in panels]
    for t, pt in zip(panels, padded):
        assert pt.shape == (*shape[:2], width) and pt.data_ptr() % 16 == 0
        assert torch.equal(pt[..., :D], t) and not pt[..., D:].any()
        assert (pt is t) == (width == D and offset == 0)
    scale = float(1.0 / np.sqrt(D))
    want = attention_grads_plain(*panels, True, scale)
    got = attention_grads_plain(*padded, True, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert not g[..., D:].any(), name
        torch.testing.assert_close(g[..., :D], w, msg=name)


# --- K2's numerical scheme on the card: 3xTF32 -----------------------------


def _k2_model(q, k, v, causal, scale, mm):
    """K2's forward with its two products taken by ``mm``: S = Q Kᵀ, then
    the unnormalised P = exp(S·scale − m) against the row max m, O = P V
    divided by the row sum l, and lse = m + log l."""
    s = mm(q, k.transpose(1, 2)) * scale
    if causal:
        T = q.shape[1]
        s = s.masked_fill(~torch.ones((T, T), dtype=torch.bool).tril(), float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return mm(p, v) / l, (m + torch.log(l))[..., 0]


def _jax_flash_with_lse(q, k, v, causal, scale):
    """The JAX package's Pallas forward in interpret mode, with its row
    logsumexp (log2 units there) in natural log."""
    from jax.experimental.pallas import tpu as pltpu

    BH, T, D = q.shape
    BQ, BK, T_pad, D_pad = _flash_tiling(T, D, q.dtype, causal)

    def pad(a):
        return jnp.pad(jnp.asarray(a), ((0, 0), (0, T_pad - T), (0, D_pad - D)))

    with pltpu.force_tpu_interpret_mode():
        out, lse2 = _flash_forward(pad(q), pad(k), pad(v), T=T, causal=causal, scale=scale,
                                   dot_dtype=jnp.float32, BQ=BQ, BK=BK, T_pad=T_pad, D_pad=D_pad,
                                   with_lse=True)
    return np.asarray(out)[:, :T, :D], np.asarray(lse2)[:, :T, 0] * np.log(2.0)


@pytest.mark.parametrize("shape,causal", TF32_SHAPES, ids=TF32_IDS)
def test_3xtf32_model_of_k2_matches_pallas_interpret(shape, causal):
    q, k, v = _qkv(shape, seed=31)
    scale = float(1.0 / np.sqrt(shape[-1]))
    got, lse = _k2_model(*[torch.from_numpy(a) for a in (q, k, v)], causal, scale, _mm_3xtf32)
    want, want_lse = _jax_flash_with_lse(q, k, v, causal, scale)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape,causal", TF32_SHAPES, ids=TF32_IDS)
def test_3xtf32_split_is_needed_and_enough_for_k2(shape, causal):
    # against fp64: 3xTF32 stays within 4x of fp32's error in the output and
    # the lse, while one TF32 product (no split) is at least 10x worse than
    # 3xTF32 in the output (the lse, a log of a sum, averages the products'
    # errors: 7x to 96x worse at these shapes)
    q, k, v = (torch.from_numpy(a) for a in _qkv(shape, seed=33))
    scale = float(1.0 / np.sqrt(shape[-1]))
    exact = attention_plain(q.double(), k.double(), v.double(), causal, scale, with_lse=True)
    fp32 = attention_plain(q, k, v, causal, scale, with_lse=True)
    three = _k2_model(q, k, v, causal, scale, _mm_3xtf32)
    one = _k2_model(q, k, v, causal, scale, _mm_1xtf32)

    def err(pair):
        return [(a.double() - e.double()).abs().max().item() for a, e in zip(pair, exact)]

    for name, e32, e3 in zip(("out", "lse"), err(fp32), err(three)):
        assert e3 <= 4 * e32, (name, e3, e32)
    assert err(one)[0] >= 10 * err(three)[0], (err(one), err(three))


# --- K2's staging on the card: rows of 16 bytes ------------------------------


@pytest.mark.parametrize("D,dtype,offset", [(33, torch.float32, 0), (64, torch.float32, 1),
                                            (20, torch.bfloat16, 0), (37, torch.bfloat16, 0),
                                            (64, torch.bfloat16, 0)],
                         ids=["fp32-odd", "fp32-misaligned", "bf16-20", "bf16-odd", "bf16-aligned"])
def test_k2_rows_padded_to_16_bytes_change_no_output(D, dtype, offset):
    # the wrapper pads panels that 16-byte cp.async cannot stage with zero
    # columns, keeps the scale of the unpadded D, and cuts the output back
    shape = (2, 37, D)
    panels = []
    for a in _qkv(shape, seed=35):
        base = torch.zeros(offset + a.size, dtype=dtype)
        base[offset:] = torch.from_numpy(a).reshape(-1).to(dtype)
        panels.append(base[offset:].view(shape))
    width = cp_async_width(D, panels[0].element_size())
    padded = [cp_async_rows(t, width) for t in panels]
    for t, pt in zip(panels, padded):
        assert pt.shape == (*shape[:2], width) and pt.data_ptr() % 16 == 0
        assert (pt is t) == (width == D and offset == 0)
    scale = float(1.0 / np.sqrt(D))
    want, want_lse = attention_plain(*panels, True, scale, with_lse=True)
    got, lse = attention_plain(*padded, True, scale, with_lse=True)
    assert not got[..., D:].any()
    torch.testing.assert_close(got[..., :D], want)
    torch.testing.assert_close(lse, want_lse)
