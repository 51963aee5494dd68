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


# --- fp16, and heads wider than 128 (D 160 and 256) ---------------------------

#: (dtype, D, causal) of the plain versions against the Pallas kernels in
#: interpret mode (inputs of the same dtype) and against ``_attention_ref``
#: / ``jax.vjp`` of it in fp32 on the same rounded inputs.  Tolerance, of
#: each reference's largest magnitude: fp32 1e-5 (orders of summation);
#: bf16 2e-2 (P and dS rounded to bf16, 2**-8 of a value, before the
#: second products, where the reference keeps fp32); fp16 2e-3 (the
#: results rounded to fp16, 2**-11 of a value: P and dS keep fp32 in the
#: plain versions and the Pallas kernels, and about 22 bits in K2 and K3).
WIDE = [("float16", 64, False), ("float16", 64, True), ("float16", 160, True), ("float32", 160, False),
        ("float32", 160, True), ("float32", 256, True), ("bfloat16", 160, False), ("bfloat16", 256, True)]
WIDE_IDS = [f"{d}-D{D}{'-causal' if c else ''}" for d, D, c in WIDE]
WIDE_REL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-3}


def _wide_inputs(dtype, D, seed):
    """q, k, v, dO of shape (2, 80, D) in ``dtype`` (torch), and the same
    values as JAX arrays of the dtype and as fp32 JAX arrays."""
    rng = np.random.default_rng(seed)
    host = [rng.normal(size=(2, 80, D)).astype("float32") * s for s in (0.3, 0.3, 1.0, 1.0)]
    ported = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in host]
    rounded = [t.float().numpy() for t in ported]
    return ported, [jnp.asarray(a, dtype=dtype) for a in rounded], [jnp.asarray(a) for a in rounded]


def _close(got, want, rel, name):
    got, want = np.asarray(got, dtype="float64"), np.asarray(want, dtype="float64")
    assert got.shape == want.shape, name
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{name}: {err / scale:.3e} of the scale (tolerance {rel})"


@pytest.mark.parametrize("dtype,D,causal", WIDE, ids=WIDE_IDS)
def test_plain_k2_in_fp16_and_wide_heads_matches_pallas_interpret_and_reference(dtype, D, causal):
    from jax.experimental.pallas import tpu as pltpu

    (q, k, v, _), jx, j32 = _wide_inputs(dtype, D, seed=41)
    scale = float(1.0 / np.sqrt(D))
    got = flash_attention(q, k, v, causal=causal, scale=scale)
    assert got.dtype == q.dtype and got.shape == q.shape
    with pltpu.force_tpu_interpret_mode():
        want_pallas = jax_flash(*jx[:3], causal=causal, scale=scale).astype(jnp.float32)
    want_ref = _attention_ref(*j32[:3], causal, scale)
    _close(got.float(), want_pallas, WIDE_REL[dtype], "vs Pallas")
    _close(got.float(), want_ref, WIDE_REL[dtype], "vs _attention_ref")


@pytest.mark.parametrize("dtype,D,causal", WIDE, ids=WIDE_IDS)
def test_plain_k3_in_fp16_and_wide_heads_matches_pallas_interpret_and_vjp(dtype, D, causal):
    from jax.experimental.pallas import tpu as pltpu

    (q, k, v, do), jx, j32 = _wide_inputs(dtype, D, seed=43)
    scale = float(1.0 / np.sqrt(D))
    got = flash_attention_grads(q, k, v, do, causal=causal, scale=scale)
    with pltpu.force_tpu_interpret_mode():
        want_pallas = jax_flash_grads(*jx, causal=causal, scale=scale)
    _, vjp = jax.vjp(lambda q_, k_, v_: _attention_ref(q_, k_, v_, causal, scale), *j32[:3])
    for name, g, wp, wv in zip(("dq", "dk", "dv"), got, want_pallas, vjp(j32[3])):
        assert g.dtype == q.dtype and g.shape == q.shape, name
        _close(g.float(), wp.astype(jnp.float32), WIDE_REL[dtype], f"{name} vs Pallas")
        _close(g.float(), wv, WIDE_REL[dtype], f"{name} vs jax.vjp")


def test_plain_fp16_attention_past_fp16s_range_of_scores():
    """Unscaled scores past fp16's 65,504 (q about 10,000, scale 5e-5, so
    the scaled scores are a few units): the plain versions take the scores
    in fp32, as the kernels do, so the output and the gradients are finite,
    and agree with the fp32 computation on the same values within fp16's
    rounding of O and the results (2e-3 of the scale)."""
    rng = np.random.default_rng(45)
    q = 10000.0 * (1.0 + 0.1 * rng.normal(size=(1, 40, 64)))
    k, v, do = rng.normal(size=(3, 1, 40, 64))
    half = [torch.from_numpy(a).half() for a in (q, k, v, do)]
    single = [t.float() for t in half]
    assert torch.einsum("btd,bsd->bts", single[0], single[1]).abs().max().item() > 65504 * 1.5
    out = attention_plain(*half[:3], True, 5e-5)
    assert out.dtype == torch.float16 and torch.isfinite(out).all()
    _close(out.float(), attention_plain(*single[:3], True, 5e-5), 2e-3, "out")
    for name, g, w in zip(("dq", "dk", "dv"), attention_grads_plain(*half, True, 5e-5),
                          attention_grads_plain(*single, True, 5e-5)):
        assert torch.isfinite(g).all(), name
        _close(g.float(), w, 2e-3, name)


@pytest.mark.parametrize("shape,dtype", [((2, 70, 300), torch.float32), ((1, 5, 40), torch.float64)],
                         ids=["D300", "fp64"])
def test_the_wrappers_raise_on_what_the_kernels_do_not_take(shape, dtype):
    """A CUDA panel that K2 and K3 do not take raises before any launch (the
    check reads shapes and dtypes only, so a meta tensor stands in)."""
    from aesara_tpu_torch.link.torch.kernels import attention as attn

    t = torch.empty(shape, dtype=dtype, device="meta")
    match = "D <= 256" if dtype == torch.float32 else "float32, bfloat16 or float16 on the card, got torch.float64"
    with pytest.raises((ValueError, TypeError), match=match):
        _check_as_cuda(attn, t)


def _check_as_cuda(attn, t):
    """``_check_cuda_panels`` on a meta tensor made to read as a CUDA one."""

    class OnCard:
        def __init__(self, x):
            self.x = x
            self.device = torch.device("cuda", 0)
            self.dtype, self.shape = x.dtype, x.shape

        def dim(self):
            return self.x.dim()

    p = OnCard(t)
    attn._check_cuda_panels("flash_attention", p, p, p)


def test_the_wrappers_take_more_than_65535_batch_heads():
    from aesara_tpu_torch.link.torch.kernels import attention as attn

    _check_as_cuda(attn, torch.empty((65600, 16, 64), device="meta"))
    with pytest.raises(ValueError, match="ceil"):
        _check_as_cuda(attn, torch.empty((2**31 // 2, 129, 8), dtype=torch.float16, device="meta"))
