"""The threefry kernel: one draw of ``jax.random``'s threefry2x32 bits (Triton).

It replaces no TPU kernel: the JAX package draws through ``jax.random``
under XLA (``aesara_tpu/link/jax/random_dispatch.py:21-35``), with no
Pallas call.  It was added because the draw's plain PyTorch version is
about 150 elementwise launches (twenty rounds of add, rotate and xor on
two words, each a torch op), which would double the kernels of a
sampling decode step.

One launch does one draw.  From the key ``k`` it computes JAX's split at
counters 0 and 1, ``next_key = threefry(k, (0, 0))`` and ``draw_key =
threefry(k, (0, 1))`` (``_threefry_split_foldlike``); program 0 writes
``next_key``.  Element ``i`` of the draw is ``threefry(draw_key, (i >> 32,
i & 0xFFFFFFFF))``, the partitionable counter layout of
``_threefry_random_bits_partitionable``: its two words xored give 32
bits, high then low 64 bits.  The result is the raw bits or JAX's uniform
floats on [0, 1) (``jax/_src/random.py``, ``_uniform``: the top mantissa
bits under the exponent of 1.0, minus 1.0), in float32 or float64, so
the kernel's floats are ``jax.random.uniform``'s bit for bit.

On the H100 the work is a fused integer pass: 20 rounds of three 32-bit
operations on two words an element, in registers, and one 4- or 8-byte
store an element.  It is bound by its stores at large sizes (the bound
``chip_smoke.py`` states is the bytes written over 3.35 TB/s) and by the
launch at the decoder's 32,000 values.  Nothing is staged; Triton's
``uint32`` arithmetic wraps as the algorithm needs.

:func:`threefry_draw` is the wrapper: a key on the CPU takes the plain
version (:func:`threefry_plain`, int64 carriers of the ``uint32`` values
masked to 32 bits, as K1's plain version computes unsigned types:
PyTorch has too few ``uint32`` operations); a key on the card launches
the kernel.
"""

from __future__ import annotations

import math

__all__ = ["MODES", "threefry2x32", "threefry_draw", "threefry_plain"]

_BLOCK = 1024
M32 = 0xFFFFFFFF
#: the rotations of threefry2x32's two alternating groups of four rounds
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the key schedule's parity constant
KS_PARITY = 0x1BD11BDA
#: what a draw returns: raw bits (as int32 / int64 bit patterns) or
#: uniform floats on [0, 1)
MODES = ("bits32", "bits64", "float32", "float64")


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of the counter pairs ``(x0, x1)`` under the
    key ``(k0, k1)``: five groups of four rounds (add, rotate, xor), a key
    injection after each.  Every argument and result holds ``uint32``
    values in int64 carriers, NumPy's or torch's alike (the host's key
    functions, ``tensor/random/op.py``, and the plain version both call
    it)."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _to_uint32(carrier):
    """int64 carriers of uint32 values as a torch.uint32 tensor."""
    import torch

    signed = carrier - ((carrier >> 31) << 32)     # the values' int32 reading
    return signed.to(torch.int32).view(torch.uint32)


def _key_words(key):
    import torch

    words = key.view(torch.int32).to(torch.int64) & M32
    return words[0], words[1]


def threefry_plain(key, shape, mode: str):
    """(next key, draw) of one draw, as the kernel computes them: ``key``
    a torch.uint32 tensor of shape (2,); the draw is int32 (``bits32``) or
    int64 (``bits64``) bit patterns, or float32/float64 on [0, 1)."""
    import torch

    if mode not in MODES:
        raise ValueError(f"threefry: mode {mode!r} is not one of {MODES}")
    k0, k1 = _key_words(key)
    c = torch.arange(2, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(c), c)
    next_key = _to_uint32(torch.stack([y0[0], y1[0]]))
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(y0[1], y1[1], i >> 32, i & M32)
    if mode in ("bits32", "float32"):
        bits = b1 ^ b2
        if mode == "bits32":
            out = _to_uint32(bits).view(torch.int32)
        else:
            out = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    elif mode == "bits64":
        # (b1 << 32) | b2 as a two's complement int64, without an overflow
        out = (b1 - ((b1 >> 31) << 32)) * (1 << 32) + b2
    else:
        mant = (b1 << 20) | (b2 >> 12)
        out = (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    return next_key, out.reshape(shape)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_SOURCE = '''
import triton
import triton.language as tl


@triton.jit
def _rotl(x, r: tl.constexpr):
    return (x << r) | (x >> (32 - r))


@triton.jit
def _group(x0, x1, r0: tl.constexpr, r1: tl.constexpr, r2: tl.constexpr, r3: tl.constexpr):
    x0 = x0 + x1
    x1 = _rotl(x1, r0) ^ x0
    x0 = x0 + x1
    x1 = _rotl(x1, r1) ^ x0
    x0 = x0 + x1
    x1 = _rotl(x1, r2) ^ x0
    x0 = x0 + x1
    x1 = _rotl(x1, r3) ^ x0
    return x0, x1


@triton.jit
def _threefry(k0, k1, x0, x1):
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    x0 = x0 + k0
    x1 = x1 + k1
    x0, x1 = _group(x0, x1, 13, 15, 26, 6)
    x0 = x0 + k1
    x1 = x1 + k2 + 1
    x0, x1 = _group(x0, x1, 17, 29, 16, 24)
    x0 = x0 + k2
    x1 = x1 + k0 + 2
    x0, x1 = _group(x0, x1, 13, 15, 26, 6)
    x0 = x0 + k0
    x1 = x1 + k1 + 3
    x0, x1 = _group(x0, x1, 17, 29, 16, 24)
    x0 = x0 + k1
    x1 = x1 + k2 + 4
    x0, x1 = _group(x0, x1, 13, 15, 26, 6)
    x0 = x0 + k2
    x1 = x1 + k0 + 5
    return x0, x1


@triton.jit
def threefry_kernel(key_ptr, next_ptr, out_ptr, N, MODE: tl.constexpr, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    k0 = tl.load(key_ptr).to(tl.uint32, bitcast=True)
    k1 = tl.load(key_ptr + 1).to(tl.uint32, bitcast=True)
    # the split: the next key at counter (0, 0), the draw's at (0, 1)
    zero = k0 * 0
    n0, n1 = _threefry(k0, k1, zero, zero)
    d0, d1 = _threefry(k0, k1, zero, zero + 1)
    tl.store(next_ptr, n0.to(tl.int32, bitcast=True), mask=pid == 0)
    tl.store(next_ptr + 1, n1.to(tl.int32, bitcast=True), mask=pid == 0)
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < N
    hi = (offs >> 32).to(tl.uint32)
    lo = (offs & 0xFFFFFFFF).to(tl.uint32)
    b1, b2 = _threefry(d0, d1, hi, lo)
    if MODE == 0:
        tl.store(out_ptr + offs, (b1 ^ b2).to(tl.int32, bitcast=True), mask=mask)
    elif MODE == 1:
        bits = (b1.to(tl.uint64) << 32) | b2.to(tl.uint64)
        tl.store(out_ptr + offs, bits.to(tl.int64, bitcast=True), mask=mask)
    elif MODE == 2:
        f = (((b1 ^ b2) >> 9) | 0x3F800000).to(tl.float32, bitcast=True)
        tl.store(out_ptr + offs, f - 1.0, mask=mask)
    else:
        m = (b1.to(tl.uint64) << 20) | (b2 >> 12).to(tl.uint64)
        f = (m | 0x3FF0000000000000).to(tl.float64, bitcast=True)
        tl.store(out_ptr + offs, f - 1.0, mask=mask)
'''

_kernel = []


def _compiled():
    if not _kernel:
        from aesara_tpu_torch.link.torch.kernels.build import triton_module

        _kernel.append(triton_module(_SOURCE, "threefry").threefry_kernel)
    return _kernel[0]


def source() -> str:
    """The kernel's Triton source (a test parses it)."""
    return _SOURCE


def threefry_draw(key, shape, mode: str):
    """(next key, draw) of one draw from ``key`` (torch.uint32, shape (2,)):
    a key on the CPU takes the plain version, a key on the card launches
    the kernel."""
    import torch

    if mode not in MODES:
        raise ValueError(f"threefry: mode {mode!r} is not one of {MODES}")
    if key.dtype != torch.uint32 or tuple(key.shape) != (2,):
        raise TypeError(f"threefry: a key is a torch.uint32 tensor of shape (2,), got {key.dtype} {tuple(key.shape)}")
    shape = tuple(int(s) for s in shape)
    if key.device.type == "cpu":
        threefry_draw.plain_calls += 1
        return threefry_plain(key, shape, mode)
    if key.device.type != "cuda":
        raise ValueError(f"threefry: no kernel for a key on {key.device}")
    dtype = {"bits32": torch.int32, "bits64": torch.int64, "float32": torch.float32, "float64": torch.float64}[mode]
    next_key = torch.empty(2, dtype=torch.uint32, device=key.device)
    out = torch.empty(shape, dtype=dtype, device=key.device)
    n = out.numel()
    grid = (max(1, (n + _BLOCK - 1) // _BLOCK),)
    _compiled()[grid](key.contiguous().view(torch.int32), next_key.view(torch.int32), out, n,
                      MODE=MODES.index(mode), BLOCK=_BLOCK, num_warps=4)
    threefry_draw.launches += 1
    return next_key, out


#: launches of the kernel, calls that took the plain version, and the
#: launches replayed from captured graphs (tallied by the linker)
threefry_draw.launches = 0
threefry_draw.plain_calls = 0
threefry_draw.replayed = 0
