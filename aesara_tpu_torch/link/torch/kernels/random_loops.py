"""TG, TP, TB and TM: the loop samplers and the MRG31k3p streams (CUDA C++).

None of them replaces a TPU kernel: the JAX package draws gamma, Poisson
and binomial values by ``jax.random`` under XLA
(``aesara_tpu/tensor/random/basic.py``, ``jax/_src/random.py``:
``_gamma_one``, ``_poisson_knuth``, ``_poisson_rejection``,
``_binomial_inversion``, ``_btrs``) and MRG31k3p uniforms by a
``lax.scan`` (``aesara_tpu/link/jax/random_dispatch.py:40-137``), with no
Pallas call.  They were added because those draws are loops whose trip
count depends on the data: as torch ops each round would read a flag on
the host, which a captured step cannot do.  ``csrc/random_loops.cu`` runs
one thread an element (a stream for TM), each walking its own threefry key
chain in registers:

- **TG**, gamma (Marsaglia and Tsang, in linear or log space): element
  ``i`` starts from ``split(key, n)[i]`` and loops until it accepts, as
  ``jax.random``'s vmapped ``while_loop`` does for each element.
- **TP**, Poisson: Knuth's product of uniforms below λ = 10, Hörmann's
  transformed rejection above, 0 at λ = 0.  Round ``r``'s key is the same
  for every element; element ``i`` reads counter ``i`` of round ``r``'s
  draw of the full shape.
- **TB**, binomial: inversion by geometric gaps where ``n q <= 10``, BTRS
  elsewhere, with the reflections and the invalid-parameter rules of
  ``jax.random.binomial``.
- **TM**, MRG31k3p: a stream steps ``ceil(n / n_streams)`` times (the
  streams past ``n % n_streams`` one fewer), writes its draws at the
  interleaved positions and its new state.  Exact integer arithmetic:
  kernel, plain version and JAX package agree bit for bit.

What the rejection loops of ``jax.random`` do that a thread must copy:
``_poisson_rejection`` and ``_btrs`` write ``k_out = select(accept, k,
k_out)`` for every element in every round, accepted or not, until the
whole batch has accepted.  An element's draw is therefore its value in the
*last* accepting round of the batch's rounds, not its first.  TP and TB
run in two launches: the first takes each element to its own first
acceptance and reduces the batch's round count R (``atomicMax``); the
second carries every rejection element on to round R.  Elements of the
other branch (Knuth, inversion) run the rejection loop as ``jax.random``
does, with its stand-in parameters (λ = 1e5; n = 1e4, p = 0.5), to their
first acceptance, because they count in R.

What bounds them on the H100: integer work.  A round costs three to five
threefry2x32 hashes (the round's keys and the element's bits, 115 integer
operations each) and a few transcendentals; the output is 4 or 8 bytes an
element.  The bound ``chip_smoke.py`` states is the larger of the bytes
moved over 3.35 TB/s and the hashes this run's rounds need at the card's
integer rate.

Rounding: each ``a * b + c`` that XLA contracts into one fused
multiply-add is ``torch.addcmul`` here (``fma``) and ``__fma_rn`` in the
kernel; every other product and sum is rounded on its own in both
(``__fmul_rn``, ``__fadd_rn``: nvcc may not contract them).  The
transcendentals are CUDA's (``log``, ``log1p``, ``exp``, ``pow``,
``erfinv``, ``sin``), as PyTorch's CUDA ops call them, and ``lgamma`` is
XLA's Lanczos form (:func:`lgamma_xla`) in both.

Each wrapper takes the plain version for tensors on the CPU (the
vectorised loop as ``jax.random`` writes it, which tests a flag on the
host each round) and launches the kernel for tensors on the card, or
raises.
"""

from __future__ import annotations

import ctypes
import math

from aesara_tpu_torch.link.torch.kernels.threefry import M32, threefry2x32

__all__ = ["gamma_draw", "gamma_plain", "poisson_draw", "poisson_plain", "binomial_draw", "binomial_plain",
           "mrg_draw", "mrg_plain", "lgamma_xla", "fma", "rdiv", "SQUEEZE", "POISSON_KNUTH_MAX", "BINOMIAL_INVERSION_MAX"]

SQUEEZE = 0.0331                 # Marsaglia and Tsang's squeeze constant
POISSON_KNUTH_MAX = 10.0         # Knuth below this λ, rejection at and above
POISSON_STANDIN = 1e5            # the λ the rejection loop runs for Knuth's elements
BINOMIAL_INVERSION_MAX = 10.0    # inversion where n q <= this
BINOMIAL_STANDIN = (1e4, 0.5)    # the (n, q) the BTRS loop runs for inversion's elements
#: Stirling's series tail of log k! for k = 0..9 (``_stirling_approx_tail``)
STIRLING_TAIL = (0.0810614667953272, 0.0413406959554092, 0.0276779256849983, 0.02079067210376509,
                 0.0166446911898211, 0.0138761288230707, 0.0118967099458917, 0.0104112652619720,
                 0.00925546218271273, 0.00833056343336287)
#: XLA's lgamma: Lanczos g = 7, n = 9 (``chlo.lgamma`` as XLA expands it)
LANCZOS = (676.520368121885098567009190444019, -1259.13921672240287047156078755283,
           771.3234287776530788486528258894, -176.61502916214059906584551354, 12.507343278686904814458936853,
           -0.13857109526572011689554707, 9.984369578019570859563e-6, 1.50563273514931155834e-7)
LANCZOS_BASE = 0.99999999999980993227684700473478
LOG_SQRT_2PI = 0.91893853320467274178
LOG_PI = 1.1447298858494002
M1, M2 = 2147483647, 2147462579
MRG_NORM = {"float64": 4.656612873077392578125e-10, "float32": 4.6566126e-10}


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def fma(a, b, c):
    """``a * b + c`` rounded once (torch.addcmul), in ``c``'s dtype."""
    import torch

    dt = c.dtype if isinstance(c, torch.Tensor) else (a.dtype if isinstance(a, torch.Tensor) else b.dtype)
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (x if isinstance(x, torch.Tensor) else torch.full((), x, dtype=dt, device=ref.device) for x in (a, b, c))
    a, b, c = torch.broadcast_tensors(a.to(dt), b.to(dt), c.to(dt))
    return torch.addcmul(c, a, b)


def lgamma_xla(x):
    """log|Γ(x)| as XLA computes it (``chlo.lgamma``): Lanczos with g = 7
    for x >= 0.5, Euler's reflection below, +inf at ±inf."""
    import torch

    dt = x.dtype
    c = lambda v: float(torch.tensor(v, dtype=dt))      # noqa: E731  (a constant rounded to x's dtype)
    reflect = x < 0.5
    z = torch.where(reflect, -x, x - 1.0)
    acc = rdiv(c(LANCZOS[0]), z + 1.0) + c(LANCZOS_BASE)
    for i, coef in enumerate(LANCZOS[1:], start=2):
        acc = acc + rdiv(c(coef), z + float(i))
    t = z + 7.5
    log_t = torch.log1p(z * c(1.0 / 7.5)) + c(math.log(7.5))     # XLA multiplies by the reciprocal
    log_y = fma((z + 0.5) - t / log_t, log_t, torch.full_like(z, c(LOG_SQRT_2PI))) + torch.log(acc)
    ax = x.abs()
    frac = ax - torch.floor(ax)
    frac = torch.where(0.5 < frac, 1.0 - frac, frac)
    denom = torch.log(torch.sin(frac * c(math.pi)))
    reflection = torch.where(torch.isfinite(denom), (c(LOG_PI) - denom) - log_y, -denom)
    out = torch.where(reflect, reflection, log_y)
    return torch.where(ax == math.inf, torch.full_like(out, math.inf), out)


def rdiv(s: float, t):
    """``s / t`` rounded once: PyTorch's ``float / tensor`` is ``t.reciprocal()
    * s``, two roundings."""
    import torch

    return torch.div(torch.full_like(t, s), t)


def _words(key):
    import torch

    w = key.view(torch.int32).to(torch.int64) & M32
    return w[0], w[1]


def _split(k, num: int):
    """``split(k, num)`` of keys held as int64 word pairs (any shape)."""
    import torch

    k0, k1 = k
    zero = torch.zeros_like(k0)
    return [threefry2x32(k0, k1, zero, zero + c) for c in range(num)]


def _unit(b, dtype):
    """JAX's uniform floats on [0, 1) from the hash words ``b``."""
    import torch

    b1, b2 = b
    if dtype == torch.float32:
        return (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return (((b1 << 20) | (b2 >> 12)) | 0x3FF0000000000000).view(torch.float64) - 1.0


def _draw_unit(k, idx, dtype):
    """Element ``idx``'s uniform float of a draw of the full shape from ``k``."""
    return _unit(threefry2x32(k[0], k[1], idx >> 32, idx & M32), dtype)


def _normal_one(k, dtype):
    """``normal(k, ())``: sqrt(2) erfinv of the uniform on (nextafter(-1, 0), 1)."""
    import numpy as np
    import torch

    npd = np.float32 if dtype == torch.float32 else np.float64
    lo = float(np.nextafter(npd(-1.0), npd(0.0)))
    u = torch.clamp_min(fma(_scalar_unit(k, dtype), float(npd(1.0) - npd(lo)), lo), lo)
    return torch.erfinv(u) * float(npd(np.sqrt(2)))


def _scalar_unit(k, dtype):
    import torch

    return _unit(threefry2x32(k[0], k[1], torch.zeros_like(k[0]), torch.zeros_like(k[0])), dtype)


def _gamma_accepts(X, V, U, d):
    import torch

    return (U >= fma(X * X, -SQUEEZE, 1.0)) & (torch.log(U) >= fma(d, (1.0 - V) + torch.log(V), X * 0.5))


def gamma_plain(key, alpha, log_space: bool, work=None):
    """``jax.random``'s gamma (``log_space``: loggamma) of each value of the
    1-D ``alpha`` from ``key``, element ``i`` from ``split(key, n)[i]``, in
    ``alpha``'s dtype.  ``work``, a dict, gains under "hashes" the threefry
    hashes TG's threads make for these inputs (each round of each element
    until it accepts)."""
    import torch

    dt = alpha.dtype
    n = alpha.numel()
    idx = torch.arange(n, dtype=torch.int64, device=alpha.device)
    k0, k1 = _words(key)
    ek = threefry2x32(k0, k1, idx >> 32, idx & M32)
    state, sub = _split(ek, 2)
    third = float(torch.tensor(1.0 / 3.0, dtype=dt))
    boost = alpha >= 1.0
    a = torch.where(boost, alpha, alpha + 1.0)
    d = a - third
    c = rdiv(third, torch.sqrt(d))
    X, V, U = torch.zeros_like(a), torch.ones_like(a), torch.full_like(a, 2.0)
    active = _gamma_accepts(X, V, U, d)
    hashes = 4 * n          # the element's key, its split, the final uniform
    while bool(active.any()):
        hashes += 4 * int(active.sum())     # the round's split and its U
        nk, xk, uk = _split(state, 3)
        x, v = torch.zeros_like(a), torch.full_like(a, -1.0)
        going = active.clone()
        while bool(going.any()):
            hashes += 3 * int(going.sum())  # a split and a normal a proposal
            xk2, sx = _split(xk, 2)
            xn = _normal_one(sx, dt)
            vn = fma(xn, c, 1.0)
            x, v = torch.where(going, xn, x), torch.where(going, vn, v)
            xk = tuple(torch.where(going, p, q) for p, q in zip(xk2, xk))
            going = going & (v <= 0.0)
        Un = _scalar_unit(uk, dt)
        X, V, U = (torch.where(active, p, q) for p, q in ((x * x, X), ((v * v) * v, V), (Un, U)))
        state = tuple(torch.where(active, p, q) for p, q in zip(nk, state))
        active = _gamma_accepts(X, V, U, d)
    if work is not None:
        work["hashes"] = work.get("hashes", 0) + hashes
    u = _scalar_unit(sub, dt)
    if log_space:
        log_u = torch.log1p(-u)
        log_boost = torch.where(boost | (log_u == 0.0), torch.zeros_like(u), log_u * rdiv(1.0, alpha))
        return (torch.log(d) + torch.log(V)) + log_boost
    boost_v = torch.where(boost, torch.ones_like(u), torch.pow(1.0 - u, rdiv(1.0, alpha)))
    return (d * V) * boost_v


def _rejection_rounds(key, idx, step, work=None, own=None):
    """Drive a rejection loop of ``jax.random`` (``key, s0, s1 = split(key,
    3)`` a round) until every element has accepted: ``step(u, v)`` gives
    (k, accept) from the round's two uniforms; ``k_out`` keeps each
    element's k of the last accepting round, as ``select(accept, k,
    k_out)`` over the whole batch does.  ``work`` gains the hashes of the
    kernel's two passes: every element's rounds to its first acceptance,
    then the batch's R rounds of each element where ``own`` is set."""
    import torch

    k_out = accepted = None
    rounds = first = 0
    while accepted is None or not bool(accepted.all()):
        key, s0, s1 = _split(key, 3)
        k, accept = step(s0, s1)
        if k_out is None:
            k_out, accepted = torch.full_like(k, -1.0), torch.zeros_like(accept)
        first += int((~accepted).sum())
        k_out = torch.where(accept, k, k_out)
        accepted = accepted | accept
        rounds += 1
    if work is not None:
        work["hashes"] = work.get("hashes", 0) + 5 * (first + rounds * int(own.sum()))
    return k_out


def poisson_plain(key, lam, work=None):
    """``jax.random.poisson`` of each value of the 1-D float32 ``lam`` from
    ``key``: int64.  ``work`` as for :func:`gamma_plain` (TP's)."""
    import torch

    n = lam.numel()
    idx = torch.arange(n, dtype=torch.int64, device=lam.device)
    f32 = torch.float32
    use_knuth = torch.isnan(lam) | (lam < POISSON_KNUTH_MAX)
    lam_k = torch.where(use_knuth, lam, torch.zeros_like(lam))
    lam_r = torch.where(use_knuth, torch.full_like(lam, POISSON_STANDIN), lam)
    # Knuth: count the uniforms whose running product stays above exp(-lam)
    rng = _words(key)
    k = torch.zeros(n, dtype=torch.int64, device=lam.device)
    log_prod = torch.zeros_like(lam)
    while bool((log_prod > -lam_k).any()):
        if work is not None:
            work["hashes"] = work.get("hashes", 0) + 3 * int((log_prod > -lam_k).sum())
        rng, sub = _split(rng, 2)
        k = torch.where(log_prod > -lam_k, k + 1, k)
        log_prod = log_prod + torch.log(_draw_unit(sub, idx, f32))
    knuth = k - 1
    # transformed rejection
    log_lam = torch.log(lam_r)
    b = fma(torch.sqrt(lam_r), 2.53, 0.931)
    a = fma(b, 0.02483, -0.059)
    inv_alpha = 1.1239 + rdiv(1.1328, b - 3.4)
    v_r = 0.9277 - rdiv(3.6224, b - 2.0)

    def step(s0, s1):
        u = _draw_unit(s0, idx, f32) - 0.5
        v = _draw_unit(s1, idx, f32)
        us = 0.5 - u.abs()
        kk = torch.floor(fma((2.0 * a) / us + b, u, lam_r) + 0.43)
        s = torch.log((v * inv_alpha) / (a / (us * us) + b))
        t = fma(kk, log_lam, -lam_r) - lgamma_xla(kk + 1.0)
        accept1 = (us >= 0.07) & (v <= v_r)
        reject = (kk < 0) | ((us < 0.013) & (v > us))
        return kk, accept1 | (~reject & (s <= t))

    rejection = _rejection_rounds(_words(key), idx, step, work, ~use_knuth).to(torch.int64)
    out = torch.where(use_knuth, knuth, rejection)
    return torch.where(lam == 0, torch.zeros_like(out), out)


def _stirling_tail(k):
    import torch

    table = torch.tensor(STIRLING_TAIL, dtype=k.dtype, device=k.device)
    kc = torch.clamp(k, 0.0, 9.0)
    kp1sq = (kc + 1.0) * (kc + 1.0)
    approx = (1.0 / 12 - (1.0 / 360 - rdiv(1.0 / 1260, kp1sq)) / kp1sq) / (kc + 1.0)
    return torch.where(k <= 9, table[torch.floor(kc).to(torch.int64)], approx)


def binomial_plain(key, count, prob, work=None):
    """``jax.random.binomial(key, count, prob)`` of the 1-D ``count`` and
    ``prob`` (one float dtype, the draw's): float values, nan where the
    parameters are invalid, inf for an infinite count.  ``work`` as for
    :func:`gamma_plain` (TB's)."""
    import torch

    dt = prob.dtype
    idx = torch.arange(prob.numel(), dtype=torch.int64, device=prob.device)
    p_lt_half = prob < 0.5
    q = torch.where(p_lt_half, prob, 1.0 - prob)
    count_nan_or_neg = torch.isnan(count) | (count < 0.0)
    count_inf = torch.isinf(count)
    q_is_nan = torch.isnan(q)
    q_l_0 = q < 0.0
    q = torch.where(q_is_nan | q_l_0, torch.full_like(q, 0.01), q)
    use_inversion = count_nan_or_neg | (count * q <= BINOMIAL_INVERSION_MAX)
    count = torch.floor(count)
    count_inv = torch.where(use_inversion, count, torch.zeros_like(count))
    count_btrs = torch.where(use_inversion, torch.full_like(count, BINOMIAL_STANDIN[0]), count)
    q_btrs = torch.where(use_inversion, torch.full_like(q, BINOMIAL_STANDIN[1]), q)
    # inversion: count the geometric gaps that fit in count
    log1mq = torch.log1p(-q)
    rng = _words(key)
    num_geom = torch.zeros_like(q)
    geom_sum = torch.zeros_like(q)
    while bool((geom_sum <= count_inv).any()):
        if work is not None:
            work["hashes"] = work.get("hashes", 0) + 3 * int((geom_sum <= count_inv).sum())
        sub, rng = _split(rng, 2)
        num_geom = torch.where(geom_sum <= count_inv, num_geom + 1.0, num_geom)
        geom_sum = geom_sum + torch.ceil(torch.log(_draw_unit(sub, idx, dt)) / log1mq)
    inversion = num_geom - 1.0
    # BTRS
    n_, p_ = count_btrs, q_btrs
    stddev = torch.sqrt((n_ * p_) * (1.0 - p_))
    b = fma(stddev, 2.53, 1.15)
    a = fma(p_, 0.01, fma(b, 0.0248, -0.0873))
    c = fma(n_, p_, 0.5)
    v_r = 0.92 - rdiv(4.2, b)
    r = p_ / (1.0 - p_)
    alpha = (2.83 + rdiv(5.1, b)) * stddev
    m = torch.floor((n_ + 1.0) * p_)

    def step(s0, s1):
        u = _draw_unit(s0, idx, dt) - 0.5
        v = _draw_unit(s1, idx, dt)
        us = 0.5 - u.abs()
        accept1 = (us >= 0.07) & (v <= v_r)
        k = torch.floor(fma((2.0 * a) / us + b, u, c))
        reject = (k < 0) | (k > n_)
        v = torch.log((v * alpha) / (a / (us * us) + b))
        ub = (fma(k + 0.5, torch.log((r * ((n_ - k) + 1.0)) / (k + 1.0)),
                  fma(n_ + 1.0, torch.log(((n_ - m) + 1.0) / ((n_ - k) + 1.0)),
                      (m + 0.5) * torch.log((m + 1.0) / (r * ((n_ - m) + 1.0)))))
              + _stirling_tail(m) + _stirling_tail(n_ - m) - _stirling_tail(k) - _stirling_tail(n_ - k))
        return k, accept1 | (~reject & (v <= ub))

    btrs = _rejection_rounds(_words(key), idx, step, work, ~use_inversion)
    samples = torch.where(use_inversion, inversion, btrs)
    invalid = q_l_0 | q_is_nan | count_nan_or_neg
    samples = torch.where(invalid, torch.full_like(samples, math.nan), samples)
    samples = torch.where(count_inf & ~invalid, torch.full_like(samples, math.inf), samples)
    keep = p_lt_half | count_nan_or_neg | q_is_nan | count_inf
    return torch.where(keep, samples, count - samples)


def _mrg_step(c):
    """One MRG31k3p step of the six components (int64 carriers), exact."""
    x11, x12, x13, x21, x22, x23 = c
    y1 = (4194304 * x12 + 129 * x13) % M1
    y2 = (32768 * x21 + 32769 * x23) % M2
    return (y1, x11, x12, y2, x21, x22)


def mrg_plain(state, n: int, dtype: str):
    """(new state, draws) of ``mrg_uniform``: ``state`` (n_streams, 6)
    int32; draw ``t * n_streams + j`` is stream ``j``'s ``t``-th, the
    streams past ``n % n_streams`` step once fewer."""
    import torch

    n_streams = state.shape[0]
    steps = -(-n // n_streams) if n else 0
    rem = n % n_streams
    comps = tuple(state[:, k].to(torch.int64) for k in range(6))
    draws, prev = [], comps
    for _ in range(steps):
        prev = comps
        comps = _mrg_step(comps)
        diff = (comps[0] - comps[3]) % M1
        draws.append(torch.where(diff == 0, torch.full_like(diff, M1), diff))
    if steps and rem:
        full = torch.arange(n_streams, device=state.device) < rem
        comps = tuple(torch.where(full, p, q) for p, q in zip(comps, prev))
    new_state = torch.stack(comps, dim=1).to(torch.int32)
    flat = torch.stack(draws).reshape(-1)[:n] if steps else torch.zeros(0, dtype=torch.int64, device=state.device)
    fdt = torch.float64 if dtype == "float64" else torch.float32
    return new_state, flat.to(fdt) * MRG_NORM[dtype]


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _library():
    """The built library, its functions typed (kept after the first call)."""
    from aesara_tpu_torch.link.torch.kernels.build import load_cuda_library

    if _library.lib is None:
        lib = load_cuda_library("random_loops")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tg_gamma.argtypes = [p, p, p, q, i, i, p]
        lib.tp_poisson.argtypes = [p, p, p, q, p, i, p]
        lib.tb_binomial.argtypes = [p, p, p, p, q, i, p, i, p]
        lib.tm_mrg.argtypes = [p, p, p, q, i, q, i, i, p]
        for fn in (lib.tg_gamma, lib.tp_poisson, lib.tb_binomial, lib.tm_mrg):
            fn.restype = i
        lib.random_loops_error_string.argtypes = [i]
        lib.random_loops_error_string.restype = ctypes.c_char_p
        _library.lib = lib
    return _library.lib


_library.lib = None


def _check(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {_library().random_loops_error_string(err).decode()}")


def _stream(t):
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _on_card(name: str, key, *tensors):
    """Whether the call takes the kernel: every tensor on the card (then
    checked), or every one on the CPU (the plain version); else raises."""
    import torch

    devices = {t.device.type for t in (key, *tensors)}
    if devices == {"cpu"}:
        return False
    if devices != {"cuda"}:
        raise ValueError(f"{name}: tensors on {sorted(devices)}; the kernel takes CUDA tensors, the plain version "
                         "CPU ones")
    if key.dtype != torch.uint32 or tuple(key.shape) != (2,):
        raise TypeError(f"{name}: a key is a torch.uint32 tensor of shape (2,), got {key.dtype} {tuple(key.shape)}")
    for t in tensors:
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: takes contiguous 1-D tensors, got {tuple(t.shape)} strides {t.stride()}")
    return True


def gamma_draw(key, alpha, log_space: bool = False):
    """TG: ``jax.random.gamma`` (``log_space``: ``loggamma``) of each value
    of the 1-D float32 or float64 ``alpha``, from ``key``."""
    import torch

    if not _on_card("gamma_draw", key, alpha):
        gamma_draw.plain_calls += 1
        return gamma_plain(key, alpha, log_space)
    if alpha.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gamma_draw takes float32 or float64 alpha, got {alpha.dtype}")
    out = torch.empty_like(alpha)
    _check("gamma_draw", _library().tg_gamma(key.data_ptr(), alpha.data_ptr(), out.data_ptr(), alpha.numel(),
                                             int(alpha.dtype == torch.float64), int(log_space), _stream(alpha)))
    gamma_draw.launches += 1
    return out


def poisson_draw(key, lam):
    """TP: ``jax.random.poisson`` of each value of the 1-D float32 ``lam``
    from ``key``: int64 (two launches, see the module's docstring)."""
    import torch

    if not _on_card("poisson_draw", key, lam):
        poisson_draw.plain_calls += 1
        return poisson_plain(key, lam)
    if lam.dtype != torch.float32:
        raise TypeError(f"poisson_draw takes float32 lam (jax.random's), got {lam.dtype}")
    out = torch.empty(lam.shape, dtype=torch.int64, device=lam.device)
    rounds = torch.zeros(1, dtype=torch.int32, device=lam.device)
    lib = _library()
    for pass_ in (0, 1):
        _check("poisson_draw", lib.tp_poisson(key.data_ptr(), lam.data_ptr(), out.data_ptr(), lam.numel(),
                                              rounds.data_ptr(), pass_, _stream(lam)))
        poisson_draw.launches += 1
    return out


def binomial_draw(key, count, prob):
    """TB: ``jax.random.binomial(key, count, prob)`` of the 1-D ``count``
    and ``prob`` of one float dtype: values in that dtype (two launches)."""
    import torch

    if not _on_card("binomial_draw", key, count, prob):
        binomial_draw.plain_calls += 1
        return binomial_plain(key, count, prob)
    if prob.dtype not in (torch.float32, torch.float64) or count.dtype != prob.dtype or count.shape != prob.shape:
        raise TypeError(f"binomial_draw takes count and prob of one float dtype and shape, got {count.dtype} "
                        f"{tuple(count.shape)} and {prob.dtype} {tuple(prob.shape)}")
    out = torch.empty_like(prob)
    rounds = torch.zeros(1, dtype=torch.int32, device=prob.device)
    lib = _library()
    for pass_ in (0, 1):
        _check("binomial_draw", lib.tb_binomial(key.data_ptr(), count.data_ptr(), prob.data_ptr(), out.data_ptr(),
                                                prob.numel(), int(prob.dtype == torch.float64), rounds.data_ptr(),
                                                pass_, _stream(prob)))
        binomial_draw.launches += 1
    return out


def mrg_draw(state, n: int, dtype: str):
    """TM: (new state, ``n`` uniforms in ``dtype``) of ``mrg_uniform`` from
    the (n_streams, 6) int32 ``state``."""
    import torch

    if dtype not in MRG_NORM:
        raise TypeError(f"mrg_draw: dtype {dtype} is not float32 or float64")
    if state.dim() != 2 or state.shape[1] != 6 or state.dtype != torch.int32:
        raise TypeError(f"mrg_draw: a state is an (n_streams, 6) int32 tensor, got {state.dtype} {tuple(state.shape)}")
    if state.device.type == "cpu":
        mrg_draw.plain_calls += 1
        return mrg_plain(state, n, dtype)
    if state.device.type != "cuda":
        raise ValueError(f"mrg_draw: no kernel for a state on {state.device}")
    state = state.contiguous()
    n_streams = state.shape[0]
    steps = -(-n // n_streams) if n else 0
    new_state = torch.empty_like(state)
    out = torch.empty(n, dtype=getattr(torch, dtype), device=state.device)
    _check("mrg_draw", _library().tm_mrg(state.data_ptr(), new_state.data_ptr(), out.data_ptr(), n, n_streams, steps,
                                         n % n_streams, int(dtype == "float64"), _stream(state)))
    mrg_draw.launches += 1
    return new_state, out


#: launches of each kernel, calls that took the plain version, and the
#: launches replayed from captured graphs (tallied by the linker)
for _w in (gamma_draw, poisson_draw, binomial_draw, mrg_draw):
    _w.launches = _w.plain_calls = _w.replayed = 0
del _w
