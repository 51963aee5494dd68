"""Optimizer update builders: (cost, params) → the ``updates`` list of
``function()`` (reference ``aesara_tpu/models/optim.py``).

All state (momenta, second moments, step counters, loss scales) lives in
shared variables on the parameters' device, so a train step is one
compiled function whose updates include the optimizer's.  The step
counters, bias corrections, schedules and clip scales are 0-d tensors on
that device: nothing in a step reads a value back to the host.

``state_shard_axis``/``state_shard_size`` (ZeRO-1 sharding of the
optimizer state) wait for the parallel slice and raise when set.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from aesara_tpu_torch.compile.sharedvalue import shared
from aesara_tpu_torch.gradient import grad
from aesara_tpu_torch.tensor import math as tm
from aesara_tpu_torch.tensor.basic import cast, switch


__all__ = ["sgd", "momentum", "rmsprop", "adam", "clip_by_global_norm", "adamw", "warmup_cosine",
           "scaled_loss_updates", "adamw_from_grads", "accumulate_gradients", "ema_updates"]


def _grads(cost, params):
    return grad(cost, list(params))


def _state(p, suffix: str, dtype=None, value=None):
    """A zero state buffer shaped like ``p`` on ``p``'s device (or a copy
    of ``value``)."""
    value = np.zeros(p.get_value().shape, dtype=dtype or p.get_value().dtype) if value is None else value
    return shared(value, name=(p.name or "p") + suffix, device=p.device)


def _counter(name: str, device):
    return shared(np.asarray(0.0, dtype="float32"), name=name, device=device)


def _no_sharding(state_shard_axis, state_shard_size):
    if state_shard_axis is not None or state_shard_size is not None:
        raise NotImplementedError("state_shard_axis/state_shard_size (ZeRO-1 optimizer state) wait for the "
                                  "parallel slice, which the port does not have yet")


def sgd(cost, params: Sequence, lr: float = 0.01) -> List[Tuple]:
    """Plain stochastic gradient descent: p ← p − lr · d cost / d p."""
    return [(p, p - lr * g) for p, g in zip(params, _grads(cost, params))]


def momentum(cost, params: Sequence, lr: float = 0.01, mu: float = 0.9, state_shard_axis=None,
             state_shard_size=None) -> List[Tuple]:
    """Polyak momentum; one velocity buffer per parameter."""
    _no_sharding(state_shard_axis, state_shard_size)
    updates = []
    for p, g in zip(params, _grads(cost, params)):
        v = _state(p, "_vel")
        v_new = mu * v - lr * g
        updates += [(v, v_new), (p, p + v_new)]
    return updates


def rmsprop(cost, params: Sequence, lr: float = 0.001, rho: float = 0.9, eps: float = 1e-8,
            state_shard_axis=None, state_shard_size=None) -> List[Tuple]:
    """RMSProp; a squared-gradient accumulator per parameter."""
    _no_sharding(state_shard_axis, state_shard_size)
    updates = []
    for p, g in zip(params, _grads(cost, params)):
        acc = _state(p, "_acc")
        acc_new = rho * acc + (1.0 - rho) * g * g
        updates += [(acc, acc_new), (p, p - lr * g / tm.sqrt(acc_new + eps))]
    return updates


def adam(cost, params: Sequence, lr: float = 0.001, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         state_shard_axis=None, state_shard_size=None) -> List[Tuple]:
    """Adam (Kingma & Ba 2015) with bias correction by a shared step
    counter, so the whole optimizer is part of the compiled step."""
    _no_sharding(state_shard_axis, state_shard_size)
    params = list(params)
    t = _counter("adam_t", params[0].device)
    t_new = t + 1.0
    updates = [(t, t_new)]
    for p, g in zip(params, _grads(cost, params)):
        m, v = _state(p, "_m"), _state(p, "_v")
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
        m_hat = m_new / (1.0 - tm.pow(cast(b1, "float32"), t_new))
        v_hat = v_new / (1.0 - tm.pow(cast(b2, "float32"), t_new))
        updates += [(m, m_new), (v, v_new), (p, p - lr * m_hat / (tm.sqrt(v_hat) + eps))]
    return updates


def clip_by_global_norm(grads: Sequence, max_norm: float):
    """Rescale ``grads`` so that their joint L2 norm is at most
    ``max_norm``: (clipped grads, global norm).  The norm accumulates in
    float32, or float64 when any gradient is float64."""
    acc = "float64" if any(getattr(g.type, "dtype", "") == "float64" for g in grads) else "float32"
    sq = None
    for g in grads:
        term = tm.sum(tm.sqr(cast(g, acc)))
        sq = term if sq is None else sq + term
    gnorm = tm.sqrt(sq)
    scale = tm.minimum(1.0, max_norm / tm.maximum(gnorm, 1e-12))
    return [cast(cast(g, acc) * scale, g.type.dtype) for g in grads], gnorm


def _adamw_updates(params, grads, lr, b1, b2, eps, weight_decay) -> List[Tuple]:
    """AdamW's state and updates for precomputed gradients: float32
    moments, a float32 step counter, bias corrections shared by every
    parameter."""
    t = _counter("adamw_t", params[0].device)
    t_new = t + 1.0
    updates: List[Tuple] = [(t, t_new)]
    bc1 = 1.0 - tm.pow(np.float32(b1), t_new)
    bc2 = 1.0 - tm.pow(np.float32(b2), t_new)
    for p, g in zip(params, grads):
        m, v = _state(p, "_m", "float32"), _state(p, "_v", "float32")
        g32 = cast(g, "float32")
        m_new = b1 * m + (1.0 - b1) * g32
        v_new = b2 * v + (1.0 - b2) * g32 * g32
        step = lr * (m_new / bc1) / (tm.sqrt(v_new / bc2) + eps)
        p32 = cast(p, "float32")
        updates += [(m, m_new), (v, v_new), (p, cast(p32 - step - lr * weight_decay * p32, p.type.dtype))]
    return updates


def adamw(cost, params: Sequence, lr=0.001, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01, grad_clip: float | None = None, state_shard_axis=None,
          state_shard_size=None) -> List[Tuple]:
    """AdamW (Loshchilov & Hutter 2019): Adam with weight decay applied
    to the parameter, not folded into the gradient, and optional
    global-norm clipping; the default recipe for transformer training.
    ``lr`` may be a float or a 0-d variable (a ``warmup_cosine`` schedule)."""
    _no_sharding(state_shard_axis, state_shard_size)
    params = list(params)
    grads = _grads(cost, params)
    if grad_clip is not None:
        grads, _ = clip_by_global_norm(grads, grad_clip)
    return _adamw_updates(params, grads, lr, b1, b2, eps, weight_decay)


def warmup_cosine(step, lr_max: float, warmup_steps: int, total_steps: int, lr_min: float = 0.0):
    """Linear warmup then cosine decay, as a symbolic function of a 0-d
    ``step`` variable (the ``adamw_t`` counter or a shared step of your
    own): the schedule is computed inside the train step."""
    stepf = cast(step, "float32")
    warm = lr_max * stepf / np.float32(max(warmup_steps, 1))
    progress = tm.minimum((stepf - warmup_steps) / np.float32(max(total_steps - warmup_steps, 1)),
                          np.float32(1.0))
    cos = lr_min + 0.5 * (lr_max - lr_min) * (1.0 + tm.cos(np.float32(np.pi) * progress))
    return switch(tm.lt(stepf, np.float32(warmup_steps)), warm, cos)


def scaled_loss_updates(cost, params: Sequence, opt_fn, init_scale: float = 2.0 ** 15,
                        growth_interval: int = 2000, growth_factor: float = 2.0,
                        backoff_factor: float = 0.5) -> List[Tuple]:
    """Dynamic loss scaling: the gradients are taken of ``cost * scale``
    and unscaled before the optimizer; on any non-finite gradient every
    update is skipped and the scale backs off, and after
    ``growth_interval`` clean steps it grows.  ``opt_fn(grads) ->
    updates`` is an optimizer taking gradients (``adamw_from_grads``
    partially applied), or a float, the learning rate of plain SGD.
    Returns the updates, the scale's and its counter's included."""
    params = list(params)
    device = params[0].device
    scale = shared(np.asarray(init_scale, dtype="float32"), name="loss_scale", device=device)
    good = _counter("loss_scale_good", device)
    unscaled = [cast(g, "float32") / scale for g in _grads(cost * scale, params)]
    finite = None
    for g in unscaled:
        ok = tm.eq(tm.any(tm.or_(tm.isnan(g), tm.isinf(g))), 0)
        finite = ok if finite is None else tm.and_(finite, ok)
    if callable(opt_fn):
        raw = opt_fn(unscaled)
    else:
        raw = [(p, p - float(opt_fn) * cast(g, p.type.dtype)) for p, g in zip(params, unscaled)]
    updates: List[Tuple] = [(var, switch(finite, new, var)) for var, new in raw]
    grew = tm.ge(good + 1.0, np.float32(growth_interval))
    scale_next = switch(finite, switch(grew, scale * np.float32(growth_factor), scale),
                        scale * np.float32(backoff_factor))
    good_next = switch(finite, switch(grew, np.float32(0.0), good + 1.0), np.float32(0.0))
    return updates + [(scale, scale_next), (good, good_next)]


def adamw_from_grads(params: Sequence, grads: Sequence, lr=0.001, b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8, weight_decay: float = 0.01) -> List[Tuple]:
    """AdamW on precomputed gradients (for ``scaled_loss_updates`` and
    ``accumulate_gradients``)."""
    return _adamw_updates(list(params), list(grads), lr, b1, b2, eps, weight_decay)


def accumulate_gradients(cost, params: Sequence, opt_fn, every: int) -> List[Tuple]:
    """Gradient accumulation over microbatches: each call adds this
    batch's gradients into accumulators (float32, float64 for float64
    parameters); every ``every``-th call the optimizer takes their mean
    and they are reset.  ``opt_fn(mean grads) -> updates`` is an
    optimizer taking gradients, or a float, the learning rate of plain
    SGD."""
    if every < 1:
        raise ValueError("every must be >= 1")
    params = list(params)
    ctr = _counter("accum_ctr", params[0].device)
    ctr_next = ctr + 1.0
    apply_now = tm.ge(ctr_next, np.float32(every))
    accs, avg_grads = [], []
    for p, g in zip(params, _grads(cost, params)):
        acc_dt = "float64" if str(p.get_value().dtype) == "float64" else "float32"
        acc = _state(p, "_gacc", acc_dt)
        acc_new = acc + cast(g, acc_dt)
        accs.append((acc, acc_new))
        avg_grads.append(acc_new / np.asarray(every, dtype=acc_dt))
    if callable(opt_fn):
        raw = opt_fn(avg_grads)
    else:
        raw = [(p, p - float(opt_fn) * cast(g, p.type.dtype)) for p, g in zip(params, avg_grads)]
    updates: List[Tuple] = [(var, switch(apply_now, new, var)) for var, new in raw]
    updates += [(acc, switch(apply_now, 0.0 * acc, acc_new)) for acc, acc_new in accs]
    updates.append((ctr, switch(apply_now, np.float32(0.0), ctr_next)))
    return updates


def ema_updates(params: Sequence, decay: float = 0.999):
    """An exponential moving average of the parameters, the weights to
    serve: (updates to add to the train step, the average's shared
    variables)."""
    updates: List[Tuple] = []
    emas = []
    for p in params:
        value = p.get_value()
        ema = _state(p, "_ema", value=value)
        acc_dt = "float64" if str(value.dtype) == "float64" else "float32"
        updates.append((ema, cast(decay * cast(ema, acc_dt) + (1.0 - decay) * cast(p, acc_dt), str(value.dtype))))
        emas.append(ema)
    return updates, emas
