"""Connectionist Temporal Classification loss (the counterpart of
``aesara_tpu/tensor/nnet/ctc.py``).

The loss is the JAX package's dynamic programme in log space, as torch
ops over the T steps (its ``lax.scan``, which XLA runs outside any Pallas
kernel): the forward variables of the blank-extended labels, floored at
``-1e30`` (so an impossible alignment gives a large finite loss, not
``inf``), each sequence frozen past its input length by a mask read on the
device (nothing is read on the host, so a step holding the loss captures
into one CUDA graph).  Padding labels (``-1``) index the classes modulo C,
as ``jnp.take_along_axis`` wraps them: a padded state reads column C-1.

:class:`CTCGrad` is the gradient of the same DP as ``jax.vjp`` takes it
(the JAX package's): the forward sweep again, then a reverse sweep written
out by hand, two log-sum-exp cotangents and a shift a step, with no
autograd graph (half the kernels of autograd's, whose tape the linker's
``no_grad`` would need lifting for).  It is deterministic: the emissions
are gathered once for all steps, and their cotangents go back to the
classes as one batched product with the states' one-hot rows, where a
gather's own gradient would scatter with atomics.  ``torch.nn.functional.ctc_loss`` computes
another function (``inf`` for impossible alignments, ``zero_infinity``)
and is not used.
"""

from __future__ import annotations

import math

from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.tensor.basic import as_tensor_variable, cast
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["CTCLoss", "CTCGrad", "ctc", "ctc_loss_torch", "ctc_grad_torch"]

#: the DP's floor in log space (the JAX package's ``neg_inf``)
NEG_INF = -1e30


def _lse_parts(a, b):
    """log(exp(a) + exp(b)) with the JAX package's guard (the max where it
    is not finite), and what its VJP reads: (out, (pair, max, finite,
    exp(pair - safe), their sum)).  The pair is stacked, so that each
    step is one kernel for both (the sum of two is their one addition)."""
    import torch

    pair = torch.stack([a, b])
    m = torch.amax(pair, dim=0)
    finite = torch.isfinite(m)
    safe = torch.where(finite, m, torch.zeros_like(m))
    e = torch.exp(pair - safe)
    total = e.sum(dim=0)
    return torch.where(finite, safe + torch.log(total), m), (pair, m, finite, e, total)


def _lse_vjp(g, parts):
    """The cotangents of the pair from the output's ``g``, as ``jax.vjp``
    computes them: (g / sum) exp(x - safe) through the finite branch (the
    max's own term there cancels to rounding and is left out), and where
    the max is not finite ``g`` to the max, split evenly between equal
    operands (``lax.max``'s balanced rule), plus the other branch's zero
    cotangent through the same formula, which is nan as in JAX."""
    import torch

    pair, m, finite, e, total = parts
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    through = (torch.where(finite, g, zero) / total).unsqueeze(0) * e
    eq = pair == m
    w = torch.where(eq[0] & eq[1], 0.5, eq.to(g.dtype))
    return through + torch.where(finite, zero, g).unsqueeze(0) * w


def _dp_setup(log_probs, labels, input_lengths, label_lengths, blank):
    """The DP's fixed pieces: each state's emission at every step (T, B,
    S), gathered (a padded state's from column C-1), the states' one-hot
    rows of the classes, the first forward variables, the skip mask, each
    sequence's frames."""
    import torch
    import torch.nn.functional as F

    T, B, C = log_probs.shape
    labels = labels.to(torch.int64)
    input_lengths = input_lengths.to(torch.int64)
    label_lengths = label_lengths.to(torch.int64)
    S = 2 * labels.shape[1] + 1
    ext = torch.full((B, S), blank, dtype=torch.int64, device=labels.device)
    ext[:, 1::2] = labels
    cls = torch.remainder(ext, C)
    emit = torch.gather(log_probs, 2, cls[None].expand(T, B, S))
    onehot = F.one_hot(cls, C).to(log_probs.dtype)
    neg_inf = torch.full((), NEG_INF, dtype=log_probs.dtype, device=log_probs.device)
    # alpha_0: the first blank, and the first label where there is one
    first = torch.zeros((B, S), dtype=torch.bool, device=labels.device)
    first[:, 0] = True
    if S > 1:
        first[:, 1] = label_lengths > 0
    alpha = torch.where(first, emit[0], neg_inf)
    same_as_prev2 = torch.cat([torch.ones((B, min(2, S)), dtype=torch.bool, device=labels.device),
                               ext[:, 2:] == ext[:, :-2]], dim=1)
    active = (torch.arange(T, device=input_lengths.device)[:, None] < input_lengths[None, :])[:, :, None]
    return emit, onehot, alpha, first, same_as_prev2, active, neg_inf, label_lengths


def _dp_step(alpha, emit_t, active_t, same_as_prev2, neg_inf, keep=None):
    """One step: a state's own, previous and skip predecessors (the skip
    unless a repeat or a blank sits between), frozen past the sequence's
    length; ``keep`` gains the two log-sum-exps' VJP parts."""
    import torch
    import torch.nn.functional as F

    padded = F.pad(alpha, (2, 0), value=NEG_INF)
    skip = torch.where(same_as_prev2, neg_inf, padded[:, :-2])
    inner, inner_parts = _lse_parts(padded[:, 1:-1], skip)
    outer, outer_parts = _lse_parts(alpha, inner)
    if keep is not None:
        keep.append((inner_parts, outer_parts))
    return torch.where(active_t, outer + emit_t, alpha)


def _dp_total(alpha, label_lengths, neg_inf):
    """log p of each sequence: the last blank's and the last label's."""
    import torch

    idx_last = 2 * label_lengths
    idx_prev = torch.clamp_min(2 * label_lengths - 1, 0)
    a_last = torch.gather(alpha, 1, idx_last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, idx_prev[:, None])[:, 0]
    return _lse_parts(a_last, torch.where(label_lengths > 0, a_prev, neg_inf)) + ((idx_last, idx_prev),)


def ctc_loss_torch(log_probs, labels, input_lengths, label_lengths, blank: int = 0):
    """The negative log-likelihood of each sequence, (B,), from (T, B, C)
    log-probabilities and (B, L) labels padded with -1."""
    emit, _, alpha, _, same_as_prev2, active, neg_inf, label_lengths = _dp_setup(
        log_probs, labels, input_lengths, label_lengths, blank)
    for t in range(1, log_probs.shape[0]):
        alpha = _dp_step(alpha, emit[t], active[t], same_as_prev2, neg_inf)
    return -_dp_total(alpha, label_lengths, neg_inf)[0]


def ctc_grad_torch(log_probs, labels, input_lengths, label_lengths, gz, blank: int = 0):
    """``gz`` times the gradient of :func:`ctc_loss_torch` with respect to
    ``log_probs``: the forward sweep again, keeping each step's VJP parts,
    then the reverse sweep by hand, as ``jax.vjp`` of the same DP computes
    it (each log-sum-exp's split, the freeze, the skip mask, the first
    step's and the end's selections); the emissions' cotangents go back
    to the classes through the one-hot rows."""
    import torch
    import torch.nn.functional as F

    T = log_probs.shape[0]
    emit, onehot, alpha, first, same_as_prev2, active, neg_inf, label_lengths = _dp_setup(
        log_probs, labels, input_lengths, label_lengths, blank)
    keep: list = []
    for t in range(1, T):
        alpha = _dp_step(alpha, emit[t], active[t], same_as_prev2, neg_inf, keep)
    _, end_parts, (idx_last, idx_prev) = _dp_total(alpha, label_lengths, neg_inf)
    S = alpha.shape[1]
    g_last, g_prev = _lse_vjp(-gz.to(alpha.dtype), end_parts)
    g_prev = torch.where(label_lengths > 0, g_prev, torch.zeros_like(g_prev))
    g_alpha = (F.one_hot(idx_last, S).to(alpha.dtype) * g_last[:, None]
               + F.one_hot(idx_prev, S).to(alpha.dtype) * g_prev[:, None])
    g_emit = [None] * T
    zero = torch.zeros((), dtype=alpha.dtype, device=alpha.device)
    for t in range(T - 1, 0, -1):
        inner_parts, outer_parts = keep.pop()
        g_new = torch.where(active[t], g_alpha, zero)
        g_emit[t] = g_new
        g_own, g_inner = _lse_vjp(g_new, outer_parts)
        g_prev1, g_skip = _lse_vjp(g_inner, inner_parts)
        g_skip = torch.where(same_as_prev2, zero, g_skip)
        g_alpha = (torch.where(active[t], zero, g_alpha) + g_own + F.pad(g_prev1[:, 1:], (0, 1))
                   + F.pad(g_skip[:, 2:], (0, 2)))
    g_emit[0] = torch.where(first, g_alpha, zero)
    g_emit = torch.stack(g_emit, dim=1)                   # (B, T, S)
    # a non-finite cotangent (an -inf log-probability's) reaches only its
    # own class, as the gather's scatter sends it
    finite = torch.isfinite(g_emit)
    g = torch.bmm(torch.where(finite, g_emit, zero), onehot)
    g = torch.where(torch.bmm((~finite).to(onehot.dtype), onehot) > 0, torch.full_like(g, math.nan), g)
    return g.transpose(0, 1)


class CTCLoss(Op):
    """ctc(log_probs (T, B, C), labels (B, L), input_lengths (B,),
    label_lengths (B,)) → the negative log-likelihood of each sequence (B,)."""

    __props__ = ("blank",)

    def __init__(self, blank: int = 0):
        self.blank = int(blank)

    def make_node(self, log_probs, labels, input_lengths, label_lengths):
        log_probs = as_tensor_variable(log_probs)
        labels = cast(as_tensor_variable(labels), "int64")
        input_lengths = cast(as_tensor_variable(input_lengths), "int64")
        label_lengths = cast(as_tensor_variable(label_lengths), "int64")
        if log_probs.type.ndim != 3:
            raise TypeError("log_probs must be (T, B, C)")
        return Apply(self, [log_probs, labels, input_lengths, label_lengths],
                     [TensorType(log_probs.type.dtype, (log_probs.type.shape[1],))()])

    def torch_forward(self, log_probs, labels, input_lengths, label_lengths):
        return ctc_loss_torch(log_probs, labels, input_lengths, label_lengths, self.blank)

    def perform(self, node, inputs, output_storage):
        from aesara_tpu_torch.scalar.ops import perform_by_torch

        perform_by_torch(self.torch_forward, node, inputs, output_storage)

    def infer_shape(self, fgraph, node, input_shapes):
        return [(input_shapes[0][1],)]

    def L_op(self, inputs, outputs, output_grads):
        from aesara_tpu_torch.gradient import disconnected_type

        return [CTCGrad(self.blank)(*inputs, output_grads[0])] + [disconnected_type() for _ in inputs[1:]]


class CTCGrad(Op):
    """The gradient of :class:`CTCLoss` with respect to its log-probabilities,
    given the loss's gradient ``gz`` (B,)."""

    __props__ = ("blank",)

    def __init__(self, blank: int = 0):
        self.blank = int(blank)

    def make_node(self, log_probs, labels, ilen, llen, gz):
        return Apply(self, [log_probs, labels, ilen, llen, gz], [log_probs.type()])

    def torch_forward(self, log_probs, labels, ilen, llen, gz):
        return ctc_grad_torch(log_probs, labels, ilen, llen, gz, self.blank)

    def perform(self, node, inputs, output_storage):
        from aesara_tpu_torch.scalar.ops import perform_by_torch

        perform_by_torch(self.torch_forward, node, inputs, output_storage)

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]


def ctc(activations, labels, input_lengths, label_lengths=None, blank=0):
    """CTC loss on (T, B, C) activations (pre-softmax; the log-softmax over
    the classes is applied here, as warp-ctc's convention has it).  Without
    ``label_lengths``, each row's count of labels >= 0."""
    from aesara_tpu_torch.tensor.special import log_softmax

    activations = as_tensor_variable(activations)
    log_probs = log_softmax(activations, axis=-1)
    labels = as_tensor_variable(labels)
    if label_lengths is None:
        from aesara_tpu_torch.tensor.math import ge as tge, sum as tsum

        label_lengths = cast(tsum(cast(tge(labels, 0), "int64"), axis=1), "int64")
    return CTCLoss(blank)(log_probs, labels, input_lengths, label_lengths)

