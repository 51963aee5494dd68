"""Weight-only int8 quantization for serving (the counterpart of
``aesara_tpu/models/quant.py``).

Single-stream decode is bound by its weight reads; storing weights as
int8 with per-output-channel float scales quarters (against fp32) the
bytes of the weights at rest.  The int8 values live on the card as int8
shared variables, and the dequantize (``cast(w_q) * scale``) is one
Composite, one K1 launch, ahead of the product that reads it (XLA fuses
it into the product's operand read; the port does not).

Symmetric per-channel quantization: ``scale_j = max|w[:, j]| / 127``,
``w_q = round(w / scale)``.  Reconstruction error is ≤ scale/2 per
entry (~0.4% of the channel's max), which preserves greedy decode on
trained models; this module keeps the MODEL GRAPH CODE UNCHANGED — the
quantized layer's ``wq``/``w1``/... attributes are dequantize
*expressions*, and ``generate_fn`` builds the same graph over them.
"""

from __future__ import annotations

import copy

import numpy as np

from aesara_tpu_torch.compile.sharedvalue import shared
from aesara_tpu_torch.config import config
from aesara_tpu_torch.scalar.ops import to_host
from aesara_tpu_torch.tensor.basic import cast

__all__ = ["quantize_array_int8", "dequantize_expr", "quantize_decoder_int8"]

_WEIGHT_NAMES = ("wq", "wk", "wv", "wo", "w1", "w2")


def quantize_array_int8(w: np.ndarray):
    """(int8 values, float32 per-channel scales) — symmetric, one scale
    per output channel (the LAST axis of the weight)."""
    w = np.asarray(w, dtype="float32")
    reduce_axes = tuple(a for a in range(w.ndim) if a != w.ndim - 1)
    amax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = (amax / 127.0 + 1e-30).astype("float32")
    q = np.clip(np.round(w / scale), -127, 127).astype("int8")
    return q, scale.reshape(-1).astype("float32")


def dequantize_expr(q_shared, scale_shared):
    """Symbolic ``float(w_q) * scale`` with the scale broadcast over the
    last (output-channel) axis."""
    fX = config.floatX
    deq = cast(q_shared, fX)
    ndim = q_shared.type.ndim
    s = cast(scale_shared, fX)
    if ndim == 2:
        s = s.dimshuffle("x", 0)
    return deq * s


def _quantize_attr(obj, name, device):
    w = getattr(obj, name)
    # the values as float32 (a bfloat16 value's user form is a torch tensor)
    q_vals, s_vals = quantize_array_int8(to_host(w.get_value(), w.type.dtype))
    q = shared(q_vals, name=f"{w.name or name}_q8", device=device)
    s = shared(s_vals, name=f"{w.name or name}_scale", device=device)
    setattr(obj, name, dequantize_expr(q, s))
    return q, s


def quantize_decoder_int8(lm):
    """Return a serving copy of a ``DecoderLM`` whose projection/FFN
    weights and embedding are int8 shareds read through dequantize
    expressions.  LayerNorm gains/biases and FFN biases stay float
    (negligible bytes).  The copy shares no training state with ``lm``;
    use it for ``generate_fn``/``generate_batched_fn``/
    ``generate_from_prompt_fn`` only.  Its shareds live on the device
    of ``lm``'s embedding."""
    device = lm.embed.device
    qlm = copy.copy(lm)
    qlm.layers = [copy.copy(layer) for layer in lm.layers]
    qlm.params = []          # not a trainable object
    qlm.quantized_shareds = []
    float_names = ("b1", "b2", "ln1_g", "ln1_b", "ln2_g", "ln2_b")
    for layer in qlm.layers:
        layer.params = []
        for name in _WEIGHT_NAMES:
            qlm.quantized_shareds += _quantize_attr(layer, name, device)
        # the float leftovers get INDEPENDENT copies too — the serving
        # model must not drift when the original keeps training
        for name in float_names:
            src = getattr(layer, name)
            setattr(layer, name,
                    shared(src.get_value(), name=src.name, device=device))
    qlm.quantized_shareds += _quantize_attr(qlm, "embed", device)
    return qlm
