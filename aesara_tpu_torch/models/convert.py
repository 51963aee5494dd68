"""Carry a JAX-package model's parameters into a port model: the encoder
layer, the linear models, the ``MLP`` (``w0, b0, w1, b1, ...``) and the
recurrent models (``ElmanRNN``: ``wx, wh, b, w_out, b_out``; ``LSTM``:
``w_lstm, b_lstm, w_out, b_out``; ``GRU``: ``w_rz, b_rz, w_h, b_h, w_out,
b_out``), whose parameters have the same names in both packages.

``load_params(model, values)`` takes either the list
``[np.asarray(p.get_value()) for p in jax_model.params]`` (the JAX
``Model.get_values()``) or a ``{name: array}`` dict, checks names, order,
shapes and dtypes against the port model's parameters, and raises on any
mismatch before it writes anything.

A ``DecoderLM`` names the parameters of every layer alike (``wq`` in each),
so it is carried by qualified name: ``named_state(lm)`` gives ``embed`` and
``layers.<i>.<name>`` of a decoder of either package, or of its
``quantize_decoder_int8`` copy (whose state is the int8 values and scales,
``layers.<i>.wq_q8``, ``layers.<i>.wq_scale``, ..., ``embed_q8``,
``embed_scale``, and the float leftovers ``layers.<i>.b1`` ...), and
``load_state(lm, named_state(jax_lm))`` writes them, with the same checks.
A bfloat16 array of the JAX package (an ml_dtypes array, which the port
does not import) is carried bit for bit into a torch.bfloat16 tensor
through float32, which holds it exactly (``port_value``).
A ``RandomStream`` of either package is carried the same way: its keys
(``uint32[2]``), ``rng.<i>.<name>`` in the order the stream made them
(``named_state(stream)``), so a port stream continues a JAX package's
draws and the other way round.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np

from aesara_tpu_torch.scalar.ops import from_host, is_torch_tensor


__all__ = ["load_params", "params_by_name", "named_state", "load_state", "port_value"]

#: the float state a quantized decoder layer keeps (``models/quant.py``)
_FLOAT_NAMES = ("b1", "b2", "ln1_g", "ln1_b", "ln2_g", "ln2_b")


def port_value(a):
    """A value for a port shared variable: an ml_dtypes bfloat16 array in
    the port's user form of one (``scalar.ops.from_host``: a float32 array
    holds it exactly), anything else as a NumPy array or the torch tensor
    it is."""
    if hasattr(a, "get_value"):
        a = a.get_value()
    if is_torch_tensor(a):
        return a
    a = np.asarray(a)
    return from_host(a.astype(np.float32), "bfloat16") if a.dtype.name == "bfloat16" else a


def _dtype_shape(a) -> tuple:
    return str(a.dtype).split(".")[-1], tuple(a.shape)


def params_by_name(model) -> dict:
    """``{name: array}`` of a model's parameters, in registration order
    (works for a model of either package)."""
    names = [p.name for p in model.params]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate parameter names {names}")
    return {p.name: port_value(p) for p in model.params}


def load_params(model, values: Union[Sequence[np.ndarray], Mapping[str, np.ndarray]]) -> None:
    params = model.params
    if isinstance(values, Mapping):
        if list(values) != [p.name for p in params]:
            raise ValueError(f"parameter names/order differ: got {list(values)}, "
                             f"model has {[p.name for p in params]}")
        arrays = list(values.values())
    else:
        arrays = list(values)
        if len(arrays) != len(params):
            raise ValueError(f"got {len(arrays)} arrays for {len(params)} parameters")
    arrays = [port_value(a) for a in arrays]
    for p, a in zip(params, arrays):
        if _dtype_shape(a) != (p.type.dtype, p.type.shape):
            raise ValueError(f"parameter {p.name}: got {a.dtype}{a.shape}, "
                             f"model has {p.type.dtype}{p.type.shape}")
    for p, a in zip(params, arrays):
        p.set_value(a)


def named_state(lm) -> dict:
    """``{qualified name: shared variable}`` of a ``DecoderLM`` of either
    package, of its int8 copy, or of a ``RandomStream`` (module
    docstring), in a fixed order."""
    out = {}
    if hasattr(lm, "state_updates"):
        for i, (rng, _) in enumerate(lm.state_updates):
            out[f"rng.{i}.{rng.name}"] = rng
        return out
    if hasattr(lm, "quantized_shareds"):
        per = len(lm.quantized_shareds) // len(lm.layers)
        for i, layer in enumerate(lm.layers):
            for w in lm.quantized_shareds[per * i:per * (i + 1)]:
                out[f"layers.{i}.{w.name}"] = w
            for name in _FLOAT_NAMES:
                out[f"layers.{i}.{name}"] = getattr(layer, name)
        for w in lm.quantized_shareds[per * len(lm.layers):]:
            out[w.name] = w
        return out
    out["embed"] = lm.embed
    for i, layer in enumerate(lm.layers):
        for p in layer.params:
            out[f"layers.{i}.{p.name}"] = p
    return out


def load_state(lm, values: Mapping) -> None:
    """Write ``values`` (``{qualified name: shared variable or array}``,
    as ``named_state`` of the source gives) into ``lm``'s state (a model or
    a ``RandomStream`` of either package), having checked names, order,
    shapes and dtypes."""
    state = named_state(lm)
    if list(values) != list(state):
        raise ValueError(f"state names/order differ: got {list(values)}, model has {list(state)}")
    arrays = [port_value(v) for v in values.values()]
    for (name, p), a in zip(state.items(), arrays):
        have = port_value(p)
        if _dtype_shape(a) != _dtype_shape(have):
            raise ValueError(f"{name}: got {a.dtype}{tuple(a.shape)}, model has {have.dtype}{tuple(have.shape)}")
    for p, a in zip(state.values(), arrays):
        p.set_value(a)
