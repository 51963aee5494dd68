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
"""

from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np


__all__ = ["load_params", "params_by_name"]


def params_by_name(model) -> dict:
    """``{name: array}`` of a model's parameters, in registration order
    (works for a model of either package)."""
    names = [p.name for p in model.params]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate parameter names {names}")
    return {p.name: np.asarray(p.get_value()) for p in model.params}


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
    arrays = [np.asarray(a) for a in arrays]
    for p, a in zip(params, arrays):
        if a.shape != p.type.shape or a.dtype.name != p.type.dtype:
            raise ValueError(f"parameter {p.name}: got {a.dtype}{a.shape}, "
                             f"model has {p.type.dtype}{p.type.shape}")
    for p, a in zip(params, arrays):
        p.set_value(a)
