"""Batch normalization (the counterpart of
``aesara_tpu/tensor/nnet/batchnorm.py``): ``batch_normalization``,
``batch_normalization_train`` and ``batch_normalization_test``, graph
compositions whose elementwise chains K1 fuses."""

from __future__ import annotations

import aesara_tpu_torch.tensor.basic as tb
import aesara_tpu_torch.tensor.math as tm
from aesara_tpu_torch.tensor.basic import as_tensor_variable


__all__ = ["batch_normalization", "batch_normalization_train",
           "batch_normalization_test"]


def batch_normalization(inputs, gamma, beta, mean, std, mode="low_mem"):
    """(x - mean)/std * gamma + beta (reference same name; the mode flag
    selected between C implementations — no-op here)."""
    inputs = as_tensor_variable(inputs)
    return (inputs - mean) * (gamma / std) + beta


def _axes_param(input_ndim, axes):
    if axes == "per-activation":
        return (0,)
    if axes == "spatial":
        return (0,) + tuple(range(2, input_ndim))
    return tuple(int(a) for a in axes)


def batch_normalization_train(
    inputs, gamma, beta, axes="spatial", epsilon=1e-4,
    running_average_factor=0.1, running_mean=None, running_var=None,
):
    """Returns (out, mean, invstd[, new_running_mean, new_running_var])
    (reference same name)."""
    inputs = as_tensor_variable(inputs)
    axes_t = _axes_param(inputs.type.ndim, axes)
    mean = tm.mean(inputs, axis=axes_t, keepdims=True)
    var = tm.var(inputs, axis=axes_t, keepdims=True)
    invstd = tm.reciprocal(tm.sqrt(var + epsilon))
    out = (inputs - mean) * (gamma * invstd) + beta
    results = [out, mean, invstd]
    if running_mean is not None:
        results.append(
            running_mean * (1.0 - running_average_factor)
            + mean * running_average_factor
        )
    if running_var is not None:
        from aesara_tpu_torch.tensor.shape import shape_tuple

        m = tb.constant(1.0)
        n = tb.constant(1, dtype="int64")
        shp = shape_tuple(inputs)
        for a in axes_t:
            n = n * shp[a]
        unbias = tb.cast(n, var.type.dtype) / tm.maximum(
            tb.cast(n, var.type.dtype) - 1.0, 1.0
        )
        results.append(
            running_var * (1.0 - running_average_factor)
            + var * unbias * running_average_factor
        )
    return tuple(results)


def batch_normalization_test(
    inputs, gamma, beta, mean, var, axes="spatial", epsilon=1e-4
):
    inputs = as_tensor_variable(inputs)
    invstd = tm.reciprocal(tm.sqrt(var + epsilon))
    return (inputs - mean) * (gamma * invstd) + beta
