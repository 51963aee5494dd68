"""Uniform-to-multinomial converters (the counterpart of
``aesara_tpu/sandbox/multinomial.py``: ``MultinomialFromUniform``,
``ChoiceFromUniform``).

The selection rule, "the first outcome whose cumulative probability
exceeds the uniform draw", is one cumulative sum and an argmax, on the
host in ``perform`` and as torch ops in ``torch_forward``, which the
lowerings (``link/torch/random_dispatch.py``) run; the draw count ``n``
is read on the host.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.tensor.basic import as_tensor_variable, zeros_like
from aesara_tpu_torch.tensor.type import TensorType

__all__ = ["MultinomialFromUniform", "ChoiceFromUniform",
           "multinomial", "choice"]


class MultinomialFromUniform(Op):
    """(pvals (B,K), unis (n*B,), n) → (B,K) counts: each uniform draw
    selects the first outcome whose cumulative probability exceeds it
    (reference ``MultinomialFromUniform:14``)."""

    __props__ = ("odtype",)

    def __init__(self, odtype):
        self.odtype = odtype

    def __str__(self):
        return f"{type(self).__name__}{{{self.odtype}}}"

    def make_node(self, pvals, unis, n=1):
        pvals = as_tensor_variable(pvals)
        unis = as_tensor_variable(unis)
        n = as_tensor_variable(n)
        if pvals.type.ndim != 2:
            raise NotImplementedError("pvals must be 2d")
        if unis.type.ndim != 1:
            raise NotImplementedError("unis must be 1d")
        odtype = pvals.type.dtype if self.odtype == "auto" else self.odtype
        out = TensorType(odtype, pvals.type.shape)()
        return Apply(self, [pvals, unis, n], [out])

    def perform(self, node, inputs, output_storage):
        pvals, unis, n = inputs
        n = int(n)
        B, K = pvals.shape
        if unis.shape[0] != B * n:
            raise ValueError("unis.shape[0] != pvals.shape[0] * n")
        cum = np.cumsum(pvals, axis=1)                       # (B, K)
        u = unis.reshape(n, B)                               # sample-major
        # first outcome index where the cumulative mass exceeds the draw
        idx = (cum[None, :, :] > u[:, :, None]).argmax(axis=2)   # (n, B)
        out = np.zeros((B, K), dtype=node.outputs[0].type.dtype)
        rows = np.broadcast_to(np.arange(B), (n, B))
        np.add.at(out, (rows.ravel(), idx.ravel()), 1)
        output_storage[0][0] = out

    def torch_forward(self, pvals, unis, n, out_dtype):
        """The counts as torch ops (``n`` a host value)."""
        import torch

        n = int(n)
        B, K = pvals.shape
        if unis.shape[0] != B * n:
            raise ValueError("unis.shape[0] != pvals.shape[0] * n")
        cum = torch.cumsum(pvals, dim=1)
        u = unis.reshape(n, B)
        idx = torch.argmax((cum[None, :, :] > u[:, :, None]).to(torch.int8), dim=2)
        out = torch.zeros((B, K), dtype=out_dtype, device=pvals.device)
        rows = torch.arange(B, device=pvals.device).expand(n, B)
        return out.index_put_((rows.reshape(-1), idx.reshape(-1)), torch.ones((), dtype=out_dtype,
                                                                                device=pvals.device), accumulate=True)

    def grad(self, inputs, output_grads):
        return [zeros_like(x) for x in inputs]

    def infer_shape(self, fgraph, node, shapes):
        return [shapes[0]]


class ChoiceFromUniform(MultinomialFromUniform):
    """(pvals (B,K), unis (n*B,), n) → (B,n) sampled outcome INDICES,
    optionally without replacement (reference ``ChoiceFromUniform:223``)."""

    __props__ = ("odtype", "replace")

    def __init__(self, odtype, replace=False):
        super().__init__(odtype)
        self.replace = replace

    def make_node(self, pvals, unis, n=1):
        pvals = as_tensor_variable(pvals)
        unis = as_tensor_variable(unis)
        n = as_tensor_variable(n)
        if pvals.type.ndim != 2:
            raise NotImplementedError("pvals must be 2d")
        if unis.type.ndim != 1:
            raise NotImplementedError("unis must be 1d")
        odtype = "int64" if self.odtype == "auto" else self.odtype
        out = TensorType(odtype, (pvals.type.shape[0], None))()
        return Apply(self, [pvals, unis, n], [out])

    def perform(self, node, inputs, output_storage):
        pvals, unis, n = inputs
        n = int(n)
        B, K = pvals.shape
        if not self.replace and n > K:
            raise ValueError(
                "Cannot sample without replacement more draws than outcomes"
            )
        if unis.shape[0] != B * n:
            raise ValueError("unis.shape[0] != pvals.shape[0] * n")
        remaining = np.array(pvals, dtype="float64", copy=True)
        u = unis.reshape(n, B)
        out = np.empty((B, n), dtype=node.outputs[0].type.dtype)
        for c in range(n):
            total = remaining.sum(axis=1, keepdims=True)      # (B, 1)
            cum = np.cumsum(remaining, axis=1)                # (B, K)
            idx = (cum > u[c][:, None] * total).argmax(axis=1)
            out[:, c] = idx
            if not self.replace:
                remaining[np.arange(B), idx] = 0.0
        output_storage[0][0] = out

    def torch_forward(self, pvals, unis, n, out_dtype):
        """The indices as torch ops (``n`` a host value)."""
        import torch

        n = int(n)
        B, K = pvals.shape
        if not self.replace and n > K:
            raise ValueError("Cannot sample without replacement more draws than outcomes")
        if unis.shape[0] != B * n:
            raise ValueError("unis.shape[0] != pvals.shape[0] * n")
        remaining = pvals.to(torch.float64).clone()
        u = unis.reshape(n, B)
        rows = torch.arange(B, device=pvals.device)
        cols = []
        for c in range(n):
            total = remaining.sum(dim=1, keepdim=True)
            cum = torch.cumsum(remaining, dim=1)
            idx = torch.argmax((cum > u[c][:, None] * total).to(torch.int8), dim=1)
            cols.append(idx)
            if not self.replace:
                remaining[rows, idx] = 0.0
        return torch.stack(cols, dim=1).to(out_dtype)

    def infer_shape(self, fgraph, node, shapes):
        return [(shapes[0][0], None)]


def multinomial(pvals, unis, n=1, odtype="auto"):
    return MultinomialFromUniform(odtype)(pvals, unis, n)


def choice(pvals, unis, n=1, replace=False, odtype="auto"):
    return ChoiceFromUniform(odtype, replace=replace)(pvals, unis, n)


from aesara_tpu_torch.link.torch import random_dispatch  # noqa: F401,E402  (registers the lowerings)
