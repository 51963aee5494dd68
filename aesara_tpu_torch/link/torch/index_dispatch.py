"""Lowerings of the fancy-index ops (the counterpart of
``aesara_tpu/link/jax/dispatch.py:886-1060``): ``AdvancedSubtensor1``,
``AdvancedIncSubtensor1``, ``AdvancedSubtensor`` and
``AdvancedIncSubtensor``.

Out-of-range indices follow the JAX package's XLA lowering, with no host
read: ``AdvancedSubtensor1`` is ``jnp.take``, whose out-of-range rows are
the fill value (NaN for floats, the least value of a signed integer type,
the largest of an unsigned one, True for booleans); ``AdvancedSubtensor``
clamps each index into its axis after wrapping a negative one once; an
inc or set drops the updates at out-of-range indices.  (The JAX package's
Python ``perform`` raises IndexError instead.)

An index is an integer array (no host read: the function captures), a
boolean mask that is a graph constant (turned into integer arrays when
the function is compiled; captures), or a boolean mask computed from data:
its result's length is the data's, so the lowering reads it on the host
(``torch.nonzero``) and the function runs eagerly, naming the blocker.  A
set or inc through one mask whose ``y`` broadcasts over the masked
elements has the shape of ``x`` and is a ``torch.where``: no host read.

A read indexes a view of ``x`` at its slices with torch, the advanced dims
moved to the front and the result's broadcast dims moved back where NumPy
keeps them in place.  A write copies ``x`` into a buffer one longer along
each advanced dim, sends an out-of-range index to that spare slot, and
calls ``index_put_`` on the same view of the buffer; the copy without the
spare slots is the result.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.graph.ir import Constant
from aesara_tpu_torch.link.torch.dispatch import _BOUND_BLOCKER, _region, _wrapped, torch_funcify
from aesara_tpu_torch.tensor.subtensor import (
    ARRAY, SYM, AdvancedIncSubtensor, AdvancedIncSubtensor1, AdvancedSubtensor, AdvancedSubtensor1,
    _fancy_layout, _input_kinds,
)


MASK_BLOCKER = "has a boolean mask computed from data: its result's length is the data's, read on the host"


def _fill_value(dtype):
    """``jnp.take``'s fill for an out-of-range row of ``dtype``."""
    import torch

    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float("nan")
    return torch.iinfo(dtype).min if dtype.is_signed else torch.iinfo(dtype).max


@torch_funcify.register(AdvancedSubtensor1)
def _torch_advanced_subtensor1(op, node):
    import torch

    def advanced_subtensor1(x, ilist):
        n = x.shape[0]
        fill = _fill_value(x.dtype)
        if n == 0:
            return torch.full((ilist.shape[0],) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        # an index in [-n, n) is its remainder; one outside reads any row, then the fill
        i = ilist.to(torch.int64)
        rows = x.index_select(0, torch.remainder(i, n))
        valid = (i >= -n) & (i < n)
        return torch.where(valid.reshape((-1,) + (1,) * (x.dim() - 1)), rows, fill)

    return advanced_subtensor1


def _padded_copy(x, dims):
    """A copy of ``x`` in a buffer one longer along each of ``dims`` (the
    spare slots that out-of-range updates go to), and the view of it that
    is the copy."""
    shape = list(x.shape)
    for d in dims:
        shape[d] += 1
    buf = x.new_empty(shape)
    copy = buf[tuple(slice(0, n) for n in x.shape)]
    copy.copy_(x)
    return buf, copy


def _spare(i, n):
    """A wrapped index tensor with each entry outside [0, n) sent to the
    spare slot ``n``."""
    import torch

    return torch.where((i >= 0) & (i < n), i, n)


@torch_funcify.register(AdvancedIncSubtensor1)
def _torch_advanced_inc_subtensor1(op, node):
    import torch

    accumulate = not op.set_instead_of_inc

    def advanced_inc_subtensor1(x, y, ilist):
        buf, copy = _padded_copy(x, (0,))
        values = y.to(x.dtype).broadcast_to((ilist.shape[0],) + tuple(x.shape[1:]))
        i = ilist.to(torch.int64)
        buf.index_put_((_spare(_wrapped(i, x.shape[0]), x.shape[0]),), values, accumulate=accumulate)
        return copy

    return advanced_inc_subtensor1


class _Fancy:
    """The plan of one fancy index of a node: its static layout and how
    each index input is read."""

    def __init__(self, op, node, n_fixed: int):
        x = node.inputs[0]
        index_inputs = node.inputs[n_fixed:]
        _, self.adv_dims, self.in_place = _fancy_layout(x, op.idx_list, list(index_inputs))
        self.ndim = x.type.ndim
        #: per entry: ("slice", parts) | ("int", part) | ("array", k) | ("mask", k, nonzero of a constant or None, ndim)
        self.entries, self.syncs, self.masks = [], [], []
        it = iter(range(len(index_inputs)))
        for e in op.idx_list:
            if e == ARRAY:
                k = next(it)
                v = index_inputs[k]
                if v.type.dtype == "bool":
                    const = np.nonzero(np.asarray(v.data)) if isinstance(v, Constant) else None
                    if const is None:
                        self.masks.append(n_fixed + k)
                    self.entries.append(("mask", k, const, v.type.ndim))
                else:
                    self.entries.append(("array", k))
            elif isinstance(e, slice):
                parts = []
                for p in (e.start, e.stop, e.step):
                    if p is SYM:
                        k = next(it)
                        v = index_inputs[k]
                        parts.append(int(v.data) if isinstance(v, Constant) else ("in", k))
                        if not isinstance(v, Constant):
                            self.syncs.append(n_fixed + k)
                    else:
                        parts.append(p)
                self.entries.append(("slice", parts))
            else:
                if e is SYM:
                    k = next(it)
                    v = index_inputs[k]
                    self.entries.append(("int", int(v.data) if isinstance(v, Constant) else ("in", k)))
                else:
                    self.entries.append(("int", e))
        self.consts: dict = {}

    def _const(self, key, arrays, device):
        import torch

        got = self.consts.get((key, str(device)))
        if got is None:
            got = self.consts[(key, str(device))] = [torch.as_tensor(a, dtype=torch.int64, device=device)
                                                     for a in arrays]
        return got

    def resolve(self, x, index_inputs):
        """(the slices by dim of x, one per dim, with a negative step
        kept, and the advanced index tensors, one per advanced dim, wrapped
        once but not clamped, not yet broadcast)."""
        import torch

        def scalar(p):
            return int(index_inputs[p[1]]) if isinstance(p, tuple) else p

        slices, adv = [], []
        for pos, entry in enumerate(self.entries):
            kind = entry[0]
            if kind == "slice":
                slices.append(slice(*[scalar(p) for p in entry[1]]))
            elif kind == "int":
                v = entry[1]
                if isinstance(v, tuple):
                    v = index_inputs[v[1]]
                if not isinstance(v, torch.Tensor):
                    v = torch.full((), int(v), dtype=torch.int64, device=x.device)
                slices.append(None)
                adv.append(v.to(torch.int64))
            elif kind == "mask":
                _, k, const, ndim = entry
                parts = (self._const(pos, const, x.device) if const is not None
                         else list(torch.nonzero(index_inputs[k], as_tuple=True)))
                slices.extend([None] * ndim)
                adv.extend(parts)
            else:
                slices.append(None)
                adv.append(index_inputs[entry[1]])
        slices.extend([slice(None)] * (self.ndim - len(slices)))
        for j, d in enumerate(self.adv_dims):
            n = x.shape[d]
            adv[j] = torch.where(adv[j] < 0, adv[j] + n, adv[j])
        return slices, adv


@torch_funcify.register(AdvancedSubtensor)
def _torch_advanced_subtensor(op, node):
    import torch

    plan = _Fancy(op, node, 1)

    def advanced_subtensor(x, *index_inputs):
        slices, adv = plan.resolve(x, index_inputs)
        static = tuple(slice(None) if s is None else s for s in slices)
        negative = {d: s for d, s in enumerate(static) if s.step is not None and s.step < 0}
        view, flips = _region(x, tuple(slice(None) if d in negative else s for d, s in enumerate(static)),
                              negative)
        if flips:
            view = view.flip(flips)
        adv = [a.clamp(0, max(x.shape[d] - 1, 0)) for a, d in zip(adv, plan.adv_dims)]
        adv = torch.broadcast_tensors(*adv)
        nb = adv[0].dim()
        moved = view.movedim(plan.adv_dims, list(range(len(plan.adv_dims))))
        res = moved[tuple(a.reshape(-1) for a in adv)].reshape(tuple(adv[0].shape) + tuple(moved.shape[len(adv):]))
        if plan.in_place and plan.adv_dims[0]:
            res = res.movedim(list(range(nb)), list(range(plan.adv_dims[0], plan.adv_dims[0] + nb)))
        return res

    advanced_subtensor.host_inputs = tuple(1 + k for k, e in enumerate(_input_kinds(op.idx_list)) if e is SYM)
    _flag_reads(advanced_subtensor, plan)
    return advanced_subtensor


def _flag_reads(fn, plan):
    """Name what keeps ``fn`` from being captured: a mask from data, or a
    slice bound read on the host where it is on the device."""
    if plan.masks:
        fn.capturable = False
        fn.blocker = MASK_BLOCKER
    fn.syncs = tuple(plan.syncs)
    fn.sync_blocker = _BOUND_BLOCKER


def _mask_where(op, node):
    """The ``torch.where`` form of a set or inc through one boolean mask
    among full slices, whose ``y`` broadcasts over the masked elements, or
    None."""
    import torch

    x, y, *index_inputs = node.inputs
    if len(index_inputs) != 1 or index_inputs[0].type.dtype != "bool":
        return None
    if any(e != ARRAY and e != slice(None) for e in op.idx_list):
        return None
    p = op.idx_list.index(ARRAY)
    k = index_inputs[0].type.ndim
    r = x.type.ndim - k + 1          # the masked region's rank
    j = p - (r - y.type.ndim)        # y's dim over the masked elements
    if y.type.ndim > r or (j >= 0 and y.type.shape[j] != 1):
        return None
    set_instead = op.set_instead_of_inc

    def mask_where(x, y, mask):
        y = y.reshape((1,) * (r - y.dim()) + tuple(y.shape))
        y = y.reshape(tuple(y.shape[:p]) + (1,) * k + tuple(y.shape[p + 1:]))
        m = mask.reshape((1,) * p + tuple(mask.shape) + (1,) * (x.dim() - p - k))
        return torch.where(m, y.to(x.dtype) if set_instead else x + y.to(x.dtype), x)

    return mask_where


@torch_funcify.register(AdvancedIncSubtensor)
def _torch_advanced_inc_subtensor(op, node):
    import torch

    where = _mask_where(op, node)
    if where is not None:
        return where
    plan = _Fancy(op, node, 2)
    accumulate = not op.set_instead_of_inc

    def advanced_inc_subtensor(x, y, *index_inputs):
        slices, adv = plan.resolve(x, index_inputs)
        dims = plan.adv_dims
        buf, copy = _padded_copy(x, dims)
        adv = torch.broadcast_tensors(*[_spare(a, x.shape[d]) for a, d in zip(adv, dims)])
        static = tuple(slice(None) if s is None else s for s in slices)
        negative = {d: s for d, s in enumerate(static) if s.step is not None and s.step < 0}
        view, flips = _region(buf, tuple(slice(None) if d in negative else s for d, s in enumerate(static)),
                              negative)
        moved = view.movedim(dims, list(range(len(dims))))
        nb = adv[0].dim()
        shape = tuple(adv[0].shape) + tuple(moved.shape[len(dims):])
        values = y.to(x.dtype)
        values = values.reshape((1,) * (len(shape) - values.dim()) + tuple(values.shape))
        if plan.in_place and dims[0]:
            # y is in the result's layout, the broadcast dims at the first advanced dim
            values = values.movedim(list(range(dims[0], dims[0] + nb)), list(range(nb)))
        rest = [d for d in range(x.dim()) if d not in dims]
        if flips:
            # the view reads a negative-step slice forward: so are its values
            values = values.flip([nb + rest.index(d) for d in flips])
        moved.index_put_(tuple(adv), values.broadcast_to(shape), accumulate=accumulate)
        return copy

    advanced_inc_subtensor.host_inputs = tuple(2 + k for k, e in enumerate(_input_kinds(op.idx_list)) if e is SYM)
    _flag_reads(advanced_inc_subtensor, plan)
    return advanced_inc_subtensor
