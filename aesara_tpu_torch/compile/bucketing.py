"""Dynamic-shape bucketing of a compiled function's inputs (the
counterpart of ``aesara_tpu/compile/bucketing.py``).

On the card a compiled function is keyed by its arguments' shapes: the
first call of a key runs eagerly, the second captures a CUDA graph, and
a function keeps ``MAX_KEYS`` keys (``link/torch/linker.py``).  A
varying-batch serving or packed-sequence loop would make a new key per
distinct length, so it would never replay a graph.  This module is the
answer: **opt-in bucket padding** in ``Function.__call__``, so that a
stream of lengths lands on a few rungs, each a key of its own.

    config.shape_buckets = "pow2"          # next power of two
    config.shape_buckets = "8,16,64,256"   # explicit ladder

Policy (batch-dim contract)
---------------------------
* Only the LEADING dim (axis 0) of explicit inputs typed with
  ``shape[0] is None`` participates; all such inputs must share one
  runtime length ``n`` (the batch).  Calls where they disagree run
  unbucketed (one compile per shape, exactly as before).
* Inputs are padded from ``n`` up to the bucket ``b`` by **replicating
  the last row** — replicated rows stay in-distribution (no log(0)/NaN
  surprises in the pad region) and integer index inputs stay in-range.
* Every user output (and ``In(update=...)`` state) whose static leading
  dim is ``None`` and whose runtime leading dim came back as ``b`` is
  sliced to ``[:n]``.

This is exact for batch-rowwise graphs — each output row depends only on
the corresponding input row (per-example losses, decode steps, dense /
elemwise / rowwise-attention stacks).  It is NOT exact for graphs that
reduce over the batch inside the function (a mean over axis 0 would see
the replicated rows): keep outputs per-example and aggregate on the
host, which is also the memory-friendly pattern.  Shared-variable
updates are applied as computed; the safety analysis below refuses a
function whose update carries the padded axis.

A second bucketed dim, the sequence, is declared per input as
``In(seq_bucketed=axis)`` and zero-padded (``pad_axis_zero``); the
declaration asserts masked semantics beyond the true length, and the
outputs that carry the axis (``axis_taint``) are sliced back.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["parse_buckets", "bucket_for", "pad_leading", "pad_axis_zero",
           "batch_axis_safety", "BucketingError"]


class BucketingError(Exception):
    """A bucket-padded function's graph mixes pad rows into real results
    (e.g. a mean over the batch axis): raising beats silently wrong
    numbers."""

_parse_cache: dict = {}


def parse_buckets(spec: str) -> Union[None, str, Tuple[int, ...]]:
    """``"off"`` → None; ``"pow2"`` → "pow2"; ``"4,16,64"`` → (4, 16, 64)."""
    if spec in _parse_cache:
        return _parse_cache[spec]
    res = _parse_buckets_uncached(spec)
    _parse_cache[spec] = res
    return res


def _parse_buckets_uncached(spec: str) -> Union[None, str, Tuple[int, ...]]:
    spec = (spec or "off").strip()
    if spec in ("off", ""):
        return None
    if spec == "pow2":
        return "pow2"
    try:
        vals = tuple(sorted({int(tok) for tok in spec.split(",") if tok.strip()}))
    except ValueError:
        raise ValueError(
            f"config.shape_buckets must be 'off', 'pow2' or a comma list of "
            f"ints; got {spec!r}"
        ) from None
    if not vals or any(v <= 0 for v in vals):
        raise ValueError(f"shape_buckets sizes must be positive: {spec!r}")
    return vals


def bucket_for(n: int, policy: Union[str, Sequence[int]]) -> int:
    """Smallest bucket ≥ n.  pow2: next power of two (n=0 → no padding);
    explicit ladder: first rung ≥ n, or n itself above the ladder (the
    call then compiles its own shape — visible, not silently wrong)."""
    if n <= 0:
        return n
    if policy == "pow2":
        return 1 << (int(n) - 1).bit_length()
    for b in policy:
        if b >= n:
            return int(b)
    return n


def pad_leading(arr: np.ndarray, b: int) -> np.ndarray:
    """Pad axis 0 from len(arr) to ``b`` by replicating the last row."""
    n = arr.shape[0]
    if n == b:
        return arr
    reps = np.broadcast_to(arr[-1:], (b - n,) + arr.shape[1:])
    return np.concatenate([np.asarray(arr), reps], axis=0)


def pad_axis_zero(arr: np.ndarray, axis: int, b: int) -> np.ndarray:
    """Pad ``axis`` from its current length to ``b`` with zeros — the
    sequence-dim policy (``In(seq_bucketed=axis)``): the graph author
    asserts masked semantics for positions beyond the true length, so
    zeros (not replicas) keep pad positions visibly inert."""
    arr = np.asarray(arr)
    n = arr.shape[axis]
    if n == b:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, b - n)
    return np.pad(arr, widths, mode="constant")


# ---------------------------------------------------------------------------
# Batch-axis safety analysis
#
# A replicate-padded batch axis is exact ONLY for row-wise graphs.  This
# dataflow analysis walks the compiled fgraph from the bucket-padded inputs
# tracking, per variable, WHICH axes carry the padded batch dim, and names
# the first op that folds pad rows into real results (an axis-0 CAReduce, a
# dot contraction over the batch, a batch-axis join/sort/reshape, ...).
# Conservative by design: an op it cannot prove row-wise is flagged — the
# failure mode is a clear error (or a forced-off warning), never silently
# wrong numbers.
# ---------------------------------------------------------------------------


def _full_slice(s) -> bool:
    return isinstance(s, slice) and s.start is None and s.stop is None and s.step is None


class _Unsafe(Exception):
    pass


class _SkipNode(Exception):
    """track-mode control flow: taint cleared at this node."""


def axis_taint(fgraph, taint0: dict) -> dict:
    """Permissive axis-tracking variant of the same propagation: given
    {fgraph input: axis} seed taints, return {variable: frozenset(axes)}
    of the axes that still carry the padded dim.  Ops the analysis cannot
    model CLEAR the taint (their outputs are then not sliced back — a
    visible shape, never a silently mis-sliced one).  Used to find which
    OUTPUT axes carry the zero-padded sequence dim (In(seq_bucketed=...))."""
    return _propagate(
        fgraph,
        {v: frozenset({ax}) for v, ax in taint0.items()},
        check=False,
    )


def batch_axis_safety(fgraph, tainted_inputs, update_outputs=()) -> Optional[str]:
    """None when every op on the path from ``tainted_inputs`` (each padded
    on axis 0) treats the padded axis row-wise; else a reason string naming
    the first offending node.  ``update_outputs`` are the positions of the
    outputs that are shared-variable updates."""
    try:
        taint = _propagate(
            fgraph, {v: frozenset({0}) for v in tainted_inputs}, check=True
        )
    except _Unsafe as e:
        return str(e)

    def t(var):
        return taint.get(var, frozenset())

    # results the function cannot slice back exactly
    update_outs = set(update_outputs)
    for i, out in enumerate(fgraph.outputs):
        ot = t(out)
        if not ot:
            continue
        if i in update_outs:
            return (
                f"bucketing is unsafe: shared-variable update (output {i}) "
                "depends on the padded batch axis — the stored state would "
                "grow to the bucket size"
            )
        if ot != frozenset({0}):
            return (
                f"bucketing is unsafe: output {i} carries the batch on "
                f"axes {sorted(ot)}, but only a leading batch axis can be "
                "sliced back to the true length"
            )
        if getattr(out.type, "shape", (1,))[:1] != (None,):
            return (
                f"bucketing is unsafe: output {i} carries the batch but its "
                "static leading dim is fixed — the function cannot slice it "
                "back"
            )
    return None


def _propagate(fgraph, taint, check: bool) -> dict:
    """Shared dataflow core: taint = {var: frozenset(axes carrying the
    padded dim)}.  check=True raises _Unsafe at the first op that folds
    pad rows into real values; check=False clears taint there instead."""
    taint = dict(taint)

    def t(var):
        return taint.get(var, frozenset())

    def _axis_set(axis, ndim):
        if axis is None:
            return set(range(ndim))
        if isinstance(axis, (int, np.integer)):
            return {int(axis) % ndim}
        return {int(a) % ndim for a in axis}

    def _drop_axes(tset, dropped):
        """Remap a taint set after removing ``dropped`` axes."""
        out = set()
        for a in tset:
            if a in dropped:
                continue
            out.add(a - sum(1 for d in dropped if d < a))
        return frozenset(out)

    for node in fgraph.toposort():
        in_taints = [t(i) for i in node.inputs]
        if not any(in_taints):
            continue
        op = node.op

        def bad(why):
            if not check:
                # track mode: the padded dim's identity is lost here;
                # downstream axes are NOT seq-sized in a sliceable way
                for o in node.outputs:
                    taint[o] = frozenset()
                raise _SkipNode()
            raise _Unsafe(
                f"bucketing is unsafe for this graph: {node.op} {why} "
                f"(node: {node}); pad rows would leak into real results. "
                "Keep the function row-wise over the batch, mark the "
                "offending input In(batched=False), or set "
                "config.shape_buckets='off'"
            )

        try:
            _dispatch_node(op, node, in_taints, taint, t, bad,
                           _axis_set, _drop_axes)
        except _SkipNode:
            continue

    return taint


def _dispatch_node(op, node, in_taints, taint, t, bad, _axis_set, _drop_axes):
    from aesara_tpu_torch.scan.op import Scan
    from aesara_tpu_torch.tensor.blas import BatchedDot, Dot22, Dot22Scalar, Gemm, Gemv, Ger
    from aesara_tpu_torch.tensor.elemwise import CAReduce, DimShuffle, Elemwise
    from aesara_tpu_torch.tensor.math import Argmax, Dot
    from aesara_tpu_torch.tensor.shape import Reshape, Shape, Shape_i, SpecifyShape
    from aesara_tpu_torch.tensor.special import LogSoftmax, Softmax, SoftmaxGrad
    from aesara_tpu_torch.tensor.subtensor import AdvancedSubtensor1, Subtensor

    if True:
        if isinstance(op, Elemwise):
            taint[node.outputs[0]] = frozenset().union(*in_taints)
        elif isinstance(op, DimShuffle):
            src = in_taints[0]
            out_t = {
                j for j, o in enumerate(op.new_order)
                if o != "x" and o in src
            }
            taint[node.outputs[0]] = frozenset(out_t)
        elif isinstance(op, (CAReduce, Argmax)):
            ndim = node.inputs[0].type.ndim
            reduced = _axis_set(op.axis, ndim)
            if reduced & in_taints[0]:
                bad("reduces over the padded batch axis")
            for o in node.outputs:
                taint[o] = _drop_axes(in_taints[0], reduced)
        elif isinstance(op, (Softmax, LogSoftmax, SoftmaxGrad)):
            ndim = node.outputs[0].type.ndim
            if op.axis is not None and (int(op.axis) % ndim) in frozenset().union(*in_taints):
                bad("normalizes over the padded batch axis")
            if op.axis is None and any(in_taints):
                bad("normalizes over the padded batch axis")
            taint[node.outputs[0]] = frozenset().union(*in_taints)
        elif isinstance(op, Subtensor):
            src = set(in_taints[0])
            if any(t(i) for i in node.inputs[1:]):
                bad("indexes with a batch-derived value")
            out_t = set()
            dropped = []
            axis = 0
            out_axis = 0
            for entry in op.idx_list:
                if isinstance(entry, slice):
                    if axis in src:
                        if not _full_slice(entry):
                            bad(
                                "re-slices the padded batch axis (the "
                                "function could no longer slice results "
                                "back to the true length)"
                            )
                        out_t.add(out_axis)
                    out_axis += 1
                else:
                    # scalar index drops the axis; replicate-padding makes
                    # any in-range (incl. negative) index read true data
                    dropped.append(axis)
                axis += 1
            # remaining untouched axes
            for a in range(axis, node.inputs[0].type.ndim):
                if a in src:
                    out_t.add(out_axis + (a - axis))
            taint[node.outputs[0]] = frozenset(out_t)
        elif isinstance(op, AdvancedSubtensor1):
            # gather rows by an index vector: batch-carrying INDICES are the
            # embedding-lookup pattern — replicate-padded indices stay
            # in-range and gather true rows (row-wise safe).  A padded
            # TABLE, by contrast, could be read anywhere: unsafe.
            xt, it = in_taints[0], in_taints[1]
            if xt:
                bad("gathers from a batch-padded table")
            taint[node.outputs[0]] = frozenset({0}) if it else frozenset()
        elif isinstance(op, (Dot22, Dot22Scalar)):
            xt, yt = in_taints[0], in_taints[1]
            if 1 in xt or 0 in yt:
                bad("contracts over the padded batch axis")
            out_t = set()
            if 0 in xt:
                out_t.add(0)
            if 1 in yt:
                out_t.add(1)
            taint[node.outputs[0]] = frozenset(out_t)
        elif isinstance(op, Gemm):
            zt, _, xt, yt, _ = in_taints
            if 1 in xt or 0 in yt:
                bad("contracts over the padded batch axis")
            out_t = set(zt)
            if 0 in xt:
                out_t.add(0)
            if 1 in yt:
                out_t.add(1)
            taint[node.outputs[0]] = frozenset(out_t)
        elif isinstance(op, Gemv):
            zt, _, At, xt, _ = in_taints
            if 1 in At or 0 in xt:
                bad("contracts over the padded batch axis")
            taint[node.outputs[0]] = frozenset(set(zt) | ({0} if 0 in At else set()))
        elif isinstance(op, Ger):
            zt, _, xt, yt = in_taints
            out_t = set(zt)
            if 0 in xt:
                out_t.add(0)
            if 0 in yt:
                out_t.add(1)
            taint[node.outputs[0]] = frozenset(out_t)
        elif isinstance(op, BatchedDot):
            xt, yt = in_taints[0], in_taints[1]
            if 2 in xt or 1 in yt:
                bad("contracts over the padded batch axis")
            out_t = set()
            if 0 in xt or 0 in yt:
                out_t.add(0)
            if 1 in xt:
                out_t.add(1)
            if 2 in yt:
                out_t.add(2)
            taint[node.outputs[0]] = frozenset(out_t)
        elif isinstance(op, Dot):
            xt, yt = in_taints[0], in_taints[1]
            xn = node.inputs[0].type.ndim
            # contraction: last axis of x with first axis of y
            if (xn - 1) in xt or 0 in yt:
                bad("contracts over the padded batch axis")
            out_t = set()
            if xn == 2 and 0 in xt:
                out_t.add(0)
            yn = node.inputs[1].type.ndim
            if yn == 2 and 1 in yt:
                out_t.add(node.outputs[0].type.ndim - 1)
            taint[node.outputs[0]] = frozenset(out_t)
        elif isinstance(op, Shape_i):
            if op.i in in_taints[0]:
                bad(
                    "reads the padded batch axis length (shape-dependent "
                    "math would see the bucket size, not the true batch)"
                )
        elif isinstance(op, Shape):
            if in_taints[0]:
                bad("reads the shape of a batch-carrying tensor")
        elif isinstance(op, SpecifyShape):
            taint[node.outputs[0]] = in_taints[0]
        elif isinstance(op, Reshape):
            if in_taints[0]:
                bad("reshapes a batch-carrying tensor")
            if any(t(i) for i in node.inputs[1:]):
                bad("builds a shape from batch-derived values")
        elif isinstance(op, Scan):
            bad(
                "feeds a batch-carrying value into an inner graph "
                "(Scan) the analysis does not descend into"
            )
        else:
            bad("is not a proven row-wise op over the padded axis")
