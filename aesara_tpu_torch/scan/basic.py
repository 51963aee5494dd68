"""User-facing ``scan``: build the inner graph and apply the Scan op
(the counterpart of ``aesara_tpu/scan/basic.py``, which it follows line
for line, so that the port builds the JAX package's graphs).

It classifies the arguments into sequences, taps (mit-sot, sit-sot,
nit-sot), shared updates and non-sequences, builds the inner
FunctionGraph over fresh placeholder variables, and returns (outputs,
updates).  A shared variable with a ``default_update`` that a node built
by the body reads (a random stream drawn in the body) rides the loop as
carried state, so every step draws anew.  The body builds no test
values.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List, Optional

import numpy as np

from aesara_tpu_torch.compile.sharedvalue import SharedVariable
from aesara_tpu_torch.graph.fg import FunctionGraph
from aesara_tpu_torch.graph.ir import Constant, Variable, clone_replace, graph_inputs
from aesara_tpu_torch.scan.op import Scan, ScanInfo
from aesara_tpu_torch.tensor.basic import as_tensor_variable
from aesara_tpu_torch.tensor.type import TensorType
from aesara_tpu_torch.updates import OrderedUpdates


__all__ = ["scan", "until", "get_updates_and_outputs", "isNaN_or_Inf_or_None"]


class until:
    """Wrap the while-loop condition in the scan body
    (reference ``scan/basic.py`` until)."""

    def __init__(self, condition):
        self.condition = as_tensor_variable(condition)
        if self.condition.type.ndim != 0:
            raise TypeError("until condition must be a scalar")


def _step_type(seq_var) -> TensorType:
    """Type of one step slice of a sequence/buffer."""
    t = seq_var.type
    return TensorType(t.dtype, t.shape[1:])


def scan(
    fn: Callable,
    sequences=None,
    outputs_info=None,
    non_sequences=None,
    n_steps=None,
    truncate_gradient: int = -1,
    go_backwards: bool = False,
    mode=None,
    name: Optional[str] = None,
    profile=False,
    allow_gc=None,
    strict: bool = False,
    return_list: bool = False,
    padded_while: bool = False,
):
    """Symbolic loop (reference ``scan/basic.py:162``).

    Returns (outputs, updates): ``outputs`` are the per-step stacks (or a
    single variable), ``updates`` maps shared variables to their final
    states (pass to ``function(updates=...)``).

    ``padded_while=True`` (requires an ``until`` condition and an
    explicit ``n_steps`` bound) builds the while-loop as a bounded
    regular scan with static shapes, which a CUDA graph captures: a
    ``done`` flag rides the carry on the device; after the stopping step
    recurrent outputs freeze at their final value, nit-sot (map) outputs
    are zero, and shared updates stop.  Stacks always have ``n_steps``
    rows, and one extra int8 output is appended holding the per-step
    validity mask (1 for rows computed before or at the stop step).
    Gradients flow only through valid rows (the masking switches handle
    it).  A plain ``until`` runs eagerly: its condition is read on the
    host each step, and its stacks end at the step that made it true.
    """
    # ---- normalize arguments -------------------------------------------------
    def listify(x):
        if x is None:
            return []
        if isinstance(x, (list, tuple)):
            return list(x)
        return [x]

    sequences = listify(sequences)
    non_sequences_user = listify(non_sequences)
    outs_info = outputs_info if isinstance(outputs_info, (list, tuple)) else (
        [outputs_info] if outputs_info is not None else None
    )

    # expand sequence taps: a sequence with taps [t0..tk] becomes one
    # shifted plain sequence per tap; the usable length shrinks by
    # (max_tap - min_tap) (reference scan/basic.py sequence-dict handling)
    seq_vars = []
    seq_len_cut = 0
    for s in sequences:
        if isinstance(s, dict):
            taps = [int(t) for t in s.get("taps", [0])]
            inp = as_tensor_variable(s["input"])
            lo, hi = min(taps), max(taps)
            span = hi - lo
            seq_len_cut = max(seq_len_cut, span)
            for tap in taps:
                off = tap - lo
                if span == 0:
                    seq_vars.append(inp)
                else:
                    end_cut = span - off
                    seq_vars.append(
                        inp[off:] if end_cut == 0 else inp[off:-end_cut]
                    )
        else:
            seq_vars.append(as_tensor_variable(s))
    if go_backwards:
        seq_vars = [s[::-1] for s in seq_vars]

    # ---- classify outputs_info ------------------------------------------------
    # user order preserved in `kinds`; canonical op order = mit, sit, nit
    kinds: List[str] = []            # per user output: 'mit' | 'sit' | 'nit'
    inits: List = []                 # per user output: initial (None for nit)
    taps_list: List = []             # per user output: taps (None for nit)
    if outs_info is None:
        # infer later from fn arity: assume all nit-sot
        pass
    else:
        for oi in outs_info:
            if oi is None:
                kinds.append("nit")
                inits.append(None)
                taps_list.append(None)
            elif isinstance(oi, dict):
                init = oi.get("initial")
                taps = list(oi.get("taps", [-1]))
                if init is None:
                    kinds.append("nit")
                    inits.append(None)
                    taps_list.append(None)
                    continue
                if any(t >= 0 for t in taps):
                    raise ValueError("output taps must be negative")
                init = as_tensor_variable(init)
                if taps == [-1]:
                    kinds.append("sit")
                else:
                    kinds.append("mit")
                inits.append(init)
                taps_list.append(sorted(taps))
            else:
                kinds.append("sit")
                inits.append(as_tensor_variable(oi))
                taps_list.append([-1])

    # ---- build inner placeholder variables and call fn ------------------------
    inner_seq_vars = [_step_type(s)(f"{s.name or 'seq'}[t]") for s in seq_vars]

    inner_tap_vars_per_out: List[List[Variable]] = []
    if outs_info is not None:
        for kind, init, taps in zip(kinds, inits, taps_list):
            if kind == "nit":
                inner_tap_vars_per_out.append([])
            elif kind == "sit":
                inner_tap_vars_per_out.append([init.type(f"{init.name or 'h'}[t-1]")])
            else:  # mit: init is a (k, ...) buffer; one var per tap
                step_t = _step_type(init)
                inner_tap_vars_per_out.append([step_t(f"h[t{t}]") for t in taps])

    fn_args = list(inner_seq_vars)
    if outs_info is not None:
        for tv in inner_tap_vars_per_out:
            fn_args.extend(tv)
    fn_args.extend(non_sequences_user)

    from aesara_tpu_torch.graph.ir import _apply_epoch

    _trace_epoch = next(_apply_epoch)  # nodes built by fn stamp >= this
    raw = fn(*fn_args)

    # unpack (outputs, updates, until) — ONE implementation, shared with
    # the public utils.get_updates_and_outputs helper
    from aesara_tpu_torch.scan.utils import get_updates_and_outputs

    raw_outputs, updates, condition = get_updates_and_outputs(raw)
    updates = OrderedDict(updates)
    user_outputs = [as_tensor_variable(o) for o in raw_outputs]

    # ---- implicit per-step state: shared vars with a default_update -------
    # A RandomStream drawn inside ``fn`` gives its key's shared variable a
    # ``default_update`` (the next key).  Such a shared variable rides the
    # loop as carried state, so every step draws fresh values (the
    # dropout-in-scan pattern).  Only one read by a node built while
    # tracing fn qualifies: a draw captured by closure stays loop-invariant.
    # To a fixpoint: a default update may read further such variables.
    from aesara_tpu_torch.graph.ir import ancestors

    while True:
        roots = [r for r in user_outputs + list(updates.values()) + ([condition] if condition is not None else [])
                 if isinstance(r, Variable)]
        inner_nodes = {id(v.owner): v.owner for v in ancestors(roots)
                       if v.owner is not None and v.owner.epoch >= _trace_epoch}
        added = False
        for n in inner_nodes.values():
            for v in n.inputs:
                if isinstance(v, SharedVariable) and v not in updates and v.default_update is not None:
                    updates[v] = v.default_update
                    added = True
        if not added:
            break

    if outs_info is None:
        kinds = ["nit"] * len(user_outputs)
        inits = [None] * len(user_outputs)
        taps_list = [None] * len(user_outputs)
        inner_tap_vars_per_out = [[] for _ in user_outputs]
    if len(user_outputs) != len(kinds):
        raise ValueError(
            f"scan fn returned {len(user_outputs)} outputs but outputs_info "
            f"has {len(kinds)} entries"
        )

    # ---- padded_while: fold the until-condition into a done carry --------------
    n_user_outs = len(user_outputs)
    if padded_while:
        if condition is None:
            raise ValueError("padded_while requires an until() condition")
        if n_steps is None:
            raise ValueError(
                "padded_while requires an explicit n_steps bound (the static "
                "stack length)"
            )
        import aesara_tpu_torch.tensor.basic as tb
        import aesara_tpu_torch.tensor.math as tmm

        done_prev = TensorType("int8", ())("done[t-1]")
        done_next = tb.cast(
            tmm.or_(done_prev, tb.cast(tmm.neq(condition, 0), "int8")), "int8"
        )
        for i, kind in enumerate(kinds):
            if kind == "nit":
                user_outputs[i] = tb.switch(
                    done_prev, tb.zeros_like(user_outputs[i]), user_outputs[i]
                )
            else:
                taps = taps_list[i]
                if -1 not in taps:
                    raise NotImplementedError(
                        "padded_while needs tap -1 on every recurrent output "
                        "to freeze its state after the stop step"
                    )
                prev = inner_tap_vars_per_out[i][taps.index(-1)]
                user_outputs[i] = tb.switch(done_prev, prev, user_outputs[i])
        for sv in list(updates):
            if not isinstance(getattr(sv.type, "dtype", None), str) or not hasattr(
                sv.type, "ndim"
            ):
                raise NotImplementedError(
                    "padded_while cannot freeze non-tensor shared state"
                )
            updates[sv] = tb.switch(done_prev, sv, updates[sv])
        # per-step validity: the row AT the stop step is still valid
        valid = tb.cast(tmm.eq(done_prev, 0), "int8")
        # synthetic outputs: done (sit-sot carry, dropped from the user
        # result) then valid (nit-sot, returned LAST)
        kinds.append("sit")
        inits.append(tb.constant(np.int8(0)))
        taps_list.append([-1])
        inner_tap_vars_per_out.append([done_prev])
        user_outputs.append(done_next)
        kinds.append("nit")
        inits.append(None)
        taps_list.append(None)
        inner_tap_vars_per_out.append([])
        user_outputs.append(valid)
        condition = None

    # check recurrent output types match their taps
    for kind, tvs, out in zip(kinds, inner_tap_vars_per_out, user_outputs):
        if kind in ("sit", "mit") and tvs:
            want = tvs[0].type
            if out.type.dtype != want.dtype or out.type.ndim != want.ndim:
                raise TypeError(
                    f"scan recurrent output type {out.type} does not match "
                    f"its initial state slice type {want}"
                )

    # ---- collect shared vars and implicit non-sequences -----------------------
    all_roots = user_outputs + list(updates.values()) + (
        [condition] if condition is not None else []
    )
    declared_inner = set(inner_seq_vars)
    for tvs in inner_tap_vars_per_out:
        declared_inner.update(tvs)

    shared_updated = [k for k in updates if isinstance(k, SharedVariable)]
    for k in updates:
        if not isinstance(k, SharedVariable):
            raise TypeError(f"scan update target {k} is not shared")

    outer_captured: List[Variable] = []
    for v in graph_inputs(all_roots) if all_roots else []:
        if v in declared_inner or isinstance(v, Constant):
            continue
        if v in shared_updated:
            continue
        if v not in outer_captured:
            outer_captured.append(v)
    # user-declared non-sequences first (dedup), then implicit captures;
    # an UPDATED shared passed via non_sequences rides the carry — adding
    # it here too would overwrite its carry replacement below and freeze
    # the body at the initial value (review finding)
    non_seq_outer: List[Variable] = []
    for v in non_sequences_user:
        v = v if isinstance(v, Variable) else as_tensor_variable(v)
        if v in shared_updated:
            continue
        if v not in non_seq_outer:
            non_seq_outer.append(v)
    for v in outer_captured:
        if v not in non_seq_outer:
            non_seq_outer.append(v)
    if strict:
        # reference semantics: EVERY variable the body captures — shared
        # variables included — must be passed via non_sequences (updated
        # shareds ride the carry and are exempt)
        for v in outer_captured:
            if v not in non_sequences_user:
                raise ValueError(
                    f"scan(strict=True): {v} used in the body but not passed "
                    f"via non_sequences"
                )

    # ---- build the inner graph over fresh placeholders -------------------------
    inner_shared_vars = [sv.type(f"{sv.name or 'shared'}[t]") for sv in shared_updated]
    inner_nonseq_vars = [
        v.type(f"{getattr(v, 'name', None) or 'w'}") for v in non_seq_outer
    ]
    replace = {}
    for sv, iv in zip(shared_updated, inner_shared_vars):
        replace[sv] = iv
    for ov, iv in zip(non_seq_outer, inner_nonseq_vars):
        replace[ov] = iv

    # canonical output order: mit, sit, nit, shared-updates [, condition]
    order_mit = [i for i, k in enumerate(kinds) if k == "mit"]
    order_sit = [i for i, k in enumerate(kinds) if k == "sit"]
    order_nit = [i for i, k in enumerate(kinds) if k == "nit"]
    canon_outputs = (
        [user_outputs[i] for i in order_mit]
        + [user_outputs[i] for i in order_sit]
        + [user_outputs[i] for i in order_nit]
        + [updates[sv] for sv in shared_updated]
        + ([condition] if condition is not None else [])
    )
    canon_outputs = clone_replace(canon_outputs, replace=replace) if canon_outputs else []

    inner_inputs = (
        list(inner_seq_vars)
        + [tv for i in order_mit for tv in inner_tap_vars_per_out[i]]
        + [inner_tap_vars_per_out[i][0] for i in order_sit]
        + inner_shared_vars
        + inner_nonseq_vars
    )
    inner_fg = FunctionGraph(inner_inputs, canon_outputs, clone=True)

    info = ScanInfo(
        n_seqs=len(seq_vars),
        mit_sot_taps=tuple(tuple(taps_list[i]) for i in order_mit),
        n_sit_sot=len(order_sit),
        n_nit_sot=len(order_nit),
        n_shared=len(shared_updated),
        n_non_seqs=len(non_seq_outer),
        as_while=condition is not None,
    )

    # ---- determine n_steps ------------------------------------------------------
    from aesara_tpu_torch.tensor.shape import shape_i as tshape_i
    import aesara_tpu_torch.tensor.math as tm

    if n_steps is None:
        if not seq_vars:
            raise ValueError("scan needs n_steps when there are no sequences")
        static = [s.type.shape[0] for s in seq_vars]
        if all(d is not None for d in static):
            n_steps_var = as_tensor_variable(int(min(static)))
        else:
            # runtime minimum over ALL sequences — a dynamic-length
            # sequence may be the shortest (review finding); static dims
            # participate as constants and fold
            n_steps_var = tshape_i(seq_vars[0], 0)
            for s in seq_vars[1:]:
                n_steps_var = tm.minimum(n_steps_var, tshape_i(s, 0))
    else:
        n_steps_var = as_tensor_variable(n_steps)

    # mit-sot inits must be (k, ...) buffers matching the deepest tap
    mit_inits = []
    for i in order_mit:
        init = inits[i]
        depth = -min(taps_list[i])
        if init.type.ndim == 0 or init.type.shape[0] not in (None, depth):
            raise ValueError(
                f"mit-sot initial must have leading dim {depth}, got {init.type}"
            )
        mit_inits.append(init)
    sit_inits = [inits[i] for i in order_sit]

    op = Scan(inner_fg, info, name=name, truncate_gradient=truncate_gradient, mode=mode)
    results = op(
        n_steps_var,
        *seq_vars,
        *mit_inits,
        *sit_inits,
        *shared_updated,
        *non_seq_outer,
        return_list=True,
    )

    n_rec = info.n_mit_sot + info.n_sit_sot
    canon_user_outs = results[: n_rec + info.n_nit_sot]
    shared_finals = results[n_rec + info.n_nit_sot:]

    # un-permute back to user output order
    canon_order = order_mit + order_sit + order_nit
    user_order_outs: List = [None] * len(kinds)
    for canon_idx, user_idx in enumerate(canon_order):
        user_order_outs[user_idx] = canon_user_outs[canon_idx]

    out_updates = OrderedUpdates()
    for sv, final in zip(shared_updated, shared_finals):
        out_updates[sv] = final

    if padded_while:
        # drop the internal done stack; keep the validity mask LAST
        valid_stack = user_order_outs[n_user_outs + 1]
        user_order_outs = user_order_outs[:n_user_outs] + [valid_stack]

    if len(user_order_outs) == 1 and not return_list:
        return user_order_outs[0], out_updates
    return user_order_outs, out_updates


# re-exports matching the reference's scan/basic.py surface
from aesara_tpu_torch.scan.utils import (  # noqa: E402,F401
    get_updates_and_outputs,
    isNaN_or_Inf_or_None,
)
