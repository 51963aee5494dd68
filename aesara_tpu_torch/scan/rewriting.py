"""Scan rewrites (the counterpart of ``aesara_tpu/scan/rewriting.py``):
every rewrite the JAX package registers in optdb, at its positions, so
that the port's ``FAST_RUN`` graph of a loop is the JAX package's, outer
and inner.

- ``scan_save_mem`` (and its prefix form): a stacked output read only
  through its tail (or a prefix) keeps only that;
- ``scan_unused_recurrent_to_final``: an unread recurrent stack keeps its
  final state only;
- ``scan_pushout_non_seqs`` and ``scan_pushout_seqs``: loop-invariant work
  and per-step products of sequences (``x_t @ Wx``) move out of the loop,
  the latter as one GEMM over all steps;
- ``scan_merge``, ``scan_remove_constants_and_unused``,
  ``scan_merge_inouts``, ``scan_pushout_sum`` and
  ``scan_identity_nitsot``: the clean-ups.

No rewrite here changes a Scan's inner graph beyond what the JAX package
does; the fusion of the inner graph happens on the copy the lowering
compiles (``link/torch/scan_dispatch.py``)."""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.compile.mode import optdb
from aesara_tpu_torch.graph.rewriting.basic import copy_stack_trace, in2out, node_rewriter
from aesara_tpu_torch.scan.op import Scan, ScanInfo
from aesara_tpu_torch.tensor.subtensor import Subtensor


def _is_last_element_index(idx_list) -> bool:
    """x[-1] — the pattern scan_save_mem truncates for."""
    return len(idx_list) == 1 and idx_list[0] == -1


def _tail_depth_of(idx_list):
    """How many trailing rows of the time dim a subtensor reads, or None.

    ``x[-k:]``/``x[-k:, ...]`` → k; ``x[-j]``/``x[-j, ...]`` → j (any
    further index entries act inside the kept rows and are re-applied to
    the truncated buffer unchanged).
    """
    if not idx_list:
        return None
    first = idx_list[0]
    if isinstance(first, slice):
        if (
            isinstance(first.start, (int, np.integer))
            and not isinstance(first.start, bool)
            and first.start < 0
            and first.stop is None
            and first.step is None
        ):
            return int(-first.start)
        return None
    if (isinstance(first, (int, np.integer))
            and not isinstance(first, bool) and first < 0):
        return int(-first)
    return None


@node_rewriter([Subtensor])
def scan_save_mem(fgraph, node):
    """Truncate a Scan's stacked recurrent buffer when it is consumed
    only through its tail (reference ``save_mem_new_scan``,
    ``scan/rewriting.py:1176``).

    * every consumer reads exactly ``x[-1]`` → the output becomes the
      final carried state (``final_only``: no stacked buffer at all);
    * consumers read tail windows ``x[-k:]`` / elements ``x[-j]`` → the
      output keeps only its last k rows
      (``tail_depths``), and each consumer re-indexes the (k, ...) ring —
      the memory win that makes windowed losses over long-horizon BPTT
      fit in device memory.  Requires a static trip count ≥ k (a ring is always
      full; a shorter run would change ``x[-k:]``'s shape).
    """
    sub_op = node.op
    if _tail_depth_of(sub_op.idx_list) is None:
        return False
    scanned = node.inputs[0]
    snode = scanned.owner
    if snode is None or not isinstance(snode.op, Scan):
        return False
    info = snode.op.info
    rec_idx = scanned.index
    n_rec = info.n_mit_sot + info.n_sit_sot
    is_nit = n_rec <= rec_idx < n_rec + info.n_nit_sot
    if rec_idx >= n_rec + info.n_nit_sot:
        return False  # shared finals carry no stack
    if is_nit:
        if info.nit_tail_depth(rec_idx - n_rec):
            return False
    elif info.is_final_only(rec_idx) or info.tail_depth(rec_idx):
        return False
    # the stack must have NO consumer outside the tail
    clients = fgraph.clients.get(scanned, [])
    depths = []
    pure_final = True
    for client, _ in clients:
        if client == "output" or not isinstance(client.op, Subtensor):
            return False
        d = _tail_depth_of(client.op.idx_list)
        if d is None:
            return False
        depths.append(d)
        if not _is_last_element_index(client.op.idx_list):
            pure_final = False

    def _mk_info(final_only, tail_depths, nit_tail_depths):
        return ScanInfo(
            n_seqs=info.n_seqs,
            mit_sot_taps=info.mit_sot_taps,
            n_sit_sot=info.n_sit_sot,
            n_nit_sot=info.n_nit_sot,
            n_shared=info.n_shared,
            n_non_seqs=info.n_non_seqs,
            as_while=info.as_while,
            final_only=final_only,
            tail_depths=tail_depths,
            nit_tail_depths=nit_tail_depths,
        )

    def _static_len_above(k):
        # a ring is always full, so the trip count must be static and
        # exceed k (k == n_steps is a FULL-depth ring: zero memory win —
        # keep the plain stacked buffer; local_useless_subtensor then
        # folds the covering x[-k:])
        if info.as_while:
            return False  # ring exactness needs a known trip count
        try:
            from aesara_tpu_torch.tensor.basic import get_scalar_constant_value

            return int(get_scalar_constant_value(snode.inputs[0])) > k
        except Exception:
            return False

    if pure_final and not is_nit:
        new_final = list(info.final_only) if info.final_only else [False] * n_rec
        new_final[rec_idx] = True
        new_info = _mk_info(tuple(new_final), info.tail_depths,
                            info.nit_tail_depths)
    elif is_nit:
        # a nit-sot has no carried state, so even pure x[-1] usage becomes
        # a depth-k ring (consumers re-index the ring) rather than a
        # final_only form
        k = max(depths)
        if not _static_len_above(k):
            return False
        new_nit = (list(info.nit_tail_depths) if info.nit_tail_depths
                   else [0] * info.n_nit_sot)
        new_nit[rec_idx - n_rec] = k
        new_info = _mk_info(info.final_only, info.tail_depths,
                            tuple(new_nit))
        pure_final = False  # always re-index the ring
    else:
        k = max(depths)
        if not _static_len_above(k):
            return False
        new_tails = list(info.tail_depths) if info.tail_depths else [0] * n_rec
        new_tails[rec_idx] = k
        new_info = _mk_info(info.final_only, tuple(new_tails),
                            info.nit_tail_depths)
    new_op = Scan(
        snode.op.fgraph, new_info, snode.op.name,
        snode.op.truncate_gradient, snode.op.mode,
    )
    new_outs = new_op(*snode.inputs, return_list=True)
    replacements = {}
    for j, (old, new) in enumerate(zip(snode.outputs, new_outs)):
        if j == rec_idx:
            continue  # consumers of the stack are the tail subtensors
        if fgraph.clients.get(old):
            replacements[old] = new
    for client, _ in clients:
        if pure_final:
            repl = new_outs[rec_idx]
        else:
            # re-apply the same tail index to the (k, ...) ring: for
            # trip count >= k, ring[-j:]/ring[-j] == stack[-j:]/stack[-j]
            repl = client.op(new_outs[rec_idx], *client.inputs[1:])
        conv = client.outputs[0].type.convert_variable(repl)
        if conv is None:
            return False
        replacements[client.outputs[0]] = conv
    if not replacements:
        return False
    for old, new in replacements.items():
        copy_stack_trace(old, new)
    return replacements


# reference position 1.61; runs again late (post-fusion graphs)
optdb.register(
    "scan_save_mem", in2out(scan_save_mem, name="scan_save_mem"),
    "fast_run", "scan", position=1.61,
)
optdb.register(
    "scan_save_mem_late", in2out(scan_save_mem, name="scan_save_mem_late"),
    "fast_run", "scan", position=50.5,
)


def _prefix_need_of(idx_list):
    """Steps needed to serve a prefix read of the time dim, or None.

    ``x[j]`` (j ≥ 0) → j+1; ``x[:j]``/``x[a:j]``/``x[a:j, ...]`` with
    static non-negative bounds → j.  Anything negative, symbolic, or
    strided belongs to the tail rule / no rule.
    """
    if not idx_list:
        return None
    first = idx_list[0]
    if isinstance(first, slice):
        if not (first.start is None
                or (isinstance(first.start, (int, np.integer))
                    and not isinstance(first.start, bool)
                    and first.start >= 0)):
            return None
        if not (first.step is None
                or (isinstance(first.step, (int, np.integer)) and first.step == 1)):
            return None
        if (isinstance(first.stop, (int, np.integer))
                and not isinstance(first.stop, bool) and first.stop > 0):
            return int(first.stop)
        return None
    if (isinstance(first, (int, np.integer))
            and not isinstance(first, bool) and first >= 0):
        return int(first) + 1
    return None


@node_rewriter([Scan])
def scan_save_mem_prefix(fgraph, node):
    """Shorten a Scan's trip count when every observed output is read
    only through a static prefix window (reference ``save_mem_new_scan``
    stop extraction, ``scan/rewriting.py:1176,1318-1323``): a
    10,000-step scan whose output feeds ``x[:10]`` runs — and stores —
    10 steps.

    Fires only when ALL live outputs tolerate truncation: stacked
    outputs read via ``x[j]`` / ``x[a:j]`` with static non-negative
    bounds (steps needed = j+1 / j), everything else dead.  A consumed
    final state, tail ring, or shared final genuinely needs the full
    trip count, so any such client blocks the rewrite (matching the
    reference's global-window minimum).
    """
    from aesara_tpu_torch.tensor.basic import constant, get_scalar_constant_value

    info = node.op.info
    if info.as_while:
        return False
    try:
        N = int(get_scalar_constant_value(node.inputs[0]))
    except Exception:
        return False
    n_rec = info.n_mit_sot + info.n_sit_sot
    n_stack_end = n_rec + info.n_nit_sot
    required = 0
    consumers = []  # (out_idx, client)
    for i, out in enumerate(node.outputs):
        clients = fgraph.clients.get(out, [])
        if not clients:
            continue
        if i >= n_stack_end:
            return False  # an observed shared final needs all N steps
        if i < n_rec and (info.is_final_only(i) or info.tail_depth(i)):
            return False  # observed final state / tail ring: all N steps
        if n_rec <= i < n_stack_end and info.nit_tail_depth(i - n_rec):
            return False
        for client, _ in clients:
            if client == "output" or not isinstance(client.op, Subtensor):
                return False
            need = _prefix_need_of(client.op.idx_list)
            if need is None:
                return False
            required = max(required, need)
            consumers.append(client)
    if required == 0 or required >= N:
        return False
    new_outs = node.op(
        constant(np.int64(required)), *node.inputs[1:], return_list=True
    )
    replacements = {}
    for client in consumers:
        out_idx = node.outputs.index(client.inputs[0])
        repl = client.op(new_outs[out_idx], *client.inputs[1:])
        conv = client.outputs[0].type.convert_variable(repl)
        if conv is None:
            return False
        replacements[client.outputs[0]] = conv
        copy_stack_trace(client.outputs[0], conv)
    return replacements


optdb.register(
    "scan_save_mem_prefix",
    in2out(scan_save_mem_prefix, name="scan_save_mem_prefix"),
    "fast_run", "scan", position=1.615,
)
optdb.register(
    "scan_save_mem_prefix_late",
    in2out(scan_save_mem_prefix, name="scan_save_mem_prefix_late"),
    "fast_run", "scan", position=50.55,
)


@node_rewriter([Scan])
def scan_unused_recurrent_to_final(fgraph, node):
    """A recurrent (mit/sit-sot) stacked output with NO consumers keeps
    only its final carried value (``final_only``) — the stack is dead
    weight for plain scans and a hard COMPILE blocker for while-scans,
    whose per-step stacks have a data-dependent length (e.g. a
    speculative-decode loop whose KV-cache carries are never read back
    as stacks)."""
    info = node.op.info
    n_rec = info.n_mit_sot + info.n_sit_sot
    if n_rec == 0:
        return False
    new_final = list(info.final_only) if info.final_only else [False] * n_rec
    tails = info.tail_depths or (0,) * n_rec
    changed = False
    for rec_idx in range(n_rec):
        if new_final[rec_idx] or tails[rec_idx]:
            continue
        if not fgraph.clients.get(node.outputs[rec_idx]):
            new_final[rec_idx] = True
            changed = True
    if not changed:
        return False
    new_info = ScanInfo(
        n_seqs=info.n_seqs,
        mit_sot_taps=info.mit_sot_taps,
        n_sit_sot=info.n_sit_sot,
        n_nit_sot=info.n_nit_sot,
        n_shared=info.n_shared,
        n_non_seqs=info.n_non_seqs,
        as_while=info.as_while,
        final_only=tuple(new_final),
        tail_depths=info.tail_depths,
        nit_tail_depths=info.nit_tail_depths,
    )
    new_op = Scan(
        node.op.fgraph, new_info, node.op.name,
        node.op.truncate_gradient, node.op.mode,
    )
    new_outs = new_op(*node.inputs, return_list=True)
    replacements = {}
    for old, new in zip(node.outputs, new_outs):
        if fgraph.clients.get(old):
            replacements[old] = new
            copy_stack_trace(old, new)
    if not replacements:
        return False  # whole scan is dead; DCE's job
    return replacements


optdb.register(
    "scan_unused_recurrent_to_final",
    in2out(scan_unused_recurrent_to_final,
           name="scan_unused_recurrent_to_final"),
    "fast_run", "scan", position=1.62,
)
optdb.register(
    "scan_unused_recurrent_to_final_late",
    in2out(scan_unused_recurrent_to_final,
           name="scan_unused_recurrent_to_final_late"),
    "fast_run", "scan", position=50.6,
)


@node_rewriter([Scan])
def scan_pushout_non_seqs(fgraph, node):
    """Hoist inner computations that depend only on non-sequences (and
    constants) out of the loop: they are computed once outside and fed in
    as new non-sequences (reference push-out-non-seqs, the scan_eqopt1
    workhorse)."""
    from aesara_tpu_torch.graph.ir import Constant, clone_replace, io_toposort

    op = node.op
    info = op.info
    if info.as_while:
        return False
    inner_in = op.fgraph.inputs
    n_loop_vars = (
        info.n_seqs
        + sum(len(t) for t in info.mit_sot_taps)
        + info.n_sit_sot
        + info.n_shared
    )
    loop_vars = set(inner_in[:n_loop_vars])
    nonseq_vars = inner_in[n_loop_vars:]
    nonseq_set = set(nonseq_vars)

    # classify inner nodes: invariant = no loop-var ancestor.  Pure-
    # constant subgraphs are NOT hoisted: they fold inside the body
    # for free, and hoisting them would ping-pong with the constant-
    # folding done by scan_remove_constants_and_unused.
    invariant_vars = set(nonseq_set)
    const_like = set()
    hoistable = []
    for inner_node in io_toposort(inner_in, op.fgraph.outputs):
        if getattr(inner_node.op, "never_fold", False):
            continue  # collectives / RNG must stay put
        ins = inner_node.inputs
        if all(
            (i in invariant_vars) or (i in const_like)
            or isinstance(i, Constant)
            for i in ins
        ):
            if all((i in const_like) or isinstance(i, Constant) for i in ins):
                const_like.update(inner_node.outputs)
            else:
                hoistable.append(inner_node)
                invariant_vars.update(inner_node.outputs)

    if not hoistable:
        return False
    # hoist only values actually consumed by non-invariant nodes/outputs
    hoist_outputs = []
    for inner_node in hoistable:
        for out in inner_node.outputs:
            for client, _ in op.fgraph.clients.get(out, []):
                if client == "output" or client not in hoistable:
                    if out not in hoist_outputs:
                        hoist_outputs.append(out)
                    break
    if not hoist_outputs:
        return False
    # avoid hoisting trivial views of existing non-seqs
    hoist_outputs = [
        v for v in hoist_outputs if v not in nonseq_set and v.owner is not None
    ]
    if not hoist_outputs:
        return False

    outer_nonseqs = node.inputs[1 + info.n_seqs + info.n_mit_sot
                                + info.n_sit_sot + info.n_shared:]
    # compute hoisted values OUTSIDE the loop over the outer non-seqs
    outer_values = clone_replace(
        hoist_outputs, replace=dict(zip(nonseq_vars, outer_nonseqs))
    )
    # new inner placeholders receive them
    new_inner_vars = [v.type() for v in hoist_outputs]
    new_inner_outputs = clone_replace(
        list(op.fgraph.outputs),
        replace=dict(zip(hoist_outputs, new_inner_vars)),
    )
    new_inner_inputs = list(inner_in) + new_inner_vars
    from aesara_tpu_torch.graph.fg import FunctionGraph

    new_fg = FunctionGraph(new_inner_inputs, new_inner_outputs, clone=True)
    new_info = ScanInfo(
        n_seqs=info.n_seqs,
        mit_sot_taps=info.mit_sot_taps,
        n_sit_sot=info.n_sit_sot,
        n_nit_sot=info.n_nit_sot,
        n_shared=info.n_shared,
        n_non_seqs=info.n_non_seqs + len(new_inner_vars),
        as_while=info.as_while,
        final_only=info.final_only,
        tail_depths=info.tail_depths,
        nit_tail_depths=info.nit_tail_depths,
    )
    new_op = Scan(new_fg, new_info, op.name, op.truncate_gradient, op.mode)
    new_outs = new_op(*(list(node.inputs) + list(outer_values)),
                      return_list=True)
    replacements = {}
    for old, new in zip(node.outputs, new_outs):
        if fgraph.clients.get(old):
            replacements[old] = new
            copy_stack_trace(old, new)
    return replacements or False


optdb.register(
    "scan_pushout_non_seqs", in2out(scan_pushout_non_seqs,
                                    name="scan_pushout_non_seqs"),
    "fast_run", "scan", position=1.60,
)


# ---------------------------------------------------------------------------
# ScanMerge (reference scan/rewriting.py ScanMerge:1947): fuse independent
# Scan nodes with the same trip count into ONE loop
# ---------------------------------------------------------------------------

def _same_n_steps(a, b) -> bool:
    if a is b:
        return True
    from aesara_tpu_torch.graph.ir import Constant

    if isinstance(a, Constant) and isinstance(b, Constant):
        return np.asarray(a.data) == np.asarray(b.data)
    return False


def _scan_depends_on(fgraph, node_a, node_b) -> bool:
    """True if any input of node_a (transitively) comes from node_b."""
    from aesara_tpu_torch.graph.ir import ancestors

    b_outs = set(node_b.outputs)
    return any(v in b_outs for v in ancestors(node_a.inputs))


def _merge_two_scans(node_a, node_b):
    """Build one Scan equivalent to the pair; returns (new_outputs_for_a,
    new_outputs_for_b)."""
    from aesara_tpu_torch.graph.fg import FunctionGraph
    from aesara_tpu_torch.graph.ir import clone

    op_a, op_b = node_a.op, node_b.op
    ia, ib = op_a.info, op_b.info

    # fresh clones of both inner graphs (never share inner variables)
    a_in, a_out = clone(list(op_a.fgraph.inputs), list(op_a.fgraph.outputs))
    b_in, b_out = clone(list(op_b.fgraph.inputs), list(op_b.fgraph.outputs))

    def _split_inner_inputs(info, inner):
        p = 0
        seqs = inner[p: p + info.n_seqs]; p += info.n_seqs
        n_taps = sum(len(t) for t in info.mit_sot_taps)
        mit = inner[p: p + n_taps]; p += n_taps
        sit = inner[p: p + info.n_sit_sot]; p += info.n_sit_sot
        shared = inner[p: p + info.n_shared]; p += info.n_shared
        non_seqs = inner[p:]
        return seqs, mit, sit, shared, non_seqs

    def _split_inner_outputs(info, inner):
        p = 0
        mit = inner[p: p + info.n_mit_sot]; p += info.n_mit_sot
        sit = inner[p: p + info.n_sit_sot]; p += info.n_sit_sot
        nit = inner[p: p + info.n_nit_sot]; p += info.n_nit_sot
        shared = inner[p: p + info.n_shared]; p += info.n_shared
        return mit, sit, nit, shared

    sa, ma, ta, ha, na = _split_inner_inputs(ia, a_in)
    sb, mb, tb, hb, nb = _split_inner_inputs(ib, b_in)
    oma, ota, onita, osha = _split_inner_outputs(ia, a_out)
    omb, otb, onitb, oshb = _split_inner_outputs(ib, b_out)

    inner_inputs = (list(sa) + list(sb) + list(ma) + list(mb) + list(ta)
                    + list(tb) + list(ha) + list(hb) + list(na) + list(nb))
    inner_outputs = (list(oma) + list(omb) + list(ota) + list(otb)
                     + list(onita) + list(onitb) + list(osha) + list(oshb))

    def _final(info):
        if info.final_only:
            return list(info.final_only)
        return [False] * info.n_recurrent

    fa, fb = _final(ia), _final(ib)
    merged_final = (fa[: ia.n_mit_sot] + fb[: ib.n_mit_sot]
                    + fa[ia.n_mit_sot:] + fb[ib.n_mit_sot:])

    def _tails(info):
        if info.tail_depths:
            return list(info.tail_depths)
        return [0] * info.n_recurrent

    ka, kb = _tails(ia), _tails(ib)
    merged_tails = (ka[: ia.n_mit_sot] + kb[: ib.n_mit_sot]
                    + ka[ia.n_mit_sot:] + kb[ib.n_mit_sot:])

    def _ntails(info):
        if info.nit_tail_depths:
            return list(info.nit_tail_depths)
        return [0] * info.n_nit_sot

    merged_nit_tails = _ntails(ia) + _ntails(ib)
    merged_info = ScanInfo(
        n_seqs=ia.n_seqs + ib.n_seqs,
        mit_sot_taps=tuple(ia.mit_sot_taps) + tuple(ib.mit_sot_taps),
        n_sit_sot=ia.n_sit_sot + ib.n_sit_sot,
        n_nit_sot=ia.n_nit_sot + ib.n_nit_sot,
        n_shared=ia.n_shared + ib.n_shared,
        n_non_seqs=ia.n_non_seqs + ib.n_non_seqs,
        as_while=False,
        final_only=tuple(merged_final) if any(merged_final) else (),
        tail_depths=tuple(merged_tails) if any(merged_tails) else (),
        nit_tail_depths=(tuple(merged_nit_tails)
                         if any(merged_nit_tails) else ()),
    )

    def _split_outer_inputs(info, node):
        ins = node.inputs
        p = 1  # skip n_steps
        seqs = ins[p: p + info.n_seqs]; p += info.n_seqs
        mit = ins[p: p + info.n_mit_sot]; p += info.n_mit_sot
        sit = ins[p: p + info.n_sit_sot]; p += info.n_sit_sot
        shared = ins[p: p + info.n_shared]; p += info.n_shared
        return seqs, mit, sit, shared, ins[p:]

    Sa, Ma, Ta, Ha, Na = _split_outer_inputs(ia, node_a)
    Sb, Mb, Tb, Hb, Nb = _split_outer_inputs(ib, node_b)
    outer = ([node_a.inputs[0]] + list(Sa) + list(Sb) + list(Ma) + list(Mb)
             + list(Ta) + list(Tb) + list(Ha) + list(Hb) + list(Na) + list(Nb))

    merged_fg = FunctionGraph(inner_inputs, inner_outputs, clone=False)
    name = f"{op_a.name or 'scan'}&{op_b.name or 'scan'}"
    merged_op = Scan(merged_fg, merged_info, name, op_a.truncate_gradient, op_a.mode)
    new_outs = merged_op(*outer, return_list=True)

    # unpack merged outputs back to the two original orders
    p = 0
    nma = new_outs[p: p + ia.n_mit_sot]; p += ia.n_mit_sot
    nmb = new_outs[p: p + ib.n_mit_sot]; p += ib.n_mit_sot
    nta = new_outs[p: p + ia.n_sit_sot]; p += ia.n_sit_sot
    ntb = new_outs[p: p + ib.n_sit_sot]; p += ib.n_sit_sot
    nnta = new_outs[p: p + ia.n_nit_sot]; p += ia.n_nit_sot
    nntb = new_outs[p: p + ib.n_nit_sot]; p += ib.n_nit_sot
    nha = new_outs[p: p + ia.n_shared]; p += ia.n_shared
    nhb = new_outs[p: p + ib.n_shared]; p += ib.n_shared
    outs_a = list(nma) + list(nta) + list(nnta) + list(nha)
    outs_b = list(nmb) + list(ntb) + list(nntb) + list(nhb)
    return outs_a, outs_b


@node_rewriter([Scan])
def scan_merge(fgraph, node):
    op = node.op
    if op.info.as_while:
        return False
    for other in fgraph.toposort():
        if other is node or not isinstance(other.op, Scan):
            continue
        oi = other.op.info
        if oi.as_while:
            continue
        if not _same_n_steps(node.inputs[0], other.inputs[0]):
            continue
        if other.op.truncate_gradient != op.truncate_gradient:
            continue
        if _scan_depends_on(fgraph, node, other) or _scan_depends_on(
            fgraph, other, node
        ):
            continue
        first, second = (node, other) if _node_key(fgraph, node) < _node_key(
            fgraph, other
        ) else (other, node)
        outs_a, outs_b = _merge_two_scans(first, second)
        repl = {}
        for old, new in zip(first.outputs, outs_a):
            if fgraph.clients.get(old):
                repl[old] = new
        for old, new in zip(second.outputs, outs_b):
            if fgraph.clients.get(old):
                repl[old] = new
        if not repl:
            return False
        for old, new in repl.items():
            copy_stack_trace(old, new)
        return repl
    return False


def _node_key(fgraph, node):
    order = fgraph.toposort()
    return order.index(node)


# reference: ScanMerge runs in scan_eqopt2 (position 1.6 range)
optdb.register(
    "scan_merge", in2out(scan_merge, name="scan_merge"),
    "fast_run", "scan", position=1.62,
)


# ---------------------------------------------------------------------------
# push-out-SEQS: batch per-step work over the whole time axis
# (reference push_out_seq_scan — the RNN-throughput rewrite: T small
# per-step ops become ONE big batched op outside the loop, e.g. the
# input projection x_t @ W turns into a single (T·B, d) @ (d, k) gemm
# that fills the tensor cores)
# ---------------------------------------------------------------------------

@node_rewriter([Scan])
def scan_pushout_seqs(fgraph, node):
    from aesara_tpu_torch.graph.fg import FunctionGraph
    from aesara_tpu_torch.graph.ir import Constant, io_toposort
    from aesara_tpu_torch.tensor.elemwise import Elemwise
    from aesara_tpu_torch.tensor.math import Dot, dot as tdot

    op = node.op
    info = op.info
    if info.as_while:
        return False
    inner_in = op.fgraph.inputs
    n_seqs = info.n_seqs
    if n_seqs == 0:
        return False
    seq_vars = inner_in[:n_seqs]
    n_loop_vars = (
        n_seqs + sum(len(t) for t in info.mit_sot_taps)
        + info.n_sit_sot + info.n_shared
    )
    nonseq_vars = inner_in[n_loop_vars:]
    outer_seqs = node.inputs[1: 1 + n_seqs]
    outer_nonseqs = node.inputs[1 + n_seqs + info.n_mit_sot
                                + info.n_sit_sot + info.n_shared:]

    invariant = set(nonseq_vars)
    seq_dep = set(seq_vars)          # seq-dependent hoistable values
    n_steps_var = node.inputs[0]

    def _sliced(ov):
        # sequences may be longer than n_steps: batched combinations
        # must align on exactly the consumed window
        return ov[:n_steps_var]

    #: inner hoisted var -> maker of the outer BATCHED value
    outer_of = {
        iv: (lambda v=ov: _sliced(v)) for iv, ov in zip(seq_vars, outer_seqs)
    }
    inv_outer = dict(zip(nonseq_vars, outer_nonseqs))

    hoisted_nodes = []
    #: hoisted value -> True when its hoisted subgraph contains a Dot.
    #: Pure elemwise stays IN the loop: it fuses into the loop body
    #: for free, while hoisting would materialize a (T, ...) buffer in
    #: device memory.  Only batchable dot chains pay for the round trip.
    worth = {}
    for inner_node in io_toposort(inner_in, op.fgraph.outputs):
        if getattr(inner_node.op, "never_fold", False):
            continue
        ins = inner_node.inputs
        ok = all(
            (i in seq_dep) or (i in invariant) or isinstance(i, Constant)
            for i in ins
        )
        has_seq = any(i in seq_dep for i in ins)
        if not (ok and has_seq):
            continue

        if isinstance(inner_node.op, Elemwise) and len(inner_node.outputs) == 1:
            def build_ew(n=inner_node):
                args = []
                for i in n.inputs:
                    if i in seq_dep:
                        args.append(outer_of[i]())
                    else:
                        ov = inv_outer[i] if i in invariant else i
                        # broadcast over the new leading time axis
                        order = ("x",) + tuple(range(ov.type.ndim))
                        from aesara_tpu_torch.tensor.elemwise import DimShuffle

                        args.append(DimShuffle(ov.type.ndim, order)(ov))
                return n.op(*args)

            make_outer = build_ew
        elif (
            isinstance(inner_node.op, Dot)
            and len(ins) == 2
            and ins[0] in seq_dep
            and ins[0].type.ndim in (1, 2)
            and (ins[1] in invariant or isinstance(ins[1], Constant))
            and ins[1].type.ndim == 2
        ):
            if ins[0].type.ndim == 1:
                def build_dot(n=inner_node):
                    rhs = inv_outer.get(n.inputs[1], n.inputs[1])
                    return tdot(outer_of[n.inputs[0]](), rhs)
            else:
                # matrix slice: (T, B, D) @ (D, K) as ONE (T·B, D) gemm
                def build_dot(n=inner_node):
                    from aesara_tpu_torch.tensor.shape import reshape, shape as tshape

                    rhs = inv_outer.get(n.inputs[1], n.inputs[1])
                    lhs = outer_of[n.inputs[0]]()
                    shp = tshape(lhs)
                    flat = reshape(lhs, (shp[0] * shp[1], shp[2]))
                    res = tdot(flat, rhs)
                    return reshape(res, (shp[0], shp[1], tshape(rhs)[1]))

            make_outer = build_dot
        else:
            continue
        hoisted_nodes.append(inner_node)
        out_v = inner_node.outputs[0]
        seq_dep.add(out_v)
        outer_of[out_v] = make_outer
        worth[out_v] = isinstance(inner_node.op, Dot) or any(
            worth.get(i, False) for i in ins
        )

    if not hoisted_nodes:
        return False

    # hoist only frontier values consumed outside the hoisted set, and
    # only when the batched computation includes a Dot
    hoisted_set = set(hoisted_nodes)
    new_seq_inner = []
    for inner_node in hoisted_nodes:
        out_v = inner_node.outputs[0]
        if not worth.get(out_v, False):
            continue
        for client, _ in op.fgraph.clients.get(out_v, []):
            if client == "output" or client not in hoisted_set:
                new_seq_inner.append(out_v)
                break
    if not new_seq_inner:
        return False
    # every frontier value becomes a new sequence; if NOTHING non-trivial
    # remains in the loop this still pays (the loop becomes a cheap copy)
    new_outer_seqs = [outer_of[v]() for v in new_seq_inner]
    placeholders = [v.type(f"pushed_{k}") for k, v in enumerate(new_seq_inner)]

    from aesara_tpu_torch.graph.ir import clone_replace

    new_inner_outputs = clone_replace(
        list(op.fgraph.outputs), replace=dict(zip(new_seq_inner, placeholders))
    )
    new_inner_inputs = (
        list(seq_vars) + placeholders + list(inner_in[n_seqs:])
    )
    new_fg = FunctionGraph(new_inner_inputs, new_inner_outputs, clone=True)
    new_info = ScanInfo(
        n_seqs=n_seqs + len(placeholders),
        mit_sot_taps=info.mit_sot_taps,
        n_sit_sot=info.n_sit_sot,
        n_nit_sot=info.n_nit_sot,
        n_shared=info.n_shared,
        n_non_seqs=info.n_non_seqs,
        as_while=info.as_while,
        final_only=info.final_only,
        tail_depths=info.tail_depths,
        nit_tail_depths=info.nit_tail_depths,
    )
    new_op = Scan(new_fg, new_info, op.name, op.truncate_gradient, op.mode)
    new_inputs = (
        [node.inputs[0]] + list(outer_seqs) + new_outer_seqs
        + list(node.inputs[1 + n_seqs:])
    )
    new_outs = new_op(*new_inputs, return_list=True)
    replacements = {}
    for old, new in zip(node.outputs, new_outs):
        if fgraph.clients.get(old):
            replacements[old] = new
            copy_stack_trace(old, new)
    return replacements or False


optdb.register(
    "scan_pushout_seqs", in2out(scan_pushout_seqs, name="scan_pushout_seqs"),
    "fast_run", "scan", position=1.62,
)


# ---------------------------------------------------------------------------
# remove_constants_and_unused_inputs_scan
# (reference scan/rewriting.py:75) — slim the loop signature: drop unused
# sequences/non-sequences, substitute constant non-sequences into the body,
# and merge duplicated sequence/non-sequence inputs.  Smaller carries and
# fewer xs mean less memory traffic per step, and the cleanup exposes
# further pushout opportunities.
# ---------------------------------------------------------------------------

def _scan_layout(info, node):
    """(inner split, outer split) of a scan node's inputs."""
    inner = node.op.fgraph.inputs
    n_taps = sum(len(t) for t in info.mit_sot_taps)
    p = 0
    i_seqs = inner[p: p + info.n_seqs]; p += info.n_seqs
    i_mid = inner[p: p + n_taps + info.n_sit_sot + info.n_shared]
    p += n_taps + info.n_sit_sot + info.n_shared
    i_nonseqs = inner[p:]
    ins = node.inputs
    p = 1
    o_seqs = ins[p: p + info.n_seqs]; p += info.n_seqs
    o_mid = ins[p: p + info.n_mit_sot + info.n_sit_sot + info.n_shared]
    p += info.n_mit_sot + info.n_sit_sot + info.n_shared
    o_nonseqs = ins[p:]
    return i_seqs, i_mid, i_nonseqs, o_seqs, o_mid, o_nonseqs


@node_rewriter([Scan])
def scan_remove_constants_and_unused(fgraph, node):
    from aesara_tpu_torch.graph.fg import FunctionGraph
    from aesara_tpu_torch.graph.ir import Constant, clone_replace

    op = node.op
    info = op.info
    i_seqs, i_mid, i_nonseqs, o_seqs, o_mid, o_nonseqs = _scan_layout(
        info, node
    )

    inner_clients = op.fgraph.clients
    replace = {}          # inner var -> inner replacement (Constant or kept)
    keep_seq_i, keep_seq_o = [], []
    seen_seq = {}         # outer seq var -> kept inner var
    for iv, ov in zip(i_seqs, o_seqs):
        if not inner_clients.get(iv):
            continue  # unused sequence: drop
        if ov in seen_seq:
            replace[iv] = seen_seq[ov]
            continue  # duplicate of an earlier sequence
        seen_seq[ov] = iv
        keep_seq_i.append(iv)
        keep_seq_o.append(ov)

    keep_ns_i, keep_ns_o = [], []
    seen_ns = {}
    for iv, ov in zip(i_nonseqs, o_nonseqs):
        if not inner_clients.get(iv):
            continue  # unused non-sequence
        if isinstance(ov, Constant):
            replace[iv] = Constant(iv.type, ov.data)
            continue  # fold the outer constant into the body
        if ov in seen_ns:
            replace[iv] = seen_ns[ov]
            continue
        seen_ns[ov] = iv
        keep_ns_i.append(iv)
        keep_ns_o.append(ov)

    n_dropped = (len(i_seqs) - len(keep_seq_i)) + (
        len(i_nonseqs) - len(keep_ns_i)
    )
    if n_dropped == 0:
        return False

    new_inner_outputs = clone_replace(list(op.fgraph.outputs), replace=replace)
    new_inner_inputs = keep_seq_i + list(i_mid) + keep_ns_i
    new_fg = FunctionGraph(new_inner_inputs, new_inner_outputs, clone=True)
    new_info = ScanInfo(
        n_seqs=len(keep_seq_i),
        mit_sot_taps=info.mit_sot_taps,
        n_sit_sot=info.n_sit_sot,
        n_nit_sot=info.n_nit_sot,
        n_shared=info.n_shared,
        n_non_seqs=len(keep_ns_i),
        as_while=info.as_while,
        final_only=info.final_only,
        tail_depths=info.tail_depths,
        nit_tail_depths=info.nit_tail_depths,
    )
    new_op = Scan(new_fg, new_info, op.name, op.truncate_gradient, op.mode)
    new_outs = new_op(
        *([node.inputs[0]] + keep_seq_o + list(o_mid) + keep_ns_o),
        return_list=True,
    )
    replacements = {}
    for old, new in zip(node.outputs, new_outs):
        if fgraph.clients.get(old):
            replacements[old] = new
            copy_stack_trace(old, new)
    return replacements or False


# reference scan_eqopt1 position 0.05; run again after the pushout band,
# which leaves behind unused inputs
optdb.register(
    "scan_remove_constants_and_unused",
    in2out(scan_remove_constants_and_unused,
           name="scan_remove_constants_and_unused"),
    "fast_run", "scan", position=0.05,
)
optdb.register(
    "scan_remove_constants_and_unused_late",
    in2out(scan_remove_constants_and_unused,
           name="scan_remove_constants_and_unused_late"),
    "fast_run", "scan", position=1.66,
)


# ---------------------------------------------------------------------------
# scan_merge_inouts (reference scan/rewriting.py:1964) — duplicate OUTPUT
# elimination: two nit-sots computing the same inner variable, or two
# sit-sots with the same inner step AND the same initial state, stack the
# same values; keep one buffer.
# ---------------------------------------------------------------------------

@node_rewriter([Scan])
def scan_merge_inouts(fgraph, node):
    op = node.op
    info = op.info
    if info.as_while:
        return False
    inner_out = op.fgraph.outputs
    n_mit, n_sit, n_nit = info.n_mit_sot, info.n_sit_sot, info.n_nit_sot
    sit_in0 = 1 + info.n_seqs + n_mit  # outer index of first sit-sot init

    # duplicate nit-sots: same inner output variable
    seen = {}
    dup_of = {}
    for j in range(n_nit):
        key = inner_out[n_mit + n_sit + j]
        if key in seen:
            dup_of[n_mit + n_sit + j] = n_mit + n_sit + seen[key]
        else:
            seen[key] = j
    # duplicate sit-sots: same inner step var + same outer init + same flag
    seen_sit = {}
    for k in range(n_sit):
        rec = n_mit + k
        key = (inner_out[rec], node.inputs[sit_in0 + k],
               info.is_final_only(rec), info.tail_depth(rec))
        if key in seen_sit:
            dup_of[rec] = seen_sit[key]
        else:
            seen_sit[key] = rec
    if not dup_of:
        return False
    replacements = {}
    for dup_idx, keep_idx in dup_of.items():
        old = node.outputs[dup_idx]
        if fgraph.clients.get(old):
            replacements[old] = node.outputs[keep_idx]
            copy_stack_trace(old, node.outputs[keep_idx])
    return replacements or False


optdb.register(
    "scan_merge_inouts", in2out(scan_merge_inouts, name="scan_merge_inouts"),
    "fast_run", "scan", position=1.63,
)


# ---------------------------------------------------------------------------
# push-out-SUM (reference push_out_add_scan:813 + push_out_dot1_scan:2167,
# unified): a sit-sot that only ACCUMULATES — step = carry + expr_t with
# expr_t independent of every recurrent/shared state — and whose stack is
# consumed only through its final element, becomes a nit-sot stack of
# expr_t plus an outer ``init + sum(stack, axis=0)``.  Gated on expr_t
# containing a Dot: scan_pushout_seqs then batches the whole chain into
# one big contraction outside the loop.
# ---------------------------------------------------------------------------

@node_rewriter([Scan])
def scan_pushout_sum(fgraph, node):
    from aesara_tpu_torch.graph.fg import FunctionGraph
    from aesara_tpu_torch.graph.ir import ancestors
    from aesara_tpu_torch.tensor.elemwise import Elemwise
    from aesara_tpu_torch.tensor.math import Dot
    from aesara_tpu_torch.tensor.math import add as tadd
    from aesara_tpu_torch.tensor.math import sum as tsum

    op = node.op
    info = op.info
    if info.as_while or info.n_sit_sot == 0:
        return False
    inner_in = op.fgraph.inputs
    inner_out = op.fgraph.outputs
    n_taps = sum(len(t) for t in info.mit_sot_taps)
    sit_i0 = info.n_seqs + n_taps      # inner index of first sit-sot tap
    state_vars = set(
        inner_in[info.n_seqs: info.n_seqs + n_taps + info.n_sit_sot
                 + info.n_shared]
    )

    for k in range(info.n_sit_sot):
        rec = info.n_mit_sot + k
        carry = inner_in[sit_i0 + k]
        out_v = inner_out[rec]
        o = out_v.owner
        if o is None or not isinstance(o.op, Elemwise):
            continue
        if type(o.op.scalar_op).__name__ != "Add":
            continue
        if sum(1 for i in o.inputs if i is carry) != 1:
            continue
        rest = [i for i in o.inputs if i is not carry]
        if not rest:
            continue
        expr = rest[0] if len(rest) == 1 else tadd(*rest)
        # the carry may appear ONLY in this add — including not as an
        # inner OUTPUT: dropping the carry input while an output still
        # references it would leave a dangling variable (review finding)
        carry_clients = [c for c, _ in op.fgraph.clients.get(carry, [])]
        if any(c != o for c in carry_clients):
            continue
        if out_v in op.fgraph.clients and any(
            c != "output" for c, _ in op.fgraph.clients.get(out_v, [])
        ):
            continue  # next state feeds other inner computation
        expr_anc = set(ancestors(rest))
        if expr_anc & state_vars:
            continue  # not batchable outside the loop
        if not any(
            v.owner is not None and isinstance(v.owner.op, Dot)
            for v in expr_anc
        ):
            continue  # no product to batch; carry accumulation is cheaper
        # stacked output must be consumed only at [-1] (or be final-only);
        # a ring (tail-depth) output is consumed as a window — skip it
        if info.tail_depth(rec):
            continue
        outer_out = node.outputs[rec]
        clients = fgraph.clients.get(outer_out, [])
        if not info.is_final_only(rec):
            if any(
                client == "output"
                or not (isinstance(client.op, Subtensor)
                        and _is_last_element_index(client.op.idx_list))
                for client, _ in clients
            ):
                continue

        # --- rebuild: drop sit-sot k, append expr as a nit-sot ------------
        new_inner_inputs = [
            v for i, v in enumerate(inner_in) if i != sit_i0 + k
        ]
        kept_out = [v for i, v in enumerate(inner_out) if i != rec]
        nit_end = info.n_mit_sot + info.n_sit_sot + info.n_nit_sot - 1
        new_inner_outputs = (
            kept_out[:nit_end] + [expr] + kept_out[nit_end:]
        )
        new_final = [
            f for i, f in enumerate(
                info.final_only
                or [False] * (info.n_mit_sot + info.n_sit_sot)
            )
            if i != rec
        ]
        new_tails = [
            t for i, t in enumerate(
                info.tail_depths
                or [0] * (info.n_mit_sot + info.n_sit_sot)
            )
            if i != rec
        ]
        new_info = ScanInfo(
            n_seqs=info.n_seqs,
            mit_sot_taps=info.mit_sot_taps,
            n_sit_sot=info.n_sit_sot - 1,
            n_nit_sot=info.n_nit_sot + 1,
            n_shared=info.n_shared,
            n_non_seqs=info.n_non_seqs,
            as_while=False,
            final_only=tuple(new_final) if any(new_final) else (),
            tail_depths=tuple(new_tails) if any(new_tails) else (),
            nit_tail_depths=(
                tuple(info.nit_tail_depths) + (0,)
                if info.nit_tail_depths and any(info.nit_tail_depths)
                else ()
            ),
        )
        new_fg = FunctionGraph(new_inner_inputs, new_inner_outputs,
                               clone=True)
        new_op = Scan(new_fg, new_info, op.name, op.truncate_gradient,
                      op.mode)
        outer_init_idx = 1 + info.n_seqs + info.n_mit_sot + k
        init = node.inputs[outer_init_idx]
        new_outer = [
            v for i, v in enumerate(node.inputs) if i != outer_init_idx
        ]
        new_outs = new_op(*new_outer, return_list=True)
        stacked_expr = new_outs[nit_end]
        final = init + tsum(stacked_expr, axis=0)

        replacements = {}
        # outputs before rec map 1:1; outputs after rec shift down by one
        old_order = [i for i in range(len(node.outputs)) if i != rec]
        for new_i, old_i in enumerate(old_order):
            # the appended nit-sot occupies slot nit_end in new_outs:
            # shift the mapping past it
            src = new_outs[new_i if new_i < nit_end else new_i + 1]
            old = node.outputs[old_i]
            if fgraph.clients.get(old):
                replacements[old] = src
                copy_stack_trace(old, src)
        if info.is_final_only(rec):
            if fgraph.clients.get(outer_out):
                replacements[outer_out] = final
                copy_stack_trace(outer_out, final)
        else:
            for client, _ in clients:
                replacements[client.outputs[0]] = final
                copy_stack_trace(client.outputs[0], final)
        return replacements or False
    return False


optdb.register(
    "scan_pushout_sum", in2out(scan_pushout_sum, name="scan_pushout_sum"),
    "fast_run", "scan", position=1.615,
)


# ---------------------------------------------------------------------------
# identity nit-sot elimination: a nit-sot whose inner value IS one of the
# inner sequence slices stacks an exact copy of the (sliced) outer
# sequence — return ``seq[:n_steps]`` instead and drop the buffer.  This
# is the cleanup pass that lets a fully-pushed-out map DISSOLVE.
# ---------------------------------------------------------------------------

@node_rewriter([Scan])
def scan_identity_nitsot(fgraph, node):
    op = node.op
    info = op.info
    if info.as_while or info.n_nit_sot == 0 or info.n_seqs == 0:
        return False
    inner_in = op.fgraph.inputs
    inner_out = op.fgraph.outputs
    seq_pos = {v: i for i, v in enumerate(inner_in[:info.n_seqs])}
    n_steps = node.inputs[0]
    outer_seqs = node.inputs[1: 1 + info.n_seqs]

    replacements = {}
    for j in range(info.n_nit_sot):
        out_idx = info.n_mit_sot + info.n_sit_sot + j
        iv = inner_out[out_idx]
        if iv not in seq_pos:
            continue
        old = node.outputs[out_idx]
        if not fgraph.clients.get(old):
            continue
        new = outer_seqs[seq_pos[iv]][:n_steps]
        replacements[old] = new
        copy_stack_trace(old, new)
    return replacements or False


optdb.register(
    "scan_identity_nitsot",
    in2out(scan_identity_nitsot, name="scan_identity_nitsot"),
    "fast_run", "scan", position=1.65,
)
