"""The ``Scan`` op: a general symbolic loop (the counterpart of
``aesara_tpu/scan/op.py``; ``ScanInfo``, ``make_node``, ``infer_shape``,
``L_op`` and ``connection_pattern`` are that module's, node for node, so
the port's graphs are the JAX package's).

The JAX package lowers the whole loop to one ``lax.scan``; the port runs
it as a host loop over the inner graph's compiled program
(``link/torch/scan_dispatch.py``), which a CUDA graph captures, unrolled,
when the trip count is fixed by shapes and constants.  The gradient is a
reverse Scan (BPTT).

Taxonomy (reference terms):
- sequences      — per-step inputs, indexed t
- mit-sot        — recurrent output with taps {-k..-1}
- sit-sot        — special case taps = [-1]
- nit-sot        — output without feedback (a map output)
- shared/carried — a shared variable updated in the body
- non-sequences  — loop-invariant inputs

Canonical input order of the op:
  [n_steps] + seqs + mit_sot_inits + sit_sot_inits + shared_inits + non_seqs
Canonical output order:
  mit_sot_outs + sit_sot_outs + nit_sot_outs + shared_finals
where *_outs are (n_steps, ...) stacks of computed steps (initial taps
not included) and shared_finals are final states.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


from aesara_tpu_torch.graph.fg import FunctionGraph
from aesara_tpu_torch.graph.ir import Apply, Variable
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.scalar.ops import discrete_dtypes
from aesara_tpu_torch.tensor.basic import as_tensor_variable, cast
from aesara_tpu_torch.tensor.type import TensorType


@dataclass(frozen=True)
class ScanInfo:
    """Static structure of a Scan (reference ``scan/op.py:206``)."""

    n_seqs: int
    mit_sot_taps: Tuple[Tuple[int, ...], ...]  # per mit-sot output
    n_sit_sot: int
    n_nit_sot: int
    n_shared: int
    n_non_seqs: int
    as_while: bool = False
    #: per recurrent output (mit then sit): True → only the FINAL state is
    #: returned (single step, no stacked buffer) — the scan_save_mem
    #: rewrite's storage truncation (reference scan/rewriting.py:1176)
    final_only: Tuple[bool, ...] = ()
    #: per recurrent output (mit then sit): k > 0 → only the LAST k steps
    #: are returned, kept as a k-deep ring in the carry instead of the
    #: full (n_steps, ...) stack — the tail-window generalization of
    #: scan_save_mem (reference save_mem_new_scan, scan/rewriting.py:1176,
    #: truncates stacked buffers for arbitrary tail windows x[-k:])
    tail_depths: Tuple[int, ...] = ()
    #: per nit-sot output: k > 0 → only the LAST k steps are returned as a
    #: k-deep ring in the carry (the map-output windowed-loss case the
    #: reference's save_mem_new_scan also truncates,
    #: ``scan/rewriting.py:1176``); 0 → full (n_steps, ...) stack.
    #: Pure x[-1] consumers use k=1 (nit-sots have no carried state, so
    #: there is no separate final_only form).
    nit_tail_depths: Tuple[int, ...] = ()

    def is_final_only(self, rec_idx: int) -> bool:
        return bool(self.final_only) and self.final_only[rec_idx]

    def tail_depth(self, rec_idx: int) -> int:
        """Ring depth for a recurrent output (0 = full stack)."""
        return self.tail_depths[rec_idx] if self.tail_depths else 0

    def nit_tail_depth(self, nit_idx: int) -> int:
        """Ring depth for a nit-sot output (0 = full stack)."""
        return self.nit_tail_depths[nit_idx] if self.nit_tail_depths else 0

    @property
    def n_mit_sot(self) -> int:
        return len(self.mit_sot_taps)

    @property
    def n_recurrent(self) -> int:
        return self.n_mit_sot + self.n_sit_sot

    @property
    def n_outs(self) -> int:
        return self.n_mit_sot + self.n_sit_sot + self.n_nit_sot + self.n_shared


def _discrete(v) -> bool:
    return v.type.dtype in discrete_dtypes


def _differentiable(pairs) -> dict:
    """{output: its gradient variable} of the pairs whose output is not
    discrete."""
    return {o: g for o, g in pairs if not _discrete(o)}


class Scan(Op):
    """The loop op.

    ``fgraph`` is the inner graph.  Inner input order:
      seq slices + mit-sot taps (flattened, oldest tap first per output)
      + sit-sot taps + shared states + non-seqs
    Inner output order:
      mit-sot next values + sit-sot next values + nit-sot values
      + shared next states [+ while-condition if as_while]
    """

    def __init__(self, fgraph: FunctionGraph, info: ScanInfo, name=None,
                 truncate_gradient: int = -1, mode=None):
        self.fgraph = fgraph
        self.info = info
        self.name = name or "scan"
        self.truncate_gradient = truncate_gradient
        self.mode = mode
        n_inner_outs = info.n_outs + (1 if info.as_while else 0)
        if len(fgraph.outputs) != n_inner_outs:
            raise ValueError(
                f"inner graph has {len(fgraph.outputs)} outputs, "
                f"expected {n_inner_outs}"
            )

    # --- identity ----------------------------------------------------------
    def __eq__(self, other):
        if self is other:
            return True
        if type(other) is not Scan or self.info != other.info:
            return False
        from aesara_tpu_torch.graph.ir import equal_computations

        return equal_computations(
            self.fgraph.outputs, other.fgraph.outputs,
            self.fgraph.inputs, other.fgraph.inputs,
        )

    def __hash__(self):
        return hash((Scan, self.info, len(self.fgraph.apply_nodes)))

    def __str__(self):
        tag = "scan_while" if self.info.as_while else "scan"
        return f"{self.name}{{{tag}}}" if self.name != "scan" else f"Scan{{{tag}}}"

    # --- inner graph -------------------------------------------------------
    @property
    def inner_inputs(self):
        return self.fgraph.inputs

    @property
    def inner_outputs(self):
        return self.fgraph.outputs

    def clone(self):
        new_fg = self.fgraph.clone()
        return Scan(new_fg, self.info, self.name, self.truncate_gradient, self.mode)

    # --- node construction ----------------------------------------------------
    def make_node(self, n_steps, *operands) -> Apply:
        info = self.info
        n_steps = cast(as_tensor_variable(n_steps), "int64")
        seqs = [as_tensor_variable(s) for s in operands[: info.n_seqs]]
        pos = info.n_seqs
        mit_inits = [as_tensor_variable(v) for v in operands[pos: pos + info.n_mit_sot]]
        pos += info.n_mit_sot
        sit_inits = [as_tensor_variable(v) for v in operands[pos: pos + info.n_sit_sot]]
        pos += info.n_sit_sot
        shared_inits = list(operands[pos: pos + info.n_shared])
        pos += info.n_shared
        non_seqs = list(operands[pos:])
        if len(non_seqs) != info.n_non_seqs:
            raise ValueError(
                f"expected {info.n_non_seqs} non-sequences, got {len(non_seqs)}"
            )

        try:
            from aesara_tpu_torch.tensor.basic import get_scalar_constant_value

            static_len = int(get_scalar_constant_value(n_steps))
            if static_len < 0:
                raise ValueError(
                    f"scan n_steps must be non-negative, got {static_len}"
                )
        except ValueError:
            raise
        except Exception:
            # a symbolic n_steps may be SMALLER than any sequence's static
            # length (scan truncates sequences to the trip count), so no
            # sequence-based fallback is sound here (review finding)
            static_len = None
        if info.as_while:
            static_len = None  # actual trip count is data-dependent

        outputs: List[Variable] = []
        inner = self.fgraph.outputs
        idx = 0
        def rec_out_type(rec_i):
            if info.is_final_only(rec_i):
                return inner[idx].type()
            tail = info.tail_depth(rec_i)
            lead = tail if tail else static_len
            return TensorType(
                inner[idx].type.dtype, (lead,) + inner[idx].type.shape
            )()

        for rec_i, taps in enumerate(info.mit_sot_taps):
            outputs.append(rec_out_type(rec_i))
            idx += 1
        for k in range(info.n_sit_sot):
            outputs.append(rec_out_type(info.n_mit_sot + k))
            idx += 1
        for nit_i in range(info.n_nit_sot):
            tail = info.nit_tail_depth(nit_i)
            lead = tail if tail else static_len
            outputs.append(
                TensorType(inner[idx].type.dtype, (lead,) + inner[idx].type.shape)()
            )
            idx += 1
        for _ in range(info.n_shared):
            outputs.append(inner[idx].type())
            idx += 1

        return Apply(
            self,
            [n_steps] + seqs + mit_inits + sit_inits + shared_inits + non_seqs,
            outputs,
        )

    # --- shape -------------------------------------------------------------------
    def infer_shape(self, fgraph, node, input_shapes):
        from aesara_tpu_torch.tensor.shape import shape as tshape

        info = self.info
        n_steps = node.inputs[0]
        out = []
        for i, o in enumerate(node.outputs):
            if (
                i < info.n_mit_sot + info.n_sit_sot
                and (info.is_final_only(i) or info.tail_depth(i))
            ):
                # final state or (k, ...) ring: the output's own (static)
                # shape, not an (n_steps, ...) stack
                out.append(tuple(tshape(o)[d] for d in range(o.type.ndim)))
            elif i < info.n_mit_sot + info.n_sit_sot + info.n_nit_sot:
                nit_i = i - info.n_mit_sot - info.n_sit_sot
                if info.nit_tail_depth(nit_i):
                    # (k, ...) ring: the output's own static shape
                    out.append(tuple(tshape(o)[d] for d in range(o.type.ndim)))
                else:
                    rest = tuple(
                        tshape(o)[d + 1] for d in range(o.type.ndim - 1)
                    )
                    # a while-scan stops early: the stack's leading dim is
                    # the EXECUTED count, only knowable from the output
                    # itself (replacing it with n_steps mis-sized every
                    # grad-of-until reverse sweep)
                    lead = tshape(o)[0] if info.as_while else n_steps
                    out.append((lead,) + rest)
            else:
                # shared finals: same shape as the matching init
                init_idx = 1 + info.n_seqs + info.n_mit_sot + info.n_sit_sot + (
                    i - info.n_mit_sot - info.n_sit_sot - info.n_nit_sot
                )
                out.append(input_shapes[init_idx])
        return out

    # --- gradient: reverse Scan (BPTT) ----------------------------------------
    def L_op(self, inputs, outputs, output_grads):
        """Build the reverse scan (reference ``scan/op.py:2379``).

        Unified treatment: every recurrent output is a mit-sot with taps
        (sit-sot = taps (-1,)).  The reverse scan carries, per recurrent
        output, a pending-gradient window P of depth = -min(taps): at
        reverse step t, ghat_t = g_out[t] + P[0]; tap contributions
        scatter into the shifted window; the final window (reversed rows)
        is the gradient wrt the initial tap buffer.  ``truncate_gradient``
        runs the reverse scan over only the last k steps (truncated BPTT,
        ``scan/basic.py:168`` semantics).
        """
        from aesara_tpu_torch.gradient import (
            DisconnectedType,
            NullType,
            disconnected_type,
            grad as sym_grad,
            grad_not_implemented,
            grad_undefined,
        )
        import aesara_tpu_torch.tensor.basic as tb
        import aesara_tpu_torch.tensor.math as tm
        from aesara_tpu_torch.tensor.shape import shape_padleft
        from aesara_tpu_torch.tensor.subtensor import inc_subtensor, set_subtensor

        info = self.info
        if (any(info.final_only) or any(info.tail_depths)
                or any(info.nit_tail_depths)):
            # save-mem scans arise from the post-grad rewrite pipeline;
            # user grads are built before scan_save_mem fires
            return [
                grad_not_implemented(self, i, inp,
                                     "gradient through save-mem Scan "
                                     "not supported")
                for i, inp in enumerate(inputs)
            ]

        n_steps = inputs[0]
        seqs = inputs[1: 1 + info.n_seqs]
        pos = 1 + info.n_seqs
        mit_inits = inputs[pos: pos + info.n_mit_sot]
        pos += info.n_mit_sot
        sit_inits = inputs[pos: pos + info.n_sit_sot]
        pos += info.n_sit_sot
        shared_inits = inputs[pos: pos + info.n_shared]
        pos += info.n_shared
        non_seqs = inputs[pos:]

        n_rec0 = n_rec = info.n_mit_sot + info.n_sit_sot
        rec_outs = outputs[:n_rec]
        nit_outs = outputs[n_rec: n_rec + info.n_nit_sot]

        # unified tap structure: mit outputs then sit outputs
        all_taps = [tuple(t) for t in info.mit_sot_taps] + [(-1,)] * info.n_sit_sot
        # unified init buffers with a leading window axis
        init_bufs = list(mit_inits) + [shape_padleft(v, 1) for v in sit_inits]

        # --- inner gradient graph over the inner placeholder vars ------------
        inner_in = self.fgraph.inputs
        inner_out = self.fgraph.outputs
        i_seqs = inner_in[: info.n_seqs]
        p = info.n_seqs
        i_taps_per_out = []
        for taps in all_taps:
            i_taps_per_out.append(inner_in[p: p + len(taps)])
            p += len(taps)
        i_shared = inner_in[p: p + info.n_shared]
        p += info.n_shared
        i_nonseqs = inner_in[p:]
        o_rec = inner_out[:n_rec]
        o_nit = inner_out[n_rec: n_rec + info.n_nit_sot]
        o_shr = inner_out[n_rec + info.n_nit_sot:
                          n_rec + info.n_nit_sot + info.n_shared]

        def _inner_grad(known, wrt):
            gs = sym_grad(
                None, wrt, known_grads=known,
                disconnected_inputs="ignore", return_disconnected="zero",
            )
            return gs if isinstance(gs, list) else [gs]

        g_o_rec = [o.type() for o in o_rec]
        g_o_nit = [o.type() for o in o_nit]
        # a discrete output (padded_while's done flag) takes no gradient:
        # the JAX package gives it one and fails on the float it carries
        # (its known fault, tests/scan/test_padded_while.py:66)
        known = _differentiable(zip(list(o_rec) + list(o_nit), g_o_rec + g_o_nit))
        flat_taps = [tv for tvs in i_taps_per_out for tv in tvs]
        base_wrt = list(i_seqs) + flat_taps + list(i_nonseqs)
        if known:
            inner_grads = _inner_grad(known, base_wrt)
        else:
            # shared-updates-only loop: nothing flows through rec/nit
            inner_grads = [tb.zeros_like(v) for v in base_wrt]

        # --- does any gradient actually flow through shared state? ----------
        # Two channels (reference scan/op.py:2379 saves per-step hidden
        # states for exactly this): (a) an inner grad expression reads the
        # per-step shared value, (b) the caller's cost depends on a shared
        # FINAL output (live cotangent).  Substituting the *initial* outer
        # value for (a) — what this code once did — is silently wrong.
        from aesara_tpu_torch.graph.ir import ancestors as _ancestors

        shared_cots = list(
            output_grads[n_rec + info.n_nit_sot:
                         n_rec + info.n_nit_sot + info.n_shared]
        )
        cot_live = [
            not isinstance(og.type, (DisconnectedType, NullType))
            for og in shared_cots
        ]
        grads_read_shared = info.n_shared > 0 and bool(
            set(i_shared) & set(_ancestors(inner_grads))
        )
        thread_shared = any(cot_live) or grads_read_shared

        n_thr = 0
        shared_stacks = []
        if thread_shared:
            if not all(isinstance(sv.type, TensorType) for sv in i_shared):
                return [disconnected_type()] + [
                    grad_not_implemented(
                        self, 1 + i, inp,
                        "gradient flows through a non-tensor Scan shared "
                        "state (e.g. an RNG stream); per-step state cannot "
                        "be replayed — restructure the loop to thread that "
                        "state as an explicit recurrent output",
                    )
                    for i, inp in enumerate(inputs[1:])
                ]
            # Replay the forward pass with shared states reclassified as
            # sit-sots so their full per-step history is stacked.  Inner
            # input order is unchanged (shared slots sit exactly where the
            # extra sit-sot taps go); outputs are reordered rec+shared+nit.
            n_thr = info.n_shared
            aux_fg = FunctionGraph(
                list(inner_in), list(o_rec) + list(o_shr) + list(o_nit),
                clone=True,
            )
            aux_info = ScanInfo(
                n_seqs=info.n_seqs,
                mit_sot_taps=info.mit_sot_taps,
                n_sit_sot=info.n_sit_sot + n_thr,
                n_nit_sot=info.n_nit_sot,
                n_shared=0,
                n_non_seqs=info.n_non_seqs,
            )
            aux_op = Scan(aux_fg, aux_info, name=f"{self.name}_grad_replay",
                          mode=self.mode)
            aux_outs = aux_op(
                n_steps, *seqs, *mit_inits, *sit_inits, *shared_inits,
                *non_seqs,
            )
            if not isinstance(aux_outs, (list, tuple)):
                aux_outs = [aux_outs]
            shared_stacks = list(aux_outs[n_rec: n_rec + n_thr])

            # fold shared states into the unified sit-sot machinery
            all_taps = all_taps + [(-1,)] * n_thr
            init_bufs = init_bufs + [shape_padleft(v, 1) for v in shared_inits]
            rec_outs = list(rec_outs) + shared_stacks
            i_taps_per_out = i_taps_per_out + [[sv] for sv in i_shared]
            flat_taps = flat_taps + list(i_shared)
            g_o_shr = [o.type() for o in o_shr]
            g_o_rec = g_o_rec + g_o_shr
            known = _differentiable(
                zip(list(o_rec) + list(o_shr) + list(o_nit),
                    g_o_rec + g_o_nit)
            )
            inner_grads = _inner_grad(
                known, list(i_seqs) + flat_taps + list(i_nonseqs)
            )
            n_rec = n_rec + n_thr

        depths = [-min(t) for t in all_taps]
        g_i_seqs = inner_grads[: info.n_seqs]
        g_i_taps = inner_grads[info.n_seqs: info.n_seqs + len(flat_taps)]
        g_i_nonseqs = inner_grads[info.n_seqs + len(flat_taps):]

        # --- reverse-scan construction ------------------------------------------
        from aesara_tpu_torch.scan.basic import scan as scan_fn
        from aesara_tpu_torch.graph.ir import clone_replace

        T = n_steps
        if info.as_while:
            # gradient through ``until`` (reference test_grad_until,
            # tests/scan/test_basic.py:2376): the reverse sweep covers
            # the EXECUTED steps only — read the trip count off a
            # stacked output's leading dim.  Steps never run contribute
            # zero gradient (the seq-tail padding below handles it).
            if thread_shared:
                return [disconnected_type()] + [
                    grad_not_implemented(
                        self, 1 + i, inp,
                        "gradient through a while-Scan whose gradient "
                        "reads shared state is not supported (the "
                        "replay would re-run the condition)",
                    )
                    for i, inp in enumerate(inputs[1:])
                ]
            probe = list(rec_outs) + list(nit_outs)
            if not probe:
                return [disconnected_type()] + [
                    grad_not_implemented(self, 1 + i, inp,
                                         "while-Scan with no stacked "
                                         "outputs has no trip count")
                    for i, inp in enumerate(inputs[1:])
                ]
            T = tb.cast(probe[0].shape[0], "int64")
        trunc = self.truncate_gradient
        if trunc is not None and trunc != -1:
            n_back = tm.minimum(tb.cast(tb.as_tensor_variable(trunc), "int64"),
                                tb.cast(T, "int64"))
        else:
            n_back = None

        def rev(x):
            return x[::-1]

        def rev_trunc(x):
            # last n_back forward steps, reversed = first n_back of rev(x)
            r = rev(x)
            return r if n_back is None else r[: n_back]

        # per recurrent output: full history buffer [h_{1-depth} .. h_T]
        full_bufs = [
            tb.join(0, init, out) for init, out in zip(init_bufs, rec_outs)
        ]
        # tap-value sequences per (output, tap): h_{t+tap} for t = T..1
        tap_seqs = []
        for full, taps, depth in zip(full_bufs, all_taps, depths):
            for tap in taps:
                # rows (tap+depth) .. (tap+depth+T-1) of full, reversed
                start = tap + depth
                sl = full[start: start + T] if n_back is None else full[start: start + T]
                tap_seqs.append(rev_trunc(sl))

        g_rec_out = []
        for i, og in enumerate(output_grads[:n_rec0]):
            if isinstance(og.type, (DisconnectedType, NullType)):
                og = tb.zeros_like(rec_outs[i])
            g_rec_out.append(rev_trunc(og))
        for i in range(n_thr):
            # shared-final cotangent enters at step T only = first
            # reversed row; zero elsewhere
            base = rev_trunc(tb.zeros_like(shared_stacks[i]))
            if cot_live[i]:
                base = set_subtensor(base[0], shared_cots[i])
            g_rec_out.append(base)
        g_nit_out = []
        for i, og in enumerate(
            output_grads[n_rec0: n_rec0 + info.n_nit_sot]
        ):
            if isinstance(og.type, (DisconnectedType, NullType)):
                og = tb.zeros_like(nit_outs[i])
            g_nit_out.append(rev_trunc(og))

        # ALWAYS truncate to the trip count first: a sequence longer than
        # n_steps would otherwise reverse from its far end and misalign
        # every backward step (review finding); when the slice provably
        # covers, local_useless_subtensor removes it
        rev_seqs = [rev_trunc(s[:T]) for s in seqs] \
            + tap_seqs + g_rec_out + g_nit_out

        # carries: pending-gradient window per recurrent output; gw per
        # differentiable non-seq
        pend_inits = [tb.zeros_like(buf) for buf in init_bufs]
        gw_inits = []
        for ns in non_seqs:
            if hasattr(ns.type, "dtype") and ns.type.dtype not in discrete_dtypes:
                gw_inits.append(tb.zeros_like(tb.as_tensor_variable(ns)))
            else:
                gw_inits.append(None)
        n_wi = sum(1 for g in gw_inits if g is not None)
        n_taps_total = len(flat_taps)

        def backward_step(*args):
            p = 0
            b_seqs = args[p: p + info.n_seqs]; p += info.n_seqs
            b_taps = args[p: p + n_taps_total]; p += n_taps_total
            b_grec = args[p: p + n_rec]; p += n_rec
            b_gnit = args[p: p + info.n_nit_sot]; p += info.n_nit_sot
            b_pend = args[p: p + n_rec]; p += n_rec
            b_gw = args[p: p + n_wi]; p += n_wi
            b_nonseqs = args[p:]

            # total cotangent on this step's recurrent outputs
            ghat = [None if _discrete(pend) else tm.add(g, pend[-1])
                    for g, pend in zip(b_grec, b_pend)]

            replace = {}
            for iv, v in zip(i_seqs, b_seqs):
                replace[iv] = v
            k = 0
            for tvs in i_taps_per_out:
                for tv in tvs:
                    replace[tv] = b_taps[k]
                    k += 1
            if not thread_shared:
                # grads provably don't read shared state (checked above);
                # entries are dead but keep values complete
                for iv, v in zip(i_shared, shared_inits):
                    replace[iv] = v
            for iv, v in zip(i_nonseqs, b_nonseqs):
                replace[iv] = v
            for gv, v in zip(g_o_rec + g_o_nit, ghat + list(b_gnit)):
                if not _discrete(gv):
                    replace[gv] = v

            rep = clone_replace(
                list(g_i_seqs) + list(g_i_taps) + list(g_i_nonseqs),
                replace=replace,
            )
            r_gseqs = rep[: info.n_seqs]
            r_gtaps = rep[info.n_seqs: info.n_seqs + n_taps_total]
            r_gw = rep[info.n_seqs + n_taps_total:]

            # shift each pending window toward the past and scatter tap
            # contributions: window rows ordered [oldest .. newest] where
            # row (depth-1) is the pending grad for the NEXT reverse step
            new_pend = []
            k = 0
            for pend, taps, depth in zip(b_pend, all_taps, depths):
                if depth == 1:
                    # the whole single-row window shifts out: no empty
                    # pend[:-1] slice and degenerate join
                    shifted = tb.zeros_like(pend)
                else:
                    shifted = tb.join(
                        0,
                        tb.zeros_like(shape_padleft(pend[0], 1)),
                        pend[:-1],
                    )
                for tap in taps:
                    # contribution to h_{t+tap}: row depth-1-(|tap|-1)
                    row = depth + tap
                    if not _discrete(pend):
                        shifted = inc_subtensor(shifted[row], r_gtaps[k])
                    k += 1
                new_pend.append(shifted)

            new_gw = []
            wi = 0
            for j, gwi in enumerate(gw_inits):
                if gwi is None:
                    continue
                new_gw.append(tm.add(b_gw[wi], r_gw[j]))
                wi += 1
            return list(r_gseqs) + new_pend + new_gw

        results, _ = scan_fn(
            backward_step,
            sequences=rev_seqs,
            outputs_info=(
                [None] * info.n_seqs
                + [{"initial": g, "taps": [-1]} for g in pend_inits]
                + [{"initial": g, "taps": [-1]} for g in gw_inits if g is not None]
            ),
            non_sequences=list(non_seqs),
            n_steps=T if n_back is None else n_back,
        )
        if not isinstance(results, list):
            results = [results]
        r_gseq_stacks = results[: info.n_seqs]
        r_pend_stacks = results[info.n_seqs: info.n_seqs + n_rec]
        r_gw_stacks = results[info.n_seqs + n_rec:]

        rval = [disconnected_type()]  # n_steps
        for i in range(info.n_seqs):
            inp = seqs[i]
            if hasattr(inp.type, "dtype") and inp.type.dtype in discrete_dtypes:
                rval.append(grad_undefined(self, 1 + i, inp))
                continue
            g = rev(r_gseq_stacks[i])
            if n_back is not None:
                # earlier (truncated-away) steps receive zero gradient
                pad_len = tb.cast(T, "int64") - n_back
                pad = tb.zeros_like(inp[: pad_len])
                g = tb.join(0, pad, g)
            # the sequence may be LONGER than the trip count (explicit
            # n_steps or a shorter co-sequence): unused tail rows get
            # zero gradient so g matches the input's length
            try:
                from aesara_tpu_torch.tensor.basic import get_scalar_constant_value

                t_static = int(get_scalar_constant_value(T))
            except Exception:
                t_static = None
            if not (t_static is not None and inp.type.shape[0] == t_static):
                tail = tb.zeros_like(inp[tb.cast(T, "int64"):])
                g = tb.join(0, g, tail)
            rval.append(g)
        # grads wrt initial tap buffers: final pending window; zero when
        # truncation stopped the reverse sweep before reaching t=1.  When
        # shared states were threaded, the tail n_thr windows are the
        # grads wrt the shared inits (sit-sot formula).
        for i in range(n_rec):
            final_pend = r_pend_stacks[i][-1]
            if n_back is not None:
                reached_start = tm.ge(n_back, tb.cast(T, "int64"))
                final_pend = final_pend * tb.cast(
                    reached_start, final_pend.type.dtype
                )
            if i < info.n_mit_sot:
                rval.append(final_pend)
            else:
                rval.append(final_pend[0])  # sit-sot init is a single step
        if not thread_shared:
            for i in range(info.n_shared):
                rval.append(grad_not_implemented(
                    self, 1 + info.n_seqs + n_rec + i, shared_inits[i],
                    "gradient through Scan shared states not supported",
                ))
        wi = 0
        for k, gwi in enumerate(gw_inits):
            if gwi is None:
                rval.append(grad_undefined(
                    self, 1 + info.n_seqs + n_rec0 + info.n_shared + k,
                    non_seqs[k],
                ))
            else:
                rval.append(r_gw_stacks[wi][-1])
                wi += 1
        return rval


    def connection_pattern(self, node):
        """Real edge-level connectivity from the INNER graph (reference
        ``scan/op.py:2092``): inner-input → inner-output reachability,
        closed transitively over the recurrences (a value reaching a
        recurrent output also reaches anything that output's tap
        placeholders reach on later steps, and likewise through shared
        states)."""
        from aesara_tpu_torch.graph.ir import ancestors

        info = self.info
        inner_in = self.fgraph.inputs
        inner_out = self.fgraph.outputs
        n_rec = info.n_recurrent
        n_out = len(node.outputs)  # rec + nit + shared (no while-cond)

        # direct reachability: inner input index -> set of inner out idx
        anc = [set(ancestors([o])) for o in inner_out[:n_out]]
        direct = [
            {j for j in range(n_out) if iv in anc[j]} for iv in inner_in
        ]

        # structural feeds: output j's next-step consumers (tap/shared
        # placeholders)
        p = info.n_seqs
        taps_slots = []  # per recurrent output: its inner tap input idxs
        for taps in list(info.mit_sot_taps) + [(-1,)] * info.n_sit_sot:
            taps_slots.append(list(range(p, p + len(taps))))
            p += len(taps)
        shared_slots = list(range(p, p + info.n_shared))

        def feeds(j):
            if j < n_rec:
                return taps_slots[j]
            if j >= n_rec + info.n_nit_sot:
                return [shared_slots[j - n_rec - info.n_nit_sot]]
            return []

        # transitive closure over steps
        changed = True
        while changed:
            changed = False
            for reach in direct:
                extra = set()
                for j in reach:
                    for slot in feeds(j):
                        extra |= direct[slot]
                if not extra <= reach:
                    reach |= extra
                    changed = True

        # outer rows: [n_steps, seqs, mit inits, sit inits, shared, nonseqs]
        rows = [[False] * n_out]  # n_steps
        p = info.n_seqs
        for s in range(info.n_seqs):
            rows.append([j in direct[s] for j in range(n_out)])
        for r in range(n_rec):  # init buffers enter via the first taps
            reach = set()
            for slot in taps_slots[r]:
                reach |= direct[slot]
            rows.append([j in reach for j in range(n_out)])
        for slot in shared_slots:
            rows.append([j in direct[slot] for j in range(n_out)])
        n_nonseq_slots = len(inner_in) - info.n_seqs - sum(
            len(t) for t in taps_slots) - info.n_shared
        base = len(inner_in) - n_nonseq_slots
        for k in range(n_nonseq_slots):
            rows.append([j in direct[base + k] for j in range(n_out)])
        assert len(rows) == len(node.inputs), (len(rows), len(node.inputs))
        return rows
