"""Scan graph utilities (the counterpart of ``aesara_tpu/scan/utils.py``:
``ScanArgs``, ``safe_new``, ``expand_empty``, ``reconstruct_graph``,
``traverse``, the toolkit downstream libraries use to pick Scan nodes
apart, and ``get_updates_and_outputs``, which ``scan`` uses)."""

from __future__ import annotations


import numpy as np

from aesara_tpu_torch.graph.ir import Variable, clone_replace


class InnerFunctionError(Exception):
    """An error inside a scan's inner function (reference name)."""


def safe_new(x: Variable, tag: str = "", dtype=None) -> Variable:
    """A fresh variable of the same type, optionally re-dtyped
    (reference ``safe_new``)."""
    from aesara_tpu_torch.tensor.type import TensorType

    t = x.type
    if dtype is not None and hasattr(t, "dtype"):
        t = TensorType(dtype, t.shape)
    new = t()
    if x.name:
        new.name = x.name + tag
    return new


def expand_empty(tensor_var, size):
    """Pad a stacked buffer with ``size`` empty rows (reference
    ``expand_empty``), a concatenate with an ``AllocEmpty``."""
    from aesara_tpu_torch.tensor.basic import AllocEmpty, join

    if size == 0:
        return tensor_var
    extra = AllocEmpty(tensor_var.type.dtype)(
        size, *[tensor_var.shape[i] for i in range(1, tensor_var.type.ndim)]
    )
    return join(0, tensor_var, extra)


def traverse(out, x, x_copy, d, visited=None):
    """Walk ``out``'s graph replacing ``x`` by ``x_copy`` in the mapping
    ``d`` (reference ``traverse`` — RNG-swap helper)."""
    if visited is None:
        visited = set()
    if out in visited:
        return d
    visited.add(out)
    if out is x:
        d[x] = x_copy
        return d
    if out.owner is not None:
        for i in out.owner.inputs:
            traverse(i, x, x_copy, d, visited)
    return d


def reconstruct_graph(inputs, outputs, tag: str = ""):
    """Fresh clones of an inner graph (reference ``reconstruct_graph``)."""
    new_inputs = [safe_new(i, tag) for i in inputs]
    new_outputs = clone_replace(outputs, replace=dict(zip(inputs, new_inputs)))
    return new_inputs, new_outputs


def scan_can_remove_outs(op, out_idxs):
    """Which of ``out_idxs`` are removable (not feeding other outputs)
    (reference ``scan_can_remove_outs``)."""
    from aesara_tpu_torch.graph.ir import ancestors

    info = op.info
    keep = [i for i in range(len(op.fgraph.outputs)) if i not in out_idxs]
    needed = set()
    for i in keep:
        needed.update(ancestors([op.fgraph.outputs[i]]))
    removable, not_removable = [], []
    for i in out_idxs:
        if op.fgraph.outputs[i] in needed:
            not_removable.append(i)
        else:
            removable.append(i)
    return removable, not_removable


def compress_outs(op, not_required, inputs):
    """Build a Scan without the ``not_required`` outputs (reference
    ``compress_outs``) — scan_save_mem's workhorse there; our save-mem
    rewrite uses final_only flags instead, so this reconstructs via the
    public ScanInfo."""
    raise NotImplementedError(
        "compress_outs: use the final_only mechanism (scan_save_mem) on "
        "this backend; see scan/rewriting.py"
    )


def safe_index(lst, x):
    try:
        return list(lst).index(x)
    except ValueError:
        return None


def forced_replace(out, x, y):
    """clone_replace wrapper matching the reference name."""
    if out is None:
        return None
    return clone_replace([out], replace={x: y})[0]


class FieldInfo:
    """(name, agg_name, index, inner_index) record (reference dataclass)."""

    __slots__ = ("name", "agg_name", "index", "inner_index")

    def __init__(self, name, agg_name, index, inner_index):
        self.name = name
        self.agg_name = agg_name
        self.index = index
        self.inner_index = inner_index


def default_filter_scanargs(x):
    return x.startswith("inner_") or x.startswith("outer_")


class ScanArgs:
    """Decompose a Scan node into named argument groups (reference
    ``ScanArgs`` — the API PyMC-era libraries use).  Maps our layout
    (n_steps, seqs, mit-sot inits, sit-sot inits, shared, non-seqs) to
    the reference's outer_*/inner_* naming."""

    def __init__(self, outer_inputs, outer_outputs, _inner_inputs,
                 _inner_outputs, info):
        self.n_steps = outer_inputs[0]
        p = 1
        self.outer_in_seqs = list(outer_inputs[p: p + info.n_seqs])
        p += info.n_seqs
        self.outer_in_mit_sot = list(outer_inputs[p: p + info.n_mit_sot])
        p += info.n_mit_sot
        self.outer_in_sit_sot = list(outer_inputs[p: p + info.n_sit_sot])
        p += info.n_sit_sot
        self.outer_in_shared = list(outer_inputs[p: p + info.n_shared])
        p += info.n_shared
        self.outer_in_non_seqs = list(outer_inputs[p:])
        self.outer_in_mit_mot = []  # unified into mit_sot here

        q = 0
        self.inner_in_seqs = list(_inner_inputs[q: q + info.n_seqs])
        q += info.n_seqs
        n_taps = sum(len(t) for t in info.mit_sot_taps)
        self.inner_in_mit_sot = list(_inner_inputs[q: q + n_taps])
        q += n_taps
        self.inner_in_sit_sot = list(_inner_inputs[q: q + info.n_sit_sot])
        q += info.n_sit_sot
        self.inner_in_shared = list(_inner_inputs[q: q + info.n_shared])
        q += info.n_shared
        self.inner_in_non_seqs = list(_inner_inputs[q:])
        self.inner_in_mit_mot = []

        r = 0
        self.inner_out_mit_sot = list(_inner_outputs[r: r + info.n_mit_sot])
        r += info.n_mit_sot
        self.inner_out_sit_sot = list(_inner_outputs[r: r + info.n_sit_sot])
        r += info.n_sit_sot
        self.inner_out_nit_sot = list(_inner_outputs[r: r + info.n_nit_sot])
        r += info.n_nit_sot
        self.inner_out_shared = list(_inner_outputs[r: r + info.n_shared])
        self.inner_out_mit_mot = []

        s = 0
        self.outer_out_mit_sot = list(outer_outputs[s: s + info.n_mit_sot])
        s += info.n_mit_sot
        self.outer_out_sit_sot = list(outer_outputs[s: s + info.n_sit_sot])
        s += info.n_sit_sot
        self.outer_out_nit_sot = list(outer_outputs[s: s + info.n_nit_sot])
        s += info.n_nit_sot
        self.outer_out_shared = list(outer_outputs[s: s + info.n_shared])
        self.outer_out_mit_mot = []
        self.info = info

    @classmethod
    def from_node(cls, node) -> "ScanArgs":
        from aesara_tpu_torch.scan.op import Scan

        if not isinstance(node.op, Scan):
            raise TypeError("from_node needs a Scan node")
        return cls(node.inputs, node.outputs, node.op.fgraph.inputs,
                   node.op.fgraph.outputs, node.op.info)

    @property
    def inner_inputs(self):
        return (self.inner_in_seqs + self.inner_in_mit_sot
                + self.inner_in_sit_sot + self.inner_in_shared
                + self.inner_in_non_seqs)

    @property
    def inner_outputs(self):
        return (self.inner_out_mit_sot + self.inner_out_sit_sot
                + self.inner_out_nit_sot + self.inner_out_shared)

    @property
    def outer_inputs(self):
        return ([self.n_steps] + self.outer_in_seqs + self.outer_in_mit_sot
                + self.outer_in_sit_sot + self.outer_in_shared
                + self.outer_in_non_seqs)

    @property
    def outer_outputs(self):
        return (self.outer_out_mit_sot + self.outer_out_sit_sot
                + self.outer_out_nit_sot + self.outer_out_shared)

    def __str__(self):
        return (f"ScanArgs(n_seqs={len(self.outer_in_seqs)}, "
                f"n_mit_sot={len(self.outer_in_mit_sot)}, "
                f"n_sit_sot={len(self.outer_in_sit_sot)}, "
                f"n_nit_sot={len(self.outer_out_nit_sot)}, "
                f"n_shared={len(self.outer_in_shared)}, "
                f"n_non_seqs={len(self.outer_in_non_seqs)})")


class Validator:
    """Track valid/invalid variable sets during scan rewrites
    (reference ``scan/utils.py Validator``)."""

    def __init__(self, valid=None, invalid=None, valid_equivalent=None):
        self.valid = set(valid or [])
        self.invalid = set(invalid or [])
        self.valid_equivalent = dict(valid_equivalent or {})

    def check(self, out):
        if out in self.valid:
            return out, True
        if out in self.valid_equivalent:
            return self.valid_equivalent[out], False
        if out in self.invalid:
            return None
        if out.owner is None:
            self.valid.add(out)
            return out, True
        for i in out.owner.inputs:
            if self.check(i) is None:
                self.invalid.add(out)
                return None
        self.valid.add(out)
        return out, True


class ScanProfileStats:
    """Per-scan profiling record (reference name)."""

    def __init__(self, name=None):
        self.name = name
        self.callcount = 0
        self.nbsteps = 0
        self.call_time = 0.0


def isNaN_or_Inf_or_None(x):
    """(reference ``scan/basic.py`` helper)"""
    if x is None:
        return True
    try:
        isnan = np.isnan(np.asarray(x)).any()
        isinf = np.isinf(np.asarray(x)).any()
        return bool(isnan or isinf)
    except Exception:
        return False


def get_updates_and_outputs(ls):
    """Split a scan inner-fn return value into (outputs, updates,
    condition) (reference ``scan/basic.py get_updates_and_outputs``)."""
    from collections import OrderedDict

    from aesara_tpu_torch.scan.basic import until

    updates = OrderedDict()
    condition = None
    raw = ls
    if (isinstance(raw, tuple) and len(raw) == 3
            and isinstance(raw[1], (dict, OrderedDict, list))
            and isinstance(raw[2], until)):
        # (outputs, updates, until) — the reference's full return form
        raw, upd, cond_wrap = raw
        updates = OrderedDict(upd)
        condition = cond_wrap.condition
    elif (isinstance(raw, tuple) and len(raw) == 2
            and isinstance(raw[1], (dict, OrderedDict, list))):
        raw, upd = raw
        updates = OrderedDict(upd)
    elif isinstance(raw, (dict, OrderedDict)):
        return [], OrderedDict(raw), None
    if isinstance(raw, until):
        return [], updates, raw.condition
    if isinstance(raw, tuple) and raw and isinstance(raw[-1], until):
        if condition is not None:
            raise ValueError("scan fn returned two until() conditions")
        condition = raw[-1].condition
        raw = list(raw[:-1])
        # reference form: ([out1, out2], until(...)) — the output group
        # may itself be a list/tuple
        if len(raw) == 1 and isinstance(raw[0], (list, tuple)):
            raw = list(raw[0])
    outputs = [raw] if isinstance(raw, Variable) else list(raw)
    return outputs, updates, condition


from aesara_tpu_torch.scan.basic import until  # noqa: E402,F401  (reference re-export)
