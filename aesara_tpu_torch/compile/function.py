"""``function(inputs, outputs, ...)``: graph → FunctionGraph → optdb
rewrites → linker (reference ``aesara_tpu/compile/function.py``:
``function`` :55, ``rebuild_collect_shared`` :219, ``pfunc`` :322).

``inputs`` are variables or ``In`` specs (a name to call by keyword, a
default value, an ``update`` that becomes the next call's default).
``givens`` substitutes variables in the graph before it is compiled (a
dict at once, a list of pairs in order).  ``updates`` pairs shared
variables with expressions of their new values; a shared variable's
``default_update`` joins them unless ``no_default_updates`` says not.
The update expressions are outputs of the one compiled graph, so they
read every shared value as it was before the call; the linker writes
the new values into the shared variables' storage only after the whole
graph has run (inside the captured step on the card), as the JAX
package donates the old buffers to XLA
(``aesara_tpu/link/jax/linker.py:304-343``).  ``steps_per_call=k``
compiles the step as a k-step Scan (``_function_ksteps``).  Under
``config.shape_buckets`` a call pads its dynamic-length inputs up to a
rung of the bucket ladder and slices the results back
(``compile/bucketing.py``), so each rung is one key of the function.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np

from aesara_tpu_torch.compile.io import In, Out
from aesara_tpu_torch.compile.mode import get_mode
from aesara_tpu_torch.compile.sharedvalue import SharedVariable
from aesara_tpu_torch.config import config
from aesara_tpu_torch.graph.fg import FunctionGraph
from aesara_tpu_torch.graph.ir import Constant, Variable, ancestors, clone_replace, graph_inputs
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["function", "Function", "rebuild_collect_shared", "UnusedInputError"]


class UnusedInputError(Exception):
    """An input of ``function()`` that no output or update reads."""


_UNSET = object()


class Function:
    """A compiled graph: call it with one value per input, by position or
    by an ``In`` name; it returns a list of torch tensors on the linker's
    device (one tensor when ``outputs`` was a single variable, None when
    there were none), having written each updated shared variable's new
    value into its storage, and binds each ``In(update=)`` input to its
    next default.  ``captured`` says whether the last call replayed a
    captured CUDA graph, ``capture_blocker`` why no call does (None when
    calls do, from the second with the same argument shapes)."""

    def __init__(self, fn, fgraph, in_specs: Sequence[In], single_output: bool, borrow: Sequence[bool],
                 update_targets: Sequence[SharedVariable], input_updates: Sequence[int], name=None):
        self.fn = fn
        self.fgraph = fgraph
        self.maker = self  # ``f.maker.fgraph``, as in the JAX package
        self.in_specs = list(in_specs)
        self.n_inputs = len(in_specs)
        self.single_output = single_output
        self.borrow = list(borrow)
        self.update_targets = list(update_targets)
        #: positions of the inputs whose ``In(update=)`` value comes last
        self.input_updates = list(input_updates)
        self.name = name
        self.shared_inputs = fgraph.inputs[self.n_inputs:]
        self._name_to_pos = {s.name: i for i, s in enumerate(self.in_specs) if s.name}
        self._in_state: dict = {}
        # bucketing (compile/bucketing.py): the inputs marked
        # In(batched=True), else every one whose leading dim is dynamic
        # (In(batched=False) keeps one out); In(seq_bucketed=axis) names
        # a sequence axis, zero-padded
        explicit = [i for i, s in enumerate(self.in_specs) if s.batched is True]
        self._bucket_positions = explicit or [
            i for i, s in enumerate(self.in_specs)
            if s.batched is not False and s.seq_bucketed is None
            and getattr(s.variable.type, "ndim", 0) >= 1 and s.variable.type.shape[0] is None]
        self._bucket_seq_positions = [(i, int(s.seq_bucketed)) for i, s in enumerate(self.in_specs)
                                      if s.seq_bucketed is not None]
        self._bucket_safety = None      # (verdict,) once the analysis has run
        self._bucket_safety_warned = False
        self._seq_out_axes = None

    def _arguments(self, args, kwargs) -> list:
        """One value per input: the positional and keyword ones, then the
        carried ``In(update=)`` state or the spec's default."""
        import torch

        if len(args) > self.n_inputs:
            raise TypeError(f"expected {self.n_inputs} arguments, got {len(args)}")
        values = list(args) + [_UNSET] * (self.n_inputs - len(args))
        for key, value in kwargs.items():
            if key not in self._name_to_pos:
                raise TypeError(f"unknown input name {key!r}")
            pos = self._name_to_pos[key]
            if values[pos] is not _UNSET:
                raise TypeError(f"input {key!r} given twice")
            values[pos] = value
        for i, (spec, value) in enumerate(zip(self.in_specs, values)):
            if value is _UNSET:
                if i in self._in_state:
                    value = self._in_state[i]
                elif spec.value is not None and not isinstance(spec.value, Variable):
                    value = spec.value
                else:
                    raise TypeError(f"missing input {spec.variable}")
            if not isinstance(value, torch.Tensor) and isinstance(spec.variable.type, TensorType):
                value = spec.variable.type.filter(value, strict=spec.strict,
                                                  allow_downcast=spec.allow_downcast)
            values[i] = value
        return values

    # -- bucketing ------------------------------------------------------------

    def _lengths(self, values, positions):
        """The one length the inputs at ``positions`` (input, axis) share,
        or None when one is not a host array or they disagree."""
        lengths = set()
        for pos, axis in positions:
            v = values[pos]
            if not isinstance(v, np.ndarray) or v.ndim <= axis:
                return None
            lengths.add(int(v.shape[axis]))
        return lengths.pop() if len(lengths) == 1 else None

    def _pad_to_bucket(self, values, policy):
        """Pad the batched inputs' leading dim up to the policy's bucket
        by replicating the last row: (true length, bucket), or (None,
        None) where nothing was padded."""
        from aesara_tpu_torch.compile.bucketing import bucket_for, pad_leading

        n = self._lengths(values, [(p, 0) for p in self._bucket_positions])
        if n is None:
            return None, None
        b = bucket_for(n, policy)
        if b == n or n == 0 or not self._check_bucket_safety():
            return None, None
        for pos in self._bucket_positions:
            values[pos] = pad_leading(values[pos], b)
        return n, b

    def _check_bucket_safety(self) -> bool:
        """The batch-axis safety analysis, run once: raise, warn and run
        unpadded, or trust, as ``config.shape_buckets_check`` says."""
        from aesara_tpu_torch.compile.bucketing import BucketingError, batch_axis_safety

        if self._bucket_safety is None:
            n_out = len(self.borrow)
            updates = range(n_out, n_out + len(self.update_targets))
            self._bucket_safety = (batch_axis_safety(
                self.fgraph, [self.fgraph.inputs[p] for p in self._bucket_positions], updates),)
        (reason,) = self._bucket_safety
        if reason is None:
            return True
        policy = config.shape_buckets_check
        if policy == "raise":
            raise BucketingError(reason)
        if policy == "warn":
            if not self._bucket_safety_warned:
                warnings.warn(reason + " — running unbucketed")
                self._bucket_safety_warned = True
            return False
        return True     # "off": the caller asserts safety

    def _pad_seq_to_bucket(self, values, policy):
        """Zero-pad each declared sequence axis up to the policy's bucket:
        (true length, bucket), or (None, None)."""
        from aesara_tpu_torch.compile.bucketing import bucket_for, pad_axis_zero

        n = self._lengths(values, self._bucket_seq_positions)
        if n is None:
            return None, None
        b = bucket_for(n, policy)
        if b == n or n == 0:
            return None, None
        for pos, axis in self._bucket_seq_positions:
            values[pos] = pad_axis_zero(values[pos], axis, b)
        return n, b

    def _seq_output_axes(self) -> list:
        """Each output's sequence axis (or None), tracked through the graph
        by ``axis_taint``: never guessed from run-time sizes, so a batch
        axis that happens to equal the bucket is never cut."""
        if self._seq_out_axes is None:
            from aesara_tpu_torch.compile.bucketing import axis_taint

            taint = axis_taint(self.fgraph, {self.fgraph.inputs[p]: a for p, a in self._bucket_seq_positions})
            self._seq_out_axes = [next(iter(t)) if len(t) == 1 else None
                                  for t in (taint.get(o, frozenset()) for o in self.fgraph.outputs)]
        return self._seq_out_axes

    @staticmethod
    def _cut(value, axis, n, b):
        """``value`` cut to ``n`` along ``axis`` where it came back at ``b``."""
        if axis is None or value is None or value.ndim <= axis or int(value.shape[axis]) != b:
            return value
        return value.narrow(axis, 0, n)

    @property
    def keys_made(self) -> int:
        """Keys of the function made so far: one for each distinct set of
        argument shapes (a bucket rung under ``config.shape_buckets``)."""
        return self.fn.keys_made

    @property
    def captured(self) -> bool:
        return self.fn.captured

    @property
    def capture_blocker(self):
        return self.fn.capture_blocker

    def __call__(self, *args, **kwargs):
        from aesara_tpu_torch.compile.bucketing import parse_buckets

        values = self._arguments(args, kwargs)
        bkt_n = bkt_b = seq_n = seq_b = None
        policy = parse_buckets(config.shape_buckets)
        if policy is not None:
            if self._bucket_positions:
                bkt_n, bkt_b = self._pad_to_bucket(values, policy)
            if self._bucket_seq_positions:
                seq_n, seq_b = self._pad_seq_to_bucket(values, policy)
        results = self.fn(*values)
        n_out = len(self.borrow)
        outs = list(results[:n_out])
        state_vars = self.fgraph.outputs[n_out + len(self.update_targets):]
        for pos, new, var in zip(self.input_updates, results[n_out:], state_vars):
            if bkt_n is not None and var.type.shape[:1] == (None,):
                new = self._cut(new, 0, bkt_n, bkt_b)
            self._in_state[pos] = new
        if bkt_n is not None:
            outs = [self._cut(o, 0, bkt_n, bkt_b) if var.type.shape[:1] == (None,) else o
                    for o, var in zip(outs, self.fgraph.outputs)]
        if seq_n is not None:
            outs = [self._cut(o, ax, seq_n, seq_b) for o, ax in zip(outs, self._seq_output_axes())]
        if self.single_output:
            return outs[0]
        return outs if outs else None


def _check_update_type(target, value):
    """``value`` as a variable of ``target``'s type; the value may know
    less of its static shape than the target (the call checks it)."""
    from aesara_tpu_torch.tensor.basic import as_tensor_variable
    from aesara_tpu_torch.tensor.type import TensorType

    if not isinstance(target.type, TensorType) and isinstance(value, Variable):
        # a PRNG key and the like: the types must agree
        if value.type != target.type:
            raise TypeError(f"update of {target} ({target.type}) has type {value.type}")
        return value
    value = as_tensor_variable(value)
    tt, vt = target.type, value.type
    if (vt.dtype != tt.dtype or vt.ndim != tt.ndim
            or any(a is not None and b is not None and a != b for a, b in zip(tt.shape, vt.shape))):
        raise TypeError(f"update of {target} ({tt}) has type {vt}")
    return value


def _pairs(updates) -> list:
    """``updates`` (a dict or pairs) as a list of pairs, refusing a target
    given twice."""
    if updates is None:
        return []
    pairs = list(updates.items()) if isinstance(updates, dict) else list(updates)
    targets = [t for t, _ in pairs]
    if len({id(t) for t in targets}) != len(targets):
        raise ValueError(f"duplicate update targets: {[t for t in targets if targets.count(t) > 1][:2]}")
    return pairs


def rebuild_collect_shared(outputs, inputs=(), replace=None, updates=None, no_default_updates=False):
    """Apply ``replace`` (the givens) to the outputs and the update
    expressions, collect the shared variables they read and the update
    pairs, default updates included: (output variables, shared variables,
    update pairs, whether ``outputs`` was one variable).  An update target
    must be a shared variable or one of ``inputs``."""
    single = isinstance(outputs, (Variable, Out))
    specs = [] if outputs is None else [outputs] if single else list(outputs)
    out_vars = [o.variable if isinstance(o, Out) else o for o in specs]
    input_ids = {id(v) for v in inputs}
    update_pairs = []
    for target, value in _pairs(updates):
        if not isinstance(target, SharedVariable) and id(target) not in input_ids:
            raise TypeError(f"update target {target} is not a shared variable")
        update_pairs.append((target, _check_update_type(target, value)))

    if replace:
        items = list(replace.items()) if isinstance(replace, dict) else list(replace)
        roots = out_vars + [v for _, v in update_pairs]
        if isinstance(replace, dict):
            roots = clone_replace(roots, replace=dict(items))
        else:
            # list-form givens apply in order: a later pair substitutes
            # into an earlier pair's replacement
            for old, new in items:
                roots = clone_replace(roots, replace={old: new})
        out_vars = roots[:len(out_vars)]
        update_pairs = [(t, e) for (t, _), e in zip(update_pairs, roots[len(out_vars):])]

    shared, seen = [], set()

    def collect(roots):
        for v in graph_inputs(roots) if roots else []:
            if isinstance(v, SharedVariable) and id(v) not in seen:
                seen.add(id(v))
                shared.append(v)

    collect(out_vars + [v for _, v in update_pairs])
    # no_default_updates: True drops all, a list drops those in it
    explicit = {id(t) for t, _ in update_pairs}
    changed = no_default_updates is not True
    while changed:
        changed = False
        for sv in list(shared):
            du = sv.default_update
            if du is None or id(sv) in explicit:
                continue
            if isinstance(no_default_updates, list) and sv in no_default_updates:
                continue
            update_pairs.append((sv, _check_update_type(sv, du)))
            explicit.add(id(sv))
            n = len(shared)
            collect([update_pairs[-1][1]])
            changed = changed or len(shared) != n
    return out_vars, shared, update_pairs, single


def function(inputs: Sequence, outputs=None, mode=None, updates=None, givens=None,
             no_default_updates=False, name=None, allow_input_downcast=None, on_unused_input=None,
             steps_per_call: int = 1) -> Function:
    """Compile ``outputs`` (a variable, an ``Out``, a list of them, or
    None) as a function of ``inputs`` (variables or ``In`` specs),
    applying ``updates`` (pairs or a dict of shared variable → new value)
    after each call.  ``givens`` replaces variables before compiling;
    ``allow_input_downcast`` is the default of the inputs' own;
    ``on_unused_input`` ("raise", "warn" or "ignore"; default
    ``config.on_unused_input``) says what an input nothing reads does."""
    if isinstance(inputs, (Variable, In)):
        raise TypeError("inputs must be a list/tuple")
    if steps_per_call != 1:
        return _function_ksteps(inputs, outputs, mode, updates, givens, no_default_updates, name,
                                allow_input_downcast, on_unused_input, int(steps_per_call))
    specs = []
    for p in inputs:
        if isinstance(p, In):
            specs.append(p)
        elif isinstance(p, SharedVariable):
            raise TypeError("shared variables do not belong in `inputs`: they are implicit; "
                            "pass updates={shared: expr} instead")
        elif isinstance(p, Constant):
            raise TypeError("constants cannot be function inputs")
        elif isinstance(p, Variable):
            specs.append(In(p, allow_downcast=allow_input_downcast))
        else:
            raise TypeError(f"invalid function input {p!r}")
    in_vars = [s.variable for s in specs]

    pairs = _pairs(updates)
    for s in specs:
        if s.update is not None:
            if any(t is s.variable for t, _ in pairs):
                raise ValueError(f"input {s.variable} has both In(update=...) and an entry in `updates`")
            pairs.append((s.variable, s.update))
    out_vars, _, update_pairs, single = rebuild_collect_shared(
        outputs, inputs=in_vars, replace=givens, updates=pairs, no_default_updates=no_default_updates)
    shared_updates = [(t, v) for t, v in update_pairs if isinstance(t, SharedVariable)]
    input_updates = [(t, v) for t, v in update_pairs if not isinstance(t, SharedVariable)]

    out_specs = [] if outputs is None else [outputs] if single else list(outputs)
    borrow = [o.borrow if isinstance(o, Out) else False for o in out_specs]
    all_outs = out_vars + [v for _, v in shared_updates] + [v for _, v in input_updates]
    sources = graph_inputs(all_outs)
    shared = [v for v in sources if isinstance(v, SharedVariable) and v not in in_vars]
    missing = [v for v in sources
               if v.owner is None and not isinstance(v, (Constant, SharedVariable)) and v not in in_vars]
    if missing:
        raise TypeError(f"graph depends on inputs not given to function(): {missing}")
    policy = on_unused_input or config.on_unused_input
    if policy != "ignore" and all_outs:
        used = set(ancestors(all_outs))
        for var in in_vars:
            if var not in used:
                msg = (f"function input {var} is unused; pass on_unused_input='ignore' or 'warn' "
                       "to silence")
                if policy == "raise":
                    raise UnusedInputError(msg)
                warnings.warn(msg)

    mode = get_mode(mode)
    fgraph = FunctionGraph(in_vars + shared, all_outs, clone=True)
    mode.optimizer.rewrite(fgraph)
    fn = mode.linker.make_function(fgraph, n_user_inputs=len(in_vars), n_outputs=len(out_vars),
                                   update_targets=[t for t, _ in shared_updates], borrow=borrow)
    positions = [next(i for i, v in enumerate(in_vars) if v is t) for t, _ in input_updates]
    return Function(fn, fgraph, specs, single, borrow, [t for t, _ in shared_updates], positions, name=name)


def _function_ksteps(params, outputs, mode, updates, givens, no_default_updates, name, allow_input_downcast,
                     on_unused_input, k: int) -> Function:
    """``function(..., steps_per_call=k)`` (``aesara_tpu/compile/function.py:
    113-210``): the step wrapped in a k-step Scan.  Every update target
    becomes a sit-sot carry, so step t+1 reads step t's state, as k
    separate calls would; the inputs are loop-invariant (each step sees
    the same values); each output is stacked on a new leading (k,) axis.
    On the card the k steps are one captured graph."""
    from aesara_tpu_torch.scan.basic import scan

    if k < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {k}")
    in_specs = []
    for p in params:
        if isinstance(p, In):
            if p.update is not None:
                raise NotImplementedError("steps_per_call>1 does not support In(update=...) inputs; "
                                          "use a shared variable for the looped state")
            in_specs.append(p)
        elif isinstance(p, SharedVariable):
            raise TypeError("shared variables do not belong in `inputs`: they are implicit; "
                            "pass updates={shared: expr} instead")
        elif isinstance(p, Variable):
            in_specs.append(In(p, allow_downcast=allow_input_downcast))
        else:
            raise TypeError(f"invalid function input {p!r}")
    out_vars, _, update_pairs, single = rebuild_collect_shared(
        outputs, inputs=[s.variable for s in in_specs], replace=givens, updates=updates,
        no_default_updates=no_default_updates)
    targets, exprs = [], []
    for target, expr in update_pairs:
        if not isinstance(target, SharedVariable) or not isinstance(target.type, TensorType):
            raise NotImplementedError("steps_per_call>1 requires every update target to be a shared tensor")
        targets.append(target)
        exprs.append(expr)

    def body(*carries):
        new = clone_replace(exprs + out_vars, replace=dict(zip(targets, carries)))
        return new if len(new) > 1 else new[0]

    outputs_info = list(targets) + [None] * len(out_vars)
    if not outputs_info:
        raise ValueError("steps_per_call>1 needs at least one output or update")
    res, _ = scan(body, outputs_info=outputs_info, n_steps=k, return_list=True)
    # the state after k steps is the last carried value (scan_save_mem
    # makes the [-1] reads final-only carries: no (k, ...) state stacks)
    new_updates = [(t, res[i][-1]) for i, t in enumerate(targets)]
    stacked = res[len(targets):]
    new_outputs = None
    if outputs is not None:
        raw = [outputs] if isinstance(outputs, (Variable, Out)) else list(outputs)
        new_outputs = [Out(v, borrow=o.borrow) if isinstance(o, Out) else v for o, v in zip(raw, stacked)]
        if single:
            new_outputs = new_outputs[0]
    fn = function(in_specs, new_outputs, mode=mode, updates=new_updates, no_default_updates=True, name=name,
                  allow_input_downcast=allow_input_downcast, on_unused_input=on_unused_input)
    fn.steps_per_call = k
    return fn
