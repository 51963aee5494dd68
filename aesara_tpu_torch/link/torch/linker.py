"""``TorchLinker``: runs a rewritten FunctionGraph on one torch device,
on the card as one captured CUDA graph per call (the counterpart of
``JAXLinker``, ``aesara_tpu/link/jax/linker.py``: one jitted program with
donation, a memo and ``allow_gc``).

**The program.**  Every Apply becomes the plain function ``torch_funcify``
gives for it (:class:`Program`); they run in topological order under
``torch.no_grad()``.  As the JAX linker folds every node whose inputs are
all concrete, this one runs ``perform`` for every node whose inputs are
all host values (constants, ``Shape_i`` results and what is computed
from them), decided when the function is compiled: shape arithmetic stays
on the host and never makes the device wait.  A host value that meets a
device node is copied to the device, except at the positions a lowering
keeps on the host (``host_inputs``, e.g. the target shape of
``Reshape``).  With ``config.allow_gc`` (default True) each
intermediate is dropped after its last reader, so its memory returns to
the allocator within the call.  Programs are memoized process-wide by
(graph key, device, ``allow_gc``, donation map) (``link/cache.py``), as
long as a function holds them: a second function of an identical graph
reuses the lowering and its generated kernels.

**Updates in place** (the counterpart of donation).  An updated shared
variable keeps its storage.  Where the destroy handler finds it legal
(``DestroyHandler.donations``: every other reader of the old value, and
of any view of it, can run before the node; no output returns it) the
node that computes the update writes it there itself: the ``out`` of the
final K1 launch, or of a lone fp32 or fp64 add, sub, mul or true_div (an sgd
step's ``w - lr * g`` once BlasOpt has taken the product), the ``addmm_``
of a ``Gemm`` whose z is the variable, the in-place ``IncSubtensor``; the
program's order puts those readers first.  A call whose shared variables
hold one storage between them, or a node whose inputs or pending values
alias the storage at run time, takes the copying route: the new value is
computed into a fresh tensor and written into the storage after the
whole graph has run, in both eager and captured mode.  Before any write, an output that reads a
target's storage is cloned, and so is an update value that reads another
target's (``updates={a: b, b: a}`` swaps); a returned output aliases no
input or update unless ``Out(borrow=True)``.  ``TorchLinker(
donate_updated=False)`` (or ``config.donate_shared``) takes the copying
route for every update.

**Keys and capture** (the counterpart of ``jax.jit``).  Calls are keyed
by the shape and dtype of each user argument and the identity of each
sparse value; a key keeps its uploads (the folded host values, which
under a key depend on shapes and constants only, and the CSR form of
each sparse value, with its K6/K7 plan).  A function keeps at most
``MAX_KEYS`` keys, the least recently used going first: on the card each
captured graph holds its own memory pool (3.0 GiB reserved for the
flagship sgd step on the H100, ``PERF.md`` §5), so a function called at
many shapes must not keep one per shape.  Two covers the traffic the
port serves: a training loop's full batch and its last, shorter one, and
path (c)'s two rhs widths in ``chip_smoke.py``; a ``predict`` that gets a
new CSR matrix every request is a new key every call and runs eagerly.
On CUDA, with ``use_graph`` (default ``config.cuda_graph``, True), the
first call with a key runs eagerly; it also warms up Triton's JIT, the
first-use builds of the ``ctypes`` kernels and cuBLAS.  The second call
captures the step into a ``torch.cuda.CUDAGraph`` (on PyTorch's capture
stream): the lowerings, the clones before the writes, then the in-place
writes.  Later calls copy the user arguments into the captured input
buffers (a one-element host value, such as a minibatch index, by a fill
kernel that takes it as an argument: a copy from pageable memory would
make the host wait for the work already queued), check that every
shared variable still holds the captured storage (``set_value`` writes
in place, so it does), replay, and return
fresh copies of the outputs (the captured buffers themselves for
``Out(borrow=True)``: the next replay overwrites them).

**Launch counts.**  A kernel wrapper counts each launch it makes
(``.launches``), a launch into a capturing stream too: that launch is
recorded into the graph.  A replay calls no wrapper; the linker adds the
launches its capture recorded to each wrapper's ``.replayed`` tally, a
record apart from the launches, which ``chip_smoke.py`` holds against
the profiler's trace of the replays.

A graph that cannot be captured runs eagerly and says so
(``TorchFunction.capture_blocker``): decided when the function is
compiled, from lowerings that flag themselves (``capturable = False``:
``ARange`` with bounds on the device, whose ``.item()`` waits on the
device, and a while-Scan, which reads its condition each step) or that
read an input on the host where it is not a host value (``syncs``: a
Scan's trip count computed on the device).  A lowering whose inputs at
some positions must be host values (``needs_host``: a slice bound, a
Join axis, Split sizes) makes the compile raise where they are not.  A
capture that fails raises; nothing carries on eagerly or on the CPU in
its place.

Sparse values (``linker.py:296-402,414-469``): a sparse argument or shared
variable, a SciPy matrix on the host, crosses to the device as a
:class:`~aesara_tpu_torch.link.torch.csr.CSRMat`, with the CSR of its
transpose when the graph transposes it (``sparse_dispatch.csr_plan``),
built once per key.  A sparse output goes back to SciPy after
the graph has run (after the replay), with exactly the device value's
pattern.

**Refusals.**  A compile for CUDA raises, before any launch, where a
process-wide torch setting would change what the graph computes: TF32
matmuls (``Dot`` is a full-fp32 product), reduced-precision sums of
bfloat16 or float16 products, and for a graph that holds convolutions
(cuDNN's) TF32 convolutions (``cudnn_tf32_flag``) or
``torch.backends.cudnn.benchmark``, which autotunes inside a capture.
The settings are the caller's to change.  A key whose first call raises
(a ``CheckAndRaise``) is not kept.

There is no fallback: an op with no lowering raises when the function is
compiled.  Dtypes are kept exactly; the card has fp64 and int64, so there
is no 64→32 canonicalisation.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np

from aesara_tpu_torch.graph.ir import Constant, io_toposort
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.link.basic import resolve_device


__all__ = ["MAX_KEYS", "Program", "TorchFunction", "TorchLinker", "cudnn_refusal"]

#: keys a function keeps (each captured one with its graph's memory pool)
MAX_KEYS = 2


def _is_host(value) -> bool:
    return isinstance(value, (np.ndarray, np.generic))


def _storage(value) -> int:
    """The address of a tensor's storage (0 for anything else)."""
    import torch

    return value.untyped_storage().data_ptr() if isinstance(value, torch.Tensor) else 0


def _index_storage(index: dict, variables, values) -> None:
    """Add the variable of each tensor of ``values`` to ``index``, {storage
    address: [variables]}.  It holds no tensor, so a freed value's memory
    returns to the allocator; an entry whose variable has left the run's
    values is stale."""
    import torch

    for var, value in zip(variables, values):
        if isinstance(value, torch.Tensor):
            index.setdefault(value.untyped_storage().data_ptr(), []).append(var)


def _capture_blocker(fn, node, host):
    """Why the lowering ``fn`` of ``node`` keeps a graph from being
    captured, or None: it says so itself (``capturable = False``, with
    ``blocker`` its reason), or it reads on the host an input that is not
    a host value (``syncs``, the positions of such inputs, with
    ``sync_blocker`` its reason)."""
    if not getattr(fn, "capturable", True):
        return getattr(fn, "blocker", "with inputs on the device")
    synced = [k for k in getattr(fn, "syncs", ()) if node.inputs[k] not in host]
    if synced:
        return getattr(fn, "sync_blocker", None) or f"reads {', '.join(str(node.inputs[k]) for k in synced)} on the host"
    return None


def inner_blocker(program):
    """Why an inner ``Program`` (a Scan's body, an OpFromGraph's subgraph)
    keeps the node that runs it from being captured, or None: its first
    blocking node reads the device on the host, or has a result whose
    length is the data's, in every step the node runs."""
    node = program.blocker
    if node is None:
        return None
    return f"runs {node.op} ({type(node.op).__name__}) in its inner graph, which {program.blocker_reason}"


def graph_nodes(fgraph):
    """The Apply nodes of ``fgraph`` and of the inner graphs of its Scan
    and OpFromGraph nodes."""
    todo = [fgraph]
    while todo:
        for node in todo.pop().apply_nodes:
            yield node
            inner = getattr(node.op, "fgraph", None)
            if inner is not None:
                todo.append(inner)


def product_dtypes(fgraph) -> set:
    """The output dtypes of the matrix products (``Dot``, ``BatchedDot``
    and the BLAS ops) in ``fgraph`` and in its inner graphs."""
    from aesara_tpu_torch.tensor.blas import Dot22, Dot22Scalar, Gemm, Gemv, Ger
    from aesara_tpu_torch.tensor.math import BatchedDot, Dot

    products = (Dot, BatchedDot, Dot22, Dot22Scalar, Gemm, Gemv, Ger)
    return {node.outputs[0].type.dtype for node in graph_nodes(fgraph) if isinstance(node.op, products)}


def cudnn_tf32_flag():
    """The setting by which cuDNN may compute an fp32 convolution in TF32,
    as text, or None.  Where the installed torch has the per-operator
    ``fp32_precision`` settings, the convolutions' one decides, or where
    it is "none" its parent's (cuDNN's, then torch's); else
    ``torch.backends.cudnn.allow_tf32``."""
    import torch

    cudnn = torch.backends.cudnn
    conv = getattr(cudnn, "conv", None)
    if conv is None or not hasattr(conv, "fp32_precision"):
        return "torch.backends.cudnn.allow_tf32 is True" if cudnn.allow_tf32 else None
    for name, owner in (("torch.backends.cudnn.conv", conv), ("torch.backends.cudnn", cudnn),
                        ("torch.backends", torch.backends)):
        value = owner.fp32_precision
        if value != "none":
            return f'{name}.fp32_precision is "{value}"' if value == "tf32" else None
    return None


def cudnn_refusal(fgraph):
    """Why a CUDA compile of ``fgraph``, which holds convolutions that
    cuDNN computes, must be refused, or None: an fp32 or fp64 one while
    cuDNN may use TF32, or any while ``torch.backends.cudnn.benchmark``
    autotunes (it would inside a capture).  The settings are the caller's
    to change, not the linker's."""
    import torch

    from aesara_tpu_torch.link.torch.nnet_dispatch import CONV_OPS

    dtypes = {node.outputs[0].type.dtype for node in graph_nodes(fgraph) if isinstance(node.op, CONV_OPS)}
    if not dtypes:
        return None
    if torch.backends.cudnn.benchmark:
        return ("torch.backends.cudnn.benchmark is True: cuDNN would autotune the convolutions' algorithms, "
                "inside a captured step too; set it to False before compiling")
    flag = cudnn_tf32_flag()
    if flag is not None and dtypes & {"float32", "float64"}:
        return (f"{flag}: a convolution would round its fp32 inputs to TF32; set "
                "torch.backends.cudnn.allow_tf32 to False before compiling")
    return None


class Program:
    """The lowering of one FunctionGraph for one device: ``run`` maps the
    value of every graph input (a tensor or CSRMat on the device) to the
    value of every output (a tensor, a CSRMat, or a host array where the
    output folds on the host).  It reads no shared variable itself, so
    functions of identical graphs share it.  The nodes in ``in_place``
    write into their first input (``dispatch.in_place_lowering``): the
    caller owns that input's value and nothing else reads it.  ``donate``
    pairs (output index, input index) of the updates whose node may write
    the new value into the input's storage; ``donated`` maps each node the
    destroy handler allows to the input it writes, and ``run(donate=True)``
    has them do so (its lowering called with ``out``, that input's value)."""

    def __init__(self, fgraph, device, allow_gc: bool, in_place=frozenset(), donate=()):
        from aesara_tpu_torch.link.torch.dispatch import in_place_lowering, torch_funcify
        from aesara_tpu_torch.link.torch.sparse_dispatch import csr_plan

        self.device = device
        self.inputs = list(fgraph.inputs)
        self.outputs = list(fgraph.outputs)
        self.output_set = set(self.outputs)
        self.csr_plan = csr_plan(fgraph)
        self.donated, orderings = donation_plan(fgraph, donate)
        self.order = io_toposort(fgraph.inputs, fgraph.outputs, orderings=orderings or None)
        self.fns = [in_place_lowering(node) if node in in_place else torch_funcify(node.op, node=node)
                    for node in self.order]
        self.keep_host = [frozenset(getattr(fn, "host_inputs", ())) for fn in self.fns]
        self.takes_device = [getattr(fn, "takes_device", False) for fn in self.fns]
        # which nodes fold on the host: all their inputs are host values
        host = {v for node in self.order for v in node.inputs if isinstance(v, Constant)}
        self.folds = []
        #: the first node that keeps the program from being captured and
        #: why, or None
        self.blocker = self.blocker_reason = None
        for node, fn in zip(self.order, self.fns):
            fold = (node.op.do_constant_folding(fgraph, node) and type(node.op).perform is not Op.perform
                    and all(i in host for i in node.inputs))
            self.folds.append(fold)
            if fold or getattr(fn, "host_outputs", False):
                host.update(node.outputs)
            if fold:
                continue
            positions, why = getattr(fn, "needs_host", ((), ""))
            if any(node.inputs[k] not in host for k in positions):
                raise NotImplementedError(f"{node.op} {why}")
            reason = _capture_blocker(fn, node, host)
            if reason is not None and self.blocker is None:
                self.blocker, self.blocker_reason = node, reason
        #: the input positions each node's op destroys (``destroy_map``)
        self.destroys = [() if fold else sorted({i for idxs in node.op.destroy_map.values() for i in idxs})
                         for node, fold in zip(self.order, self.folds)]
        self.any_destroys = any(self.destroys)
        last = {}
        for k, node in enumerate(self.order):
            for var in node.inputs:
                last[var] = k
        #: each variable's last reader (its index in ``order``)
        self.last_reader = last
        kept = set(self.inputs) | set(self.outputs)
        self.frees = [[] for _ in self.order]
        if allow_gc:
            for var, k in last.items():
                if var not in kept and not isinstance(var, Constant):
                    self.frees[k].append(var)
        self.device_constants: dict = {}
        #: donated writes that met an alias of their storage at run time and
        #: took the copying route
        self.donation_fallbacks = 0

    def host_to_device(self, value, dtype=None):
        """A host value on the device, in ``dtype`` (the variable's; by
        default the value's own): a bfloat16 value's host form is float32
        (``scalar.ops.to_host``)."""
        import torch

        from aesara_tpu_torch.link.torch.kernels.elemwise import torch_dtype

        value = np.asarray(value)
        dtype = torch_dtype(dtype or value.dtype.name)
        if not value.flags.c_contiguous:
            value = value.copy(order="C")   # a folded [::-1] has negative strides, which torch refuses
        if value.size == 1:
            # a fill kernel takes the value as an argument: unlike a copy
            # from pageable memory, it does not make the host wait for the
            # work already queued on the device (and a CUDA graph takes it)
            return torch.full(value.shape, value.item(), dtype=dtype, device=self.device)
        return torch.as_tensor(value, device=self.device).to(dtype)

    def to_device(self, value, var, uploads: dict):
        """A host value of ``var`` on the device: a constant's once per
        program, another's once per key, in ``uploads``."""
        cache = self.device_constants if isinstance(var, Constant) else uploads
        if var not in cache:
            cache[var] = self.host_to_device(value, getattr(var.type, "dtype", None))
        return cache[var]

    def _clear(self, k, ins, target, env, index, skip=None) -> bool:
        """Whether node ``k`` may write into ``target``'s storage now: no
        other value it reads, and no live value (but ``skip``'s) still to
        be read or returned, lies in that storage (the destroy handler's
        decision, checked against the views the lowerings made; ``index``
        holds the run's tensors by storage)."""
        import torch

        if not isinstance(target, torch.Tensor) or not target.is_contiguous():
            return False
        storage = _storage(target)
        for var in index.get(storage, ()):
            value = env.get(var)
            if value is not None and value is not target and var is not skip and (
                    self.last_reader.get(var, -1) > k or var in self.output_set):
                return False
        return not any(a is not target and _storage(a) == storage for a in ins)

    def run(self, inputs: Sequence, uploads: dict, donate: bool = False) -> list:
        import torch

        env = dict(zip(self.inputs, inputs))
        # the run's variables by their tensors' storage, kept where some node
        # writes in place
        index = {} if (donate and self.donated) or self.any_destroys else None
        if index is not None:
            _index_storage(index, self.inputs, inputs)
        with torch.no_grad():
            for k, (node, fn, fold, keep, frees, takes_device, destroys) in enumerate(zip(
                    self.order, self.fns, self.folds, self.keep_host, self.frees, self.takes_device,
                    self.destroys)):
                ins = [env[i] if i in env else i.data for i in node.inputs]
                if fold:
                    storage = [[None] for _ in node.outputs]
                    node.op.perform(node, ins, storage)
                    outs = [np.asarray(s[0]) for s in storage]
                else:
                    ins = [a if (k in keep or not _is_host(a)) else self.to_device(a, i, uploads)
                           for k, (a, i) in enumerate(zip(ins, node.inputs))]
                    for d in destroys:
                        # an in-place op (blas_inplace) whose input turns out
                        # to share a storage still read: it writes into a copy
                        if not self._clear(k, ins, ins[d], env, index, skip=node.inputs[d]):
                            ins[d] = ins[d].clone()
                    write = self.donated.get(node) if donate else None
                    target = env[write[0]] if write is not None else None
                    if target is not None and self._clear(k, ins, target, env, index) and (
                            write[1] or _fits(target, ins)):
                        outs = fn(*ins, out=target)
                    else:
                        if target is not None:
                            self.donation_fallbacks += 1
                        outs = fn(*ins, device=self.device) if takes_device else fn(*ins)
                    if len(node.outputs) == 1:
                        outs = (outs,)
                env.update(zip(node.outputs, outs))
                if index is not None:
                    _index_storage(index, node.outputs, outs)
                for var in frees:
                    del env[var]
        return [env[o] if o in env else o.data for o in self.outputs]


def _fits(target, ins) -> bool:
    """Whether an elementwise node's result over ``ins`` has ``target``'s
    shape (an update may change a variable's shape; it is then copied):
    each operand broadcasts to it, and together they give each of its
    dims (``torch.broadcast_shapes`` would go through its symbolic-shape
    reference on every call)."""
    shape = tuple(target.shape)
    given = [1] * len(shape)
    if max(a.dim() for a in ins) != len(shape):
        return False
    for a in ins:
        for d, n in enumerate(a.shape, len(shape) - a.dim()):
            if n != 1:
                if n != shape[d]:
                    return False
                given[d] = n
    return tuple(given) == shape


def donation_plan(fgraph, donate) -> tuple:
    """({node: (the input it writes, whether that input is its first)},
    the orderings that put every other reader of each written input, and
    of the graph's own destroyed storage, before its writer) for the
    updates ``donate`` (output index, input index) whose node can write
    into the input's storage (``dispatch.can_donate``: a K1 Composite, a
    lone arithmetic op, a BLAS op whose z is the input, an IncSubtensor of
    it) and where the destroy handler finds it legal
    (``DestroyHandler.donations``)."""
    from aesara_tpu_torch.graph.destroyhandler import add_destroy_handler
    from aesara_tpu_torch.link.torch.dispatch import can_donate, donates_into_first_input

    if not donate:
        return {}, fgraph.orderings()
    add_destroy_handler(fgraph)
    candidates = []
    for out_idx, in_idx in sorted(donate):
        value, target = fgraph.outputs[out_idx], fgraph.inputs[in_idx]
        node = value.owner
        if (node is None or not can_donate(node) or getattr(value.type, "dtype", None) != target.type.dtype
                or getattr(value.type, "ndim", None) != getattr(target.type, "ndim", None)):
            continue
        first = donates_into_first_input(node)
        if first and node.inputs[0] is not target:
            continue
        # where the node may read the target itself: a BLAS op's z or an
        # IncSubtensor's x; any operand of K1, which reads each value
        # where it writes it
        same = [0] if first else [i for i, inp in enumerate(node.inputs) if inp is target]
        candidates.append((node, target, same))
    kept, orderings = fgraph.destroy_handler.donations(fgraph, candidates)
    if not kept:
        return {}, fgraph.orderings()
    return {node: (target, donates_into_first_input(node)) for node, target, _ in kept}, orderings


#: process-wide memo of lowered programs, (graph key, device, allow_gc,
#: donation map) -> Program, kept while some function holds its program
_PROGRAMS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def program_for(fgraph, device, allow_gc: bool, donate=()) -> Program:
    from aesara_tpu_torch.link.cache import fgraph_key

    donate = tuple(sorted(donate))
    key = (fgraph_key(fgraph), str(device), allow_gc, donate)
    program = _PROGRAMS.get(key)
    if program is None:
        program = _PROGRAMS[key] = Program(fgraph, device, allow_gc, donate=donate)
    return program


class _Key:
    """What one key of a function keeps: its uploads and CSR forms, and
    once captured its graph, input buffers, results and launches."""

    def __init__(self, sparse_values):
        self.sparse_values = sparse_values   # held, so that their ids stay theirs
        self.calls = 0
        self.uploads: dict = {}
        self.csr: dict = {}
        self.graph = None
        self.donating = False
        self.static_inputs = None
        self.shared = None
        self.results = None
        self.launches = None


class TorchFunction:
    """A compiled graph bound to its shared variables: ``fn(*user_args)``
    returns the user outputs, then the values of the non-shared update
    targets (``In(update=)``), having written the shared updates in place.

    ``update_targets`` are the shared variables the graph's outputs after
    the first ``n_outputs`` update, in order; ``borrow`` says per user
    output whether it may alias the function's own buffers."""

    def __init__(self, program: Program, fgraph, n_user_inputs: int, n_outputs: int,
                 update_targets: Sequence, borrow: Sequence[bool], use_graph: bool):
        self.program = program
        self.device = program.device
        self.user_inputs = fgraph.inputs[:n_user_inputs]
        self.shared_inputs = fgraph.inputs[n_user_inputs:]
        self.n_user_inputs = n_user_inputs
        self.n_outputs = n_outputs
        self.update_targets = list(update_targets)
        #: the update targets that are not inputs of the graph
        self.unread_targets = [t for t in self.update_targets if not any(t is v for v in self.shared_inputs)]
        self.borrow = list(borrow) + [False] * (n_outputs - len(borrow))
        self.output_vars = fgraph.outputs
        if self.device.type != "cuda":
            self.capture_blocker = f"runs on {self.device}"
        elif not use_graph:
            self.capture_blocker = "use_graph is off"
        elif program.blocker is not None:
            node = program.blocker
            self.capture_blocker = f"{node.op} ({type(node.op).__name__}) {program.blocker_reason}"
        else:
            self.capture_blocker = None
        #: whether the last call replayed a captured graph
        self.captured = False
        #: whether the last call let the donated nodes write into the
        #: shared storage (``Program.donated``; off where shared variables
        #: share a storage)
        self.donating = False
        #: keys made so far (the counterpart of the JAX package's
        #: ``xla_compile_count``): a key dropped and made again counts twice
        self.keys_made = 0
        self._keys: "OrderedDict" = OrderedDict()

    # -- arguments --------------------------------------------------------

    def _to_csr(self, pos, var, value, state: _Key):
        """A sparse value as a CSRMat on the device, built once per key (the
        key holds the value object)."""
        from aesara_tpu_torch.link.torch.csr import CSRMat

        if pos not in state.csr:
            state.csr[pos] = CSRMat.from_scipy(var.type.filter(value), self.device,
                                               with_transpose=self.program.csr_plan[pos]["transpose"])
        return state.csr[pos]

    def _dense_argument(self, var, value):
        """A dense user argument as a tensor, on the device if it was given
        as one (checked against the variable's type), else on the host."""
        import torch

        from aesara_tpu_torch.link.torch.kernels.elemwise import torch_dtype

        if isinstance(value, torch.Tensor):
            if value.device != self.device:
                raise ValueError(f"input {var} is on {value.device}; this function runs on {self.device}")
            if value.dtype != torch_dtype(var.type.dtype):
                raise TypeError(f"input {var} has dtype {value.dtype}, expected {var.type.dtype}")
            var.type.check_shape(tuple(value.shape))
            return value
        return torch.from_numpy(np.asarray(var.type.filter(value), order="C")).to(torch_dtype(var.type.dtype))

    def _upload(self, value):
        """A dense argument on the device; a one-element host value by a
        fill kernel, as ``Program.host_to_device`` uploads one."""
        import torch

        if value.device.type == "cpu" and value.numel() == 1 and self.device.type != "cpu":
            return torch.full(value.shape, value.item(), dtype=value.dtype, device=self.device)
        return value.to(self.device)

    def _shared_values(self, state: _Key) -> list:
        values = []
        for pos, var in enumerate(self.shared_inputs, start=self.n_user_inputs):
            sparse = self.program.csr_plan[pos] is not None
            where = var.device if sparse else var.value.device
            if where != self.device:
                raise ValueError(f"shared variable {var} lives on {where}; this function runs on {self.device}")
            values.append(self._to_csr(pos, var, var.value, state) if sparse else var.value)
        return values

    def _may_donate(self, shared: list) -> bool:
        """Whether this call's updates may be written by their nodes: the
        program has such nodes, and no two of the shared variables' values
        and update targets share a storage (two variables on one borrowed
        array: each update would overwrite the other's)."""
        if not self.program.donated:
            return False
        values = list(shared) + [t.value for t in self.unread_targets]
        storages = [st for st in map(_storage, values) if st]
        return len(storages) == len(set(storages))

    def _key(self, args):
        key = []
        for pos, value in enumerate(args):
            if self.program.csr_plan[pos] is not None:
                key.append(id(value))
            else:
                key.append((tuple(value.shape), str(value.dtype)))
        key += [id(var.value) for pos, var in enumerate(self.shared_inputs, start=self.n_user_inputs)
                if self.program.csr_plan[pos] is not None]
        return tuple(key)

    # -- results ------------------------------------------------------------

    def _settle(self, results: list, held: list, uploads, in_graph: bool) -> list:
        """Clone what a write would clobber, write the shared updates into
        their variables' storage, and return the other results.  A result
        folded on the host goes to the device through the key's uploads
        (a returned one as a copy, so that the caller cannot change the
        next call's)."""
        n_out, n_up = self.n_outputs, len(self.update_targets)
        targets = [t.value for t in self.update_targets]
        target_ptrs = {_storage(t) for t in targets} - {0}
        folded = [_is_host(v) for v in results]
        results = [self.program.to_device(v, o, uploads) if f else v
                   for v, o, f in zip(results, self.output_vars, folded)]
        outs, new, rest = results[:n_out], results[n_out:n_out + n_up], results[n_out + n_up:]
        taken = {_storage(v) for v in held + new + rest} - {0}
        outs = [o.clone() if _storage(o) and (_storage(o) in target_ptrs or (not b and _storage(o) in taken)
                                             or (f and not b and not in_graph))
                else o for o, b, f in zip(outs, self.borrow, folded)]
        new = [v.clone() if v is not t and _storage(v) in target_ptrs else v for v, t in zip(new, targets)]
        for var, target, value in zip(self.update_targets, targets, new):
            if not in_graph:
                if value.device != target.device:
                    raise ValueError(f"update of {var} computed on {value.device}; "
                                     f"the variable lives on {target.device}")
                var.type.check_shape(tuple(value.shape))
            if value is not target:
                target.copy_(value)
        return outs + rest

    def _returned(self, results: list, fresh: bool) -> tuple:
        """The results as the caller gets them: sparse ones in SciPy, and
        with ``fresh`` (after a replay) copies of the captured buffers,
        but for borrowed outputs."""
        from aesara_tpu_torch.link.torch.csr import CSRMat

        out = []
        for i, v in enumerate(results):
            if isinstance(v, CSRMat):
                var = self.output_vars[i if i < self.n_outputs else i + len(self.update_targets)]
                v = v.to_scipy(var.type.format)
            elif fresh and not (i < self.n_outputs and self.borrow[i]):
                v = v.clone()
            out.append(v)
        return tuple(out)

    # -- the call -----------------------------------------------------------

    def __call__(self, *args):
        import torch

        args = [a if self.program.csr_plan[pos] is not None else self._dense_argument(var, a)
                for pos, (var, a) in enumerate(zip(self.user_inputs, args))]
        key = self._key(args)
        state = self._keys.pop(key, None)
        if state is None:
            self.keys_made += 1
            sparse = [a for pos, a in enumerate(args) if self.program.csr_plan[pos] is not None]
            state = _Key(sparse + [var.value for pos, var in enumerate(self.shared_inputs, self.n_user_inputs)
                                   if self.program.csr_plan[pos] is not None])
        self._keys[key] = state
        while len(self._keys) > MAX_KEYS:
            self._keys.popitem(last=False)
        state.calls += 1
        values = [self._to_csr(pos, var, a, state) if self.program.csr_plan[pos] is not None else a
                  for pos, (var, a) in enumerate(zip(self.user_inputs, args))]
        if state.calls == 1 or self.capture_blocker is not None:
            self.captured = False
            values = [self._upload(v) if isinstance(v, torch.Tensor) else v for v in values]
            shared = self._shared_values(state)
            self.donating = self._may_donate(shared)
            try:
                results = self.program.run(values + shared, state.uploads, donate=self.donating)
            except Exception:
                if state.calls == 1:
                    # a key whose first call failed (a CheckAndRaise) is
                    # not kept, so the next call with it is not captured
                    del self._keys[key]
                raise
            return self._returned(self._settle(results, values + shared, state.uploads, False), False)
        if state.graph is None:
            self._capture(state, values)
        self._replay(state, values)
        self.captured = True
        self.donating = state.donating
        return self._returned(state.results, True)

    def _capture(self, state: _Key, values: list) -> None:
        """Capture one step into a CUDA graph: its input buffers are device
        copies of this call's dense arguments (they are filled again before
        each replay)."""
        import torch

        from aesara_tpu_torch.link.torch.kernels import counted_wrappers

        state.static_inputs = [torch.empty(v.shape, dtype=v.dtype, device=self.device)
                               if isinstance(v, torch.Tensor) else v for v in values]
        shared = self._shared_values(state)
        state.donating = self._may_donate(shared)
        wrappers = counted_wrappers()
        before = [w.launches for w in wrappers]
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        with torch.cuda.graph(graph):
            results = self.program.run(state.static_inputs + shared, state.uploads, donate=state.donating)
            state.results = self._settle(results, state.static_inputs + shared, state.uploads, True)
        state.launches = [w.launches - b for w, b in zip(wrappers, before)]
        # the storage the graph reads and writes: its shared inputs' and its
        # update targets' (a target need not be an input)
        state.graph = graph
        state.shared = [(var, value) for var, value in zip(self.shared_inputs + self.update_targets,
                                                           shared + [t.value for t in self.update_targets])
                        if isinstance(value, torch.Tensor)]

    def _replay(self, state: _Key, values: list) -> None:
        import torch

        from aesara_tpu_torch.link.torch.kernels import counted_wrappers

        for static, value in zip(state.static_inputs, values):
            if isinstance(value, torch.Tensor):
                if value.device.type == "cpu" and value.numel() == 1:
                    # a fill kernel takes the value as an argument: a copy
                    # from pageable memory would make the host wait for
                    # the work already queued (a minibatch index each step)
                    static.fill_(value.item())
                else:
                    static.copy_(value)
        if any(var.value is not captured for var, captured in state.shared):
            raise RuntimeError("a shared variable no longer holds the storage its captured graph reads")
        state.graph.replay()
        for w, n in zip(counted_wrappers(), state.launches):
            w.replayed += n

    @property
    def n_graphs(self) -> int:
        """Keys that hold a captured graph."""
        return sum(s.graph is not None for s in self._keys.values())


class TorchLinker:
    """Links a FunctionGraph to a callable on ``device`` (a
    ``torch.device`` or its name; None means ``config.device`` when the
    function is compiled).  ``use_graph`` (None: ``config.cuda_graph``)
    captures each step into a CUDA graph on the card.  ``donate_updated``
    (None: ``config.donate_shared``, default True) lets the node that
    computes a shared variable's update write it into the variable's
    storage where the destroy handler finds it legal (the counterpart of
    ``JAXLinker(donate_updated=)``); False computes every update into a
    fresh tensor and copies it there after the graph has run."""

    def __init__(self, device=None, use_graph=None, donate_updated=None):
        self.device = device
        self.use_graph = use_graph
        self.donate_updated = donate_updated

    def make_function(self, fgraph, n_user_inputs: int, n_outputs: int = None, update_targets=(),
                      borrow=()) -> Callable:
        import torch

        from aesara_tpu_torch.config import config

        device = resolve_device(self.device)
        if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            # Dot must be a full-fp32 product, as in the reference; the
            # process-wide switch is the caller's to set, not the linker's
            raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is True: Dot would round "
                               "its fp32 inputs to TF32; set it to False before compiling")
        if device.type == "cuda":
            # a bfloat16 or float16 product sums in fp32 (dispatch.sums_in_fp32);
            # PyTorch lets cuBLAS sum in the inputs' precision unless told not to
            for dtype, flag in (("bfloat16", "allow_bf16_reduced_precision_reduction"),
                                ("float16", "allow_fp16_reduced_precision_reduction")):
                if getattr(torch.backends.cuda.matmul, flag) and dtype in product_dtypes(fgraph):
                    raise RuntimeError(f"torch.backends.cuda.matmul.{flag} is True: a {dtype} Dot would "
                                       "sum in reduced precision; set it to False before compiling")
            refusal = cudnn_refusal(fgraph)
            if refusal is not None:
                raise RuntimeError(refusal)
        use_graph = config.cuda_graph if self.use_graph is None else self.use_graph
        n_outputs = len(fgraph.outputs) - len(update_targets) if n_outputs is None else n_outputs
        donate = config.donate_shared if self.donate_updated is None else self.donate_updated
        pairs = tuple(getattr(fgraph, "update_mapping", {}).items()) if donate else ()
        return TorchFunction(program_for(fgraph, device, bool(config.allow_gc), pairs), fgraph, n_user_inputs,
                             n_outputs, update_targets, borrow, bool(use_graph))

    def __str__(self):
        return f"TorchLinker(device={self.device})"
