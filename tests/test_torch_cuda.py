"""Kernel tests that need the card: each hand-written kernel against its
plain PyTorch version on CUDA tensors (K1 on every op of the scalar
table), a small encoder forward and train step, a small sparse
logistic-regression step on the card against the CPU, a captured
minibatch window replayed at every index, every Scan form captured
against eager and the CPU (``-k scan``), and the decoder's greedy, prompt,
batched and continuous-batching decode captured against eager and the
CPU, its caches written in place, K1 and K4 at its shapes (``-k
decoder``), and the random streams (``-k "threefry or topk or sampled"``):
the threefry kernel bit for bit against its plain version and the host's
keys, top-k's tie order, and a sampled decode, beam search and
speculative decoding on the card against the CPU, and a small conv net's
step captured against eager and the CPU, and its step guarded by
``IfElse`` (``-k convnet``), and the loop samplers TG, TP, TB and TM
against their plain versions, the new distributions and a CTC step on the
card against the CPU, captured against eager (``-k "ctc or
random_loops"``), and K2 and K3 in fp16, at head widths up to 256 and past
65,535 batch-heads, in fp64 and past 256 (the D split), and K1's
float-to-integer casts at their edges (``-k "fp16 or fp64 or past_256 or
d_split or fused_attention_compiled or saturate"``),
and the user API's core ops on the card against the CPU, bitwise, with
an output that views an updated shared variable (``-k "core_ops or
viewing"``), and a small encoder's sgd and AdamW steps with the updates
written in place by their nodes and without, bitwise (``-k donation``).
They skip where there
is no CUDA device; run them on a GPU machine with ``python -m pytest -m
cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import aesara_tpu_torch as ptp
import aesara_tpu_torch.tensor as pt
from aesara_tpu_torch.config import config
from aesara_tpu_torch.link.torch.kernels.attention import (
    attention_grads_plain, attention_plain, flash_attention, flash_attention_grads,
)
from aesara_tpu_torch.link.torch.csr import CSRMat
from aesara_tpu_torch.link.torch.kernels.elemwise import (
    ElemwiseKernel, composite_plain, fused_elemwise,
)
from aesara_tpu_torch.link.torch.kernels.softmax import (
    BLOCK_ROWS, LANE_GROUPS, LANE_ROWS_MAX, ONE_PASS, TWO_PASS, launch_softmax, softmax_rows, softmax_rows_plain,
)
from aesara_tpu_torch.link.torch.kernels.sparse import (
    SPMM_CHUNK, SPMM_SHORT, csr_matmul_plain, csr_sddmm, csr_sddmm_plain, csr_spmm, csr_spmv, launch_sddmm,
    spmm_vector_bytes,
)
from aesara_tpu_torch.models.linear import LogisticRegression
from aesara_tpu_torch.models.optim import adamw, sgd, warmup_cosine
from aesara_tpu_torch.scalar import ops as aes
from aesara_tpu_torch.scalar.composite import Composite
from aesara_tpu_torch.models.transformer import TransformerEncoderLayer
from aesara_tpu_torch.tensor import math as ptm


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _composite_node(fn):
    (node,) = [n for n in fn.maker.fgraph.toposort()
               if type(getattr(n.op, "scalar_op", None)).__name__ == "Composite"]
    return node


@pytest.mark.parametrize("shape", [(4, 33, 70), (2, 1, 5)])
def test_k1_kernel_matches_plain(cuda, shape):
    x = pt.TensorType("float32", (None, None, None))("x")
    b = pt.TensorType("float32", (1, 1, None))("b")
    fn = ptp.function([x, b], ptm.sqrt(ptm.maximum(x * b + 1.0, 0.0)) / (b + 2.0))
    node = _composite_node(fn)
    kernel = ElemwiseKernel(node.op.scalar_op, ["float32", "float32"], "float32")
    gen = torch.Generator(device=cuda).manual_seed(0)
    xv = torch.randn(shape, device=cuda, generator=gen)
    bv = torch.randn((1, 1, shape[-1]), device=cuda, generator=gen)
    before = fused_elemwise.launches
    got = fused_elemwise(kernel, xv, bv)
    assert fused_elemwise.launches == before + 1
    want = composite_plain(node.op.scalar_op, "float32", xv, bv)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("shape,causal,dtype,offset", [
    ((4, 96, 64), False, torch.float32, 0), ((2, 130, 40), True, torch.float32, 0),
    ((3, 200, 128), True, torch.bfloat16, 0),
    # rows not a multiple of 16 bytes, or a panel off a 16-byte boundary:
    # the wrapper pads them with zero columns
    ((2, 33, 33), True, torch.float32, 0), ((2, 70, 64), False, torch.float32, 1),
    ((2, 37, 20), False, torch.bfloat16, 0), ((2, 75, 37), True, torch.bfloat16, 0),
    # D = 128, and T no multiple of the walked tile, causal and not
    ((2, 130, 128), False, torch.float32, 0), ((1, 65, 128), True, torch.float32, 0),
    ((2, 150, 128), False, torch.bfloat16, 0), ((3, 1000, 64), True, torch.float32, 0),
    ((3, 1000, 64), False, torch.bfloat16, 0), ((3, 1, 64), False, torch.float32, 0)])
def test_k2_kernel_matches_plain(cuda, shape, causal, dtype, offset):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(shape, device=cuda, generator=gen).to(dtype) for _ in range(3))
    if offset:
        q = torch.cat([q.new_zeros(offset), q.reshape(-1)])[offset:].view(shape)
        assert q.data_ptr() % 16 != 0
    before = flash_attention.launches
    got, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
    assert flash_attention.launches == before + 1
    assert got.shape == shape and got.dtype == dtype
    want, want_lse = attention_plain(q, k, v, causal, shape[-1] ** -0.5, with_lse=True)
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_is_deterministic(cuda, dtype):
    # no atomics: every sum is taken in one fixed order
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn((4, 256, 64), device=cuda, generator=gen).to(dtype) for _ in range(3))
    first = flash_attention(q, k, v, causal=True, with_lse=True)
    second = flash_attention(q, k, v, causal=True, with_lse=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse"), first, second):
        assert torch.equal(a, b), name


def test_small_encoder_on_card_matches_cpu(cuda):
    def build(device):
        with config.change_flags(device=device):
            layers = [TransformerEncoderLayer(64, 4, 128, seed=i) for i in range(2)]
        x = pt.tensor3("x")
        h = x
        for layer in layers:
            h = layer(h)
        return ptp.function([x], h, mode=ptp.Mode(ptp.TorchLinker(device=device)))

    x = np.random.default_rng(0).normal(size=(2, 48, 64)).astype("float32")
    got = build("cuda")(x)
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), build("cpu")(x), atol=1e-4, rtol=1e-4)


def test_k1_relu_grad_composite_matches_plain(cuda):
    # mul(gz, cast(ge(y, 0))): a bool intermediate inside the Composite
    y, gz = pt.tensor3("y"), pt.tensor3("gz")
    fn = ptp.function([y, gz], ptm.mul(gz, pt.cast(ptm.ge(y, 0.0), "float32")))
    node = _composite_node(fn)
    kernel = ElemwiseKernel(node.op.scalar_op, ["float32", "float32"], "float32")
    gen = torch.Generator(device=cuda).manual_seed(2)
    yv, gv = (torch.randn((4, 33, 70), device=cuda, generator=gen) for _ in range(2))
    got = fused_elemwise(kernel, yv, gv)
    want = composite_plain(node.op.scalar_op, "float32", yv, gv)
    assert bool((yv < 0).any()) and bool((yv > 0).any())
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("shape,causal,dtype", [
    ((4, 96, 64), False, torch.float32), ((2, 130, 40), True, torch.float32),
    ((3, 200, 128), True, torch.bfloat16), ((2, 70, 96), False, torch.bfloat16),
    ((2, 130, 96), False, torch.float32), ((1, 65, 128), True, torch.float32),
    ((3, 1, 64), False, torch.float32),
    # rows not a multiple of 16 bytes: the wrapper pads them with zero columns
    ((2, 33, 33), True, torch.float32), ((2, 37, 20), False, torch.bfloat16)])
def test_k3_kernel_matches_plain(cuda, shape, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(shape, device=cuda, generator=gen).to(dtype) for _ in range(4))
    before = flash_attention_grads.launches
    got = flash_attention_grads(q, k, v, do, causal=causal)
    assert flash_attention_grads.launches == before + 1
    want = attention_grads_plain(q, k, v, do, causal, shape[-1] ** -0.5)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=5e-4, rtol=1e-3)
        else:
            tol = 2e-2 * w.float().abs().max().item()
            torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_is_deterministic(cuda, dtype):
    # no atomics: every sum is taken in one fixed order
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, do = (torch.randn((4, 256, 64), device=cuda, generator=gen).to(dtype) for _ in range(4))
    first = flash_attention_grads(q, k, v, do)
    second = flash_attention_grads(q, k, v, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def _scalar_composite(case: str, dtype: str):
    """A Composite of one of the optimizers' scalar ops over ``dtype``
    operands: (composite, number of inputs)."""
    S = aes.ScalarType(dtype)
    x, y, z = S(), S(), S()
    zero = aes.constant(0, dtype="int8")
    two = {
        "pow": aes.pow(x, y), "minimum": aes.minimum(x, y), "gt": aes.gt(x, y), "le": aes.le(x, y),
        "eq": aes.eq(x, y), "neq": aes.neq(x, y), "and": aes.and_(aes.gt(x, zero), aes.isnan(y)),
        "or": aes.or_(aes.isinf(x), aes.le(x, y)), "invert": aes.invert(aes.eq(x, y)),
        "switch": aes.switch(aes.gt(x, y), x, y),
    }
    one = {
        "abs": aes.abs_(x), "sgn": aes.sgn(x), "isnan": aes.isnan(x), "isinf": aes.isinf(x),
        "identity": aes.identity(x), "log": aes.log(x), "cos": aes.cos(x), "sin": aes.sin(x),
    }
    three = {"clip": aes.clip_scalar(x, y, z), "switch_float_cond": aes.switch(x, y, z)}
    for ins, table in (([x], one), ([x, y], two), ([x, y, z], three)):
        if case in table:
            return Composite(ins, [table[case]]), len(ins)
    raise KeyError(case)


K1_SCALAR_CASES = ["pow", "minimum", "gt", "le", "eq", "neq", "and", "or", "invert", "switch", "abs", "sgn",
                   "isnan", "isinf", "identity", "log", "cos", "sin", "clip", "switch_float_cond"]
#: ops whose result is exact in every dtype (no rounding inside)
K1_EXACT = {"minimum", "gt", "le", "eq", "neq", "and", "or", "invert", "switch", "abs", "sgn", "isnan", "isinf",
            "identity", "clip", "switch_float_cond"}


def _special_values(shape, dtype, gen, device):
    """Normal values times 3 with NaN, +-inf, -0.0 and 0.0 in the first
    entries and, for pow, integral exponents for some negative bases."""
    v = torch.randn(shape, device=device, generator=gen, dtype=torch.float64) * 3
    flat = v.reshape(-1)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 0.0, -2.0, 2.0],
                           dtype=torch.float64, device=device)
    n = min(flat.numel(), special.numel())
    flat[:n] = special[:n]
    half = flat.numel() // 2
    flat[half:] = torch.round(flat[half:])
    return v.to(dtype)


@pytest.mark.parametrize("layout", ["broadcast", "0-d"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("case", K1_SCALAR_CASES)
def test_k1_optimizer_scalar_ops_match_plain(cuda, case, dtype, layout):
    comp, nin = _scalar_composite(case, dtype)
    out_dtype = comp.outputs[0].type.dtype
    kernel = ElemwiseKernel(comp, [dtype] * nin, out_dtype)
    gen = torch.Generator(device=cuda).manual_seed(K1_SCALAR_CASES.index(case))
    shapes = [(), (), ()] if layout == "0-d" else [(33, 70), (1, 70), (33, 1)]
    args = [_special_values(s, getattr(torch, dtype), gen, cuda) for s in shapes[:nin]]
    if layout == "0-d":
        args[0] = torch.tensor(-2.0 if case == "pow" else float("nan"), dtype=args[0].dtype, device=cuda)
    before = fused_elemwise.launches
    got = fused_elemwise(kernel, *args)
    assert fused_elemwise.launches == before + 1
    want = composite_plain(comp, out_dtype, *args)
    assert got.dtype == want.dtype == (torch.bool if out_dtype == "bool" else getattr(torch, dtype))
    assert got.shape == want.shape == torch.broadcast_shapes(*[a.shape for a in args])
    if case in K1_EXACT or out_dtype == "bool":
        torch.testing.assert_close(got, want, atol=0, rtol=0, equal_nan=True)
    else:
        # libdevice against torch's own CUDA math: a few ulp
        tol = {"float32": 2e-6, "float64": 1e-14, "bfloat16": 8e-3}[dtype]
        torch.testing.assert_close(got, want, atol=tol, rtol=tol, equal_nan=True)


@pytest.mark.parametrize("case", ["and", "or", "invert"])
def test_k1_bitwise_ops_on_integers_match_plain(cuda, case):
    S = aes.ScalarType("int32")
    x, y = S(), S()
    expr = {"and": aes.and_(x, y), "or": aes.or_(x, y), "invert": aes.invert(x)}[case]
    comp = Composite([x, y], [aes.add(expr, y)])
    kernel = ElemwiseKernel(comp, ["int32", "int32"], "int32")
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randint(-1000, 1000, (40, 50), device=cuda, generator=gen, dtype=torch.int32)
    b = torch.randint(-1000, 1000, (1, 50), device=cuda, generator=gen, dtype=torch.int32)
    torch.testing.assert_close(fused_elemwise(kernel, a, b), composite_plain(comp, "int32", a, b), atol=0, rtol=0)


def test_small_adamw_step_on_card_matches_cpu(cuda):
    """The AdamW step of the flagship recipe (warmup-cosine schedule on a
    shared step, weight decay, global-norm clipping) at a small size: 2
    steps on the card and on the CPU; every parameter, moment and counter
    agrees within 1e-5."""
    xv = np.random.default_rng(3).normal(size=(1, 96, 64)).astype("float32")

    def build(device):
        with config.change_flags(device=device):
            layers = [TransformerEncoderLayer(64, 4, 128, seed=i) for i in range(2)]
            x = ptp.shared(xv, name="x")
            s = ptp.shared(np.asarray(0.0, "float32"), name="s")
        h = x
        for layer in layers:
            h = layer(h)
        loss = ptm.mean(ptm.sqr(h))
        params = [p for layer in layers for p in layer.params]
        updates = adamw(loss, params, lr=warmup_cosine(s, 1e-3, 2, 13), weight_decay=0.01, grad_clip=1.0)
        updates.append((s, s + 1.0))
        step = ptp.function([], ptp.Out(loss, borrow=True), updates=updates,
                            mode=ptp.Mode(ptp.TorchLinker(device=device)))
        return step, [t for t, _ in updates]

    (step_gpu, state_gpu), (step_cpu, state_cpu) = build("cuda"), build("cpu")
    before = fused_elemwise.launches
    for _ in range(2):
        loss_gpu, loss_cpu = step_gpu(), step_cpu()
        torch.testing.assert_close(loss_gpu.cpu(), loss_cpu, atol=1e-5, rtol=1e-5)
    n_composite = len(_composite_nodes(step_gpu))
    assert fused_elemwise.launches == before + 2 * n_composite
    for sg, sc in zip(state_gpu, state_cpu):
        assert sg.value.is_cuda and sg.name == sc.name
        torch.testing.assert_close(sg.value.cpu(), sc.value, atol=1e-5, rtol=1e-5, msg=sg.name)


def _composite_nodes(fn):
    return [n for n in fn.maker.fgraph.toposort()
            if type(getattr(n.op, "scalar_op", None)).__name__ == "Composite"]


def test_small_train_step_on_card_matches_cpu(cuda):
    xv = np.random.default_rng(1).normal(size=(2, 96, 64)).astype("float32")

    def build(device):
        with config.change_flags(device=device):
            layers = [TransformerEncoderLayer(64, 4, 128, seed=i) for i in range(2)]
            x = ptp.shared(xv, name="x")
        h = x
        for layer in layers:
            h = layer(h)
        loss = ptm.mean(ptm.sqr(h))
        params = [p for layer in layers for p in layer.params]
        step = ptp.function([], ptp.Out(loss, borrow=True), updates=sgd(loss, params, lr=0.01),
                            mode=ptp.Mode(ptp.TorchLinker(device=device)))
        return step, params

    (step_gpu, params_gpu), (step_cpu, params_cpu) = build("cuda"), build("cpu")
    before = flash_attention_grads.launches
    for _ in range(2):
        loss_gpu, loss_cpu = step_gpu(), step_cpu()
        assert loss_gpu.is_cuda
        torch.testing.assert_close(loss_gpu.cpu(), loss_cpu, atol=1e-5, rtol=1e-5)
    assert flash_attention_grads.launches == before + 4
    for pg, pc in zip(params_gpu, params_cpu):
        torch.testing.assert_close(pg.value.cpu(), pc.value, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(11314, 20), (5, 37), (3, 10000)], ids=["wide_m", "ragged", "two_pass"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64, torch.float16])
@pytest.mark.parametrize("log", [False, True], ids=["softmax", "log_softmax"])
def test_k4_kernel_matches_plain(cuda, shape, dtype, log):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.randn(shape, device=cuda, generator=gen) * 3).to(dtype)
    x[0] = float("-inf")                 # -inf throughout: nan, as jax.nn gives
    x[1, ::3] = float("-inf")
    before = softmax_rows.launches
    got = softmax_rows(x, log)
    torch.cuda.synchronize()
    assert softmax_rows.launches == before + 1 and got.dtype == dtype
    want = softmax_rows_plain(x, log)
    tol = _K4_TOL[dtype]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol, equal_nan=True)
    assert bool(got[0].isnan().all())


#: K4 against its plain version: fp32 and fp64 differ in the order of the
#: row sums; bf16 and fp16 compute in fp32 and may round to a neighbour
_K4_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float64: 1e-12, torch.float16: 2e-3}


def _k4_rows(cuda, shape, seed, dtype=torch.float32):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(shape, device=cuda, generator=gen) * 3).to(dtype)
    if shape[0] > 5:
        x[3] = float("-inf")             # -inf throughout: nan
        x[5, ::2] = float("-inf")
    return x


def _k4_check(x, log, tol=1e-5):
    before = softmax_rows.launches
    got = softmax_rows(x, log)
    torch.cuda.synchronize()
    assert softmax_rows.launches == before + 1 and got.shape == x.shape and got.dtype == x.dtype
    torch.testing.assert_close(got, softmax_rows_plain(x, log), atol=tol, rtol=tol, equal_nan=True)
    return got


@pytest.mark.parametrize("n", [20, 37, 300, 3000, 10000])
@pytest.mark.parametrize("log", [False, True], ids=["softmax", "log_softmax"])
def test_k4_base_off_16_bytes_matches_plain(cuda, n, log):
    """x one element past a 16-byte boundary: every regime takes one value
    an access."""
    x = torch.empty(70 * n + 1, device=cuda)[1:].view(70, n)
    x.copy_(_k4_rows(cuda, (70, n), 27))
    assert x.data_ptr() % 16 != 0
    _k4_check(x, log)


@pytest.mark.parametrize("n,width", [(20, 24), (100, 128), (3000, 3072), (9000, 9004)])
@pytest.mark.parametrize("log", [False, True], ids=["softmax", "log_softmax"])
def test_k4_row_strided_view_matches_plain(cuda, n, width, log):
    """A column slice is read in place, its rows ``width`` values apart."""
    x = _k4_rows(cuda, (70, width), 28)[:, :n]
    assert x.stride() == (width, 1)
    _k4_check(x, log)


@pytest.mark.parametrize("shape", [(11314, 20), (64, 10000)])
@pytest.mark.parametrize("log", [False, True], ids=["softmax", "log_softmax"])
def test_k4_is_deterministic(cuda, shape, log):
    x = _k4_rows(cuda, shape, 29)
    first, second = softmax_rows(x, log), softmax_rows(x, log)
    torch.cuda.synchronize()
    assert torch.equal(first.nan_to_num(), second.nan_to_num())
    assert torch.equal(first.isnan(), second.isnan())


@pytest.mark.parametrize("shape", [(0, 20), (5, 0), (0, 0), (2, 0, 7)])
def test_k4_launches_nothing_for_no_values(cuda, shape):
    x = torch.empty(shape, device=cuda)
    before = softmax_rows.launches
    got = softmax_rows(x, log=True)
    assert got.shape == x.shape and got.device == x.device and softmax_rows.launches == before


@pytest.mark.parametrize("regime,tile,n", [
    (LANE_GROUPS, 128, 1), (LANE_GROUPS, 128, 7), (LANE_GROUPS, 128, 20), (LANE_GROUPS, 32, 20),
    (LANE_GROUPS, 512, 20), (LANE_GROUPS, 128, 21), (LANE_GROUPS, 128, 22), (LANE_GROUPS, 64, 100),
    (LANE_GROUPS, 256, 1000), (LANE_GROUPS, 128, 1001), (LANE_GROUPS, 128, 1024), (BLOCK_ROWS, 128, 20),
    (BLOCK_ROWS, 128, 1000), (BLOCK_ROWS, 256, 8192), (BLOCK_ROWS, 512, 16384), (TWO_PASS, 256, 1),
    (TWO_PASS, 256, 20), (TWO_PASS, 1024, 1000), (TWO_PASS, 256, 32768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64, torch.float16])
def test_k4_every_regime_matches_plain(cuda, regime, tile, n, dtype):
    """Each regime at widths and tiles the plan does not choose as well; 21
    and 22 fp32 values a row take 4- and 8-byte accesses."""
    x = _k4_rows(cuda, (70, n), 30, dtype)
    for log in (False, True):
        out = torch.empty_like(x)
        launch_softmax(x, out, log, regime, tile)
        torch.cuda.synchronize()
        tol = _K4_TOL[dtype]
        torch.testing.assert_close(out, softmax_rows_plain(x, log), atol=tol, rtol=tol, equal_nan=True)


def _awkward_csr(n, d, seed, dtype="float32"):
    """A CSR with empty rows, duplicate and unsorted entries and a stored
    zero."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 12, size=n)
    counts[::7] = 0
    indptr = np.concatenate([[0], np.cumsum(counts)])
    data = rng.random(indptr[-1]).astype(dtype)
    data[0] = 0.0
    return sps.csr_matrix((data, rng.integers(0, d, size=indptr[-1]), indptr), shape=(n, d))


@pytest.mark.parametrize("C", [None, 1, 2, 5, 8, 9, 20, 40], ids=lambda c: f"C{c}")
@pytest.mark.parametrize("kernel", [csr_spmv, csr_spmm], ids=["K5", "K6"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bf16_rhs"])
def test_k5_k6_kernels_match_plain(cuda, kernel, C, dtype):
    x = _awkward_csr(3000, 700, seed=6, dtype="float64" if dtype == "float64" else "float32")
    a = CSRMat.from_scipy(x, cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    b = torch.randn((700,) if C is None else (700, C), device=cuda, generator=gen,
                    dtype=torch.float64 if dtype == "float64" else torch.float32)
    if dtype == "bf16_rhs":
        b = b.to(torch.bfloat16)
    out_dtype = torch.float64 if dtype == "float64" else torch.float32
    before = kernel.launches
    got = kernel(a, b, out_dtype)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and got.dtype == out_dtype
    want = csr_matmul_plain(a, b, out_dtype)
    tol = 1e-12 if dtype == "float64" else 1e-5
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("kernel", [csr_spmv, csr_spmm], ids=["K5", "K6"])
def test_k5_k6_a_stored_zero_times_inf_is_nan(cuda, kernel):
    x = sps.csr_matrix((np.array([0.0, 1.0, 2.0], "float32"), np.array([2, 0, 1]),
                        np.array([0, 2, 3])), shape=(2, 3))
    b = torch.tensor([[1.0], [2.0], [float("inf")]], device=cuda)
    got = kernel(CSRMat.from_scipy(x, cuda), b).cpu()
    assert bool(got[0, 0].isnan()) and float(got[1, 0]) == 4.0


def _dyadic_csr(counts, d, seed):
    """A CSR with the given entries a row, distinct columns, values that
    are multiples of 1/4: against a rhs of multiples of 1/16 every float32
    sum here is exact, so any order of summation gives the same bits."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts)
    cols = np.concatenate([rng.choice(d, size=c, replace=False) for c in counts])
    indptr = np.concatenate([[0], np.cumsum(counts)])
    values = rng.integers(1, 5, size=indptr[-1]).astype("float32") / 4
    return sps.csr_matrix((values, cols, indptr), shape=(len(counts), d))


def _one_long_row(seed=12):
    counts = np.random.default_rng(seed).integers(0, 6, size=300)
    counts[5] = 50000
    return _dyadic_csr(counts, 60000, seed)


def _long_among_empty(seed=13):
    counts = np.random.default_rng(seed).integers(0, 11, size=2000)
    counts[::3] = 0
    counts[1::97] = 3000
    return _dyadic_csr(counts, 5000, seed)


K6_PATTERNS = {"one_row_of_50000": _one_long_row, "long_among_empty": _long_among_empty,
               "no_entries": lambda: sps.csr_matrix((500, 300), dtype="float32")}


@pytest.mark.parametrize("short", [0, SPMM_SHORT, 8])
@pytest.mark.parametrize("chunk", [32, SPMM_CHUNK])
@pytest.mark.parametrize("which", sorted(K6_PATTERNS))
def test_k6_splits_long_rows_and_writes_empty_ones(cuda, which, chunk, short):
    x = K6_PATTERNS[which]()
    a = CSRMat.from_scipy(x, cuda)
    rhs = np.clip(np.round(np.random.default_rng(14).normal(size=(x.shape[1], 20)) * 16) / 16, -2, 2)
    b = torch.from_numpy(rhs).to(cuda, torch.float32)      # sums of at most 50,000 x 2: exact
    before = csr_spmm.launches
    got = csr_spmm(a, b, torch.float32, chunk=chunk, short=short)
    torch.cuda.synchronize()
    assert csr_spmm.launches == before + 1
    torch.testing.assert_close(got, csr_matmul_plain(a, b, torch.float32), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got.cpu().numpy(), (x @ b.cpu().numpy()).astype("float32"))


@pytest.mark.parametrize("case", ["C33", "C64", "C129", "C33_f64", "bf16_C20", "bf16_C9", "unaligned_C20",
                                  "unaligned_bf16_C20"])
def test_k6_widths_dtypes_and_alignments_match_plain(cuda, case):
    dtype = torch.float64 if case.endswith("f64") else torch.float32
    C = int(case.split("C")[1].split("_")[0])
    x = _awkward_csr(3000, 700, seed=15, dtype="float64" if dtype == torch.float64 else "float32")
    a = CSRMat.from_scipy(x, cuda)
    gen = torch.Generator(device=cuda).manual_seed(16)
    rhs_dtype = torch.bfloat16 if "bf16" in case else dtype
    if case.startswith("unaligned"):             # a rhs 4 bytes past a 16-byte boundary
        flat = torch.randn(700 * C + 8, device=cuda, generator=gen).to(rhs_dtype)
        b = flat[4 // flat.element_size():][:700 * C].view(700, C)
        assert b.data_ptr() % 16 != 0 and b.is_contiguous()
    else:
        b = torch.randn((700, C), device=cuda, generator=gen, dtype=dtype).to(rhs_dtype)
    before = csr_spmm.launches
    got = csr_spmm(a, b, dtype)
    torch.cuda.synchronize()
    assert csr_spmm.launches == before + 1 and got.dtype == dtype
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, csr_matmul_plain(a, b, dtype), atol=tol, rtol=tol)


def test_k6_is_deterministic_on_a_transposed_bag_of_words(cuda):
    rng = np.random.default_rng(17)
    docs, features = 2000, 30000
    lengths = np.clip(np.rint(rng.lognormal(4.85, 1.0, docs)), 1, 20000).astype(np.int64)
    rank = np.floor(np.exp(rng.random(lengths.sum()) * np.log(features))).astype(np.int64) - 1
    x = sps.csr_matrix((rng.random(lengths.sum()).astype(np.float32),
                        (np.repeat(np.arange(docs), lengths), rng.permutation(features)[rank])),
                       shape=(docs, features))
    # rows at unit norm, as TfidfVectorizer leaves them: float32 sums of
    # order one, which no two summation orders give with the same bits
    x.data /= np.repeat(np.sqrt(np.add.reduceat(x.data.astype(np.float64) ** 2, x.indptr[:-1])),
                        np.diff(x.indptr)).astype(np.float32)
    a = CSRMat.from_scipy(x, cuda, with_transpose=True).transpose()
    assert np.diff(a.to_scipy().indptr).max() > 1000       # the commonest words: long rows
    g = torch.randn((docs, 20), device=cuda, generator=torch.Generator(device=cuda).manual_seed(18))
    first, second = csr_spmm(a, g, torch.float32), csr_spmm(a, g, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    torch.testing.assert_close(first, csr_matmul_plain(a, g, torch.float32), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("C", [None, 1, 2, 4, 5, 8, 20, 33, 64, 160], ids=lambda c: f"C{c}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k7_kernel_matches_plain(cuda, C, dtype):
    x = _awkward_csr(3000, 700, seed=8, dtype="float64" if dtype == torch.float64 else "float32")
    a = CSRMat.from_scipy(x, cuda)
    gen = torch.Generator(device=cuda).manual_seed(9)
    gz, b = (torch.randn((n,) if C is None else (n, C), device=cuda, generator=gen, dtype=dtype)
             for n in (3000, 700))
    before = csr_sddmm.launches
    got = csr_sddmm(a, gz, b)
    torch.cuda.synchronize()
    assert csr_sddmm.launches == before + 1
    assert got.indptr is a.indptr and got.indices is a.indices and got.data.dtype == dtype
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got.data, csr_sddmm_plain(a, gz, b), atol=tol, rtol=tol)


def _dyadic_rhs(rows, C, seed, device):
    """Multiples of 1/16 in [-2, 2]: against multiples of 1/4 every float32
    dot of up to 160 terms here is exact."""
    rhs = np.clip(np.round(np.random.default_rng(seed).normal(size=(rows, C)) * 16) / 16, -2, 2)
    return torch.from_numpy(rhs).to(device, torch.float32)


K7_PATTERNS = {**K6_PATTERNS, "ragged_total": lambda: _dyadic_csr(
    np.random.default_rng(19).integers(0, 9, size=1001), 900, 19)}


@pytest.mark.parametrize("C", [1, 20, 160], ids=lambda c: f"C{c}")
@pytest.mark.parametrize("chunk", [32, SPMM_CHUNK])
@pytest.mark.parametrize("which", sorted(K7_PATTERNS))
def test_k7_splits_long_rows_and_skips_empty_ones(cuda, which, chunk, C):
    """The wrapper at the package's chunk; one launch at a chunk of 32
    (many more chunks a row) through ``launch_sddmm``."""
    x = K7_PATTERNS[which]()
    if which == "ragged_total":
        assert (x.shape[0] + x.nnz) % chunk != 0
    a = CSRMat.from_scipy(x, cuda)
    gz, b = _dyadic_rhs(x.shape[0], C, 20, cuda), _dyadic_rhs(x.shape[1], C, 21, cuda)
    if chunk == SPMM_CHUNK:
        before = csr_sddmm.launches
        got = csr_sddmm(a, gz, b).data
        assert csr_sddmm.launches == before + int(x.nnz > 0)
    else:
        got = torch.full_like(a.data, float("nan"))
        if x.nnz:
            launch_sddmm(a, gz, b, got, chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, csr_sddmm_plain(a, gz, b), atol=0, rtol=0)    # exact sums


@pytest.mark.parametrize("C,offset,ld,vecs", [
    (20, 1, 22, (4, 8)), (20, 2, 24, (8, 16)), (8, 0, 9, (4, 8)), (64, 4, 72, (16, 16)), (5, 0, 6, (4, 8)),
    (160, 1, 161, (4, 8))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k7_column_slices_take_a_narrower_load(cuda, C, offset, ld, vecs, dtype):
    """gz and b as column slices of wider matrices, rows ``ld`` values
    apart and ``offset`` values in: the load is the widest that divides the
    addresses and the row strides as well as the row (``vecs``: fp32,
    fp64)."""
    x = _awkward_csr(3000, 700, seed=22, dtype="float64" if dtype == torch.float64 else "float32")
    a = CSRMat.from_scipy(x, cuda)
    gen = torch.Generator(device=cuda).manual_seed(23)
    gz, b = (torch.randn((rows, ld), device=cuda, generator=gen, dtype=dtype)[:, offset:offset + C]
             for rows in (3000, 700))
    item = gz.element_size()
    vec = spmm_vector_bytes(C, item, gz.data_ptr() | b.data_ptr() | gz.stride(0) * item | b.stride(0) * item)
    assert not gz.is_contiguous() and vec == vecs[dtype == torch.float64]
    before = csr_sddmm.launches
    got = csr_sddmm(a, gz, b)
    torch.cuda.synchronize()
    assert csr_sddmm.launches == before + 1
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got.data, csr_sddmm_plain(a, gz, b), atol=tol, rtol=tol)


def test_k7_is_deterministic(cuda):
    rng = np.random.default_rng(24)
    docs, features = 2000, 30000
    lengths = np.clip(np.rint(rng.lognormal(4.85, 1.0, docs)), 1, 20000).astype(np.int64)
    rank = np.floor(np.exp(rng.random(lengths.sum()) * np.log(features))).astype(np.int64) - 1
    x = sps.csr_matrix((rng.random(lengths.sum()).astype(np.float32),
                        (np.repeat(np.arange(docs), lengths), rng.permutation(features)[rank])),
                       shape=(docs, features))
    a = CSRMat.from_scipy(x, cuda, with_transpose=True).transpose()     # rows of thousands of entries
    assert np.diff(a.to_scipy().indptr).max() > 1000
    gen = torch.Generator(device=cuda).manual_seed(25)
    gz, b = (torch.randn((rows, 20), device=cuda, generator=gen) for rows in (features, docs))
    first, second = csr_sddmm(a, gz, b), csr_sddmm(a, gz, b)
    torch.cuda.synchronize()
    assert torch.equal(first.data, second.data)
    torch.testing.assert_close(first.data, csr_sddmm_plain(a, gz, b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", sorted({1, 20, 33, 1000, 8192, 8193, 32768, *(
    edge + d for edge in (LANE_ROWS_MAX, 4096, ONE_PASS) for d in (-1, 0, 1))}))
@pytest.mark.parametrize("log", [False, True], ids=["softmax", "log_softmax"])
def test_k4_launch_at_widths_matches_plain(cuda, n, log):
    gen = torch.Generator(device=cuda).manual_seed(26)
    x = torch.randn((70, n), device=cuda, generator=gen) * 3
    x[3] = float("-inf")                 # -inf throughout: nan
    x[5, ::2] = float("-inf")
    before = softmax_rows.launches
    got = softmax_rows(x, log)
    torch.cuda.synchronize()
    assert softmax_rows.launches == before + 1
    torch.testing.assert_close(got, softmax_rows_plain(x, log), atol=1e-5, rtol=1e-5, equal_nan=True)
    assert bool(got[3].isnan().all())


def test_small_logistic_regression_step_on_card_matches_cpu(cuda):
    xv = sps.random(500, 3000, density=0.01, format="csr", dtype="float32",
                    random_state=np.random.RandomState(10))
    yv = np.random.default_rng(11).integers(0, 20, size=500).astype("int64")

    def build(device):
        with config.change_flags(device=device):
            x, y = ptp.shared(xv, name="x"), ptp.shared(yv, name="y")
            model = LogisticRegression(3000, 20, seed=0)
        loss = model.loss(x, y)
        return model, ptp.function([], ptp.Out(loss, borrow=True),
                                   updates=sgd(loss, model.params, lr=0.1),
                                   mode=ptp.Mode(ptp.TorchLinker(device=device)))

    (m_gpu, step_gpu), (m_cpu, step_cpu) = build("cuda"), build("cpu")
    counts = (csr_spmm.launches, softmax_rows.launches)
    for _ in range(2):
        torch.testing.assert_close(step_gpu().cpu(), step_cpu(), atol=1e-5, rtol=1e-5)
    assert (csr_spmm.launches, softmax_rows.launches) == (counts[0] + 4, counts[1] + 2)
    for pg, pc in zip(m_gpu.params, m_cpu.params):
        torch.testing.assert_close(pg.value.cpu(), pc.value, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the captured step: each compiled function captured into a CUDA graph on
# its second call with a key, then replayed
# ---------------------------------------------------------------------------

def _adamw_step(device, use_graph, seed=0):
    """The small AdamW encoder step (2 layers, d 64) on ``device``: (step,
    every update target)."""
    xv = np.random.default_rng(seed).normal(size=(2, 32, 64)).astype("float32")
    with config.change_flags(device=device):
        layers = [TransformerEncoderLayer(64, 4, 128, seed=i) for i in range(2)]
        x = ptp.shared(xv, name="x")
        s = ptp.shared(np.asarray(0.0, "float32"), name="s")
    h = x
    for layer in layers:
        h = layer(h)
    loss = ptm.mean(ptm.sqr(h))
    params = [p for layer in layers for p in layer.params]
    updates = adamw(loss, params, lr=warmup_cosine(s, 1e-3, 2, 13), weight_decay=0.01, grad_clip=1.0)
    updates.append((s, s + 1.0))
    step = ptp.function([], ptp.Out(loss, borrow=True), updates=updates,
                        mode=ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph)))
    return step, [t for t, _ in updates]


def test_captured_step_is_bitwise_equal_to_eager(cuda):
    (captured, state_c), (eager, state_e) = _adamw_step("cuda", True), _adamw_step("cuda", False)
    assert captured.capture_blocker is None and eager.capture_blocker == "use_graph is off"
    for call in range(4):
        loss_c, loss_e = captured(), eager()
        assert captured.captured == (call >= 1) and not eager.captured
        assert torch.equal(loss_c, loss_e), call
        for a, b in zip(state_c, state_e):
            assert torch.equal(a.value, b.value), (call, a.name)
    assert captured.fn.n_graphs == 1


def test_replays_keep_storage_and_take_set_value(cuda):
    w = ptp.shared(np.arange(4, dtype="float32"), name="w", device="cuda")
    f = ptp.function([], ptm.sum(w), updates=[(w, w * 2.0)], mode=ptp.Mode(ptp.TorchLinker(device="cuda")))
    ptr = w.value.data_ptr()
    got = [float(f()) for _ in range(3)]
    assert got == [6.0, 12.0, 24.0] and f.captured and w.value.data_ptr() == ptr
    # set_value writes into the storage the graph reads
    w.set_value(np.ones(4, "float32"))
    assert w.value.data_ptr() == ptr
    assert float(f()) == 4.0 and f.captured
    np.testing.assert_array_equal(w.get_value(), [2, 2, 2, 2])
    w.set_value(np.full(4, 3.0, "float32"))
    assert float(f()) == 12.0 and f.captured and w.value.data_ptr() == ptr
    np.testing.assert_array_equal(w.get_value(), [6, 6, 6, 6])


def test_a_replay_tallies_its_launches_apart_from_the_wrappers(cuda):
    x = pt.vector("x")
    f = ptp.function([x], ptm.exp(x) * 2.0 + 1.0, mode=ptp.Mode(ptp.TorchLinker(device="cuda")))
    xv = np.arange(4, dtype="float32")
    launches, replayed = fused_elemwise.launches, fused_elemwise.replayed
    f(xv)                       # eager: one launch
    f(xv)                       # captured (the launch is recorded into the graph), then replayed
    assert fused_elemwise.launches == launches + 2 and fused_elemwise.replayed == replayed + 1
    for _ in range(3):
        np.testing.assert_allclose(f(xv).cpu().numpy(), np.exp(xv) * 2 + 1, rtol=1e-6)
    assert f.captured
    assert fused_elemwise.launches == launches + 2 and fused_elemwise.replayed == replayed + 4


def test_a_new_shape_captures_again_and_outputs_stay_put(cuda):
    x = pt.matrix("x")
    f = ptp.function([x], [ptm.exp(x) * 2.0 + 1.0, ptp.Out(ptm.sum(x), borrow=True)],
                     mode=ptp.Mode(ptp.TorchLinker(device="cuda")))
    a, b = np.ones((3, 4), "float32"), np.zeros((5, 2), "float32")
    outs = [f(a), f(a), f(b), f(b), f(a * 2.0)]
    assert f.fn.n_graphs == 2 and f.captured
    want = [np.exp(a) * 2 + 1, np.exp(a) * 2 + 1, np.exp(b) * 2 + 1, np.exp(b) * 2 + 1, np.exp(a * 2) * 2 + 1]
    for (out, _), w in zip(outs, want):
        # a returned output is a fresh tensor: later replays leave it alone
        np.testing.assert_allclose(out.cpu().numpy(), w, rtol=1e-6)
    # a borrowed output is the graph's own buffer, which the next replay writes
    assert float(outs[1][1]) == 24.0 and outs[1][1].data_ptr() == outs[4][1].data_ptr()


def test_a_device_arange_reports_its_blocker_and_runs(cuda):
    x = pt.vector("x")
    f = ptp.function([x], pt.arange(0, pt.cast(ptm.sum(x), "int64"), 1, dtype="int64"),
                     mode=ptp.Mode(ptp.TorchLinker(device="cuda")))
    assert "ARange" in f.capture_blocker
    for _ in range(3):
        np.testing.assert_array_equal(f(np.asarray([1.0, 2.0], "float32")).cpu().numpy(), [0, 1, 2])
        assert not f.captured


@pytest.mark.parametrize("case", ["neg_inf", "int_pow", "uint32"])
def test_k1_launches_the_repaired_forms(cuda, case):
    if case == "neg_inf":
        x = pt.TensorType("float32", (None,))("x")
        out = pt.switch(ptm.isnan(x), np.float32(-np.inf), x) * 2.0
        xv = np.asarray([1.0, np.nan, -2.0, np.inf] * 300, "float32")
        args = (xv,)
    elif case == "int_pow":
        x, y = pt.TensorType("int32", (None,))("x"), pt.TensorType("int32", (None,))("y")
        out = ptm.pow(x, y) + np.int32(1)
        rng = np.random.default_rng(5)
        args = (rng.integers(-9, 101, size=1000).astype("int32"), rng.integers(-3, 12, size=1000).astype("int32"))
    else:
        x = pt.TensorType("uint32", (None,))("x")
        out = pt.switch(ptm.gt(x, np.uint32(2**31)), x * x + x, -x)
        xv = np.random.default_rng(6).integers(0, 2**32, size=1000, dtype="uint32")
        args = (xv,)
    inputs = [x] if case != "int_pow" else [x, y]
    gpu = ptp.function(inputs, out, mode=ptp.Mode(ptp.TorchLinker(device="cuda")))
    cpu = ptp.function(inputs, out, mode=ptp.Mode(ptp.TorchLinker(device="cpu")))
    before = fused_elemwise.launches
    got = gpu(*args)
    assert fused_elemwise.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), cpu(*args).numpy())


def test_a_failing_capture_raises(cuda):
    # last in the file: a capture that fails may leave the process's CUDA
    # state less tidy than a test after it would want
    from aesara_tpu_torch.graph.ir import Apply
    from aesara_tpu_torch.graph.op import Op
    from aesara_tpu_torch.link.torch.dispatch import torch_funcify

    class HostRead(Op):
        """x times its first value, read on the host: not capturable, and
        its lowering does not say so."""

        __props__ = ()

        def make_node(self, x):
            return Apply(self, [x], [x.type()])

    @torch_funcify.register(HostRead)
    def _host_read(op, node):
        return lambda x: x * float(x.reshape(-1)[0].item())

    x = pt.vector("x")
    f = ptp.function([x], HostRead()(x) + 1.0, mode=ptp.Mode(ptp.TorchLinker(device="cuda")))
    assert f.capture_blocker is None
    np.testing.assert_array_equal(f(np.asarray([2.0, 3.0], "float32")).cpu().numpy(), [5, 7])
    with pytest.raises(RuntimeError):
        f(np.asarray([2.0, 3.0], "float32"))


# ---------------------------------------------------------------------------
# the rest of the real scalar table and the special functions: K1's Triton
# form of each against its plain form on the card, in every dtype it takes
# ---------------------------------------------------------------------------

#: fp32/fp64 tolerance (rtol = atol) of each op's Triton form (libdevice)
#: against its plain form (PyTorch's own CUDA math); bfloat16 rounds both
#: to 8 bits, so 8e-3.  Exact: integer arithmetic, roundings, comparisons,
#: the floor division and modulo (one algorithm, NumPy's, in both forms)
K1_TABLE_EXACT = {"int_div", "mod", "ceil", "floor", "trunc", "round_half_to_even", "round_half_away_from_zero",
                  "xor", "shift_left", "shift_right", "in_range"}
K1_TABLE_TOL = {"float32": 4e-6, "float64": 1e-13}
#: the special functions, where PyTorch's CUDA forms are not libdevice's;
#: PyTorch's float64 J0 and J1 are off by up to 4e-7 (against SciPy, on
#: the CPU: tests/test_torch_scalar_math.py), so 1e-6 for those
K1_TABLE_SPECIAL_TOL = {"float32": 3e-5, "float64": 1e-11}
K1_TABLE_SPECIAL = {"erfcx", "gamma", "gammaln", "j0", "j1", "i0", "i1", "erfinv", "erfcinv"}
K1_TABLE_BESSEL_J_TOL = 1e-6


def _table_case_params():
    from tests.torch_scalar_cases import CASES, DTYPES

    return [(name, dtype) for name, _, _, _, kind in CASES for dtype in DTYPES[kind]]


@pytest.mark.parametrize("name,dtype", _table_case_params())
def test_k1_scalar_table_matches_plain(cuda, name, dtype):
    from tests.torch_scalar_cases import BY_NAME, case_values, port_op

    nin = BY_NAME[name][2]
    S = aes.ScalarType(dtype)
    ins = [S() for _ in range(nin)]
    comp = Composite(ins, [port_op(name)(*ins)])
    out_dtype = comp.outputs[0].type.dtype
    kernel = ElemwiseKernel(comp, [dtype] * nin, out_dtype)
    rng = np.random.default_rng(sorted(BY_NAME).index(name))
    vals = case_values(name, dtype, 33 * 70, rng)
    args = [torch.tensor(np.asarray(v, dtype="float64" if dtype == "bfloat16" else dtype)).to(
        getattr(torch, dtype)).reshape(33, 70).to(cuda) for v in vals]
    if nin > 1:
        args[-1] = args[-1][:1]       # the last operand broadcasts along dim 0
    before = fused_elemwise.launches
    got = fused_elemwise(kernel, *args)
    assert fused_elemwise.launches == before + 1
    want = composite_plain(comp, out_dtype, *args)
    assert got.dtype == want.dtype and got.shape == want.shape == (33, 70)
    if name in K1_TABLE_EXACT or out_dtype == "bool" or dtype in ("int8", "int32", "int64", "uint8"):
        torch.testing.assert_close(got, want, atol=0, rtol=0, equal_nan=True)
        return
    tol = 8e-3 if dtype == "bfloat16" else (K1_TABLE_SPECIAL_TOL if name in K1_TABLE_SPECIAL
                                            else K1_TABLE_TOL)[dtype]
    if name in ("j0", "j1") and dtype != "bfloat16":
        tol = max(tol, K1_TABLE_BESSEL_J_TOL)
    err = ((got.double() - want.double()).abs() / want.double().abs().clamp_min(1.0)).nan_to_num(0.0).max()
    print(f"K1 {name} {dtype}: largest error {float(err):.3e} (relative above 1, absolute below)")
    torch.testing.assert_close(got, want, atol=tol, rtol=tol, equal_nan=True)


def test_k1_integer_division_by_zero_is_zero_on_the_card(cuda):
    """NumPy's integer floor division and modulo by zero give 0 (the JAX
    package's -2/-1 is a fault of the reference); MIN // -1 wraps to MIN."""
    S = aes.ScalarType("int32")
    x, y = S(), S()
    for op, want in ((aes.int_div, [0, 0, 0, -2**31, -3, -2]), (aes.mod, [0, 0, 0, 0, 1, -1])):
        kernel = ElemwiseKernel(Composite([x, y], [op(x, y)]), ["int32", "int32"], "int32")
        a = torch.tensor([5, 0, -5, -2**31, -5, 5], dtype=torch.int32, device=cuda)
        b = torch.tensor([0, 0, 0, -1, 2, -3], dtype=torch.int32, device=cuda)
        assert fused_elemwise(kernel, a, b).tolist() == want


def test_captured_dynamic_slice_reads_each_replays_start(cuda):
    """A minibatch window ``X[i*B:(i+1)*B]`` of a shared X on the card:
    every call after the first two replays one captured graph, and each
    replay's window is that of its own index (the start is computed on
    the card, never read on the host), as the eager run gives it."""
    B = 10
    xv = np.random.default_rng(3).normal(size=(10 * B, 7)).astype("float32")
    with config.change_flags(device="cuda"):
        X = ptp.shared(xv, name="X")
        w = ptp.shared(np.zeros(7, dtype="float32"), name="w")
    i = pt.iscalar("i")
    window = X[i * B:(i + 1) * B]
    out = ptm.sum(window, axis=0)
    names = []
    fns = {}
    for use_graph in (True, False):
        mode = ptp.Mode(ptp.TorchLinker(device="cuda", use_graph=use_graph))
        fns[use_graph] = ptp.function([i], out, updates={w: w + out}, mode=mode)
        names = [type(n.op).__name__ for n in fns[use_graph].maker.fgraph.toposort()]
    assert "DynamicSlice" in names and "Subtensor" not in names
    captured, eager = fns[True], fns[False]
    assert captured.capture_blocker is None
    captured(np.int32(9))
    captured(np.int32(8))
    for k in range(10):
        got = captured(np.int32(k)).cpu().numpy()
        assert captured.captured
        np.testing.assert_array_equal(got, eager(np.int32(k)).cpu().numpy())
        np.testing.assert_allclose(got, xv[k * B:(k + 1) * B].sum(axis=0), rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# Scan on the card (``python -m pytest -m cuda tests/test_torch_cuda.py -k scan``)
# ---------------------------------------------------------------------------

def _scan_forms(device, use_graph):
    """Every capturable Scan form at a small size, compiled on ``device``:
    {name: (function, its arguments)}, each returning its stacks and the
    gradients of a cost of them."""
    from aesara_tpu_torch.scan import scan, until
    from aesara_tpu_torch.scan.views import foldl

    mode = ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph))
    rng = np.random.default_rng(3)
    xs, w, h0 = (rng.normal(size=(7, 4)), rng.normal(size=(4, 4)) * 0.5, rng.normal(size=4))
    forms = {}
    x, wv, hv = pt.matrix("x", dtype="float64"), pt.matrix("w", dtype="float64"), pt.vector("h0", dtype="float64")
    (h, y), _ = scan(lambda xt, hp, w: (ptm.tanh(ptm.dot(hp, w) + xt), ptm.sum(hp * xt)), sequences=[x],
                     outputs_info=[hv, None], non_sequences=[wv])
    forms["sit_nit"] = (ptp.function([x, wv, hv], [h, y] + ptp.grad(ptm.sum(h ** 2) + ptm.sum(y), [x, wv, hv]),
                                     mode=mode), [xs, w, h0])
    init = pt.matrix("init", dtype="float64")
    m, _ = scan(lambda xt, h2, h1: 0.5 * h2 - 0.3 * ptm.tanh(h1) + xt, sequences=[x],
                outputs_info=[{"initial": init, "taps": [-2, -1]}], go_backwards=True)
    forms["mit_sot_backwards"] = (ptp.function([init, x], [m] + ptp.grad(ptm.sum(m * m), [init, x]), mode=mode),
                                  [rng.normal(size=(2, 4)), xs])
    t, _ = scan(lambda xt, hp: ptm.tanh(hp * 0.9 + xt), sequences=[x], outputs_info=[hv], truncate_gradient=3,
                n_steps=x.shape[0] - 1)
    forms["truncated_shape_steps"] = (ptp.function([x, hv], [t] + ptp.grad(ptm.sum(t), [x, hv]), mode=mode),
                                      [xs, h0])
    v = pt.vector("v", dtype="float64")
    (p, valid), _ = scan(lambda vt, acc: (acc + vt, until(acc + vt > 2.0)), sequences=[v],
                         outputs_info=[pt.constant(np.float64(0.0))], n_steps=4, padded_while=True)
    forms["padded_while"] = (ptp.function([v], [p, valid, ptp.grad(ptm.sum(p * valid), v)], mode=mode),
                             [np.array([1.0, 1.5, 1.0, 1.0])])
    r, _ = foldl(lambda xt, acc, w: ptm.tanh(ptm.dot(acc, w) + xt), sequences=[x], outputs_info=[hv],
                 non_sequences=[wv])
    forms["foldl"] = (ptp.function([x, wv, hv], [r, ptp.grad(ptm.sum(r), wv)], mode=mode), [xs, w, h0])
    return forms


def test_scan_forms_captured_equal_eager_and_cpu(cuda):
    captured, eager, cpu = (_scan_forms("cuda", True), _scan_forms("cuda", False), _scan_forms("cpu", None))
    for name, (fn, args) in captured.items():
        assert fn.capture_blocker is None, name
        for call in range(3):
            got = [o.cpu().numpy() for o in fn(*args)]
            assert fn.captured == (call >= 1), name
        want = [o.cpu().numpy() for o in eager[name][0](*args)]
        ref = [o.numpy() for o in cpu[name][0](*args)]
        for g, e, c in zip(got, want, ref):
            np.testing.assert_array_equal(g, e, err_msg=name)
            np.testing.assert_allclose(g, c, atol=1e-10, rtol=1e-10, err_msg=name)
    np.testing.assert_allclose(captured["padded_while"][0](*captured["padded_while"][1])[2].cpu().numpy(),
                               [2.0, 1.0, 0.0, 0.0])


def test_scan_while_runs_eagerly_and_names_its_blocker(cuda):
    from aesara_tpu_torch.scan import scan, until

    p0 = pt.scalar("p0", dtype="float64")
    k, _ = scan(lambda p: (p * 2.0, until(p * 2.0 > 10)), outputs_info=[p0], n_steps=100)
    f = ptp.function([p0], k, mode=ptp.Mode(ptp.TorchLinker(device="cuda")))
    assert f.capture_blocker == "Scan{scan_while} (Scan) reads its until condition on the host each step"
    for _ in range(3):
        np.testing.assert_array_equal(f(np.float64(1.0)).cpu().numpy(), [2.0, 4.0, 8.0, 16.0])
        assert not f.captured
    n = pt.iscalar("n")
    h, _ = scan(lambda hp: hp * 2.0, outputs_info=[p0], n_steps=n)
    g = ptp.function([p0, n], h, mode=ptp.Mode(ptp.TorchLinker(device="cuda")))
    assert g.capture_blocker == "Scan{scan} (Scan) reads its trip count on the host"
    np.testing.assert_array_equal(g(np.float64(1.0), np.int32(3)).cpu().numpy(), [2.0, 4.0, 8.0])


def test_scan_inner_composites_launch_k1_and_match_plain(cuda):
    """Config 4's body and the LSTM's gate chain, fused in the inner
    programs, each one K1 launch a step, against their plain versions."""
    from aesara_tpu_torch.models import LSTM
    from aesara_tpu_torch.scan import scan

    mode = ptp.Mode(ptp.TorchLinker(device="cuda"))
    with config.change_flags(device="cuda"):
        x = ptp.shared(np.random.default_rng(0).normal(size=(6, 8, 5)).astype("float32"), name="x")
        wx = ptp.shared(np.full((5, 16), 0.1, "float32"))
        wh = ptp.shared(np.full((16, 16), 0.05, "float32"))
        b = ptp.shared(np.zeros(16, "float32"))
        lstm = LSTM(5, 16, 3, seed=1)
    hs, _ = scan(lambda xt, hp: ptm.tanh(ptm.dot(xt, wx) + ptm.dot(hp, wh) + b), sequences=[x],
                 outputs_info=[pt.zeros((8, 16), dtype="float32")])
    X = pt.tensor3("X", dtype="float32")
    fns = [ptp.function([], ptm.mean(hs ** 2), mode=mode), ptp.function([X], lstm.logits(X), mode=mode)]
    rng = np.random.default_rng(9)
    for fn, args in zip(fns, [[], [rng.normal(size=(6, 8, 5)).astype("float32")]]):
        (scan_node,) = [n for n in fn.fn.program.order if type(n.op).__name__ == "Scan"]
        inner = fn.fn.program.fns[fn.fn.program.order.index(scan_node)].program
        composites = [n for n, fold in zip(inner.order, inner.folds)
                      if not fold and type(getattr(n.op, "scalar_op", None)).__name__ == "Composite"]
        assert composites
        before = fused_elemwise.launches
        fn(*args)
        assert fused_elemwise.launches - before >= 6 * len(composites)
        for node in composites:
            comp, out_dtype = node.op.scalar_op, node.outputs[0].type.dtype
            kernel = ElemwiseKernel(comp, [v.type.dtype for v in node.inputs], out_dtype)
            vals = [torch.as_tensor(rng.uniform(0.05, 0.95, size=tuple(s or 8 for s in v.type.shape)).astype(
                v.type.dtype), device=cuda) for v in node.inputs]
            torch.testing.assert_close(fused_elemwise(kernel, *vals), composite_plain(comp, out_dtype, *vals),
                                       atol=1e-6, rtol=1e-6)


def test_scan_steps_per_call_is_bitwise_equal_to_separate_calls(cuda):
    def build(k):
        with config.change_flags(device="cuda"):
            w = ptp.shared(np.array([1.0, -2.0, 0.5, 3.0], "float32"), name="w")
        x = pt.vector("x", dtype="float32")
        loss = ptm.sum(ptm.tanh(w * x - 1.0) ** 2)
        f = ptp.function([x], loss, updates=[(w, w - 0.1 * ptp.grad(loss, w))], steps_per_call=k,
                         mode=ptp.Mode(ptp.TorchLinker(device="cuda")))
        return f, w

    (one, w1), (three, w3) = build(1), build(3)
    xv = np.random.default_rng(4).normal(size=4).astype("float32")
    for call in range(3):
        want = torch.stack([one(xv) for _ in range(3)])
        got = three(xv)
        assert torch.equal(got, want), call
        assert torch.equal(w3.value, w1.value), call
    assert three.captured


# ---------------------------------------------------------------------------
# the decoder's serving path on the card (``-k decoder``), at the CPU tests'
# size (tests/test_torch_decoder.py, tests/test_torch_serve.py)
# ---------------------------------------------------------------------------

DECODER_SIZE = dict(vocab=50, n_layers=2, d_model=32, n_heads=4, d_ff=64, seed=0)


def _decoder(device, **kw):
    from aesara_tpu_torch.models.decoder import DecoderLM

    with config.change_flags(device=device):
        return DecoderLM(**DECODER_SIZE, **kw)


@pytest.mark.parametrize("kv", [None, 2], ids=["mha", "gqa"])
def test_decoder_greedy_prompt_and_batched_captured_equal_eager_and_cpu(cuda, kv):
    builds = [(lambda lm, m: lm.generate_fn(6, 8, mode=m), np.int64(3)),
              (lambda lm, m: lm.generate_from_prompt_fn(4, 5, 16, mode=m), np.array([5, 9, 2, 7], dtype="int64")),
              (lambda lm, m: lm.generate_batched_fn(3, 6, 8, mode=m), np.array([3, 7, 11], dtype="int64"))]
    gpu, cpu = _decoder("cuda", n_kv_heads=kv), _decoder("cpu", n_kv_heads=kv)
    for build, arg in builds:
        captured = build(gpu, ptp.Mode(ptp.TorchLinker(device="cuda")))
        eager = build(gpu, ptp.Mode(ptp.TorchLinker(device="cuda", use_graph=False)))
        assert captured.capture_blocker is None
        for call in range(3):
            got = captured(arg).cpu().numpy()
            assert captured.captured == (call >= 1)
        np.testing.assert_array_equal(got, eager(arg).cpu().numpy())
        np.testing.assert_array_equal(got, build(cpu, None)(arg).numpy())


def test_decoder_cache_storage_stays_put_across_steps_on_the_card(cuda):
    lm = _decoder("cuda")
    f = lm.generate_fn(6, 8, mode=ptp.Mode(ptp.TorchLinker(device="cuda", use_graph=False)))
    program = f.fn.program
    scan = program.fns[[type(n.op).__name__ for n in program.order].index("Scan")]
    assert scan.owned == [2, 3, 4, 5]
    seen, run = [], scan.program.run

    def spy(args, uploads):
        seen.append([a.untyped_storage().data_ptr() for a in args[2:6]])
        return run(args, uploads)

    scan.program.run = spy
    try:
        first = f(np.int64(3)).cpu().numpy()
        second = f(np.int64(3)).cpu().numpy()
    finally:
        scan.program.run = run
    np.testing.assert_array_equal(first, second)
    assert len(seen) == 12 and seen[:6] == [seen[0]] * 6 and seen[6:] == [seen[6]] * 6


@pytest.mark.parametrize("chunk", [1, 4])
def test_decoder_batcher_captured_equals_eager_and_cpu(cuda, chunk):
    from aesara_tpu_torch.models.serve import ContinuousBatcher

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 50, size=n).astype("int64") for n in (4, 6, 8, 5)]
    runs = []
    for device, use_graph in (("cuda", True), ("cuda", False), ("cpu", None)):
        lm = _decoder(device)
        srv = ContinuousBatcher(lm, n_slots=2, t_max=64, t_pad=8, chunk=chunk,
                                mode=ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph)))
        queue, rids, results = list(enumerate(prompts)), {}, {}
        while queue or srv.pending():
            while queue and srv.free_slots():
                i, p = queue.pop(0)
                rids[srv.submit(p, max_new=10)] = i
            srv.step()
            for rid in list(rids):
                if rid in srv._done:
                    results[rids.pop(rid)] = srv.result(rid)
        if use_graph:
            assert srv._decode.captured
        state = [v.get_value() for v in srv._caches + [srv._pos, srv._cur, srv._act]]
        runs.append((results, state))
    (cap, cap_state), (eag, eag_state), (cpu, _) = runs
    assert cap == eag == cpu
    for a, b in zip(cap_state, eag_state):
        np.testing.assert_array_equal(a, b)


def test_decoder_k1_and_k4_at_its_shapes_match_plain(cuda):
    """K1 on every Composite of the decode step's inner program and K4 at
    the softmaxes of the decode step (over time, 512 rows of 8 heads) and
    the prefill (rows of its length), against their plain versions."""
    lm = _decoder("cuda")
    f = lm.generate_fn(6, 8, mode=ptp.Mode(ptp.TorchLinker(device="cuda")))
    program = f.fn.program
    inner = program.fns[[type(n.op).__name__ for n in program.order].index("Scan")].program
    composites = [n for n, fold in zip(inner.order, inner.folds)
                  if not fold and type(getattr(n.op, "scalar_op", None)).__name__ == "Composite"]
    assert len(composites) >= 10
    rng = np.random.default_rng(5)
    for node in composites:
        comp, out_dtype = node.op.scalar_op, node.outputs[0].type.dtype
        kernel = ElemwiseKernel(comp, [v.type.dtype for v in node.inputs], out_dtype)
        vals = [torch.as_tensor(rng.uniform(0.05, 0.95, size=tuple(s or 8 for s in v.type.shape)).astype(
            v.type.dtype) if v.type.dtype.startswith("float") else rng.integers(0, 8, size=tuple(
                s or 8 for s in v.type.shape)).astype(v.type.dtype), device=cuda) for v in node.inputs]
        torch.testing.assert_close(fused_elemwise(kernel, *vals), composite_plain(comp, out_dtype, *vals),
                                   atol=1e-6, rtol=1e-6)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for shape in ((8, 512), (256, 512), (2048, 256)):
        x = torch.randn(shape, device=cuda, generator=gen) * 3
        torch.testing.assert_close(softmax_rows(x, log=False), softmax_rows_plain(x, log=False), atol=1e-6,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# random streams, sort and the decoder's sampling on the card
# (``-k "threefry or topk or sampled"``)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 31, 32000, 2**20 + 3])
@pytest.mark.parametrize("key", [0, 42, "ones"], ids=str)
def test_threefry_kernel_is_bitwise_its_plain_version_and_the_host_keys(cuda, n, key):
    from aesara_tpu_torch.link.torch.kernels.threefry import MODES, threefry_draw, threefry_plain
    from aesara_tpu_torch.tensor.random.op import prng_key, random_bits, split

    data = np.full(2, 0xFFFFFFFF, np.uint32) if key == "ones" else prng_key(key)
    host_next, host_draw = split(data)
    k = torch.as_tensor(data).to(cuda)
    for mode in MODES:
        before = threefry_draw.launches
        nk, out = threefry_draw(k, (n,), mode)
        assert threefry_draw.launches == before + 1
        pk, want = threefry_plain(k, (n,), mode)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(nk.cpu().numpy(), host_next)
        np.testing.assert_array_equal(nk.cpu().numpy(), pk.cpu().numpy())
        assert out.dtype == want.dtype and out.shape == want.shape
        got = out.cpu().numpy()
        np.testing.assert_array_equal(got, want.cpu().numpy())
        if mode.startswith("bits"):
            width = 32 if mode == "bits32" else 64
            np.testing.assert_array_equal(got.view(np.uint32 if width == 32 else np.uint64),
                                          random_bits(host_draw, (n,), width))
    np.testing.assert_array_equal(k.cpu().numpy(), data)


def test_topk_ties_keep_the_lowest_index_first_on_the_card(cuda):
    """argtopk over a beam's joint scores (runs of equal values, -inf
    lanes), sort and argsort with ties: the card gives the CPU's order."""
    rng = np.random.default_rng(7)
    joint = np.round(rng.normal(size=4 * 5000), 1)
    joint[rng.random(joint.size) < 0.3] = -np.inf
    x = pt.vector("x", dtype="float64")
    from aesara_tpu_torch.tensor.sort import argsort, argtopk, sort, topk

    outs = [argtopk(x, 8), argtopk(x, -8), topk(x, 64), sort(x), argsort(x)]
    with config.change_flags(device="cuda"):
        gpu = ptp.function([x], outs)
    cpu = ptp.function([x], outs)
    for g, c in zip(gpu(joint), cpu(joint)):
        np.testing.assert_array_equal(g.cpu().numpy(), c.numpy())


def test_sampled_decode_beam_and_speculative_on_the_card_equal_the_cpu(cuda):
    """A sampled decode (top-k 5) captured, call for call against the CPU
    (each call advances the key, on the card in the captured graph's
    replays); beam search and speculative decoding against the CPU."""
    from aesara_tpu_torch.link.torch.kernels.threefry import threefry_draw

    gpu, cpu = _decoder("cuda"), _decoder("cpu")
    with config.change_flags(device="cuda"):
        f = gpu.generate_fn(6, 8, temperature=0.8, top_k=5, mode=ptp.Mode(ptp.TorchLinker(device="cuda")))
        beam = gpu.beam_search_fn(4, 3, 16, beam=60, mode=ptp.Mode(ptp.TorchLinker(device="cuda")))
        spec = gpu.speculative_generate_fn(gpu, 4, 5, 16, n_spec=3, mode=ptp.Mode(ptp.TorchLinker(device="cuda")))
    g = cpu.generate_fn(6, 8, temperature=0.8, top_k=5)
    assert f.capture_blocker is None
    launched, replayed = threefry_draw.launches, threefry_draw.replayed
    for call in range(3):
        np.testing.assert_array_equal(f(np.int64(3)).cpu().numpy(), g(np.int64(3)).numpy())
        assert f.captured == (call >= 1)
    # 6 draws in the loop and the stream's key advanced once outside it
    assert threefry_draw.launches - launched == 2 * 7 and threefry_draw.replayed - replayed == 2 * 7
    prompt = np.array([5, 9, 2, 7], dtype="int64")
    got, score = beam(prompt)
    want, want_score = cpu.beam_search_fn(4, 3, 16, beam=60)(prompt)
    assert got == want
    np.testing.assert_allclose(score, want_score, rtol=1e-6)
    np.testing.assert_array_equal(spec(prompt).cpu().numpy(),
                                  cpu.generate_from_prompt_fn(4, 5, 16)(prompt).numpy())


# ---------------------------------------------------------------------------
# bfloat16 graphs: K2 and K3 at the model-scale encoder's head dim, and the
# encoder's bfloat16 step (with and without remat) captured against eager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 1024, 128), (2, 2048, 128)])
def test_k2_k3_bfloat16_head_dim_128(cuda, shape):
    """``run_model_scale_remat``'s panels (d_model 2048 over 16 heads) at
    T 1024 and 2048: K2 and K3 within 2e-2 of the plain versions' scale,
    and two calls with the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, do = (torch.randn(shape, device=cuda, generator=gen).to(torch.bfloat16) for _ in range(4))
    scale = shape[-1] ** -0.5
    out = flash_attention(q, k, v)
    want = attention_plain(q, k, v, False, scale)
    tol = 2e-2 * want.float().abs().max().item()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    assert torch.equal(out, flash_attention(q, k, v))
    grads = flash_attention_grads(q, k, v, do)
    for g, w in zip(grads, attention_grads_plain(q, k, v, do, False, scale)):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2 * w.float().abs().max().item(), rtol=0)
    for a, b in zip(grads, flash_attention_grads(q, k, v, do)):
        assert torch.equal(a, b)


def _bf16_encoder_step(use_graph, use_remat):
    """The 2-layer bfloat16 encoder sgd step (d 128, 8 heads: head dim 16)
    on the card, each layer a ``remat`` node with ``use_remat``."""
    from aesara_tpu_torch.compile.builders import remat
    from aesara_tpu_torch.misc.safe_asarray import _asarray

    xv = np.random.default_rng(0).normal(size=(2, 64, 128)) * 0.1
    with config.change_flags(device="cuda", floatX="bfloat16"):
        layers = [TransformerEncoderLayer(128, 8, 256, seed=i) for i in range(2)]
        x = ptp.shared(_asarray(xv, "bfloat16"), name="x")
        h = x
        for layer in layers:
            h = remat([h] + layer.params, [layer(h)])(h, *layer.params) if use_remat else layer(h)
        loss = ptm.mean(ptm.sqr(h))
        params = [p for layer in layers for p in layer.params]
        step = ptp.function([], ptp.Out(loss, borrow=True), updates=sgd(loss, params, lr=0.01),
                            mode=ptp.Mode(ptp.TorchLinker(device="cuda", use_graph=use_graph)))
    return step, params


@pytest.mark.parametrize("use_remat", [False, True], ids=["plain", "remat"])
def test_captured_bfloat16_encoder_step_is_bitwise_eager(cuda, use_remat):
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        (captured, pc), (eager, pe) = _bf16_encoder_step(True, use_remat), _bf16_encoder_step(False, use_remat)
        for call in range(4):
            assert torch.equal(captured(), eager()), call
            for a, b in zip(pc, pe):
                assert a.value.dtype == torch.bfloat16
                assert torch.equal(a.value, b.value), (call, a.name)
        assert captured.captured
    finally:
        matmul.allow_bf16_reduced_precision_reduction = old


# -- the conv net and control flow (path (j) of chip_smoke.py, at a small size) -------------------


@pytest.fixture
def cudnn_exact(cuda):
    """cuDNN in full fp32, deterministic, not autotuning (the linker refuses
    the first and the last otherwise); restored after the test."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = False, True, False
    yield cuda
    cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = saved


def _convnet_step(device, use_graph=None, guarded=False):
    from aesara_tpu_torch.ifelse import ifelse
    from aesara_tpu_torch.models import ConvNet

    with config.change_flags(device=device, floatX="float32"):
        model = ConvNet(1, (12, 12), [4, 8], 10, seed=0)
    x, y = pt.tensor4("x", dtype="float32"), pt.lvector("y")
    loss = model.loss(x, y)
    updates = sgd(loss, model.params, lr=0.1)
    if guarded:
        finite = ptm.invert(ptm.or_(ptm.isnan(loss), ptm.isinf(loss)))
        updates = [(p, ifelse(finite, new, p)) for p, new in updates]
    step = ptp.function([x, y], ptp.Out(loss, borrow=True), updates=updates,
                        mode=ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph)))
    return step, model.params


def _conv_batch(n=16):
    rng = np.random.default_rng(0)
    return rng.normal(size=(n, 1, 12, 12)).astype("float32"), rng.integers(0, 10, size=n).astype("int64")


def test_convnet_step_captured_is_bitwise_eager_and_the_cpu(cudnn_exact):
    """The conv net's sgd step captured against the same step eager (every
    call and parameter bitwise), and its first step against the CPU."""
    x, y = _conv_batch()
    (captured, pc), (eager, pe), (cpu, pcpu) = (_convnet_step("cuda", True), _convnet_step("cuda", False),
                                               _convnet_step("cpu"))
    want = float(cpu(x, y))
    for call in range(4):
        got = captured(x, y)
        assert torch.equal(got, eager(x, y)), call
        if call == 0:
            np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-5)
            for a, c in zip(pc, pcpu):
                np.testing.assert_allclose(a.get_value(), c.get_value(), rtol=1e-5, atol=1e-5)
        for a, b in zip(pc, pe):
            assert torch.equal(a.value, b.value), (call, a.name)
    assert captured.captured and captured.capture_blocker is None


def test_guarded_convnet_step_equals_sgd_and_keeps_the_parameters_on_nan(cudnn_exact):
    """ifelse(isfinite(loss), p - 0.1 g, p): on a finite batch the same bits
    as the sgd step, captured; on a batch with one NaN pixel the loss is NaN
    and every parameter keeps its bits."""
    x, y = _conv_batch()
    (plain, pp), (guarded, pg) = _convnet_step("cuda"), _convnet_step("cuda", guarded=True)
    start = [p.get_value() for p in pp]
    for call in range(3):
        for params in (pp, pg):
            for p, v in zip(params, start):
                p.set_value(v)
        assert torch.equal(plain(x, y), guarded(x, y)), call
        for a, b in zip(pp, pg):
            assert torch.equal(a.value, b.value), (call, a.name)
    assert guarded.captured
    before = [p.value.clone() for p in pg]
    bad = x.copy()
    bad[3, 0, 5, 7] = np.nan
    assert torch.isnan(guarded(bad, y))
    assert guarded.captured
    for p, b in zip(pg, before):
        assert torch.equal(p.value, b), p.name


# ---------------------------------------------------------------------------
# the CTC loss, the loop samplers and MRG31k3p (``-k "ctc or random_loops"``)
# ---------------------------------------------------------------------------

def test_random_loops_kernels_match_their_plain_versions(cuda):
    """TG (both spaces, fp32 and fp64), TP and TB at parameters that reach
    every branch, and TM at a ragged n: bit for bit against the plain
    versions on the same key and state, with their launch counts."""
    from aesara_tpu_torch.link.torch.kernels import random_loops as rl
    from aesara_tpu_torch.tensor.random.op import prng_key

    key = torch.as_tensor(prng_key(7)).to(cuda)
    n = 1 << 14
    for dtype in (torch.float64, torch.float32):
        alpha = torch.tensor([0.05, 0.7, 1.0, 3.5, 250.0], dtype=dtype, device=cuda).repeat(n // 5)
        for log_space in (False, True):
            before = rl.gamma_draw.launches
            got = rl.gamma_draw(key, alpha, log_space)
            assert rl.gamma_draw.launches == before + 1
            assert torch.equal(got, rl.gamma_plain(key, alpha, log_space))
        count = torch.tensor([5, 40, 1000, 1e6, 30, 7], dtype=dtype, device=cuda).repeat(n // 6)
        prob = torch.tensor([0.3, 0.2, 0.5, 0.01, 0.9, -0.1], dtype=dtype, device=cuda).repeat(n // 6)
        got = rl.binomial_draw(key, count, prob)
        assert torch.equal(got.nan_to_num(-7.0), rl.binomial_plain(key, count, prob).nan_to_num(-7.0))
    lam = torch.tensor([0.0, 0.5, 9.99, 10.0, 37.0, 1e4], dtype=torch.float32, device=cuda).repeat(n // 6)
    before = rl.poisson_draw.launches
    got = rl.poisson_draw(key, lam)
    assert rl.poisson_draw.launches == before + 3
    assert torch.equal(got, rl.poisson_plain(key, lam))
    state = torch.as_tensor(np.random.default_rng(1).integers(1, 2**31 - 30000, size=(77, 6)), dtype=torch.int32,
                            device=cuda)
    for dtype in ("float32", "float64"):
        (ks, kv), (ps, pv) = rl.mrg_draw(state, 1000, dtype), rl.mrg_plain(state, 1000, dtype)
        assert torch.equal(ks, ps) and torch.equal(kv, pv)


def _mrg_states(n_streams, seed):
    """Seeded MRG31k3p states, each component below its modulus."""
    from aesara_tpu_torch.link.torch.kernels.random_loops import M1, M2

    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, M1, size=(n_streams, 3)), rng.integers(0, M2, size=(n_streams, 3))],
                          axis=1).astype(np.int32)


def _tm_draws(state, n, dtype, chunk):
    """TM's (new state, draws) on the card: through the wrapper, one launch
    (chunk None), or at chunks of ``chunk`` steps."""
    from aesara_tpu_torch.link.torch.kernels import random_loops as rl

    card = torch.from_numpy(state).cuda()
    if chunk is not None:
        return rl._mrg_launch(card, n, dtype, chunk)
    before = rl.mrg_draw.launches
    got = rl.mrg_draw(card, n, dtype)
    assert rl.mrg_draw.launches == before + 1
    return got


@pytest.mark.parametrize("n_streams,n,chunk", [
    (7, 0, None), (40, 13, None), (1, 1, None), (33, 33, None), (33, 34 * 33 - 5, None), (1, 4000, None),
    (1, 4000, 3), (1, 4000, 61), (5, 997, 7), (64, 64 * 300, None), (64, 1 << 20, None), (15360, 1 << 20, None),
    (15360, 1 << 20, 5), (15360, 1 << 20, 64), (15360, 15360 * 6, None), (166, 1000, None), (15360, 1 << 24, None),
], ids=["n0", "fewer_than_streams", "one_step", "one_step_each", "ragged", "one_stream", "one_stream_L3",
        "one_stream_L61", "ragged_L7", "64_streams", "64_streams_2e20", "15360x69", "15360x69_L5", "15360x69_L64",
        "15360x6", "guessed_1000", "15360x1093"])
def test_random_loops_tm_is_bitwise_over_the_grid(cuda, n_streams, n, chunk):
    """TM (a thread a chunk of a stream's steps, jumped there by the jump
    table) bit for bit against its plain version on the CPU, draws and new
    state, in float32 and float64: through the wrapper, one launch a draw,
    or at a given chunk length."""
    from aesara_tpu_torch.link.torch.kernels import random_loops as rl

    state = _mrg_states(n_streams, n_streams + n)
    for dtype in ("float32", "float64"):
        (ks, kv), (ps, pv) = _tm_draws(state, n, dtype, chunk), rl.mrg_plain(torch.from_numpy(state), n, dtype)
        assert torch.equal(ks.cpu(), ps) and torch.equal(kv.cpu(), pv), dtype


@pytest.mark.parametrize("n", [1, 4096 * 40 - 3])
def test_random_loops_tm_at_the_edge_states(cuda, n):
    """TM from every state whose components come from 0, 1, m2 - 1 and m1 -
    1 (4**6 streams), through the wrapper and at chunks of 5 and 8 steps,
    bit for bit against its plain version in float32 and float64."""
    import itertools

    from aesara_tpu_torch.link.torch.kernels import random_loops as rl

    state = np.array(list(itertools.product((0, 1, rl.M2 - 1, rl.M1 - 1), repeat=6)), dtype=np.int32)
    for dtype in ("float32", "float64"):
        ps, pv = rl.mrg_plain(torch.from_numpy(state), n, dtype)
        for chunk in (None, 5, 8):
            ks, kv = _tm_draws(state, n, dtype, chunk)
            assert torch.equal(ks.cpu(), ps) and torch.equal(kv.cpu(), pv), (dtype, chunk)


def test_random_loops_tm_replays_from_a_cuda_graph(cuda):
    """A TM draw captured into a CUDA graph (its launch counted there),
    replayed on a state rewritten in place, bitwise the eager draw of that
    state; a draw whose jump table was never uploaded raises while a graph
    is captured, naming the cause."""
    from aesara_tpu_torch.link.torch.kernels import random_loops as rl

    n = 1 << 20
    state = torch.from_numpy(_mrg_states(15360, 1)).cuda()
    eager = rl.mrg_draw(state, n, "float32")
    graph = torch.cuda.CUDAGraph()
    before = rl.mrg_draw.launches
    with torch.cuda.graph(graph):
        captured = rl.mrg_draw(state, n, "float32")
    assert rl.mrg_draw.launches == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured[0], eager[0]) and torch.equal(captured[1], eager[1])
    state.copy_(torch.from_numpy(_mrg_states(15360, 2)))
    graph.replay()
    eager = rl.mrg_draw(state, n, "float32")
    torch.cuda.synchronize()
    assert torch.equal(captured[0], eager[0]) and torch.equal(captured[1], eager[1])
    with pytest.raises(RuntimeError, match="jump table"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            rl._mrg_launch(state, n, "float32", 23)


@pytest.mark.parametrize("n", [1, 255, 257, 2**20 + 3])
def test_random_loops_tp_and_tb_are_bitwise_at_every_cap(cuda, n):
    """TP and TB (the round keys once a launch, pass 0 to each element's
    first acceptance, pass 1 walking back from round R - 1) bit for bit
    against their plain versions at n values: parameters cycling through
    every branch and the invalid ones, and uniform ones (poisson(37),
    binomial(1000, 0.5)), TB in float32 and float64.  The wrappers (the cap
    of stored rounds their size gives; one launch a call up to 256 values,
    where the block derives the keys and walks back itself, three past it),
    then the launches with caps of 2 and 0, where threads derive the rounds
    past the cap themselves."""
    from aesara_tpu_torch.link.torch.kernels import random_loops as rl
    from aesara_tpu_torch.tensor.random.op import prng_key

    key = torch.as_tensor(prng_key(11)).to(cuda)
    launches = 1 if n <= 256 else 3
    lams = {"mixed": [0.0, 0.5, 9.99, 10.0, 37.0, 1e4, np.nan, -1.0], "uniform": [37.0]}
    pairs = {"mixed": [(5, 0.3), (40, 0.2), (1000, 0.5), (1e6, 0.01), (30, 0.9), (7, -0.1), (np.nan, 0.4),
                       (5000, 1.5), (np.inf, 0.3)],
             "uniform": [(1000, 0.5)]}

    def poisson(lam, cap):
        if cap is not None:
            return rl._poisson_launch(key, lam, cap)
        before = rl.poisson_draw.launches
        got = rl.poisson_draw(key, lam)
        assert rl.poisson_draw.launches == before + launches
        return got

    def binomial(count, prob, cap):
        if cap is not None:
            return rl._binomial_launch(key, count, prob, cap)
        before = rl.binomial_draw.launches
        got = rl.binomial_draw(key, count, prob)
        assert rl.binomial_draw.launches == before + launches
        return got

    for cap in (None, 2, 0):
        for label in ("mixed", "uniform"):
            lam = torch.as_tensor(np.resize(np.array(lams[label], np.float32), n), device=cuda)
            assert torch.equal(poisson(lam, cap), rl.poisson_plain(key, lam)), (cap, label)
            for dtype in (torch.float64, torch.float32):
                cp = torch.as_tensor(np.resize(np.array(pairs[label]), (n, 2)), dtype=dtype, device=cuda)
                count, prob = cp[:, 0].contiguous(), cp[:, 1].contiguous()
                got, want = binomial(count, prob, cap), rl.binomial_plain(key, count, prob)
                assert torch.equal(got.nan_to_num(-7.0), want.nan_to_num(-7.0)), (cap, label, dtype)


def test_random_loops_distributions_on_the_card_are_the_cpus(cuda):
    """A compiled function drawing gamma, poisson, binomial, multinomial,
    integers, permutation and dirichlet on the card, captured: each call
    the CPU's draws from the same seed (integers equal, floats within
    1e-12 relative), the keys advancing alike.  Poisson at lambda = 1e4 is
    float32 arithmetic near lgamma(1e4) = 8.2e4, where an ulp of CUDA's
    log against the CPU's flips an acceptance now and then: that column
    may differ in 1 draw of 500, and only near lambda."""
    from aesara_tpu_torch.tensor.random.utils import RandomStream

    def build(device):
        # the stream's keys live on the device the function runs on
        with config.change_flags(device=device):
            srng = RandomStream(seed=3)
            outs = [srng.gamma(np.array([0.05, 0.7, 3.5]), 2.0, size=(500, 3)),
                    srng.poisson(np.array([0.5, 9.99, 37.0, 1e4]), size=(500, 4)),
                    srng.binomial(np.array([5, 1000, 30]), np.array([0.3, 0.5, 0.9]), size=(500, 3)),
                    srng.multinomial(20, np.array([0.2, 0.3, 0.5]), size=(100,)),
                    srng.integers(-3, 2**40, size=(500,)), srng.permutation(np.arange(64)),
                    srng.dirichlet(np.array([0.05, 1.0, 3.0]), size=(200,))]
            return ptp.function([], outs)

    card, host = build("cuda"), build("cpu")
    for call in range(3):
        for k, (a, b) in enumerate(zip(card(), host())):
            a = a.cpu().numpy()
            b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-300)
            elif k == 1:
                np.testing.assert_array_equal(a[:, :3], b[:, :3])
                differ = a[:, 3] != b[:, 3]
                assert differ.sum() <= a.shape[0] // 500 and np.all(np.abs(a[differ, 3] - 1e4) < 600)
            else:
                np.testing.assert_array_equal(a, b)
    assert card.captured


def test_ctc_step_on_the_card_is_the_cpus_and_captured_equals_eager(cuda):
    """A small CTC head (T 30, B 4, C 6, d 8) trained by sgd: 3 captured
    calls bitwise the eager ones, and the card's loss and weights within
    1e-5 of the CPU's (the Dot's and the DP's sums in another order)."""
    from aesara_tpu_torch.tensor.nnet.ctc import ctc

    rng = np.random.default_rng(5)
    feats = rng.normal(size=(30, 4, 8)).astype("float32")
    w0 = (rng.normal(size=(8, 6)) * 0.3).astype("float32")
    labels = np.array([[1, 1, 2, -1], [3, 4, 5, 2], [-1, -1, -1, -1], [2, 3, 2, 3]])
    ilen = np.array([30, 25, 30, 3])

    def build(device, use_graph):
        w = ptp.shared(w0.copy(), device=device)
        x, lab, il = pt.tensor3("x", dtype="float32"), pt.lmatrix("l"), pt.lvector("i")
        loss = pt.mean(ctc(pt.dot(x, w), lab, il))
        step = ptp.function([x, lab, il], loss, updates=[(w, w - 0.1 * ptp.grad(loss, w))],
                            mode=ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph)))
        return step, w

    (cap, wc), (eag, we), (cpu, wcpu) = build("cuda", True), build("cuda", False), build("cpu", False)
    for _ in range(3):
        lc, le, lh = cap(feats, labels, ilen), eag(feats, labels, ilen), cpu(feats, labels, ilen)
        assert torch.equal(lc, le) and torch.equal(wc.value, we.value)
        np.testing.assert_allclose(lc.cpu().numpy(), np.asarray(lh), rtol=1e-5)
        np.testing.assert_allclose(wc.get_value(), wcpu.get_value(), rtol=1e-5, atol=1e-5)
    assert cap.captured and cap.capture_blocker is None


# ---------------------------------------------------------------------------
# K2 and K3 in fp16, at head widths 160 and 256 and past 65,535 batch-heads;
# fp64 refused; K1's float-to-integer casts at their edges
# ---------------------------------------------------------------------------

#: each against its plain version within this of the plain output's scale:
#: fp32 1e-4 (3xTF32 and the order of sums), bf16 2e-2 (P and dS rounded to
#: bf16), fp16 2e-3 (the outputs rounded to fp16; P and dS kept as hi + lo)
WIDE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-3}


@pytest.mark.parametrize("shape,causal,dtype", [
    ((16, 512, 64), False, torch.float16), ((4, 300, 64), True, torch.float16),
    ((2, 130, 128), True, torch.float16), ((3, 77, 40), False, torch.float16),
    ((4, 200, 160), True, torch.float32), ((4, 200, 160), False, torch.bfloat16),
    ((4, 200, 160), True, torch.float16), ((2, 300, 256), False, torch.float32),
    ((2, 300, 256), True, torch.bfloat16), ((2, 300, 256), True, torch.float16),
    ((2, 65, 200), True, torch.float32), ((2, 65, 250), False, torch.bfloat16),
    ((65600, 16, 64), False, torch.float32), ((65600, 16, 64), True, torch.float16)])
def test_k2_k3_fp16_wide_heads_and_many_batch_heads(cuda, shape, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, do = (torch.randn(shape, device=cuda, generator=gen).to(dtype) for _ in range(4))
    scale = shape[-1] ** -0.5
    before = flash_attention.launches, flash_attention_grads.launches
    out = flash_attention(q, k, v, causal=causal, scale=scale)
    grads = flash_attention_grads(q, k, v, do, causal=causal, scale=scale)
    assert (flash_attention.launches, flash_attention_grads.launches) == (before[0] + 2, before[1] + 1)
    want = attention_plain(q, k, v, causal, scale)
    assert out.dtype == dtype and out.shape == shape
    tol = WIDE_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol * want.float().abs().max().item(), rtol=0)
    for g, w in zip(grads, attention_grads_plain(q, k, v, do, causal, scale)):
        assert g.dtype == dtype and g.shape == shape and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), atol=tol * w.float().abs().max().item(), rtol=0)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal, scale=scale))
    for a, b in zip(grads, flash_attention_grads(q, k, v, do, causal=causal, scale=scale)):
        assert torch.equal(a, b)


def test_fp16_attention_past_fp16s_range_of_scores(cuda):
    """Unscaled scores past 65,504: K2 and K3 keep them in fp32, so the
    results are finite and the plain versions'."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    q = (10000.0 * (1.0 + 0.1 * torch.randn((2, 64, 64), device=cuda, generator=gen))).half()
    k, v, do = (torch.randn((2, 64, 64), device=cuda, generator=gen).half() for _ in range(3))
    assert (q.float() @ k.float().transpose(1, 2)).abs().max().item() > 65504 * 1.5
    out = flash_attention(q, k, v, causal=True, scale=5e-5)
    assert bool(torch.isfinite(out).all())
    want = attention_plain(q, k, v, True, 5e-5)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-3 * want.float().abs().max().item(), rtol=0)
    for g, w in zip(flash_attention_grads(q, k, v, do, causal=True, scale=5e-5),
                    attention_grads_plain(q, k, v, do, True, 5e-5)):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), atol=2e-3 * w.float().abs().max().item(), rtol=0)


#: fp64: 1e-12 of the scale (fp64 sums, taken in another order than the
#: plain version's); the others as WIDE_TOL.  A gradient's scale is at least
#: that of dO times V, the size of dS's terms: at T = 1 dS is their
#: difference and the gradients cancel to rounding.
FP64_TOL = 1e-12


@pytest.mark.parametrize("shape,causal", [
    ((2, 70, 40), False), ((2, 70, 40), True), ((4, 200, 64), True), ((3, 1000, 64), False),
    ((2, 130, 128), False), ((1, 65, 128), True), ((2, 33, 130), True), ((2, 100, 256), False),
    ((2, 77, 384), True), ((3, 1, 64), False)])
def test_k2_k3_fp64_match_plain(cuda, shape, causal):
    """fp64 panels launch K2 and K3 (the fp64 tensor cores; the D split past
    128) and agree with the fp64 plain versions within 1e-12 of the scale,
    the lse too; two calls give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    q, k, v, do = (torch.randn(shape, device=cuda, generator=gen, dtype=torch.float64) for _ in range(4))
    scale = shape[-1] ** -0.5
    before = flash_attention.launches, flash_attention_grads.launches, flash_attention.plain_calls
    out, lse = flash_attention(q, k, v, causal=causal, scale=scale, with_lse=True)
    grads = flash_attention_grads(q, k, v, do, causal=causal, scale=scale)
    assert (flash_attention.launches, flash_attention_grads.launches) == (before[0] + 2, before[1] + 1)
    assert flash_attention.plain_calls == before[2]
    want, want_lse = attention_plain(q, k, v, causal, scale, with_lse=True)
    assert out.dtype == lse.dtype == torch.float64
    torch.testing.assert_close(out, want, atol=FP64_TOL * want.abs().max().item(), rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=FP64_TOL * want_lse.abs().max().item(), rtol=0)
    terms = do.abs().max().item() * v.abs().max().item()
    for g, w in zip(grads, attention_grads_plain(q, k, v, do, causal, scale)):
        assert g.dtype == torch.float64 and g.shape == shape
        torch.testing.assert_close(g, w, atol=FP64_TOL * max(w.abs().max().item(), terms), rtol=0)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal, scale=scale))
    for a, b in zip(grads, flash_attention_grads(q, k, v, do, causal=causal, scale=scale)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,causal", [((2, 100, 300), True), ((2, 130, 384), False), ((2, 70, 512), True),
                                          ((1, 64, 1024), False), ((2, 33, 520), True)])
def test_k2_k3_past_256_match_plain(cuda, shape, causal, dtype):
    """Heads wider than 256 take the D split and agree with the plain
    versions within WIDE_TOL of the scale; two calls give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    q, k, v, do = (torch.randn(shape, device=cuda, generator=gen).to(dtype) for _ in range(4))
    scale = shape[-1] ** -0.5
    before = flash_attention.launches, flash_attention_grads.launches
    out = flash_attention(q, k, v, causal=causal, scale=scale)
    grads = flash_attention_grads(q, k, v, do, causal=causal, scale=scale)
    assert (flash_attention.launches, flash_attention_grads.launches) == (before[0] + 2, before[1] + 1)
    tol = WIDE_TOL[dtype]
    want = attention_plain(q, k, v, causal, scale)
    torch.testing.assert_close(out.float(), want.float(), atol=tol * want.float().abs().max().item(), rtol=0)
    for g, w in zip(grads, attention_grads_plain(q, k, v, do, causal, scale)):
        assert g.dtype == dtype and g.shape == shape and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), atol=tol * w.float().abs().max().item(), rtol=0)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal, scale=scale))
    for a, b in zip(grads, flash_attention_grads(q, k, v, do, causal=causal, scale=scale)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,D", [(torch.float32, 512), (torch.bfloat16, 512), (torch.float16, 768),
                                     (torch.float64, 256), (torch.float64, 384)])
def test_the_d_split_gives_every_chunk_the_same_p(cuda, dtype, D):
    """Each chunk of the D split recomputes the scores over the whole of D
    in one order: with V's (and dO's, K's, Q's) chunks equal, the output's
    and the gradients' chunks are equal bit for bit."""
    chunk = 128 if dtype == torch.float64 else 256
    gen = torch.Generator(device=cuda).manual_seed(14)
    half = [torch.randn((2, 90, chunk), device=cuda, generator=gen).to(dtype) for _ in range(4)]
    q, k, v, do = (t.repeat(1, 1, D // chunk) for t in half)
    out = flash_attention(q, k, v, causal=True, scale=0.05)
    grads = flash_attention_grads(q, k, v, do, causal=True, scale=0.05)
    for t in (out, *grads):
        first = t[..., :chunk]
        for c in range(1, D // chunk):
            assert torch.equal(t[..., c * chunk:(c + 1) * chunk], first)


@pytest.mark.parametrize("dtype,shape", [("float16", (4, 200, 64)), ("float32", (2, 130, 256)),
                                         ("bfloat16", (2, 130, 160))])
def test_fused_attention_compiled_through_function_on_the_card(cuda, dtype, shape):
    """A causal FusedAttention graph and its gradient, compiled through
    ``function()``: K2 and K3 on the card, the CPU's values."""
    q, k, v = (pt.tensor3(n, dtype=dtype) for n in "qkv")
    out = pt.fused_attention(q, k, v, causal=True)
    cost = ptm.sum(out * out)
    gen = torch.Generator().manual_seed(11)
    args = [torch.randn(shape, generator=gen).to(getattr(torch, dtype)) for _ in range(3)]
    results = []
    for device in ("cuda", "cpu"):
        mode = ptp.Mode(ptp.TorchLinker(device=device))
        f = ptp.function([q, k, v], [out] + ptp.grad(cost, [q, k, v]), mode=mode)
        before = flash_attention.launches, flash_attention_grads.launches
        results.append([r.float().cpu() for r in f(*[a.to(device) for a in args])])
        if device == "cuda":
            assert flash_attention.launches > before[0] and flash_attention_grads.launches == before[1] + 1
    # twice the kernels' tolerance: the gradient takes K2's output through K3
    tol = 2 * WIDE_TOL[getattr(torch, dtype)]
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, atol=tol * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("src", ["float32", "float64", "float16", "bfloat16"])
def test_k1_float_to_integer_casts_saturate_as_the_plain_form(cuda, src):
    """K1's cast of ``x * 2`` to every integer width at the edges (past the
    bounds, NaN, the infinities, fractions either side) equals the plain
    form's: saturated, NaN as 0."""
    edges = [300.0, -1.9, 3e9, float("nan"), float("inf"), float("-inf"), -300.0, 1e19, 2e19, -3e9, 127.9,
             -128.9, 255.5, 65535.7, 1e30, 0.0, -0.0, 0.99, -0.99, 2147483520.0, 4294967040.0]
    xt = torch.tensor(edges, dtype=getattr(torch, src))
    for dst in ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64"):
        x = pt.vector("x", dtype=src)
        y = pt.cast(x * np.asarray(2.0, dtype="float32" if src == "bfloat16" else src), dst)
        node = _composite_node(ptp.function([x], y))
        kernel = ElemwiseKernel(node.op.scalar_op, [src], dst)
        before = fused_elemwise.launches
        got = fused_elemwise(kernel, xt.to(cuda)).cpu()
        assert fused_elemwise.launches == before + 1
        want = composite_plain(node.op.scalar_op, dst, xt)
        assert torch.equal(got, want), (src, dst, got.tolist(), want.tolist())


@pytest.mark.parametrize("shrink", [1e-2, 1e-3])
def test_k3_fp16_keeps_small_output_gradients(cuda, shrink):
    """A loss's dS is often below fp16's normal range (6.1e-5): at dO of
    1e-3, over 300 keys, dS is about 3e-5 while dQ, dK and dV stay normal.
    K3 scales dS by a power of two before its hi + lo split, so they keep
    the plain version's values (which hold dS in fp32) within 2e-3 of
    their scale."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    q, k, v, do = (torch.randn((4, 300, 64), device=cuda, generator=gen) for _ in range(4))
    q, k, v, do = q.half(), k.half(), v.half(), (do * shrink).half()
    assert bool((do != 0).any())
    for causal in (False, True):
        for g, w in zip(flash_attention_grads(q, k, v, do, causal=causal),
                        attention_grads_plain(q, k, v, do, causal, 0.125)):
            scale = w.float().abs().max().item()
            assert scale > 0
            torch.testing.assert_close(g.float(), w.float(), atol=2e-3 * scale, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,v_size", [(64, 32768.0), (256, 8192.0)])
def test_k3_fp16_keeps_large_ds_finite(cuda, d, v_size, causal):
    """dS is dO times V: at dO of 2**-10 (which puts K3's starting scale of
    dS at 2**10) and |V| in the thousands, over 8 keys of nearly equal
    scores, |dS| reaches a few hundred, and 2**10 times that passes fp16's
    65,504.  K3 lowers a row's scale where a tile's dS would pass 2**14, so
    dQ, dK and dV stay finite and the plain version's (which holds dS in
    fp32) within 2e-3 of their scale."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    shape = (4, 8, d)
    q = torch.randn(shape, device=cuda, generator=gen).half()
    k = (0.01 * torch.randn(shape, device=cuda, generator=gen)).half()
    sign = torch.where(torch.rand((4, 8, 1), device=cuda, generator=gen) < 0.5, -1.0, 1.0)
    v = (v_size * sign * (1 + 0.01 * torch.randn(shape, device=cuda, generator=gen))).half()
    do = torch.full(shape, 2.0**-10, device=cuda).half()
    scale = d ** -0.5
    s = (q.float() @ k.float().transpose(1, 2)) * scale
    if causal:
        s = s.masked_fill(torch.ones(8, 8, dtype=torch.bool, device=cuda).triu(1), float("-inf"))
    p = s.softmax(-1)
    ds = p * (do.float() @ v.float().transpose(1, 2) - (do.float() * (p @ v.float())).sum(-1, keepdim=True))
    assert 2.0**10 * ds.abs().max().item() > 4 * 65504
    for g, w in zip(flash_attention_grads(q, k, v, do, causal=causal, scale=scale),
                    attention_grads_plain(q, k, v, do, causal, scale)):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), atol=2e-3 * w.float().abs().max().item(), rtol=0)


# -- the user API's core ops (-k core_ops) ------------------------------------------

def _core_op_functions():
    """Functions of the core ops at small sizes: (label, build(inputs) ->
    outputs, input values)."""
    rng = np.random.default_rng(11)
    x, n = rng.normal(size=(37, 29)).astype("float32"), rng.normal(size=(3, 41, 17)).astype("float32")
    index = rng.integers(-1, 5, size=(6, 29)).astype("int64")
    choices = rng.normal(size=(4, 6, 29)).astype("float32")
    perms = np.argsort(rng.random((6, 29)), axis=1).astype("int64")
    return [
        ("diagonal", lambda m: [m.diagonal(), m.diagonal(-3), m.trace(), pt.eye(m.shape[0], m.shape[1], 2),
                                ptp.grad((m.diagonal(1) ** 2).sum() + m.diagonal(-2).sum(), m)], [x]),
        ("eye_tri", lambda m: [pt.eye(9, 7, -1), pt.tril(m, 1), pt.triu(m, -2), pt.diag(m[0])], [x]),
        ("nonzero", lambda m: list((m > 0.5).nonzero()) + [m.nonzero_values(), pt.flatnonzero(m < -1)], [x]),
        ("choose", lambda a, c: [a.choose(c), pt.choose(a, c, mode="wrap")], [index, choices]),
        ("permute", lambda r, p: [pt.permute_row_elements(r, p), pt.permute_row_elements(r, p, inverse=True),
                                  pt.inverse_permutation(p)], [x[:6], perms]),
        ("shape_helpers", lambda c: [pt.roll(c, 5), pt.roll(c, -1, axis=0), pt.tile(c, (2, 1, 3)), c.flatten(2),
                                     pt.swapaxes(c, 0, 2), pt.expand_dims(c, 1)], [n]),
    ]


@pytest.mark.parametrize("label", [c[0] for c in _core_op_functions()])
def test_core_ops_on_the_card_are_the_cpus_bitwise(cuda, label):
    """Each core op of the user API on the card against the same function
    on the CPU, bitwise (they move data; the trace sums, within 1e-5)."""
    _, build, values = next(c for c in _core_op_functions() if c[0] == label)
    outs = []
    for device in ("cpu", "cuda"):
        with config.change_flags(device=device):
            ins = [pt.TensorType(str(v.dtype), (None,) * v.ndim)(f"i{k}") for k, v in enumerate(values)]
            f = ptp.function(ins, build(*ins))
            outs.append([[o.cpu().numpy() for o in f(*values)] for _ in range(3)])
    for call_cpu, call_card in zip(*outs):
        for a, b in zip(call_card, call_cpu):
            assert a.dtype == b.dtype and a.shape == b.shape
            if a.ndim == 0 and label == "diagonal":
                np.testing.assert_allclose(a, b, rtol=1e-5)
            else:
                np.testing.assert_array_equal(a, b)


def test_an_output_viewing_an_updated_shared_variable_on_the_card(cuda):
    with config.change_flags(device="cuda"):
        w = ptp.shared(np.arange(16.0, dtype="float32").reshape(4, 4))
        f = ptp.function([], [w.diagonal(), w.T], updates={w: w * 2})
        for k in range(4):
            d, t = (v.cpu().numpy() for v in f())
            np.testing.assert_array_equal(d, np.array([0.0, 5.0, 10.0, 15.0]) * 2.0 ** k)
            np.testing.assert_array_equal(t, np.arange(16.0).reshape(4, 4).T * 2.0 ** k)
        assert f.captured


# -- the graph core's fancy indexing (-k graph_core) ---------------------------------


def test_graph_core_mask_set_is_captured_on_the_card(cuda):
    """set_subtensor(x[x < 0], 0) is a torch.where: the step captures, and
    its replays equal the CPU's bitwise."""
    x = np.random.default_rng(0).normal(size=(64, 33)).astype("float32")
    outs = []
    for device in ("cpu", "cuda"):
        with config.change_flags(device=device):
            xv = pt.matrix("x")
            f = ptp.function([xv], pt.set_subtensor(xv[xv < 0], 0.0))
            outs.append([f(x).cpu().numpy() for _ in range(3)])
            if device == "cuda":
                assert f.captured and f.capture_blocker is None
    for a in outs[1]:
        np.testing.assert_array_equal(a, outs[0][0])


def test_graph_core_eager_blockers_are_named_on_the_card(cuda):
    """A mask read from data and a slice bound from data run eagerly and name
    their blockers; their results equal the CPU's bitwise."""
    x = np.random.default_rng(1).normal(size=(40, 9)).astype("float32")
    for build, why in ((lambda v: v[v > 0.5], "boolean mask computed from data"),
                       (lambda v: v[: (v[:, 0] > 0).sum()], "slice bound computed from data")):
        outs = []
        for device in ("cpu", "cuda"):
            with config.change_flags(device=device):
                xv = pt.matrix("x")
                f = ptp.function([xv], build(xv))
                outs.append([f(x).cpu().numpy() for _ in range(2)])
                if device == "cuda":
                    assert why in f.capture_blocker and not f.captured
        for a in outs[1]:
            np.testing.assert_array_equal(a, outs[0][0])


@pytest.mark.parametrize("holder", ["scan", "op_from_graph"])
@pytest.mark.parametrize("body", ["mask", "bound"])
def test_graph_core_inner_graph_blockers_run_eagerly_on_the_card(cuda, body, holder):
    """A mask or a slice bound from data inside a Scan's body or an
    OpFromGraph's subgraph: the outer function runs eagerly (no capture
    of the per-step host read), names the inner node as its blocker, and
    its results equal the CPU's within 1e-6 (the sums' order)."""
    read, why = {"mask": (lambda r: r[r > 0].sum(), "boolean mask computed from data"),
                 "bound": (lambda r: r[: (r > 0).sum()].sum(), "slice bound computed from data")}[body]
    x = np.random.default_rng(3).normal(size=(24, 33)).astype("float32")
    outs = []
    for device in ("cpu", "cuda"):
        with config.change_flags(device=device):
            xv = pt.matrix("x")
            if holder == "scan":
                out, _ = ptp.scan(read, sequences=[xv])
            else:
                r = pt.vector("r")
                out = ptp.OpFromGraph([r], [read(r)])(xv[1])
            f = ptp.function([xv], out)
            outs.append([f(x).cpu().numpy() for _ in range(3)])
            if device == "cuda":
                assert not f.captured
                assert "in its inner graph" in f.capture_blocker and why in f.capture_blocker, f.capture_blocker
    for a in outs[1]:
        np.testing.assert_allclose(a, outs[0][0], rtol=1e-6, atol=1e-6)


def test_graph_core_inc_with_duplicates_is_the_same_bits_twice(cuda):
    """inc_subtensor(x[:, cols], y) with duplicated columns: two calls on the
    card give the same bits, and the CPU's sums within 1e-6."""
    r = np.random.default_rng(2)
    x = r.normal(size=(512, 96)).astype("float32")
    cols = r.integers(0, 96, size=64)
    y = r.normal(size=(512, 64)).astype("float32")
    outs = []
    for device in ("cpu", "cuda"):
        with config.change_flags(device=device):
            xv, yv, cv = pt.matrix("x"), pt.matrix("y"), pt.lvector("c")
            f = ptp.function([xv, yv, cv], pt.inc_subtensor(xv[:, cv], yv))
            outs.append([f(x, y, cols).cpu().numpy() for _ in range(2)])
    np.testing.assert_array_equal(outs[1][0], outs[1][1])
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_donation_on_and_off_give_the_same_bits_on_the_card(cuda, optimizer):
    """A small encoder's step compiled twice from the same seeds,
    ``donate_updated`` on and off: 4 calls (eager, captured, replayed) give
    the same bits, the updated variables keep their storage, and with it on
    the nodes that compute the updates write into it."""
    runs = {}
    for donate in (True, False):
        with config.change_flags(device="cuda"):
            layers = [TransformerEncoderLayer(64, 4, 128, seed=i) for i in range(2)]
            params = [p for layer in layers for p in layer.params]
            h = ptp.shared(np.random.default_rng(5).normal(size=(2, 48, 64)).astype("float32"), name="x")
            for layer in layers:
                h = layer(h)
            loss = ptm.mean(ptm.sqr(h))
            updates = sgd(loss, params, lr=0.01) if optimizer == "sgd" else adamw(loss, params, lr=1e-3)
            step = ptp.function([], loss, updates=updates,
                                mode=ptp.Mode(ptp.TorchLinker(device="cuda", donate_updated=donate)))
        targets = list(step.update_targets)
        ptrs = [t.value.data_ptr() for t in targets]
        trace = []
        for _ in range(4):
            trace.append([step().clone()] + [t.value.clone() for t in targets])
        assert step.captured and [t.value.data_ptr() for t in targets] == ptrs
        runs[donate] = (trace, len(step.fn.program.donated), len(targets))
    assert runs[True][1] == runs[True][2] and runs[False][1] == 0
    for a, b in zip(runs[True][0], runs[False][0]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
