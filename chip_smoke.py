"""Drive the PyTorch port on one NVIDIA GPU: build its kernels, check each
against its plain PyTorch version, serve a few requests of the flagship
encoder forward, then train the same encoder for a few steps, all
through ``aesara_tpu_torch.function``.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):

0. setup: a CUDA device is required; prints the card's name and power
   limit; builds the flash-attention forward (K2) and backward (K3)
   kernels with nvcc for sm_90a, both at once, and compiles one
   fused-elemwise kernel (K1) with Triton.
1. kernels: K1 and K2 against their plain versions on the card, at the
   shapes the forward gives them, with the times of both.
2. forward: the 4-layer encoder (d_model 1024, 16 heads, d_ff 4096,
   float32, random weights from seeds) compiled with the TORCH mode on
   the card answers 3 requests of (8, 1024, 1024); the kernels' launch
   counts show the forward went through them, and one sequence is held
   against the same graph compiled for the CPU.
3. train kernels: K1 on the train step's Composites and K3 against their
   plain versions on the card, with the times of both.
4. train: the train step of the same encoder (symbolic ``grad``, ``sgd``
   updates of the shared parameters, ``x`` a shared (8, 1024, 1024)
   tensor on the card, as ``benchmarks/bench_transformer.py:26-67``
   builds it) takes 3 steps; the launch counts show every step went
   through K1, K2 (forward and K3's recompute) and K3, and the loss falls
   below the first step's.
   Then 10 steps are timed back to back and one is profiled.  The same
   step at batch 1 on the card and on the CPU agrees after one step.

The next-to-last line is a JSON object describing the kernels, with the
launch counts of the train steps; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_LAYERS, D_MODEL, N_HEADS, D_FF = 4, 1024, 16, 4096
BATCH, SEQ = 8, 1024
N_REQUESTS = 3
N_COMPOSITE = 5 * N_LAYERS + 1   # see check_graph
N_COMPOSITE_TRAIN = 98           # see check_train_graph
N_TRAIN_STEPS, N_TIMED_STEPS, LR = 3, 10, 0.01
F32_ATOL = 1e-4          # fp32 kernels against fp32 plain versions
BF16_REL = 2e-2          # bf16 error relative to the output's scale
K3_ATOL, K3_RTOL = 5e-4, 1e-3   # fp32 K3: the JAX package's own bound for its backward
SLICE_TOL = 1e-3         # card against CPU after 4 layers (reduction order)
TRAIN_TOL = 1e-4         # card against CPU after one train step (reduction order)

K1_SOURCE = "aesara_tpu_torch/link/torch/kernels/elemwise.py"
K2_SOURCE = "aesara_tpu_torch/link/torch/kernels/csrc/flash_fwd.cu"
K3_SOURCE = "aesara_tpu_torch/link/torch/kernels/csrc/flash_bwd.cu"
K1_REPLACES = "aesara_tpu/link/jax/pallas_kernels.py:38"
K2_REPLACES = "aesara_tpu/link/jax/pallas_kernels.py:205"
K3_REPLACES = "aesara_tpu/link/jax/pallas_kernels.py:403"


def log(*args):
    print(*args, flush=True)


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one call of ``fn`` by CUDA events around it.  For a
    short kernel this is bounded by the host's launch cost, not by the
    device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_split(fn, reps: int = 20, warmup: int = 3) -> dict:
    """Device time of one call of ``fn`` by kernel name: the summed
    duration of the kernels (and copies) it runs on the card, by
    torch.profiler (CUPTI), averaged over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise RuntimeError("the profiler saw no device activity")
    by_name: dict = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / reps / 1e3
    return by_name


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` (see ``device_split``)."""
    return sum(device_split(fn, reps, warmup).values())


def build_encoder(device: str):
    import aesara_tpu_torch.tensor as pt
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.models.transformer import TransformerEncoderLayer
    from aesara_tpu_torch.tensor import math as tm

    with config.change_flags(device=device, floatX="float32"):
        layers = [TransformerEncoderLayer(D_MODEL, N_HEADS, D_FF, seed=i) for i in range(N_LAYERS)]
    x = pt.tensor3("x")
    h = x
    for layer in layers:
        h = layer(h)
    return layers, x, [h, tm.mean(tm.sqr(h))]


def compile_encoder(device: str):
    import aesara_tpu_torch as ptp

    _, x, outs = build_encoder(device)
    return ptp.function([x], outs, mode=ptp.Mode(ptp.TorchLinker(device=device)))


def composite_nodes(fgraph):
    from aesara_tpu_torch.scalar.composite import Composite

    return [n for n in fgraph.toposort() if isinstance(getattr(n.op, "scalar_op", None), Composite)]


def guarded_inputs(comp):
    """Indices of the Composite's inputs that reach a sqrt's argument or a
    divisor; only these need positive values."""
    from aesara_tpu_torch.scalar.ops import Sqrt, TrueDiv

    guarded = set()
    for node in reversed(comp.nodes):
        if isinstance(node.op, Sqrt):
            guarded.add(node.inputs[0])
        elif isinstance(node.op, TrueDiv):
            guarded.add(node.inputs[1])
        if any(o in guarded for o in node.outputs):
            guarded.update(node.inputs)
    return {i for i, var in enumerate(comp.inputs) if var in guarded}


def composite_inputs(node, rng, device):
    """Test values for one Composite node at full width: static-1 dims stay
    1 (they broadcast), unknown dims become (B, T, d_model).  Inputs that
    reach a sqrt or a divisor are positive; the others take both signs, so
    ``maximum(., 0)`` takes both of its branches."""
    guarded = guarded_inputs(node.op.scalar_op)
    out = []
    for i, var in enumerate(node.inputs):
        full = (BATCH, SEQ, D_MODEL)
        shape = tuple(s if s is not None else full[d] for d, s in enumerate(var.type.shape))
        if var.type.dtype.startswith("int"):
            arr = rng.integers(1, 100, size=shape).astype(var.type.dtype)
        elif i in guarded:
            arr = rng.uniform(0.5, 2.0, size=shape).astype(var.type.dtype)
        else:
            arr = rng.normal(size=shape).astype(var.type.dtype)
        out.append(torch.as_tensor(arr, device=device))
    return out


def phase_setup():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    if importlib.util.find_spec("aesara_tpu_torch") is None:
        raise SystemExit("chip_smoke: the package aesara_tpu_torch is not here; run this script "
                         "from the root of a checkout of the repo")
    # Dot is a full-fp32 product, as in the JAX reference; the linker refuses TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"card: {smi}; python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    from aesara_tpu_torch.link.torch.kernels.attention import _library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:      # one nvcc per source, started together
        list(pool.map(_library, ["flash_fwd", "flash_bwd"]))
    log(f"K2 + K3 nvcc builds + load: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    warm_k1()
    log(f"K1 Triton compile + first launch (bias+ReLU Composite): {time.perf_counter() - t0:.2f} s")
    return smi


def warm_k1():
    """Compile and launch one generated K1 kernel on a small input."""
    import aesara_tpu_torch as ptp
    from aesara_tpu_torch.link.torch.kernels.elemwise import fused_elemwise
    from aesara_tpu_torch.tensor import math as tm
    from aesara_tpu_torch.tensor.type import TensorType

    y = TensorType("float32", (None, None, None))("y")
    b = TensorType("float32", (1, 1, None))("b")
    fn = ptp.function([y, b], tm.maximum(tm.add(y, b), 0.0),
                      mode=ptp.Mode(ptp.TorchLinker(device="cuda")))
    before = fused_elemwise.launches
    out = fn(np.ones((2, 3, 4), "float32"), -np.ones((1, 1, 4), "float32"))
    torch.cuda.synchronize()
    if fused_elemwise.launches != before + 1 or float(out.abs().max()) != 0.0:
        raise AssertionError("K1 warm-up did not launch or gave a wrong result")


def phase_k1(fgraph, rng):
    """K1 on each distinct Composite of ``fgraph`` against its plain
    version: (max abs err, (ms, plain ms) of the first full-width
    Composite of more than two ops, or None)."""
    from aesara_tpu_torch.link.torch.kernels.elemwise import (
        ElemwiseKernel, composite_plain, fused_elemwise,
    )

    device = torch.device("cuda")
    k1_err, k1_times = 0.0, None
    distinct = []
    for node in composite_nodes(fgraph):
        if node.op not in [n.op for n in distinct]:
            distinct.append(node)
    for node in distinct:
        comp = node.op.scalar_op
        out_dtype = node.outputs[0].type.dtype
        kernel = ElemwiseKernel(comp, [v.type.dtype for v in node.inputs], out_dtype)
        args = composite_inputs(node, rng, device)
        t0 = time.perf_counter()
        got = fused_elemwise(kernel, *args)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        want = composite_plain(comp, out_dtype, *args)
        err = (got.double() - want.double()).abs().max().item()
        if not err <= F32_ATOL or got.shape != want.shape:
            raise AssertionError(f"K1 {comp} {tuple(got.shape)}: max err {err} > {F32_ATOL}")
        ms = device_ms(lambda: fused_elemwise(kernel, *args))
        plain_ms = device_ms(lambda: composite_plain(comp, out_dtype, *args))
        call, plain_call = (call_ms(lambda: fused_elemwise(kernel, *args)),
                            call_ms(lambda: composite_plain(comp, out_dtype, *args)))
        k1_err = max(k1_err, err)
        shapes = [tuple(a.shape) for a in args]
        log(f"K1 {comp} inputs {shapes} -> {tuple(got.shape)}: max_abs_err {err:.3e}, "
            f"device ms kernel {ms:.4f} plain {plain_ms:.4f}; per call ms kernel {call:.4f} "
            f"plain {plain_call:.4f}; first call {compile_s:.2f} s")
        if tuple(got.shape) == (BATCH, SEQ, D_MODEL) and len(comp.nodes) > 2 and k1_times is None:
            k1_times = (ms, plain_ms)
    return k1_err, k1_times


def phase_kernels(fgraph):
    from aesara_tpu_torch.link.torch.kernels.attention import attention_plain, flash_attention

    log(f"tolerances: fp32 max_abs_err <= {F32_ATOL}; bf16 <= {BF16_REL} x max|plain|; "
        f"lse <= {F32_ATOL}")

    rng = np.random.default_rng(0)
    device = torch.device("cuda")
    k1_err, k1_times = phase_k1(fgraph, rng)   # k1_times: the layer-norm scale Composite
    if k1_times is None:
        raise AssertionError("no layer-norm scale Composite among the forward's Composites")

    k2_err, k2_times = 0.0, None
    gen = torch.Generator(device=device).manual_seed(0)
    cases = [((128, 1024, 64), False, torch.float32), ((128, 1024, 64), True, torch.float32),
             ((128, 1024, 64), False, torch.bfloat16), ((128, 1024, 64), True, torch.bfloat16),
             ((6, 1000, 40), True, torch.float32)]
    for shape, causal, dtype in cases:
        q, k, v = (torch.randn(shape, device=device, generator=gen).to(dtype) for _ in range(3))
        scale = 1.0 / shape[-1] ** 0.5
        got, lse = flash_attention(q, k, v, causal=causal, scale=scale, with_lse=True)
        torch.cuda.synchronize()
        want, want_lse = attention_plain(q, k, v, causal, scale, with_lse=True)
        err = (got.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        if dtype == torch.float32:
            ok = err <= F32_ATOL and lse_err <= F32_ATOL
            k2_err = max(k2_err, err)
        else:
            ok = err <= BF16_REL * want.float().abs().max().item() and lse_err <= F32_ATOL
        if not ok:
            raise AssertionError(f"K2 {shape} causal={causal} {dtype}: max err {err}, lse err {lse_err}")
        ms = device_ms(lambda: flash_attention(q, k, v, causal=causal, scale=scale))
        plain_ms = device_ms(lambda: attention_plain(q, k, v, causal, scale))
        call = call_ms(lambda: flash_attention(q, k, v, causal=causal, scale=scale))
        log(f"K2 {shape} causal={causal} {str(dtype).split('.')[-1]}: max_abs_err {err:.3e}, "
            f"lse_err {lse_err:.3e}, device ms kernel {ms:.4f} plain {plain_ms:.4f}; "
            f"per call ms kernel {call:.4f}")
        if shape == (128, 1024, 64) and not causal and dtype == torch.float32:
            k2_times = (ms, plain_ms)
    return k1_err, k1_times, k2_err, k2_times


def check_graph(fgraph):
    """The rewritten forward holds the fused nodes the kernels serve: per
    layer two layer-norm centres, two layer-norm scales and one bias+ReLU,
    plus the tail of ``mean``; and one FusedAttention per layer."""
    n_composite = len(composite_nodes(fgraph))
    n_attention = sum(type(n.op).__name__ == "FusedAttention" for n in fgraph.toposort())
    log(f"slice graph: {len(fgraph.toposort())} nodes, {n_composite} Composite, "
        f"{n_attention} FusedAttention")
    if n_composite != N_COMPOSITE or n_attention != N_LAYERS:
        raise AssertionError(f"{n_composite} Composite and {n_attention} FusedAttention nodes, "
                             f"expected {N_COMPOSITE} and {N_LAYERS}")


def phase_slice(fn):
    from aesara_tpu_torch.link.torch.kernels.attention import flash_attention
    from aesara_tpu_torch.link.torch.kernels.elemwise import fused_elemwise

    requests = [np.random.default_rng(100 + r).normal(size=(BATCH, SEQ, D_MODEL)).astype("float32")
                for r in range(N_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in (fused_elemwise, flash_attention):
        counter.launches = 0
        counter.plain_calls = 0
    results, latencies = [], []
    for x in requests:
        t0 = time.perf_counter()
        h, msq = fn(x)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        results.append((h, msq))
    launches = {"K1": fused_elemwise.launches, "K2": flash_attention.launches}
    plain = fused_elemwise.plain_calls + flash_attention.plain_calls
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"request latency ms: {[round(t, 3) for t in latencies]} (first includes kernel compiles)")
    log(f"peak device memory: {peak_gib:.3f} GiB; launches {launches}; plain calls {plain}")
    if launches["K1"] != N_COMPOSITE * N_REQUESTS or launches["K2"] != N_LAYERS * N_REQUESTS:
        raise AssertionError(f"launch counts {launches}, expected K1 {N_COMPOSITE * N_REQUESTS}, "
                             f"K2 {N_LAYERS * N_REQUESTS}")
    if plain != 0:
        raise AssertionError(f"{plain} calls of a plain version on the card")
    for h, msq in results:
        if not (h.is_cuda and msq.is_cuda and tuple(h.shape) == (BATCH, SEQ, D_MODEL)
                and h.dtype == torch.float32 and bool(torch.isfinite(h).all())
                and bool(torch.isfinite(msq))):
            raise AssertionError("slice output not finite float32 (8, 1024, 1024) on cuda")
    return requests, results, launches


def profile_request(fn, x):
    """Device busy time and its split by kernel for one request whose
    input already lies on the card."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.as_tensor(x, device="cuda")
    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    by_name: dict = {}
    for e in device:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    log(f"profiled request (input on the card): wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f}%)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {ms:8.3f} ms  {name}")
    t0 = time.perf_counter()
    fn(x)
    enqueue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fn(x)
    torch.cuda.synchronize()
    log(f"host time to enqueue one request: {enqueue:.3f} ms; 10 requests back to back: "
        f"{(time.perf_counter() - t0) * 1e2:.3f} ms each")


def steady_latency(fn, requests, n: int = 12):
    """Host-clock latency of ``n`` more requests from NumPy, each ending in
    a synchronise: (median, first quartile, third quartile) in ms."""
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(requests[i % len(requests)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return statistics.median(times), times[n // 4], times[(3 * n) // 4]


def check_against_cpu(requests, results):
    fn_cpu = compile_encoder("cpu")
    h_cpu, _ = fn_cpu(requests[0][:1])
    h_gpu = results[0][0][:1].cpu()
    err = (h_gpu.double() - h_cpu.double()).abs().max().item()
    log(f"request 1, sequence 1: card vs CPU max_abs_err {err:.3e}")
    torch.testing.assert_close(h_gpu, h_cpu, atol=SLICE_TOL, rtol=SLICE_TOL)


def build_train_step(device: str, batch: int = BATCH):
    """The flagship train step: the 4-layer encoder on a shared ``x``
    (normal × 0.1 from a seed, its first ``batch`` sequences), loss
    mean(h²), ``sgd`` updates of every parameter, the loss returned on
    the card (``Out(borrow=True)``)."""
    import aesara_tpu_torch as ptp
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.models.optim import sgd
    from aesara_tpu_torch.models.transformer import TransformerEncoderLayer
    from aesara_tpu_torch.tensor import math as tm

    xv = (np.random.default_rng(200).normal(size=(BATCH, SEQ, D_MODEL)) * 0.1).astype("float32")
    with config.change_flags(device=device, floatX="float32"):
        layers = [TransformerEncoderLayer(D_MODEL, N_HEADS, D_FF, seed=i) for i in range(N_LAYERS)]
        x = ptp.shared(xv[:batch], name="x")
    h = x
    for layer in layers:
        h = layer(h)
    loss = tm.mean(tm.sqr(h))
    params = [p for layer in layers for p in layer.params]
    step = ptp.function([], ptp.Out(loss, borrow=True), updates=sgd(loss, params, lr=LR),
                        mode=ptp.Mode(ptp.TorchLinker(device=device)))
    return step, params


def check_train_graph(fgraph):
    """The rewritten train step holds one FusedAttention and one
    FusedAttentionGrad per layer, and the Composites K1 serves (24 per
    layer, 2 more for the loss)."""
    nodes = fgraph.toposort()
    n_composite = len(composite_nodes(fgraph))
    n_grad = sum(type(n.op).__name__ == "FusedAttentionGrad" for n in nodes)
    n_attention = sum(type(n.op).__name__ == "FusedAttention" for n in nodes)
    log(f"train graph: {len(nodes)} nodes, {n_composite} Composite "
        f"({len({n.op for n in composite_nodes(fgraph)})} distinct), {n_attention} FusedAttention, "
        f"{n_grad} FusedAttentionGrad")
    if (n_composite, n_attention, n_grad) != (N_COMPOSITE_TRAIN, N_LAYERS, N_LAYERS):
        raise AssertionError(f"{n_composite} Composite, {n_attention} FusedAttention and {n_grad} "
                             f"FusedAttentionGrad nodes, expected {N_COMPOSITE_TRAIN}, {N_LAYERS}, "
                             f"{N_LAYERS}")


def phase_k3():
    """K3 against its plain version on the card: (fp32 max abs err,
    (ms, plain ms) at the flagship shape, fp32, non-causal)."""
    from aesara_tpu_torch.link.torch.kernels.attention import (
        attention_grads_plain, flash_attention_grads,
    )

    log(f"K3 tolerances: fp32 |err| <= {K3_ATOL} + {K3_RTOL} x |plain|; "
        f"bf16 <= {BF16_REL} x max|plain|")
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(1)
    k3_err, k3_times = 0.0, None
    cases = [((128, 1024, 64), False, torch.float32), ((128, 1024, 64), True, torch.float32),
             ((128, 1024, 64), False, torch.bfloat16), ((128, 1024, 64), True, torch.bfloat16),
             ((6, 1000, 40), True, torch.float32)]
    for shape, causal, dtype in cases:
        q, k, v, do = (torch.randn(shape, device=device, generator=gen).to(dtype) for _ in range(4))
        scale = 1.0 / shape[-1] ** 0.5
        got = flash_attention_grads(q, k, v, do, causal=causal, scale=scale)
        torch.cuda.synchronize()
        want = attention_grads_plain(q, k, v, do, causal, scale)
        errs = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"K3 {name} {tuple(g.shape)} {g.dtype}, plain {tuple(w.shape)} {w.dtype}")
            g, w = g.float(), w.float()
            err = (g - w).abs().max().item()
            if dtype == torch.float32:
                ok = bool(((g - w).abs() <= K3_ATOL + K3_RTOL * w.abs()).all())
                k3_err = max(k3_err, err)
            else:
                ok = err <= BF16_REL * w.abs().max().item()
            if not ok:
                raise AssertionError(f"K3 {shape} causal={causal} {dtype} {name}: max err {err}")
            errs.append(err)
        split = device_split(lambda: flash_attention_grads(q, k, v, do, causal=causal, scale=scale))
        ms = sum(split.values())
        bwd = sum(t for name, t in split.items() if "flash_bwd" in name)
        plain_ms = device_ms(lambda: attention_grads_plain(q, k, v, do, causal, scale))
        log(f"K3 {shape} causal={causal} {str(dtype).split('.')[-1]}: max_abs_err dq/dk/dv "
            f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, device ms kernel {ms:.4f} (backward "
            f"kernels {bwd:.4f}, K2 recompute {ms - bwd:.4f}) plain {plain_ms:.4f}")
        if shape == (128, 1024, 64) and not causal and dtype == torch.float32:
            k3_times = (ms, plain_ms)
    return k3_err, k3_times


def _counters():
    from aesara_tpu_torch.link.torch.kernels.attention import flash_attention, flash_attention_grads
    from aesara_tpu_torch.link.torch.kernels.elemwise import fused_elemwise

    return {"K1": fused_elemwise, "K2": flash_attention, "K3": flash_attention_grads}


def phase_train(step, params):
    """3 train steps with the launch counters set to 0 just before and
    read just after; the loss must be finite and fall below the first
    step's."""
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
        c.plain_calls = 0
    losses, times = [], []
    for _ in range(N_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    launches = {k: c.launches for k, c in counters.items()}
    plain = sum(c.plain_calls for c in counters.values())
    want = {"K1": N_COMPOSITE_TRAIN * N_TRAIN_STEPS, "K2": 2 * N_LAYERS * N_TRAIN_STEPS,
            "K3": N_LAYERS * N_TRAIN_STEPS}
    log(f"train step ms: {[round(t, 3) for t in times]} (first includes kernel compiles)")
    log(f"train launches {launches} (expected {want}); plain calls {plain}")
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if plain != 0:
        raise AssertionError(f"{plain} calls of a plain version on the card")
    for loss in losses:
        if not (loss.is_cuda and loss.shape == () and loss.dtype == torch.float32):
            raise AssertionError(f"loss {loss} is not a float32 scalar on the card")
    values = [float(v) for v in losses]
    log(f"train losses: {values}")
    # sgd at lr 0.01 overshoots on this objective at full width: on the
    # CPU at batch 1 the JAX package and the port both go 3.0427 ->
    # 1.7635 -> 1.8381, so the check is that every step's loss lies
    # below the first one's
    if not all(np.isfinite(values)) or not all(v < values[0] for v in values[1:]):
        raise AssertionError(f"loss not finite or not below the first step's: {values}")
    for p in params:
        if not (p.value.is_cuda and bool(torch.isfinite(p.value).all())):
            raise AssertionError(f"parameter {p.name} not finite on the card")
    return values, launches


def time_train(step):
    """Steps back to back (host clock around work that ends in a
    synchronise), peak memory, and one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_TIMED_STEPS):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / N_TIMED_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"full-width train step: {N_TIMED_STEPS} steps back to back {ms:.3f} ms each, "
        f"{BATCH * SEQ / ms * 1e3:.1f} tokens/s ({BATCH}x{SEQ} tokens a step); peak device "
        f"memory {peak:.3f} GiB")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    groups: dict = {}
    by_name: dict = {}
    for e in device:
        t = e.time_range.elapsed_us() / 1e3
        name = e.name
        group = ("K3 flash backward" if "flash_bwd" in name else "K2 flash forward" if "flash_fwd" in name
                 else "K1 fused Composite" if name == "kernel"
                 else "matmul" if "gemm" in name.lower() or "cutlass" in name.lower() else "other torch")
        groups[group] = groups.get(group, [0.0, 0])
        groups[group][0] += t
        groups[group][1] += 1
        by_name[name[:70]] = by_name.get(name[:70], 0.0) + t
    log(f"profiled train step: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f}%)")
    for group, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"  {t:9.3f} ms  {100 * t / busy:5.1f}%  {n:4d} launches  {group}")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {t:9.3f} ms  {name}")
    return ms, peak


def check_train_against_cpu():
    """One step at batch 1 from the same seeded weights on the card and
    on the CPU: the loss and every updated parameter agree."""
    step_gpu, params_gpu = build_train_step("cuda", batch=1)
    step_cpu, params_cpu = build_train_step("cpu", batch=1)
    loss_gpu, loss_cpu = step_gpu().cpu(), step_cpu()
    loss_err = abs(float(loss_gpu) - float(loss_cpu))
    param_err = 0.0
    for pg, pc in zip(params_gpu, params_cpu):
        got = pg.value.cpu()
        param_err = max(param_err, (got.double() - pc.value.double()).abs().max().item())
        torch.testing.assert_close(got, pc.value, atol=TRAIN_TOL, rtol=TRAIN_TOL)
    torch.testing.assert_close(loss_gpu, loss_cpu, atol=TRAIN_TOL, rtol=TRAIN_TOL)
    log(f"train step at batch 1, card vs CPU: loss {float(loss_gpu):.7f} vs {float(loss_cpu):.7f} "
        f"(abs err {loss_err:.3e}); max abs err over the {len(params_gpu)} updated parameters "
        f"{param_err:.3e} (tolerance {TRAIN_TOL})")


def main():
    smi = phase_setup()
    t0 = time.perf_counter()
    fn = compile_encoder("cuda")
    log(f"compile (graph + rewrites + link): {time.perf_counter() - t0:.2f} s")
    check_graph(fn.maker.fgraph)
    k1_err, k1_times, k2_err, k2_times = phase_kernels(fn.maker.fgraph)
    requests, results, launches = phase_slice(fn)
    profile_request(fn, requests[-1])
    check_against_cpu(requests, results)
    steady, q1, q3 = steady_latency(fn, requests)
    log(f"full-width forward, steady request latency over 12 more requests: median {steady:.3f} "
        f"ms, quartiles {q1:.3f} / {q3:.3f} ms ({BATCH}x{SEQ} tokens)")
    del fn, requests, results

    t0 = time.perf_counter()
    step, params = build_train_step("cuda")
    log(f"train step compile (graph + grad + rewrites + link): {time.perf_counter() - t0:.2f} s")
    check_train_graph(step.maker.fgraph)
    k1_train_err, _ = phase_k1(step.maker.fgraph, np.random.default_rng(1))
    k3_err, k3_times = phase_k3()
    _, train_launches = phase_train(step, params)
    time_train(step)
    del step, params
    check_train_against_cpu()
    kernels = [
        {"name": "K1 fused elemwise Composite", "route": "triton", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": train_launches["K1"],
         "max_abs_err": max(k1_err, k1_train_err), "ms": k1_times[0], "plain_ms": k1_times[1]},
        {"name": "K2 flash attention forward", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": train_launches["K2"], "max_abs_err": k2_err,
         "ms": k2_times[0], "plain_ms": k2_times[1]},
        {"name": "K3 flash attention backward", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": train_launches["K3"], "max_abs_err": k3_err,
         "ms": k3_times[0], "plain_ms": k3_times[1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
