"""Kernel tests that need the card: each hand-written kernel against its
plain PyTorch version on CUDA tensors, and a small encoder forward and
train step on the card against the CPU.  They skip where there is no CUDA
device; run them on a GPU machine with
``python -m pytest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import aesara_tpu_torch as ptp
import aesara_tpu_torch.tensor as pt
from aesara_tpu_torch.config import config
from aesara_tpu_torch.link.torch.kernels.attention import (
    attention_grads_plain, attention_plain, flash_attention, flash_attention_grads,
)
from aesara_tpu_torch.link.torch.kernels.elemwise import (
    ElemwiseKernel, composite_plain, fused_elemwise,
)
from aesara_tpu_torch.models.optim import sgd
from aesara_tpu_torch.models.transformer import TransformerEncoderLayer
from aesara_tpu_torch.tensor import math as ptm

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


@pytest.mark.parametrize("shape,causal,dtype", [
    ((4, 96, 64), False, torch.float32), ((2, 130, 40), True, torch.float32),
    ((3, 200, 128), True, torch.bfloat16)])
def test_k2_kernel_matches_plain(cuda, shape, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(shape, device=cuda, generator=gen).to(dtype) for _ in range(3))
    before = flash_attention.launches
    got, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
    assert flash_attention.launches == before + 1
    want, want_lse = attention_plain(q, k, v, causal, shape[-1] ** -0.5, with_lse=True)
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)


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
    ((3, 200, 128), True, torch.bfloat16), ((2, 70, 96), False, torch.bfloat16)])
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
