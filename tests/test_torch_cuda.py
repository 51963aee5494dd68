"""Kernel tests that need the card: each hand-written kernel against its
plain PyTorch version on CUDA tensors, and a small encoder forward on the
card against the CPU.  They skip where there is no CUDA device; run them
on a GPU machine with ``python -m pytest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import aesara_tpu_torch as ptp
import aesara_tpu_torch.tensor as pt
from aesara_tpu_torch.config import config
from aesara_tpu_torch.link.torch.kernels.attention import attention_plain, flash_attention
from aesara_tpu_torch.link.torch.kernels.elemwise import (
    ElemwiseKernel, composite_plain, fused_elemwise,
)
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
