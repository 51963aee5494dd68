"""The PyTorch port imports without jax, refuses a missing device, and
names an op it cannot lower."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import aesara_tpu_torch as ptp
import aesara_tpu_torch.tensor as pt
from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.link.basic import resolve_device
from aesara_tpu_torch.link.torch.linker import TorchLinker
from aesara_tpu_torch.config import config


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = ("import sys, aesara_tpu_torch, aesara_tpu_torch.sparse, aesara_tpu_torch.compile.builders\n"
            "import aesara_tpu_torch.link.torch.control_dispatch, aesara_tpu_torch.misc.safe_asarray\n"
            "import aesara_tpu_torch.tensor.nnet.ctc, aesara_tpu_torch.sandbox.rng_mrg, aesara_tpu_torch.sandbox.multinomial\n"
            "import aesara_tpu_torch.link.torch.kernels.random_loops, aesara_tpu_torch.tensor.random\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'aesara_tpu' or m.startswith('aesara_tpu.')"
            " or m == 'ml_dtypes' or m.startswith('ml_dtypes.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    x = pt.vector("x")
    with pytest.raises(RuntimeError, match="cuda"):
        ptp.function([x], x * 2.0, mode=ptp.Mode(TorchLinker(device="cuda")))
    with pytest.raises(RuntimeError, match="cuda"):
        ptp.shared(np.zeros(3, dtype="float32"), device="cuda")


class _NoLowering(Op):
    __props__ = ()

    def make_node(self, x):
        return Apply(self, [x], [x.type()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = inputs[0]


def test_op_without_lowering_raises_naming_it():
    x = pt.vector("x")
    with pytest.raises(NotImplementedError, match="_NoLowering"):
        ptp.function([x], _NoLowering()(x * 2.0))
