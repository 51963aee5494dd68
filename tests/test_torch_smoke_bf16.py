"""``chip_smoke.py``'s path (i) on the host at a small size: the bfloat16
encoder step that ``build_bf16_step`` builds as
``benchmarks/bench_transformer.py:26-67`` does, with and without
``remat``; the launches ``graph_launches`` reads from a step's graph, inner
programs included; the Composite shapes ``composite_shapes`` reads from
a run; the two remat arms' gradients at the start and their losses and
parameters after 3 steps bitwise equal, as the card run holds them; the
float64 twin of the step that the card-vs-CPU gradient check uses."""

import numpy as np
import pytest
import torch

from aesara_tpu_torch.config import config
from aesara_tpu_torch.compile.builders import Remat
from tests.test_torch_sparse import _chip_smoke

SMALL = dict(n_layers=2, d=64, heads=4, ff=128, batch=2, seq=16)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


@pytest.fixture(scope="module")
def smoke():
    return _chip_smoke()


@pytest.mark.parametrize("use_remat", [False, True], ids=["plain", "remat"])
def test_the_bf16_step_and_its_launches(smoke, use_remat):
    step, params = smoke.build_bf16_step("cpu", use_remat=use_remat, **SMALL)
    assert all(p.type.dtype == "bfloat16" for p in params)
    launches = smoke.graph_launches(step)
    # a FusedAttention a layer, and with remat its recompute in the
    # outer graph; each FusedAttentionGrad runs K2 again and K3
    assert launches["K2"] == (3 if use_remat else 2) * SMALL["n_layers"]
    assert launches["K3"] == SMALL["n_layers"]
    census = smoke.op_census(step)
    assert census["Remat"] == (SMALL["n_layers"] if use_remat else 0)
    assert census["RematBarrier"] == (12 * SMALL["n_layers"] if use_remat else 0)
    inner = [lowered.program for node, lowered in zip(step.fn.program.order, step.fn.program.fns)
             if isinstance(node.op, Remat)]
    outer = sum(1 for n, fold in zip(step.fn.program.order, step.fn.program.folds)
                if not fold and type(getattr(n.op, "scalar_op", None)).__name__ == "Composite")
    assert launches["K1"] == outer + sum(
        1 for p in inner for n, fold in zip(p.order, p.folds)
        if not fold and type(getattr(n.op, "scalar_op", None)).__name__ == "Composite")
    loss = step()
    assert loss.dtype == torch.bfloat16 and bool(torch.isfinite(loss))


def test_the_remat_arms_are_bitwise_equal_after_three_steps(smoke):
    runs = []
    for use_remat in (False, True):
        step, params, grads = smoke.build_bf16_step("cpu", use_remat=use_remat, with_grads=True, **SMALL)
        first = grads()
        losses = [step().clone() for _ in range(3)]
        runs.append((first, losses, [p.get_value() for p in params]))
    (ga, la, pa), (gb, lb, pb) = runs
    assert len(ga) == 1 + len(pa) and all(g.dtype == torch.bfloat16 for g in ga)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    # the gradient function reads the parameters it was built with: the
    # first loss is the first step's
    assert torch.equal(ga[0], la[0])


def test_the_float64_twin_starts_from_the_bfloat16_values(smoke):
    """``build_bf16_step(dtype="float64")``, the exact arithmetic that the
    card-vs-CPU gradient check measures the CPU's own distance from:
    the same graph from the bfloat16 values of x and the weights."""
    _, params = smoke.build_bf16_step("cpu", **SMALL)
    step64, params64, grads64 = smoke.build_bf16_step("cpu", with_grads=True, dtype="float64", **SMALL)
    assert all(p.type.dtype == "float64" for p in params64)
    for p, q in zip(params, params64):
        assert np.array_equal(p.get_value().double().numpy(), q.get_value()), p.name
    x = next(v for v in step64.fn.shared_inputs if v.name == "x")
    x16 = next(v for v in smoke.build_bf16_step("cpu", **SMALL)[0].fn.shared_inputs if v.name == "x")
    assert np.array_equal(x16.get_value().double().numpy(), x.get_value())
    assert all(g.dtype == torch.float64 for g in grads64())


def test_composite_shapes_are_those_of_the_run(smoke):
    step, _ = smoke.build_bf16_step("cpu", **SMALL)
    shapes = smoke.composite_shapes(step, [])
    assert len(shapes) == smoke.graph_launches(step)["K1"]
    for node, node_shapes in shapes.items():
        assert len(node_shapes) == len(node.inputs)
        for var, shape in zip(node.inputs, node_shapes):
            assert len(shape) == var.type.ndim
            assert all(s is None or s == d for s, d in zip(var.type.shape, shape))
    full = {(SMALL["batch"], SMALL["seq"], SMALL["d"])}
    assert full <= {tuple(s) for node_shapes in shapes.values() for s in node_shapes}
    # the shapes feed K1's inputs: one draw per input, of that shape and dtype
    node, node_shapes = next(iter(shapes.items()))
    ins = smoke.composite_inputs(node, np.random.default_rng(0), "cpu", sample="unit", shapes=node_shapes)
    assert [tuple(a.shape) for a in ins] == node_shapes
    assert [str(a.dtype).split(".")[-1] for a in ins] == [v.type.dtype for v in node.inputs]
