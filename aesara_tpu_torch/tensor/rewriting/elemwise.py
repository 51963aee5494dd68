"""Elemwise fusion: chains of single-client Elemwise nodes become one
``Elemwise(Composite)`` (reference ``aesara_tpu/tensor/rewriting/
elemwise.py``, optdb position 49, tag "fusion").

Eager PyTorch runs one kernel per scalar op, with a round trip through
device memory between them.  In the port each Composite this pass builds
runs as one generated Triton kernel, so this pass is what fuses.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from aesara_tpu_torch.compile.mode import optdb
from aesara_tpu_torch.graph.ir import Constant, Variable
from aesara_tpu_torch.graph.rewriting.basic import GraphRewriter, copy_stack_trace
from aesara_tpu_torch.scalar.composite import Composite
from aesara_tpu_torch.scalar.ops import ScalarConstant, ScalarType
from aesara_tpu_torch.tensor.elemwise import Elemwise


def _inline_constant(var) -> bool:
    """Size-1 constants become scalar literals inside the Composite."""
    return isinstance(var, Constant) and np.asarray(var.data).size == 1


class FusionOptimizer(GraphRewriter):
    """Greedy maximal fusion of single-client Elemwise chains."""

    def apply(self, fgraph):
        n_fused = 0
        changed = True
        while changed:
            changed = False
            for node in reversed(fgraph.toposort()):
                if not isinstance(node.op, Elemwise) or len(node.outputs) != 1:
                    continue
                if isinstance(node.op.scalar_op, Composite):
                    continue
                absorbed, leaves = self._collect(fgraph, node)
                if len(absorbed) < 2:
                    continue
                replacement = self._build_composite(node, absorbed, leaves)
                if replacement is None:
                    continue
                fgraph.replace_all_validate([(node.outputs[0], replacement)],
                                            reason="FusionOptimizer")
                n_fused += 1
                changed = True
                break
        return n_fused

    @staticmethod
    def _fusable_producer(fgraph, var) -> bool:
        node = var.owner
        return (node is not None and isinstance(node.op, Elemwise)
                and len(node.outputs) == 1
                and not isinstance(node.op.scalar_op, Composite)
                and len(fgraph.clients.get(var, [])) == 1
                and var not in fgraph.outputs)

    def _collect(self, fgraph, root):
        """Post-order DFS from ``root`` absorbing fusable producers."""
        absorbed: List = []
        leaves: List[Variable] = []
        seen = set()

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for inp in node.inputs:
                if self._fusable_producer(fgraph, inp):
                    visit(inp.owner)
                elif not _inline_constant(inp) and inp not in leaves:
                    leaves.append(inp)
            absorbed.append(node)

        visit(root)
        return absorbed, leaves

    @staticmethod
    def _build_composite(root, absorbed, leaves):
        """Mirror the tensor subgraph as a scalar graph and wrap it."""
        if not leaves or len(leaves) > 32:
            return None
        smap: Dict[Variable, Variable] = {}
        s_inputs = []
        for leaf in leaves:
            smap[leaf] = ScalarType(leaf.type.dtype)()
            s_inputs.append(smap[leaf])
        for node in absorbed:
            args = []
            for inp in node.inputs:
                if inp in smap:
                    args.append(smap[inp])
                else:
                    args.append(ScalarConstant(ScalarType(inp.type.dtype),
                                               np.asarray(inp.data).reshape(())[()]))
            smap[node.outputs[0]] = node.op.scalar_op(*args)
        new_out = Elemwise(Composite(s_inputs, [smap[root.outputs[0]]]))(*leaves)
        if new_out.type != root.outputs[0].type:
            new_out = root.outputs[0].type.convert_variable(new_out)
            if new_out is None:
                return None
        return copy_stack_trace(root.outputs[0], new_out)

    def __str__(self):
        return "FusionOptimizer"


optdb.register("elemwise_fusion", FusionOptimizer(), "fast_run", "fusion", position=49)
