"""FLOP and byte roll-up of one step run on meta tensors.

The counterpart of ``repro.launch.hlo_analysis``, which parses a compiled
and partitioned HLO module.  There is no HLO here: :func:`analyze` runs
the step on meta tensors (nothing is allocated, no kernel runs) under
``torch.utils.flop_counter.FlopCounterMode`` and a dispatch mode that sees
every aten op, and returns the reference's keys where they mean the same:

  dot_flops      ``FlopCounterMode``'s count: matrix products (forward,
                 backward and every remat recompute), attention, convolution
  elem_flops     one a result element of every pointwise op
  flops          their sum
  mem_bytes      operand + result bytes of every op that is not a view
                 (unfused: an upper bound, as the reference's)
  mem_bytes_out  result bytes only

These counts are **global**: the whole step on every device, since no
partitioner divides the work.  The reference's are per device; the two do
not compare one to one, and the result says so under ``"counts"``.
Collective bytes are not counted here.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

# ops that move no data: allocations without a write, and metadata
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class _OpCounter(TorchDispatchMode):
    """Sums each aten op's operand and result bytes and its pointwise
    result elements."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.elem_flops = 0
        self.mem_bytes = 0
        self.mem_bytes_out = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        if func.is_view or func in _NO_TRAFFIC:
            return out
        out_bytes = _bytes(out)
        self.mem_bytes += _bytes((args, kwargs)) + out_bytes
        self.mem_bytes_out += out_bytes
        if torch.Tag.pointwise in func.tags:
            self.elem_flops += sum(t.numel() for t in _tensors(out))
        return out


def analyze(fn: Callable, *args) -> Dict[str, object]:
    """Run ``fn(*args)`` (meta tensors) and count its work."""
    with FlopCounterMode(display=False) as flops, _OpCounter() as ops:
        fn(*args)
    dot = int(flops.get_total_flops())
    return {"dot_flops": dot, "elem_flops": ops.elem_flops,
            "flops": dot + ops.elem_flops, "mem_bytes": ops.mem_bytes,
            "mem_bytes_out": ops.mem_bytes_out, "aten_ops": ops.ops,
            "counts": "global: the whole step on every device, not per "
                      "device as the reference's"}
