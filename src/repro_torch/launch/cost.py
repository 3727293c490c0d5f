"""The cost of one step, counted from its operations under fake tensors.

Replaces `repro.launch.hlo_cost`, which walks the compiled HLO text with
its loop trip counts.  PyTorch has no HLO: the step runs eagerly, so
`step_cost` runs it once under `FakeTensorMode` (shapes and dtypes only:
no storage, no device, nothing computed) inside a `TorchDispatchMode`
that sees every aten operation the step dispatches and counts

  * flops: `torch.utils.flop_counter`'s registry (matmuls, convolutions,
    attention), dispatched as `FlopCounterMode` dispatches, so a real run
    under `FlopCounterMode` counts the same;
  * bytes: the operands and results of each operation that is not a
    view, the eager analogue of XLA's "bytes accessed" (every operation
    reads its inputs and writes its outputs once; no fusion);
  * collective bytes and counts, for the c10d operations;
  * the peak of the live results' bytes (non-view results, freed when
    their tensors are), the eager program's working set over its inputs.

A step whose Python reads a tensor's value (``.item()``, ``bool(t)``)
raises here: the port keeps such values on the host or in the config.

A sharded step (DTensors on a device mesh, `sharding`) is counted per
rank: an operation on DTensors is passed to DTensor, which runs this
rank's local operations and the collectives its redistributions need
(functional c10d operations), and those are what is counted.  The
global-shape operations DTensor runs on fake tensors to infer its
outputs' metadata are not counted: they are found by their caller's
frame, a DTensor internal that is looked up, and walked to, only once
the step has dispatched a DTensor operation.
A collective's bytes are its larger buffer (an all-gather's result, a
reduce-scatter's or all-reduce's input): what its ring moves, to within
the (n − 1)/n factor.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# operations that only read metadata (FlopCounterMode skips them too)
_META_OPS = {
    torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default,
    torch.ops.aten.size.default,
    torch.ops.aten.sym_size.default,
    torch.ops.aten.stride.default,
    torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default,
    torch.ops.aten.sym_numel.default,
    torch.ops.aten.dim.default,
    torch.ops.prim.layout.default,
}

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
_NOT_COLLECTIVES = ("wait_tensor",)


def _meta_inference_code():
    """The code object of DTensor's output-metadata inference, whose
    global-shape operations are no rank's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    return ShardingPropagator._propagate_tensor_meta_non_cached.__code__


def _in(code, depth: int = 64) -> bool:
    f = sys._getframe(2)
    while f is not None and depth:
        if f.f_code is code:
            return True
        f, depth = f.f_back, depth - 1
    return False


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    n_ops: int = 0
    peak_live_bytes: int = 0
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())


class CostMode(TorchDispatchMode):
    """Counts flops, bytes and collectives of every operation it sees
    (one rank's share of a step on DTensors)."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.cost = Cost()
        self._live = 0
        self._whole = set()     # operations with no decomposition
        self._dtensor = DTensor
        self._infer = None      # set at the first DTensor operation

    def _free(self, n: int) -> None:
        self._live -= n

    def _track(self, out) -> None:
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                n = _nbytes(t)
                self._live += n
                weakref.finalize(t, self._free, n)
        self.cost.peak_live_bytes = max(self.cost.peak_live_bytes,
                                        self._live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META_OPS:
            return NotImplemented
        if any(issubclass(t, self._dtensor) for t in types):
            if self._infer is None:
                self._infer = _meta_inference_code()
            return NotImplemented       # DTensor runs the local operations
        if self._infer is not None and _in(self._infer):
            return func(*args, **kwargs)
        if func is torch.ops.prim.device.default:
            return func(*args, **kwargs)
        if func not in self._whole and func not in self.registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            self._whole.add(func)
        out = func(*args, **kwargs)
        c = self.cost
        c.n_ops += 1
        packet = func._overloadpacket
        if packet in self.registry:
            f = self.registry[packet](*args, **kwargs, out_val=out)
            c.flops += f
            name = str(packet)
            c.flops_by_op[name] = c.flops_by_op.get(name, 0.0) + f
        operands = sum(_nbytes(x) for x in tree_flatten((args, kwargs))[0])
        if func.namespace in _COLLECTIVE_NAMESPACES:
            name = packet.__name__.rstrip("_")
            if name in _NOT_COLLECTIVES:
                return out
            moved = max(operands, sum(_nbytes(x)
                                      for x in tree_flatten(out)[0]))
            c.coll_bytes[name] = c.coll_bytes.get(name, 0.0) + moved
            c.coll_counts[name] = c.coll_counts.get(name, 0) + 1
        elif not func.is_view:
            c.bytes += operands + sum(_nbytes(x)
                                      for x in tree_flatten(out)[0])
            self._track(out)
        return out


def fake_like(tree, mode):
    """Meta (or real) tensors of a tree as fake CPU tensors of ``mode``,
    with their shapes and dtypes; anything else passes through."""
    def one(x):
        if isinstance(x, torch.Tensor):
            with mode:
                return torch.empty(tuple(x.shape), dtype=x.dtype)
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(one(v) for v in x)
        return x
    return one(tree)


def step_cost(step: Callable, *args) -> Cost:
    """Run ``step(*args)`` once under fake tensors (the tensor leaves of
    ``args``, meta or real, become fake tensors of the same shapes and
    dtypes) and count what its operations cost."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = FakeTensorMode(allow_non_fake_inputs=False)
    fargs = fake_like(args, fake)
    counter = CostMode()
    with fake, counter:
        step(*fargs)
    return counter.cost
