"""The step cost counter: FLOPs, bytes and collective bytes of what a step
dispatches, the counterpart of ``repro/roofline/hlo_cost.py``.

The JAX package walks the optimized HLO text of a compiled step. Eager
PyTorch has no such text, so ``OpCost``, a ``TorchDispatchMode``, tallies
every aten op a step dispatches (its backward included) by the walker's
rules:

* FLOPs: 2 prod(result) prod(contracting) for each matmul-family op
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot``, ``linear``,
  ``convolution`` and its backward, ``_scaled_dot_product_*``);
  elementwise ops count none, and nor does a product that contracts
  nothing (size 1: an outer product, which XLA emits as a multiply);
* bytes: operand + result bytes of every op. In eager PyTorch every op is
  top level; views and ``empty`` allocations move no data and count none;
* collectives: the result bytes of each c10d collective, all-reduce
  doubled (a ring's reduce and broadcast), and their counts by kind.

Each kernel entry point of ``kernels/ops.py`` is one scope, and the
backward of each one another (``kernels/meta.py``): the ops inside it
are not counted, and the scope adds the kernel's own bytes and the FLOPs
the walker counts for its JAX counterpart. So one step counts the same on
the CPU, on the card and on the ``meta`` device.

The counted FLOPs are therefore the JAX program's, masked work included:
a flash scope counts ``chunked_attention``'s 512-query chunks against
window + chunk keys (all keys with no window), masked keys too, while
the kernel skips fully masked tiles. At StarCoder2-3B's (1, 8192) window
4096 that is about 1.5x the causal-window work, and 2x at full causal.
The compute term and any counted-FLOP share of the peak overstate
attention's cost by that much; ``analysis.MODEL_FLOPS`` (6 N D) is the
utilisation figure that reads the same work whatever implements it.

    with OpCost() as cost:
        step(params, opt_state, batch)
    cost.flops, cost.bytes, cost.collective_bytes, cost.by_op

A CUDA-graph replay dispatches nothing: count an eager step.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import meta

__all__ = ["OpCost", "op_flops", "COLLECTIVE_KINDS"]

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute", "broadcast")

# c10d op (``torch.ops.c10d`` in place, ``_c10d_functional`` out of place)
# -> the walker's kind
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}
_OUT_OF_PLACE = "_c10d_functional"
_NO_DATA = ("empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "resize_", "set_")


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in rets)


def _conv_flops(out, weight, transposed, inp) -> int:
    # each output element of a convolution sums (C_in / groups) x kernel
    # products; a transposed one runs the same products from its input
    per = math.prod(weight.shape[1:])
    return 2 * (math.prod(inp.shape) if transposed
                else math.prod(out.shape)) * per


def _product(result: int, contracting: int) -> int:
    """2 prod(result) prod(contracting); none for an outer product."""
    return 2 * result * contracting if contracting > 1 else 0


def op_flops(func, args, kwargs, out) -> int:
    """FLOPs of one aten op, by the walker's rule; 0 for elementwise ops."""
    name = func._overloadpacket.__name__
    if name in ("mm", "addmm"):
        a, b = (args[0], args[1]) if name == "mm" else (args[1], args[2])
        return _product(a.shape[0] * b.shape[1], a.shape[1])
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        return _product(a.shape[0] * a.shape[1] * b.shape[2], a.shape[2])
    if name in ("mv", "addmv"):
        a = args[0] if name == "mv" else args[1]
        return _product(a.shape[0], a.shape[1])
    if name in ("dot", "vdot"):
        return _product(1, args[0].shape[0])
    if name == "linear":
        x, w = args[0], args[1]
        return _product(math.prod(x.shape[:-1]) * w.shape[0], w.shape[1])
    if name == "convolution":
        return _conv_flops(out, args[1], args[6], args[0])
    if name == "convolution_backward":
        # (grad_out, input, weight, bias_sizes, stride, padding, dilation,
        # transposed, output_padding, groups, output_mask)
        mask = args[10]
        one = _conv_flops(args[0], args[2], args[7], args[1])
        return one * (int(mask[0]) + int(mask[1]))
    if name.startswith("_scaled_dot_product") and "attention" in name:
        q, k, v = args[0], args[1], args[2]
        b_h = math.prod(q.shape[:-2])
        sq, sk = q.shape[-2], k.shape[-2]
        one = 2 * b_h * sq * sk * (q.shape[-1] + v.shape[-1])
        return 2 * one if name.endswith("backward") else one
    return 0


class _Scope:
    def __init__(self):
        self.extra = 0

    def add_bytes(self, n: int) -> None:
        self.extra += int(n)


class OpCost(TorchDispatchMode):
    """Counts a step: ``flops``, ``bytes``, ``collective_bytes``,
    ``collective_counts`` / ``collective_bytes_by_kind`` (by the walker's
    kinds), ``by_op`` (aten op -> [calls, FLOPs, bytes]) and ``kernels``
    (kernel scope -> [calls, FLOPs, bytes]). Nest-safe; counts nothing
    once it has exited."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collective_bytes = 0
        self.collective_counts = {k: 0 for k in COLLECTIVE_KINDS}
        self.collective_bytes_by_kind = {k: 0 for k in COLLECTIVE_KINDS}
        self.by_op: dict = {}
        self.kernels: dict = {}
        self.active = False
        self._depth = 0

    def __enter__(self):
        self.active = True
        meta.push_counter(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            meta.pop_counter(self)
            self.active = False

    @contextlib.contextmanager
    def scope(self, name: str, flops: int, nbytes: int):
        """A kernel's scope: the ops inside are not counted; it adds
        ``flops`` and ``nbytes`` plus what ``add_bytes`` adds."""
        sc = _Scope()
        outer = self._depth == 0
        self._depth += 1
        try:
            yield sc
        finally:
            self._depth -= 1
        if outer:
            nb = int(nbytes) + sc.extra
            self.flops += int(flops)
            self.bytes += nb
            row = self.kernels.setdefault(name, [0, 0, 0])
            row[0] += 1
            row[1] += int(flops)
            row[2] += nb

    def add_collective(self, kind: str, result) -> None:
        """Count a collective that did not dispatch (no process group, as
        on ``meta``) as a c10d op of ``kind`` with ``result`` would be."""
        res = meta.nbytes(result) * (2 if kind == "all-reduce" else 1)
        self.collective_bytes += res
        self.collective_counts[kind] += 1
        self.collective_bytes_by_kind[kind] += res

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._depth == 0:
            self._tally(func, args, kwargs, out)
        return out

    def _tally(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        if _is_view(func) or name in _NO_DATA:
            nb = 0
        else:
            nb = sum(meta.nbytes(t) for t in
                     _tensors(args) + _tensors(kwargs) + _tensors(out))
        fl = op_flops(func, args, kwargs, out)
        kind = _COLLECTIVES.get(name)
        ns = func.namespace
        if kind is not None and ns in ("c10d", _OUT_OF_PLACE):
            self.add_collective(kind, _tensors(
                out if ns == _OUT_OF_PLACE else args[0]))
        self.flops += fl
        self.bytes += nb
        row = self.by_op.setdefault(str(func), [0, 0, 0])
        row[0] += 1
        row[1] += fl
        row[2] += nb
