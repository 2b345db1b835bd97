"""The operations one call of a step dispatches: its collectives and its
kernel launches.  The counterpart of the reference's
``repro.launch.hlo_parse``.

The reference reads them off XLA's optimized HLO text, where a ``while``
body appears once, so it multiplies each op by the trip counts of the
loops around it.  The port has no compiled program text: it runs the step
eagerly once, under :class:`OpInventory` (a ``TorchDispatchMode``), and
records each op as it is dispatched.  Eager execution runs every loop, so
each op is counted as often as it runs and no trip-count correction is
needed.  What the HLO gives and an eager run does not (the lowering and
compile seconds, generated code and alias bytes, the number of loops, their
trip counts, the program's length) has no counterpart here.

Collectives are the ``c10d::`` ops ``torch.distributed`` dispatches and
the ``_c10d_functional::`` ops of the functional collectives, by kind, with
the reference's cost model of per-device bytes on the wire (ring
algorithms, (k-1)/k ~ 1):

    all-reduce          2 x operand bytes
    all-gather          1 x result bytes
    reduce-scatter      1 x operand bytes
    all-to-all          1 x operand bytes
    collective-permute  1 x operand bytes

A collective over a group of one rank moves nothing (XLA drops it from
the reference's program) and is not recorded.  Each is also marked by the
8-card nodes its group's ranks span (ranks numbered node by node): one
node's collectives cross NVLink, the others InfiniBand.  Kernel launches
are the ``repro_torch::`` custom ops (``kernels/*``), by name: on fake
tensors their fake implementations run, so the count is what the card
would launch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.launch.roofline import CARDS_PER_NODE

_COLL_COST = {"all-reduce": ("operand", 2.0), "all-gather": ("result", 1.0),
              "reduce-scatter": ("operand", 1.0),
              "all-to-all": ("operand", 1.0),
              "collective-permute": ("operand", 1.0)}

#: op -> (kind, the argument whose tensors are its operand, the argument
#: whose tensors are its result; -1: the op's return value)
_COLLECTIVES = {
    "c10d::allreduce_": ("all-reduce", 0, 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0, 0),
    "c10d::allgather_": ("all-gather", 1, 0),
    "c10d::_allgather_base_": ("all-gather", 1, 0),
    "c10d::allgather_coalesced_": ("all-gather", 1, 0),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
    "c10d::reduce_scatter_": ("reduce-scatter", 1, 0),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
    "c10d::alltoall_": ("all-to-all", 1, 0),
    "c10d::alltoall_base_": ("all-to-all", 1, 0),
    "c10d::send": ("collective-permute", 0, 0),
    "_c10d_functional::all_reduce": ("all-reduce", 0, -1),
    "_c10d_functional::all_reduce_": ("all-reduce", 0, 0),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", 0, -1),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", 0, -1),
    "_c10d_functional::all_gather_into_tensor_coalesced": (
        "all-gather", 0, -1),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", 0, -1),
    "_c10d_functional::reduce_scatter_tensor_coalesced": (
        "reduce-scatter", 0, -1),
    "_c10d_functional::all_to_all_single": ("all-to-all", 0, -1),
}

#: the namespace of the port's kernels' custom ops
KERNEL_NAMESPACE = "repro_torch"


def _nbytes(x: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _group(args: tuple):
    """The process group among a collective's arguments (a ``c10d::`` op's
    boxed ``ProcessGroup``, or a functional collective's group name)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except RuntimeError:        # another class: the ReduceOp
                continue
    return _resolve_process_group(      # the group name comes last
        [a for a in args if isinstance(a, str)][-1])


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    op: str                       #: the dispatched op's name
    result_bytes: int
    operand_bytes: int
    group_size: int
    nodes: int                    #: the 8-card nodes its group's ranks span
    ranks: tuple = ()             #: its group's ranks

    @property
    def wire_bytes(self) -> float:
        which, factor = _COLL_COST[self.kind]
        base = self.operand_bytes if which == "operand" else self.result_bytes
        return factor * base


@dataclasses.dataclass
class OpReport:
    collectives: list             #: CollectiveOp, in dispatch order
    kernel_launches: dict         #: custom op name -> launches
    n_ops: int                    #: every op dispatched

    @property
    def collective_bytes(self) -> float:
        """Per-device wire bytes of every collective."""
        return sum(c.wire_bytes for c in self.collectives)

    def by_kind(self) -> dict:
        out: dict[str, float] = {}
        for c in self.collectives:
            out[c.kind] = out.get(c.kind, 0.0) + c.wire_bytes
        return out

    def by_axis(self, groups: dict) -> dict:
        """{axis: {kind: wire bytes}} of the collectives over each mesh
        axis's group, ``groups`` {axis: its group's ranks}; a group of
        several axes under its ranks' tuple."""
        named = {tuple(sorted(r)): a for a, r in groups.items()}
        out: dict[str, dict] = {}
        for c in self.collectives:
            axis = named.get(tuple(sorted(c.ranks)), str(c.ranks))
            kinds = out.setdefault(axis, {})
            kinds[c.kind] = kinds.get(c.kind, 0.0) + c.wire_bytes
        return out

    def by_link(self) -> dict:
        """Wire bytes within one node (NVLink) and across nodes
        (InfiniBand)."""
        out = {"nvlink": 0.0, "infiniband": 0.0}
        for c in self.collectives:
            out["nvlink" if c.nodes == 1 else "infiniband"] += c.wire_bytes
        return out


class OpInventory(TorchDispatchMode):
    """Within ``with``: every op dispatched, the collectives and kernel
    launches among them recorded (:meth:`report`)."""

    def __init__(self) -> None:
        super().__init__()
        self._collectives: list[CollectiveOp] = []
        self._launches: dict[str, int] = {}
        self._n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._n += 1
        name = func._schema.name
        if func.namespace == KERNEL_NAMESPACE:
            short = name.split("::", 1)[1]
            self._launches[short] = self._launches.get(short, 0) + 1
        elif name in _COLLECTIVES:
            self._record(name, args, out)
        return out

    def _record(self, name: str, args: tuple, out: Any) -> None:
        import torch.distributed as dist
        kind, operand_at, result_at = _COLLECTIVES[name]
        ranks = dist.get_process_group_ranks(_group(args))
        if len(ranks) == 1:
            return
        operand = _nbytes(args[operand_at])
        result = _nbytes(out if result_at < 0 else args[result_at])
        nodes = len({r // CARDS_PER_NODE for r in ranks})
        self._collectives.append(CollectiveOp(kind, name, result, operand,
                                              len(ranks), nodes,
                                              tuple(ranks)))

    def report(self) -> OpReport:
        return OpReport(list(self._collectives), dict(self._launches),
                        self._n)
