"""Meshes: named axes over the processes of a ``torch.distributed`` group.

The reference's ``repro.launch.mesh`` in torch.  A :class:`Mesh` carries
``shape``, an ordered mapping from axis name to size (all the binding
rules read), and, where it has devices, a ``DeviceMesh`` whose ranks are
laid out row-major over that shape, as ``jax.make_mesh`` lays out its
devices.  The production meshes are shapes only: the rules and
``bytes_per_device`` need no devices.

A mesh with devices lives on the card over NCCL unless the caller asks for
the CPU (``device="cpu"``), where it runs over gloo.  There is no
fallback: a mesh asked of the card where NCCL or the card is missing
raises.  A mesh of one process makes its own one-rank group from an
in-memory store, with no network; a larger one needs the caller's process
group (``torch.distributed.init_process_group`` with its address, rank and
world size) of exactly its size.  Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.binding import NamedSharding, entry_axes


class Mesh:
    """Named mesh axes, and the devices behind them where it has any."""

    def __init__(self, shape: dict, device_mesh=None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def device_type(self) -> str:
        return self._devices().device_type

    def _devices(self):
        if self.device_mesh is None:
            raise ValueError(f"mesh {self.shape} is a shape only: it has no "
                             f"devices")
        return self.device_mesh

    def coordinate(self) -> tuple[int, ...]:
        """This process's index along each axis, in mesh order."""
        return tuple(self._devices().get_coordinate())

    def group(self, axis: str):
        """The process group along ``axis``: the ranks that differ only
        in their index on it, in that index's order."""
        return self._devices().get_group(axis)

    def block(self, sharding: NamedSharding, shape: Sequence[int]
              ) -> tuple[slice, ...]:
        """The slices of a tensor of ``shape`` this process holds."""
        return sharding.block(shape, self.coordinate())

    def reduce(self, t: torch.Tensor, axes: Sequence[str],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced in place over the ranks that differ along
        ``axes`` (one all-reduce per axis)."""
        for a in axes:
            dist.all_reduce(t, op=op, group=self.group(a))
        return t

    def gather_into(self, full: torch.Tensor, sharding: NamedSharding
                    ) -> torch.Tensor:
        """Complete ``full`` in place, where each rank holds valid values
        in its own block of it under ``sharding``: an all-gather along
        each split dimension, over its mesh axes innermost first.  A
        tensor the sharding does not split is left as it is."""
        coord = dict(zip(self.axis_names, self.coordinate()))
        region = list(self.block(sharding, full.shape))
        for d, entry in enumerate(sharding.spec):
            axes = entry_axes(entry)
            for i in reversed(range(len(axes))):
                a = axes[i]
                n = self.shape[a]
                if n == 1:
                    continue
                part = full[tuple(region)].contiguous()
                parts = [torch.empty_like(part) for _ in range(n)]
                dist.all_gather(parts, part, group=self.group(a))
                # the block grows n-fold along d, to the one that the
                # rank's outer axes' indices select
                length = (region[d].stop - region[d].start) * n
                outer = 0
                for b in axes[:i]:
                    outer = outer * self.shape[b] + coord[b]
                region[d] = slice(outer * length, (outer + 1) * length)
                full[tuple(region)].copy_(torch.cat(parts, dim=d))
        return full

    def __repr__(self) -> str:
        where = "shape only" if self.device_mesh is None else \
            self.device_mesh.device_type
        return f"Mesh({self.shape}, {where})"


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def make_test_mesh(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model"),
                   device=None) -> Mesh:
    """A mesh over the processes of the default group, on the card
    (NCCL) unless ``device`` is the CPU (gloo).

    One process makes its own one-rank group; more need the caller's
    process group, of ``prod(shape)`` ranks and this device's backend.
    Every axis's communicator is made and used once here, so a graph
    captured later holds the collectives without creating one.  Over a
    :func:`fake_world` the mesh takes the fake group of any device."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    device_type = torch.device(device if device is not None
                               else "cuda").type
    backend = _backend(device_type)
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a mesh on the card needs a CUDA device; pass "
                           "device='cpu' for a gloo mesh on the CPU")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("a mesh on the card needs NCCL, which this torch "
                           "build does not have")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a {' x '.join(map(str, shape))} mesh needs {n} processes: "
                f"call torch.distributed.init_process_group(world_size={n}, "
                f"...) in each first")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != n:
        raise RuntimeError(
            f"a {' x '.join(map(str, shape))} mesh needs {n} processes; the "
            f"process group has {dist.get_world_size()}")
    have = dist.get_backend()
    if backend not in have and have != "fake":
        raise RuntimeError(f"a mesh on {device_type} runs over {backend}; "
                           f"the process group's backend is {have}")
    from torch.distributed.device_mesh import DeviceMesh
    dm = DeviceMesh(device_type, torch.arange(n).reshape(shape),
                    mesh_dim_names=axes)
    mesh = Mesh(dict(zip(axes, shape)), dm)
    mesh.reduce(torch.zeros((), device=device_type), axes)
    return mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> Mesh:
    """16 x 16 single pod (256 chips) or 2 x 16 x 16 (two pods, 512).

    The "pod" axis is outermost: only data-parallel gradient reduction
    crosses the slow links between pods.  Without ``device`` the mesh is
    its shape alone, for the rules and ``bytes_per_device``; with one it
    needs a process group of 256 (512) ranks, a :func:`fake_world`'s for
    a dry-run, and raises without it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if device is None:
        return Mesh(dict(zip(axes, shape)))
    return make_test_mesh(shape, axes, device)


def _fake_store():
    """The store a ``"fake"`` process group is made with.  It lives in
    torch's testing package, a private API: checked on torch 2.13.0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


@contextlib.contextmanager
def fake_world(shape: Sequence[int], axes: Sequence[str],
               device=None) -> Iterator[Mesh]:
    """Within ``with``: this process as rank 0 of a ``"fake"`` process
    group of ``prod(shape)`` ranks, and the :class:`Mesh` over it, on the
    card unless ``device`` is the CPU.  A collective over the fake group
    returns at once and moves nothing; each rank's share of the work is
    rank 0's.  Refuses to start while a process group is up, and where the
    card is asked for and missing (no fallback to the CPU); the group is
    destroyed on the way out."""
    device_type = torch.device(device if device is not None
                               else "cuda").type
    if dist.is_initialized():
        raise RuntimeError("a fake world needs this process without a "
                           "process group; one is up")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a fake world on the card needs a CUDA device; "
                           "pass device='cpu' for one on the CPU")
    dist.init_process_group("fake", store=_fake_store(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield make_test_mesh(shape, axes, device_type)
    finally:
        dist.destroy_process_group()


def single_device_mesh(device=None) -> Mesh:
    """The 1 x 1 (data, model) mesh of this one process."""
    return make_test_mesh((1, 1), ("data", "model"), device)


def mesh_of(device_mesh: Optional[object]) -> Mesh:
    """The :class:`Mesh` of a DTensor's ``DeviceMesh``."""
    names = device_mesh.mesh_dim_names
    return Mesh(dict(zip(names, device_mesh.shape)), device_mesh)
