"""Kernel registry — the catalogue ``emit_cuda`` lowers through.

:data:`KERNELS` holds the hand-written CUDA kernels, registered under the
reference's names and nn-graph patterns (``Conv2d`` -> conv2d_vmem,
``Linear`` -> smallfloat_matmul, ``Softmax`` / the NLB attention softmax ->
fused_softmax), so a lowering plan of the port compares with the
reference's key for key.  Each entry carries the public wrapper (plain
version on CPU tensors, kernel on CUDA tensors), the raw kernel launch and
the plain PyTorch version.

Registration is open: ``register()`` accepts new entries without touching
the emitter.  flash_attention and the DFG tier's opcode table come with
their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One registered kernel: public wrapper + raw kernel + plain version."""

    name: str
    fn: Callable          #: public wrapper (plain on CPU, kernel on CUDA)
    kernel: Callable      #: the raw CUDA kernel launch
    oracle: Callable      #: the plain PyTorch version
    accelerates: tuple[str, ...]   #: nn-graph node/nest patterns served
    description: str = ""


KERNELS: dict[str, KernelEntry] = {}


def register(entry: KernelEntry) -> KernelEntry:
    if entry.name in KERNELS:
        raise ValueError(f"kernel {entry.name!r} already registered")
    KERNELS[entry.name] = entry
    return entry


def get(name: str) -> KernelEntry:
    try:
        return KERNELS[name]
    except KeyError:
        raise KeyError(f"no kernel {name!r}; registered: "
                       f"{sorted(KERNELS)}") from None


def names() -> list[str]:
    return sorted(KERNELS)


def for_pattern(pattern: str) -> Optional[KernelEntry]:
    """The registered fast path for an nn-graph pattern name, if any."""
    for entry in KERNELS.values():
        if pattern in entry.accelerates:
            return entry
    return None


def _register_kernels() -> None:
    from repro_torch.kernels.conv2d_vmem import conv2d_vmem as _conv_mod
    from repro_torch.kernels.conv2d_vmem import ops as _conv_ops
    from repro_torch.kernels.conv2d_vmem import ref as _conv_ref
    from repro_torch.kernels.fused_softmax import fused_softmax as _sm_mod
    from repro_torch.kernels.fused_softmax import ops as _sm_ops
    from repro_torch.kernels.fused_softmax import ref as _sm_ref
    from repro_torch.kernels.smallfloat_matmul import ops as _mm_ops
    from repro_torch.kernels.smallfloat_matmul import ref as _mm_ref
    from repro_torch.kernels.smallfloat_matmul import \
        smallfloat_matmul as _mm_mod

    register(KernelEntry(
        name="conv2d_vmem",
        fn=_conv_ops.conv2d,
        kernel=_conv_mod.conv2d_vmem,
        oracle=_conv_ref.conv2d_ref,
        accelerates=("Conv2d", "nlb.conv1x1"),
        description="weights-resident valid conv, optional fused ReLU, "
                    "(wE,wF) operand and result quantisation, residual"))
    register(KernelEntry(
        name="smallfloat_matmul",
        fn=_mm_ops.matmul,
        kernel=_mm_mod.smallfloat_matmul,
        oracle=_mm_ref.smallfloat_matmul_ref,
        accelerates=("Linear", "MLP", "Attention.proj"),
        description="tiled matmul, fp32 FMA accumulate, optional (wE,wF) "
                    "operand and result quantisation, fused bias/ReLU"))
    register(KernelEntry(
        name="fused_softmax",
        fn=_sm_ops.softmax,
        kernel=_sm_mod.fused_softmax,
        oracle=_sm_ref.fused_softmax_ref,
        accelerates=("Softmax", "nlb.soft", "Attention.soft"),
        description="warp-per-row softmax, incl. the paper's Taylor-exp "
                    "mode (matches the DFG functional model), optional "
                    "(wE,wF) input quantisation"))


_register_kernels()


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches so far in this process."""
    return {name: e.kernel.launches for name, e in sorted(KERNELS.items())}


def reset_launch_counts() -> None:
    for e in KERNELS.values():
        e.kernel.launches = 0
