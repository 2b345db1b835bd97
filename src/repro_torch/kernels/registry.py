"""Kernel registry — the catalogue ``emit_cuda`` lowers through.

Two tables:

* :data:`KERNELS` — the hand-written CUDA kernels, registered under the
  reference's names and nn-graph patterns (``Conv2d`` -> conv2d_vmem,
  ``Linear`` -> smallfloat_matmul, ``Softmax`` / the NLB attention softmax
  -> fused_softmax, the NLB attention core -> flash_attention), so a
  lowering plan of the port compares with the reference's key for key.
  Each entry carries the public wrapper (plain version on CPU tensors,
  kernel on CUDA tensors), the raw kernel launch and the plain PyTorch
  version.

* :data:`OPCODE_KERNELS` — the scalar-DFG opcode -> torch compute table of
  the generic DFG tier, the ``simd`` backend and the DFG segment kernel's
  plain version.  Contiguous runs of levelised (level, opcode) groups
  whose opcodes all appear here fuse into one segment (one launch of the
  ``dfg_segment`` kernel); a group whose opcode is missing falls back to
  plain torch and is recorded in the ``KernelPlan``.
  :func:`opcode_compute` renders any group: the table, plus ``cmpugt``
  and ``select``, which the table leaves out.

Registration is open: ``register()`` accepts new entries without touching
the emitter.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


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
    from repro_torch.kernels.flash_attention import \
        flash_attention as _fa_mod
    from repro_torch.kernels.flash_attention import ops as _fa_ops
    from repro_torch.kernels.flash_attention import ref as _fa_ref
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
        description="a chain of dense layers in one launch (the nest "
                    "tier's runs of Linear), fp32 FMA accumulate, "
                    "optional (wE,wF) operand and result quantisation, "
                    "fused bias/ReLU"))
    register(KernelEntry(
        name="fused_softmax",
        fn=_sm_ops.softmax,
        kernel=_sm_mod.fused_softmax,
        oracle=_sm_ref.fused_softmax_ref,
        accelerates=("Softmax", "nlb.soft", "Attention.soft"),
        description="warp-per-row softmax, incl. the paper's Taylor-exp "
                    "mode (matches the DFG functional model), optional "
                    "(wE,wF) input quantisation"))
    register(KernelEntry(
        name="flash_attention",
        fn=_fa_ops.attention,
        kernel=_fa_mod.flash_attention,
        oracle=_fa_ref.flash_attention_ref,
        accelerates=("NonLocalBlock.attention", "Attention"),
        description="online-softmax attention over strided views, any "
                    "head dim to 256, K/V staged in shared memory once "
                    "per block; NLB throughput mode (true-exp softmax — "
                    "not the Taylor functional model)"))


_register_kernels()


# ---------------------------------------------------------------------------
# Generic tier: scalar-DFG opcode -> torch compute
# ---------------------------------------------------------------------------

def _relu(a: torch.Tensor) -> torch.Tensor:
    # torch.maximum propagates NaN, as np.maximum does
    return torch.maximum(a, a.new_zeros(()))


#: opcode -> (arity, compute over gathered operand tensors).  Each entry
#: rounds as ``emit.evaluate`` does: fmac is ``a*b`` then ``+c``, two fp32
#: roundings; maxf/minf/relu propagate NaN.  cmpugt/select are deliberately
#: absent: raw (un-recomposed) graphs route those groups through the
#: per-group torch fallback, the path the fallback tests pin down.
OPCODE_KERNELS: dict[str, tuple[int, Callable]] = {
    "mulf": (2, lambda a: a[0] * a[1]),
    "addf": (2, lambda a: a[0] + a[1]),
    "subf": (2, lambda a: a[0] - a[1]),
    "divf": (2, lambda a: a[0] / a[1]),
    "sqrtf": (1, lambda a: torch.sqrt(a[0])),
    "maxf": (2, lambda a: torch.maximum(a[0], a[1])),
    "minf": (2, lambda a: torch.minimum(a[0], a[1])),
    "negf": (1, lambda a: -a[0]),
    "relu": (1, lambda a: _relu(a[0])),
    "fmac": (3, lambda a: a[0] * a[1] + a[2]),
    "load": (1, lambda a: a[0]),
    "store": (1, lambda a: a[0]),
    "copy": (1, lambda a: a[0]),
}

def opcode_compute(oc: str, a: list) -> torch.Tensor:
    """One group's result over its gathered operands: the table's compute,
    or the compare/select rendering of the opcodes the table leaves out
    (the ``simd`` backend and the DFG tier's per-group fallback)."""
    if oc == "cmpugt":
        return (a[0] > a[1]).to(torch.float32)
    if oc == "select":
        return torch.where(a[0] > 0.5, a[1], a[2])
    if oc in OPCODE_KERNELS:
        return OPCODE_KERNELS[oc][1](a)
    raise NotImplementedError(f"no torch rendering of opcode {oc!r}")


#: opcodes whose results the functional model does NOT re-quantise
#: (moves/compares — mirrors ``emit.evaluate``)
NO_QUANT_OPCODES = frozenset({"cmpugt", "load", "store", "copy"})


def _launch_counters() -> dict[str, Callable]:
    from repro_torch.kernels.dfg_segment.dfg_segment import dfg_segment
    from repro_torch.kernels.slstm_scan.slstm_scan import (
        slstm_scan, slstm_scan_backward)
    counters = {name: e.kernel for name, e in KERNELS.items()}
    counters["dfg_segment"] = dfg_segment
    counters["slstm_scan"] = slstm_scan
    counters["slstm_scan_backward"] = slstm_scan_backward
    return counters


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches so far in this process: the registry's
    kernels, the DFG tier's segment kernel and the sLSTM's time loop and
    its backward."""
    return {name: k.launches
            for name, k in sorted(_launch_counters().items())}


def reset_launch_counts() -> None:
    for k in _launch_counters().values():
        k.launches = 0


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches) to the wrappers' counters:
    what a replayed CUDA graph launched, which no wrapper saw."""
    counters = _launch_counters()
    for name, n in counts.items():
        counters[name].launches += n
