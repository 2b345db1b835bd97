"""Public wrapper for the DFG-segment kernel: the plain version for a CPU
buffer, the CUDA kernel for a CUDA buffer."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.dfg_segment.dfg_segment import dfg_segment
from repro_torch.kernels.dfg_segment.ref import dfg_segment_ref


def segment(buf: torch.Tensor, idx: torch.Tensor, desc: torch.Tensor, *,
            fmt: Optional[tuple[int, int]] = None) -> torch.Tensor:
    if buf.device.type == "cpu":
        return dfg_segment_ref(buf, idx, desc, fmt=fmt)
    return dfg_segment(buf, idx, desc, fmt=fmt)
