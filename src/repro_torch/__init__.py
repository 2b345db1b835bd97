"""repro_torch: OpenHLS reproduced on PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper.

The counterpart of the JAX package ``repro``, module for module: the same
compiler core (trace -> DFG -> passes -> schedule), the same ``hls`` front
door, and an emission tier that serves a compiled design through CUDA C++
kernels built from ``csrc/`` at first use.

Subpackages:
    hls      — ``hls.compile(model) -> Design`` with run/serve/report
    core     — the paper's compiler, plus ``emit_cuda`` (the nest tier)
    nn       — the declarative ``ModuleGraph`` and its ``ParamSpec`` tree
    models   — BraggNN (graph + the plain tensor twin)
    kernels  — the CUDA kernels, each beside its plain PyTorch version
    obs      — tracing and metrics (stdlib only)
    serving  — queue and percentile bookkeeping
"""

__version__ = "0.1.0"
