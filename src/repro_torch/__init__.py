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
    serving  — queue and percentile bookkeeping, the request engine
    trigger  — trigger budgets and the streaming trigger loop
    tune     — design-space search and its TuningDB
    optim    — AdamW and int8 error-feedback gradient compression
    data     — the seekable, host-sharded synthetic token pipeline
    checkpoint — atomic, async checkpoints (the reference's layout)
    runtime  — failure injection, the watchdog, the training driver
    examples — quickstart and BraggNN train-compile-serve
"""

__version__ = "0.1.0"
