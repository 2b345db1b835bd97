"""``repro_torch.hls`` — the one public compile-to-serve API.

High-level representations of DNNs in, deployable low-level designs out::

    import repro_torch.hls as hls
    from repro_torch.models import braggnn

    model = braggnn.build(s=1, params=params)          # described once
    design = hls.compile(model)                        # device="cuda"
    report = design.serve(batches, backend="cuda")     # the CUDA kernels

``compile`` accepts a :class:`~repro_torch.nn.graph.ModuleGraph`
(auto-lowered to the paper's loop nests by :mod:`repro_torch.hls.bridge`),
a loop-nest build callable, or a traced ``Graph``.  The returned
:class:`Design` carries the verbs: ``run`` (numpy functional model),
``torch_fn`` (the nest tier on the CUDA kernels), ``with_config``,
``serve`` and ``report``.
"""

from repro_torch.core.pipeline import CompiledDesign, CompilerConfig
from repro_torch.hls.api import (Design, ServeReport, Session, compile,
                                 trace)
from repro_torch.nn.graph import ModuleGraph

__all__ = [
    "compile",
    "trace",
    "Design",
    "Session",
    "ServeReport",
    "CompilerConfig",
    "CompiledDesign",
    "ModuleGraph",
]
