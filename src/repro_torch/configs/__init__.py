"""Selectable model configurations: BraggNN's
(:mod:`repro_torch.configs.braggnn`, which the tuner's CLI reads) and the
decoder LMs ported so far (dense and MoE), by name through
:mod:`repro_torch.configs.registry`."""
