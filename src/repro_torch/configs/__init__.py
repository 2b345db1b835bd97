"""Selectable model configurations: BraggNN's
(:mod:`repro_torch.configs.braggnn`, which the tuner's CLI reads) and the
dense decoder LMs ported so far, by name through
:mod:`repro_torch.configs.registry`."""
