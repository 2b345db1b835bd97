"""Selectable model configurations: BraggNN's
(:mod:`repro_torch.configs.braggnn`, which the tuner's CLI reads) and the
decoder LMs ported so far (dense, MoE and the RG-LRU hybrid), by name through
:mod:`repro_torch.configs.registry`."""
