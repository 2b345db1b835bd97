"""Selectable model configurations.  So far only BraggNN's
(:mod:`repro_torch.configs.braggnn`), which the tuner's CLI reads."""
