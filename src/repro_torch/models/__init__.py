"""Assembled models: BraggNN, the transformer encoder block, and the
decoder LM's serving entry points (:mod:`repro_torch.models.lm`)."""
