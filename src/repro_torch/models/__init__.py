"""Assembled models: BraggNN, the transformer encoder block, the decoder
LM's serving entry points (:mod:`repro_torch.models.lm`) and the
encoder-decoder (:mod:`repro_torch.models.encdec`)."""
