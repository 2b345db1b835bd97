"""Optimizers over trees of tensors: AdamW and int8 error-feedback
gradient compression."""
from repro_torch.optim import adamw, compress

__all__ = ["adamw", "compress"]
