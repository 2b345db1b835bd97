"""Runnable examples: ``python -m repro_torch.examples.quickstart`` and
``python -m repro_torch.examples.braggnn_serve`` (on the card by default;
``--device cpu`` runs the kernels' plain versions)."""
