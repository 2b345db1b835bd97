"""Runnable examples: ``python -m repro_torch.examples.quickstart``,
``python -m repro_torch.examples.braggnn_serve`` and ``python -m
repro_torch.examples.serve_moe`` (on the card by default; ``--device cpu``
runs the kernels' plain versions)."""
