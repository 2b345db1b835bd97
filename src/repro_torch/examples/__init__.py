"""Runnable examples: ``python -m repro_torch.examples.quickstart``,
``python -m repro_torch.examples.braggnn_serve``, ``python -m
repro_torch.examples.serve_moe`` and ``python -m
repro_torch.examples.train_lm`` (on the card by default; ``--device cpu``
runs the kernels' plain versions)."""
