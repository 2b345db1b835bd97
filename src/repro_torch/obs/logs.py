"""Logging conventions for the repo: one ``repro`` root logger.

Library modules call ``get_logger(__name__)`` and emit at the usual
levels; nothing under ``src/repro`` ever installs handlers.  The CLIs
(examples, benchmarks, ``python -m repro_torch.tune``) call
``setup_logging()`` exactly once, which attaches a single stdout handler
to the ``repro`` root logger — idempotent, so a CLI importing another
CLI's module does not double-log.  ``REPRO_LOG_LEVEL`` overrides the
level (e.g. ``REPRO_LOG_LEVEL=DEBUG``).
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

ROOT = "repro_torch"
_FORMAT = "%(message)s"


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """Module-level logger under the ``repro`` hierarchy.  Pass
    ``__name__``; names outside the hierarchy (``examples.*``,
    ``benchmarks.*``) are re-rooted so one ``setup_logging()`` call
    governs them all."""
    if not name:
        return logging.getLogger(ROOT)
    if name != ROOT and not name.startswith(ROOT + "."):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)


def setup_logging(level: Optional[str] = None, stream=None,
                  force: bool = False) -> logging.Logger:
    """Configure the ``repro`` root logger once (CLI entry points only).

    Attaches a plain-format handler writing to ``stream`` (default
    ``sys.stdout``, so CLI progress reads like the prints it replaced)
    and sets the level from ``level`` or ``$REPRO_LOG_LEVEL`` (default
    INFO).  Re-invocations are no-ops unless ``force=True``.
    """
    root = logging.getLogger(ROOT)
    if root.handlers and not force:
        return root
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root.addHandler(handler)
    lvl = (level or os.environ.get("REPRO_LOG_LEVEL") or "INFO").upper()
    root.setLevel(getattr(logging, lvl, logging.INFO))
    root.propagate = False
    return root
