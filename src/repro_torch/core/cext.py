"""Lazy in-tree C kernel builds — stdlib ``ctypes`` plus the system ``cc``.

The compiler hot path has one genuinely order-serial loop (the ASAP
resource-serialisation core); everything around it is numpy array programs.
Rather than pull in a JIT dependency, the reference C source shipped next
to this module (``_asap.c``) is compiled once per source revision into a
content-hashed shared object under ``_cbuild/`` and bound through ctypes.

Every call site must treat ``None`` from :func:`asap_pool_lib` as "no
kernel" and fall back to the pure-Python loop — machines without a C
compiler (or with ``REPRO_TORCH_NO_CEXT=1``) lose speed, never correctness.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import Optional

_SRC = pathlib.Path(__file__).with_name("_asap.c")

_lib: Optional[ctypes.CDLL] = None
_tried = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_ASAP_ARGTYPES = (
    [ctypes.c_int64] * 2 + [_I64P] * 8 + [ctypes.c_int64] * 6 + [_I64P] * 5)


def _build() -> ctypes.CDLL:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    cache_dir = pathlib.Path(
        os.environ.get("REPRO_TORCH_CEXT_DIR", str(_SRC.parent / "_cbuild")))
    so = cache_dir / f"_asap_{tag}.so"
    if not so.exists():
        cache_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
        cc = os.environ.get("CC", "cc")
        subprocess.run(
            [cc, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: concurrent builds race benignly
    lib = ctypes.CDLL(str(so))
    lib.asap_pool.restype = ctypes.c_int
    lib.asap_pool.argtypes = _ASAP_ARGTYPES
    return lib


def asap_pool_lib() -> Optional[ctypes.CDLL]:
    """The compiled ASAP kernel, or ``None`` when unavailable.

    The first call pays the (cached) compile; failures of any kind latch to
    ``None`` for the process lifetime so the scheduler probes exactly once.
    """
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("REPRO_TORCH_NO_CEXT", "") == "1":
        return None
    try:
        _lib = _build()
    except Exception:
        _lib = None
    return _lib
