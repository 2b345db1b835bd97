"""Build the CUDA kernels of ``repro_torch/csrc`` and bind them with ctypes.

Every ``*.cu`` source is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), and the objects are linked into one
shared library with a plain C interface.  The library lands in
``repro_torch/_kbuild/``, named by a hash of the sources and flags, so an
edit rebuilds and an unchanged tree loads the existing file.  Nothing is
built on import: the first kernel launch calls :func:`library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kbuild"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry point -> argument types (every one returns a cudaError_t as int)
SIGNATURES = {
    "conv2d_vmem_f32": [_P] * 5 + [_I] * 12 + [_P],
    "conv2d_vmem_smem_bytes": [_I] * 6,
    "fused_softmax_f32": [_P, _P] + [_I] * 6 + [_P],
    "smallfloat_matmul_f32": [_P] * 4 + [_I] * 12 + [_P],
    "smallfloat_matmul_bf16": [_P] * 4 + [_I] * 12 + [_P],
    "quantize_f32": [_P, _P, ctypes.c_longlong, _I, _I, _P],
}


class BuildInfo:
    """What the last :func:`library` call did: the library path, whether it
    was compiled in this process, the seconds that took, and nvcc's output
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""

    path: Optional[Path] = None
    compiled: bool = False
    seconds: float = 0.0
    log: str = ""


info = BuildInfo()
_lib: Optional[ctypes.CDLL] = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(repr(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built with the CUDA toolkit")


def build() -> Path:
    """Compile the sources (if this tree's hash has no library yet)."""
    so = BUILD_DIR / f"librepro_torch_{source_hash()}.so"
    info.path = so
    if so.exists():
        return so
    nvcc = _nvcc()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate(timeout=900)
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        info.log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{info.log}")
        tmp_so = Path(tmp) / so.name
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp_so),
                               *map(str, objs)],
                              capture_output=True, text=True, timeout=300)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_so, so)   # atomic: concurrent builds race benignly
    info.compiled = True
    info.seconds = time.perf_counter() - t0
    return so


def library() -> ctypes.CDLL:
    """The kernels' shared library, built and loaded on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")
