"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

Each kernel directory holds:
  <name>.py — the launch wrapper around the CUDA C++ kernel in
              ``repro_torch/csrc/<name>.cu`` (built for sm_90a with nvcc at
              first use, bound with ctypes; counts its launches)
  ref.py    — the plain PyTorch version (the CPU path and the kernel's
              yardstick on the card)
  ops.py    — the public wrapper: the plain version for a CPU tensor, the
              kernel for a CUDA tensor, never a fallback between them

conv2d_vmem       — weights-resident BraggNN conv (paper's no-BRAM result)
fused_softmax     — fused softmax incl. Taylor-exp mode (paper §3/§4.1)
smallfloat_matmul — reduced-precision MAC array (paper §4.2)

``registry.py`` catalogues them as pattern-matched fast paths for the nest
tier (:mod:`repro_torch.core.emit_cuda`).
"""
