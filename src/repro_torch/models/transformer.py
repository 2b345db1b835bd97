"""A whisper_tiny-shaped transformer encoder block in PyTorch — the module
graph and its plain tensor twin.

``build`` is the model description ``repro_torch.hls.compile`` lowers
through the nn -> loop-nest bridge, the twin of the scalar loop-nest
program ``repro_torch.core.frontend.transformer_encoder_block``:

    x = x + Attn(RMS(x));  x = x + MLP(RMS(x));  out = RMS(x)

``forward`` is the tensor-level twin the ``tensor`` serving backend runs.
It mirrors the DFG's functional model — the softmax is the paper's
Taylor-exp approximation (order-k series with 2^r range reduction), not
``torch.softmax`` — so the fp32 DFG matches it to rounding.  Parameters
are nested dicts of tensors in the reference's param-tree layout;
:func:`params_from_numpy` carries the JAX package's parameters across.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.precision import FORMATS, quantize
from repro_torch.nn import graph as nng
from repro_torch.nn.attention import out_project, qkv_project
from repro_torch.nn.module import map_tree
# the model's own name for the loader, as models/braggnn.py has it
from repro_torch.nn.module import params_from_numpy  # noqa: F401


def build(seq: int = 16, d_model: int = 64, n_heads: int = 4,
          ffn: int = 256, *, params=None,
          taylor_order: int = 8, eps: float = 1e-5) -> nng.ModuleGraph:
    """The encoder block as a declarative
    :class:`~repro_torch.nn.graph.ModuleGraph`.

    Node names pin the hand-written ``frontend.transformer_encoder_block``
    memref/label scheme, so the bridged DFG is bit-identical (same
    ``graph_fingerprint``) to the hand-written one — and to the reference
    package's.  Defaults are whisper_tiny-shaped, trimmed to a 16-token
    window; ``params`` optionally binds a param tree (host-side: numpy
    arrays or CPU tensors).
    """
    nodes = [
        nng.Attention("attn", d_model=d_model, n_heads=n_heads,
                      taylor_order=taylor_order, eps=eps),
        nng.MLP("mlp", d_model=d_model, hidden=ffn, eps=eps),
        nng.RMSNorm("ln_post", dim=d_model, eps=eps),
    ]
    return nng.ModuleGraph(
        "encoder_block", (seq, d_model), nodes, params=params,
        forward_fn=functools.partial(forward, n_heads=n_heads,
                                     taylor_order=taylor_order, eps=eps),
        meta={"seq": seq, "d_model": d_model, "n_heads": n_heads,
              "ffn": ffn, "taylor_order": taylor_order})


def specs(seq: int = 16, d_model: int = 64, n_heads: int = 4,
          ffn: int = 256) -> dict:
    """The ParamSpec tree (derived from :func:`build` — one description)."""
    return build(seq, d_model, n_heads, ffn).specs()


def taylor_exp(x: torch.Tensor, *, order: int = 8,
               range_reduce: int = 2) -> torch.Tensor:
    """exp(x) the way the DFG computes it: k-th order Taylor series on
    x/2^r, squared r times (``Context.exp`` + ``frontend.soft_max``)."""
    z = x * (1.0 / (1 << range_reduce))
    acc = torch.ones_like(z) + z
    zk = z
    fact = 1.0
    for k in range(2, order + 1):
        zk = zk * z
        fact *= k
        acc = acc + zk * float(np.float32(1.0 / fact))
    for _ in range(range_reduce):
        acc = acc * acc
    return acc


def _softmax_taylor(scores: torch.Tensor, *, order: int) -> torch.Tensor:
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = taylor_exp(scores - m, order=order)
    return e / torch.sum(e, dim=-1, keepdim=True)


def _rms(x: torch.Tensor, gamma: torch.Tensor, *, eps: float
         ) -> torch.Tensor:
    # sum * (1/D), matching the DFG's reduction + const-multiply form
    ms = torch.sum(x * x, dim=-1, keepdim=True) * (1.0 / x.shape[-1])
    return x * (1.0 / torch.sqrt(ms + eps)) * gamma


def forward(params: dict, x: torch.Tensor, *, n_heads: int,
            taylor_order: int = 8, eps: float = 1e-5,
            fmt: Optional[str] = None) -> torch.Tensor:
    """x: (B, L, d_model) -> (B, L, d_model), on ``x``'s device, where
    ``params`` lie too.

    fmt: FloPoCo format key ('5_11' | '5_4' | '5_3') — quantises weights
    and inter-layer activations, modelling the reduced-precision datapath
    (coarser than the DFG's per-op functional model, so quantised
    comparisons need loose tolerances).
    """
    q = (lambda a: quantize(a, FORMATS[fmt])) if fmt else (lambda a: a)
    p = map_tree(q, params)
    x = q(torch.as_tensor(x, dtype=torch.float32))

    # --- attention sub-block ------------------------------------------------
    h = q(_rms(x, p["attn"]["norm"]["gamma"], eps=eps))
    qh, kh, vh = qkv_project(p["attn"], h)                 # (B,L,H,dh)
    dh = qh.shape[-1]
    inv = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    scores = q(torch.einsum("bshk,bthk->bhst", qh, kh) * inv)
    attn = q(_softmax_taylor(scores, order=taylor_order))
    y = q(torch.einsum("bhst,bthk->bshk", attn, vh))
    x = q(x + q(out_project(p["attn"], y)))

    # --- MLP sub-block ------------------------------------------------------
    h = q(_rms(x, p["mlp"]["norm"]["gamma"], eps=eps))
    h = q(torch.relu(h @ p["mlp"]["fc1"]["w"].T + p["mlp"]["fc1"]["b"]))
    h = q(h @ p["mlp"]["fc2"]["w"].T + p["mlp"]["fc2"]["b"])
    x = q(x + h)

    return q(_rms(x, p["ln_post"]["gamma"], eps=eps))
