"""BraggNN in PyTorch (paper Listing 5) — the module graph and its plain
tensor twin.

``build`` is the single-source model description that
``repro_torch.hls.compile`` lowers through the nn -> loop-nest bridge;
``forward`` is the tensor-level twin the ``tensor`` serving backend runs
(fp32 accumulation, per-layer quantisation, a true-exp softmax);
``loss_fn`` and ``make_step`` train that twin by autograd and AdamW.
Parameters are nested dicts of tensors (the reference's param-tree layout);
:func:`params_from_numpy` carries the JAX package's parameters across.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.graphs import GraphRunner, copy_all
from repro_torch.core.precision import FORMATS, quantize
from repro_torch.nn import graph as nng
from repro_torch.nn.module import (map_tree, params_from_numpy, tree_flatten,
                                   tree_unflatten)
from repro_torch.optim import adamw

ACCUM = torch.float32


def build(s: int = 1, img: int = 11, *, params=None,
          taylor_order: int = 8) -> nng.ModuleGraph:
    """BraggNN(s) as a declarative :class:`~repro_torch.nn.graph.ModuleGraph`.

    ``.specs()`` is the param tree, and ``repro_torch.hls.compile(build(...))``
    auto-lowers it to the loop-nest DFG via the bridge.  Node
    names/prefixes/labels pin the hand-written ``frontend.braggnn`` memref
    scheme, so the bridged DFG is bit-identical (same ``graph_fingerprint``)
    to the hand-written one — and to the reference package's.  ``params``
    optionally binds a param tree (host-side: numpy arrays or CPU tensors;
    the serving runners upload it to their device once).
    """
    c1, c2 = 16 * s, 8 * s
    h3 = img - 6
    n_flat = 2 * s * h3 * h3
    dims = [n_flat, 16 * s, 8 * s, 4 * s, 2]
    nodes = [
        nng.Conv2d("conv1", in_channels=1, out_channels=c1, kernel=3,
                   out_name_="feat", label_="cnn_layers_1"),
        nng.NonLocalBlock("nlb", channels=c1, mid_channels=c2,
                          taylor_order=taylor_order),
        nng.ReLU(out_name_="cnn2_relu0", label_="cnn_layers_2.relu0"),
        nng.Conv2d("conv2a", in_channels=c1, out_channels=c2, kernel=3,
                   prefix_="cnn2.conv1", out_name_="cnn2_conv1",
                   label_="cnn_layers_2.conv1"),
        nng.ReLU(out_name_="cnn2_relu1", label_="cnn_layers_2.relu1"),
        nng.Conv2d("conv2b", in_channels=c2, out_channels=2 * s, kernel=3,
                   prefix_="cnn2.conv2", out_name_="cnn2_conv2",
                   label_="cnn_layers_2.conv2"),
        nng.ReLU(out_name_="cnn2_relu2", label_="cnn_layers_2.relu2"),
        nng.Flatten(out_name_="flat"),
    ]
    for li in range(4):
        nodes.append(nng.Linear(
            f"dense{li}", in_features=dims[li], out_features=dims[li + 1],
            prefix_=f"dense.{li}", out_name_=f"dense_{li}_out",
            label_=f"dense.{li}"))
        if li < 3:
            nodes.append(nng.ReLU(out_name_=f"dense_{li}_relu",
                                  label_=f"dense.{li}.relu"))
    nodes.append(nng.OutputReLU(label_="dense.final_relu"))
    # functools.partial (not a lambda) keeps the module picklable
    return nng.ModuleGraph(
        "braggnn", (1, 1, img, img), nodes, params=params,
        forward_fn=functools.partial(forward, s=s),
        meta={"s": s, "img": img})


def specs(s: int = 1, img: int = 11) -> dict:
    """The ParamSpec tree (derived from :func:`build` — one description)."""
    return build(s, img).specs()


def _conv(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor]) -> torch.Tensor:
    """Valid-padding NCHW conv (matches the loop-nest semantics)."""
    y = F.conv2d(x.to(ACCUM), w.to(ACCUM))
    if b is not None:
        y = y + b.to(ACCUM)[None, :, None, None]
    return y


def forward(params: dict, x: torch.Tensor, *, s: int = 1,
            fmt: Optional[str] = None) -> torch.Tensor:
    """x: (B, 1, img, img) -> (B, 2) peak centre estimates.

    fmt: FloPoCo format key ('5_11' | '5_4' | '5_3') — quantises weights
    *and* inter-layer activations, modelling the paper's reduced-precision
    datapath end to end.  ``params`` lie on ``x``'s device.
    """
    q = (lambda a: quantize(a, FORMATS[fmt])) if fmt else (lambda a: a)
    p = map_tree(q, params)

    feat = q(_conv(x, p["conv1"]["w"], p["conv1"]["b"]))       # (B,c1,9,9)
    b, c1, h, w = feat.shape
    n = h * w

    def conv1x1(name):
        return q(_conv(feat, p["nlb"][name]["w"], None))       # (B,c2,9,9)

    theta, phi, g = conv1x1("theta"), conv1x1("phi"), conv1x1("g")
    c2 = theta.shape[1]
    tf = theta.reshape(b, c2, n)
    pf = phi.reshape(b, c2, n)
    gf = g.reshape(b, c2, n)
    scores = q(torch.bmm(tf.transpose(1, 2), pf))              # (B,n,n)
    attn = torch.softmax(scores, dim=-1)
    y = q(torch.bmm(gf, attn.transpose(1, 2))).reshape(b, c2, h, w)
    z = q(_conv(y, p["nlb"]["out"]["w"], None))
    feat = q(feat + z)

    r = torch.relu(feat)
    r = torch.relu(q(_conv(r, p["conv2a"]["w"], p["conv2a"]["b"])))
    r = torch.relu(q(_conv(r, p["conv2b"]["w"], p["conv2b"]["b"])))
    flat = r.reshape(b, -1)
    for li in range(4):
        d = p[f"dense{li}"]
        flat = q(flat @ d["w"].to(ACCUM).T + d["b"].to(ACCUM))
        flat = torch.relu(flat)
    return flat


def loss_fn(params: dict, x: torch.Tensor, y: torch.Tensor, *,
            s: int = 1) -> torch.Tensor:
    """Mean squared error of the peak centre, labels scaled by 10."""
    return torch.mean((forward(params, x, s=s) - y * 10.0) ** 2)


def make_step(opt_cfg: adamw.AdamWConfig, *, s: int = 1):
    """``step(params, state, x, y) -> (params, state, loss)``: the loss and
    its gradients by autograd over the tensor twin, then one AdamW update.
    Functional: the given params and state are left as they were.

    On the card the step is one captured CUDA graph per batch shape, as
    the reference jits it (:class:`~repro_torch.core.graphs.GraphRunner`:
    the first call runs eagerly and captures): each call copies the
    parameters, moments, step count and batch into the graph's static
    inputs, replays it, and returns copies of its static outputs, which
    the caller may keep.  On the CPU it runs eagerly on copies (AdamW
    updates in place); ``step.eager`` runs it so anywhere."""
    def update(params, state, x, y):
        """The step, written into ``params`` and ``state``."""
        leaves, treedef = tree_flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        loss = loss_fn(tree_unflatten(treedef, live), x, y, s=s)
        grads = torch.autograd.grad(loss, live)
        adamw.apply_updates(opt_cfg, params,
                            tree_unflatten(treedef, list(grads)), state)
        return params, state, loss.detach()

    def eager(params, state, x, y):
        leaves, treedef = tree_flatten((params, state))
        params, state = tree_unflatten(treedef, [t.clone() for t in leaves])
        return update(params, state, x, y)

    runners: dict = {}               #: (device, tree) -> its GraphRunner

    def step(params, state, x, y):
        if x.device.type != "cuda":
            return eager(params, state, x, y)
        leaves, treedef = tree_flatten((params, state))
        run = runners.get((x.device, treedef))
        if run is None:
            n = len(leaves)

            def call(feeds):
                p, st = tree_unflatten(treedef, [feeds[str(i)] for i in
                                                 range(n)])
                new_p, new_s, loss = update(p, st, feeds["x"], feeds["y"])
                return tree_flatten((new_p, new_s))[0] + [loss]
            run = runners[(x.device, treedef)] = GraphRunner(call, x.device)
        out = run({**{str(i): t for i, t in enumerate(leaves)},
                   "x": x, "y": y})
        kept = [torch.empty_like(t) for t in out]
        copy_all(kept, out)
        new_p, new_s = tree_unflatten(treedef, kept[:-1])
        return new_p, new_s, kept[-1]

    step.eager = eager
    return step


def params_from_feeds(feeds: dict[str, np.ndarray], s: int = 1) -> dict:
    """Adapt the scalar-DFG feed dict (frontend.braggnn names, batch index 0)
    into this model's param tree — lets a testbench drive both paths with
    identical weights."""
    f = {k: np.asarray(v)[0] for k, v in feeds.items()}
    out = {
        "conv1": {"w": f["conv1.weight"], "b": f["conv1.bias"]},
        "nlb": {
            "theta": {"w": f["nlb.theta.weight"]},
            "phi": {"w": f["nlb.phi.weight"]},
            "g": {"w": f["nlb.g.weight"]},
            "out": {"w": f["nlb.out_cnn.weight"]},
        },
        "conv2a": {"w": f["cnn2.conv1.weight"], "b": f["cnn2.conv1.bias"]},
        "conv2b": {"w": f["cnn2.conv2.weight"], "b": f["cnn2.conv2.bias"]},
    }
    for li in range(4):
        out[f"dense{li}"] = {"w": f[f"dense.{li}.weight"],
                             "b": f[f"dense.{li}.bias"]}
    return params_from_numpy(out)


def synthetic_peaks(n: int, img: int = 11, generator=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian-blob Bragg-peak surrogates + centre labels (CPU tensors;
    ``generator`` seeds them)."""
    centers = 3.0 + torch.rand((n, 2), generator=generator) * (img - 6.0)
    sigma = 0.8 + torch.rand((n, 1, 1), generator=generator) * 0.8
    yy, xx = torch.meshgrid(torch.arange(img, dtype=torch.float32),
                            torch.arange(img, dtype=torch.float32),
                            indexing="ij")
    blob = torch.exp(-(((yy[None] - centers[:, 0, None, None]) ** 2
                        + (xx[None] - centers[:, 1, None, None]) ** 2)
                       / (2 * sigma ** 2)))
    noise = 0.02 * torch.randn(blob.shape, generator=generator)
    imgs = (blob + noise)[:, None, :, :].to(torch.float32)
    labels = centers / img                      # normalised to [0,1]
    return imgs, labels.to(torch.float32)
