"""The nn -> loop-nest auto-lowering bridge (the headline of ``repro_torch.hls``).

Walks a :class:`repro_torch.nn.graph.ModuleGraph` and emits the corresponding
``repro_torch.core.frontend`` loop nests under a symbolic-interpretation
``Context`` — the missing link between "model described once, at the
tensor level" and the paper's scalar loop-nest programs.  Every node type
lowers through the *same* frontend function the hand-written programs use
(``conv2d``, ``linear``, ``non_local_block``, ...), so a module graph whose
names pin the hand-written memref/label scheme produces a bit-identical
DFG: ``hls.compile(models.braggnn.build(s))`` and the hand-written
``frontend.braggnn`` share one ``graph_fingerprint`` (proved by
``tests/test_hls_bridge.py``), and therefore one design-cache and
``TuningDB`` identity — tuning wins found on either path serve both.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.core import frontend
from repro_torch.core.interp import Context, MemRef
from repro_torch.nn.graph import (MLP, Attention, BatchNorm2d, Conv2d, Flatten,
                            Linear, MaxPool2d, ModuleGraph, NonLocalBlock,
                            OutputReLU, ReLU, RMSNorm, Softmax)


def _emit_conv2d(ctx: Context, node: Conv2d, cur: MemRef,
                 shape: tuple, kind: str) -> MemRef:
    w = ctx.memref(f"{node.prefix}.weight",
                   (node.out_channels, node.in_channels, node.kernel,
                    node.kernel), "weight")
    b = ctx.memref(f"{node.prefix}.bias", (node.out_channels,), "weight") \
        if node.bias else None
    out = ctx.memref(node.out_name, node.out_shape(shape), kind)
    frontend.conv2d(ctx, cur, w, b, out, stride=node.stride,
                    padding=node.padding, label=node.label)
    return out


def _emit_linear(ctx: Context, node: Linear, cur: MemRef,
                 shape: tuple, kind: str) -> MemRef:
    w = ctx.memref(f"{node.prefix}.weight",
                   (node.out_features, node.in_features), "weight")
    b = ctx.memref(f"{node.prefix}.bias", (node.out_features,), "weight") \
        if node.bias else None
    out = ctx.memref(node.out_name, node.out_shape(shape), kind)
    frontend.linear(ctx, cur, w, b, out, label=node.label)
    return out


def _emit_batch_norm(ctx: Context, node: BatchNorm2d, cur: MemRef,
                     shape: tuple, kind: str) -> MemRef:
    mems = {leaf: ctx.memref(f"{node.prefix}.{leaf}", (node.channels,),
                             "weight")
            for leaf in ("gamma", "beta", "mean", "var")}
    out = ctx.memref(node.out_name, node.out_shape(shape), kind)
    frontend.batch_norm_2d(ctx, cur, mems["gamma"], mems["beta"],
                           mems["mean"], mems["var"], out, eps=node.eps,
                           label=node.label)
    return out


def _emit_relu(ctx: Context, node: ReLU, cur: MemRef,
               shape: tuple, kind: str) -> MemRef:
    out = ctx.memref(node.out_name, node.out_shape(shape), kind)
    frontend.relu_layer(ctx, cur, out, label=node.label)
    return out


def _emit_output_relu(ctx: Context, node: OutputReLU, cur: MemRef,
                      shape: tuple, kind: str) -> MemRef:
    # in-place: rewrite the previous node's (output) symbol table, one
    # sequential nest per element — frontend.braggnn's final-ReLU form
    for idx in list(cur.table.keys()):
        with ctx.sequential(label=node.label):
            cur.table[idx] = ctx.relu(cur.table[idx])
    return cur


def _emit_max_pool(ctx: Context, node: MaxPool2d, cur: MemRef,
                   shape: tuple, kind: str) -> MemRef:
    out = ctx.memref(node.out_name, node.out_shape(shape), kind)
    frontend.max_pool_2d(ctx, cur, out, k=node.kernel, stride=node.stride,
                         label=node.label)
    return out


def _emit_softmax(ctx: Context, node: Softmax, cur: MemRef,
                  shape: tuple, kind: str) -> MemRef:
    out = ctx.memref(node.out_name, node.out_shape(shape), kind)
    frontend.soft_max(ctx, cur, out, taylor_order=node.taylor_order,
                      label=node.label)
    return out


def _emit_nlb(ctx: Context, node: NonLocalBlock, cur: MemRef,
              shape: tuple, kind: str) -> MemRef:
    if kind == "output":
        raise ValueError("NonLocalBlock cannot be the output node")
    return frontend.non_local_block(
        ctx, cur, channels=node.channels, mid_channels=node.mid_channels,
        prefix=node.prefix, taylor_order=node.taylor_order)


def _emit_flatten(ctx: Context, node: Flatten, cur: MemRef,
                  shape: tuple, kind: str) -> MemRef:
    out = ctx.memref(node.out_name, node.out_shape(shape), kind)
    frontend.copy_reshape(cur, out)
    return out


def _emit_rms_norm(ctx: Context, node: RMSNorm, cur: MemRef,
                   shape: tuple, kind: str) -> MemRef:
    gamma = ctx.memref(f"{node.prefix}.gamma", (shape[-1],), "weight")
    out = ctx.memref(node.out_name, node.out_shape(shape), kind)
    frontend.rms_norm(ctx, cur, gamma, out, eps=node.eps, label=node.label)
    return out


def _emit_attention(ctx: Context, node: Attention, cur: MemRef,
                    shape: tuple, kind: str) -> MemRef:
    l, d = shape
    h, dh = node.n_heads, node.head_dim
    src = cur
    if node.pre_norm:
        gamma = ctx.memref(f"{node.prefix}.norm.gamma", (d,), "weight")
        src = ctx.temp(f"{node.name}_norm", (l, d))
        frontend.rms_norm(ctx, cur, gamma, src, eps=node.eps,
                          label=f"{node.label}.norm")
    wq = ctx.memref(f"{node.prefix}.q.kernel", (d, h, dh), "weight")
    wk = ctx.memref(f"{node.prefix}.k.kernel", (d, h, dh), "weight")
    wv = ctx.memref(f"{node.prefix}.v.kernel", (d, h, dh), "weight")
    wo = ctx.memref(f"{node.prefix}.o.kernel", (h, dh, d), "weight")
    mix = ctx.temp(f"{node.name}_mix", (l, d)) if node.residual \
        else ctx.memref(node.out_name, (l, d), kind)
    frontend.attention(ctx, src, wq, wk, wv, wo, mix, n_heads=h,
                       taylor_order=node.taylor_order, label=node.label)
    if not node.residual:
        return mix
    out = ctx.memref(node.out_name, (l, d), kind)
    frontend.add_residual(ctx, mix, cur, out, label=f"{node.label}.residual")
    return out


def _emit_mlp(ctx: Context, node: MLP, cur: MemRef,
              shape: tuple, kind: str) -> MemRef:
    l, d = shape
    src = cur
    if node.pre_norm:
        gamma = ctx.memref(f"{node.prefix}.norm.gamma", (d,), "weight")
        src = ctx.temp(f"{node.name}_norm", (l, d))
        frontend.rms_norm(ctx, cur, gamma, src, eps=node.eps,
                          label=f"{node.label}.norm")
    w1 = ctx.memref(f"{node.prefix}.fc1.weight", (node.hidden, d), "weight")
    b1 = ctx.memref(f"{node.prefix}.fc1.bias", (node.hidden,), "weight")
    w2 = ctx.memref(f"{node.prefix}.fc2.weight", (d, node.hidden), "weight")
    b2 = ctx.memref(f"{node.prefix}.fc2.bias", (d,), "weight")
    fc = ctx.temp(f"{node.name}_fc", (l, d)) if node.residual \
        else ctx.memref(node.out_name, (l, d), kind)
    frontend.mlp(ctx, src, w1, b1, w2, b2, fc, label=node.label)
    if not node.residual:
        return fc
    out = ctx.memref(node.out_name, (l, d), kind)
    frontend.add_residual(ctx, fc, cur, out, label=f"{node.label}.residual")
    return out


_EMITTERS: dict[type, Callable] = {
    Conv2d: _emit_conv2d,
    Linear: _emit_linear,
    BatchNorm2d: _emit_batch_norm,
    ReLU: _emit_relu,
    OutputReLU: _emit_output_relu,
    MaxPool2d: _emit_max_pool,
    Softmax: _emit_softmax,
    NonLocalBlock: _emit_nlb,
    Flatten: _emit_flatten,
    RMSNorm: _emit_rms_norm,
    Attention: _emit_attention,
    MLP: _emit_mlp,
}


def emit_module(ctx: Context, module: ModuleGraph) -> MemRef:
    """Lower ``module`` to loop nests under ``ctx``; returns the output
    memref.  The *last memref-allocating* node writes an ``output``-kind
    memref (an ``OutputReLU`` tail rewrites it in place)."""
    shapes = module.shapes()
    last_alloc = max(i for i, n in enumerate(module.nodes)
                    if not isinstance(n, OutputReLU))
    cur = ctx.memref(module.input_name, module.input_shape, "input")
    shape = module.input_shape
    for i, node in enumerate(module.nodes):
        kind = "output" if i == last_alloc else "temp"
        cur = _EMITTERS[type(node)](ctx, node, cur, shape, kind)
        shape = shapes[i]
    return cur


def build_fn(module: ModuleGraph) -> Callable[[Context], None]:
    """The ``Context -> None`` build callable the ``CompilerDriver`` traces —
    ``hls.compile`` uses this to accept a ``ModuleGraph`` anywhere a
    hand-written build function is accepted."""
    def build(ctx: Context) -> None:
        emit_module(ctx, module)
    return build
