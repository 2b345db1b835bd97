"""CUDA emission, nest-pattern tier: compile the bridged module, don't
interpret it.

The counterpart of the nest-pattern tier of the reference's
``repro/core/emit_pallas.py`` (``to_pallas_fn``'s ``mode='nests'`` branch,
``_lower_module``, ``_nlb_step``, ``_normalize_weights``, ``PallasPlan``).
When the design carries the ``ModuleGraph`` it was bridged from, each node
lowers through the kernel registry (:mod:`repro_torch.kernels.registry`):
``Conv2d`` -> the weights-resident conv, ``Linear`` -> the smallfloat
matmul, ``Softmax`` and the NLB attention softmax -> the fused Taylor
softmax.  ReLU nodes fuse into the preceding conv/matmul kernel.  Nodes
without a registered kernel (batch norm, pooling, strided/padded conv,
RMS norm) run as plain PyTorch and are recorded as fallbacks in the
:class:`KernelPlan`, exactly as the reference records them.  The two NLB
contractions (scores and mix) are ``torch.bmm`` calls outside any kernel,
as the reference leaves them to ``jnp.einsum``.

With a ``fmt`` every kernel result is rounded to the format, as the
reference rounds it after each kernel.  The kernels do that rounding
themselves — conv and matmul in their epilogue, the NLB residual in the
out-projection conv's epilogue, the NLB scores as the softmax reads them
— so the quantised path launches the same kernels as the fp32 one and
nothing beside them but the two ``torch.bmm``.

On a CUDA device every registry step launches a hand-written kernel; on
the CPU (only when asked for with ``device="cpu"``) the same steps run the
kernels' plain versions.  The bound weights are uploaded to the device
once, when the runner is built; per batch only the input moves.

Not ported yet: the generic DFG tier (ROADMAP queue 1 item 8, kernel K4),
the ``Attention``/``MLP`` steps of the transformer slice (item 12) and the
flash-attention NLB mode (kernel K5).  Each raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core import device as devices
from repro_torch.core.ir import Graph
from repro_torch.core.precision import FORMATS, FloatFormat, quantize
from repro_torch.kernels import registry as kreg


def _norm_fmt(fmt) -> tuple[Optional[FloatFormat], Optional[str]]:
    """-> (FloatFormat or None, format key or None)."""
    if fmt is None or fmt == "fp32":
        return None, None
    if isinstance(fmt, str):
        return FORMATS[fmt], fmt
    if isinstance(fmt, FloatFormat):
        key = next((k for k, v in FORMATS.items() if v == fmt), None)
        return fmt, key or f"{fmt.exp_bits}_{fmt.man_bits}"
    raise TypeError(f"fmt must be None, a FORMATS key or a FloatFormat, "
                    f"got {type(fmt).__name__}")


@dataclasses.dataclass
class KernelPlan:
    """What the lowering actually did — serving telemetry + test surface.

    The reference's ``PallasPlan`` field for field, minus ``interpret``;
    ``use_kernels`` (the reference's ``use_pallas``) says whether the
    hand-written CUDA kernels serve (False: their plain versions on the
    CPU).
    """

    mode: str                                  #: 'nests' (| 'dfg' later)
    use_kernels: bool                          #: CUDA kernels launched?
    fmt: Optional[str] = None                  #: FloPoCo key, None = fp32
    n_groups: int = 0                          #: levelised groups (dfg tier)
    n_segments: int = 0                        #: fused kernels (dfg tier)
    fused_scatters: int = 0                    #: scatter->gather pairs elided
    kernels: dict = dataclasses.field(default_factory=dict)
    fallbacks: list = dataclasses.field(default_factory=list)
    notes: list = dataclasses.field(default_factory=list)

    def record_kernel(self, name: str) -> None:
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def summary(self) -> str:
        kern = ", ".join(f"{k}x{v}" for k, v in sorted(self.kernels.items()))
        parts = [f"cuda[{self.mode}]"]
        if kern:
            parts.append(kern)
        parts.append(f"{len(self.fallbacks)} fallbacks")
        if not self.use_kernels:
            parts.append("plain versions (CPU tensors)")
        return "; ".join(parts)


# ---------------------------------------------------------------------------
# Nest-pattern tier: registry kernels per bridged module node
# ---------------------------------------------------------------------------

def _lower_module(module, *, fmt_obj, fmt_tuple, plan: KernelPlan):
    from repro_torch.nn import graph as nng

    if module.input_shape[0] != 1 and len(module.input_shape) != 2:
        raise ValueError(
            f"nest tier expects a per-sample memref input shape with a "
            f"leading 1 (image models) or a 2-D (L, D) sequence shape, "
            f"got {module.input_shape}")

    conv_e = kreg.for_pattern("Conv2d")
    mm_e = kreg.for_pattern("Linear")
    sm_e = kreg.for_pattern("Softmax")
    q = (lambda x: quantize(x, fmt_obj)) if fmt_obj is not None \
        else (lambda x: x)

    nodes = list(module.nodes)
    weight_names: list[str] = []
    for n in nodes:
        weight_names.extend(n.weight_memrefs())

    steps: list[Callable] = []   # each: (x, w: dict) -> x
    step_labels: list[str] = []  # one per step, for profiling spans
    i = 0
    while i < len(nodes):
        node = nodes[i]
        fuse_relu = (i + 1 < len(nodes)
                     and isinstance(nodes[i + 1],
                                    (nng.ReLU, nng.OutputReLU)))
        if isinstance(node, nng.Conv2d):
            wn, bn = f"{node.prefix}.weight", f"{node.prefix}.bias"
            has_b = node.bias
            if node.stride == 1 and node.padding == 0:
                plan.record_kernel(conv_e.name + (":relu" if fuse_relu
                                                 else ""))

                def step(x, w, wn=wn, bn=bn, has_b=has_b, fr=fuse_relu):
                    return conv_e.fn(x, w[wn], w[bn] if has_b else None,
                                     fmt=fmt_tuple, fuse_relu=fr,
                                     out_fmt=fmt_tuple)
            else:
                plan.fallbacks.append(
                    f"{node.name}: Conv2d(stride={node.stride}, "
                    f"padding={node.padding}) via torch")

                def step(x, w, wn=wn, bn=bn, has_b=has_b, fr=fuse_relu,
                         node=node):
                    xq, wq = x, w[wn]
                    if fmt_obj is not None:
                        xq, wq = q(xq), q(wq)
                    y = F.conv2d(xq, wq, stride=node.stride,
                                 padding=node.padding)
                    if has_b:
                        y = y + w[bn][None, :, None, None]
                    if fr:
                        y = torch.relu(y)
                    return q(y)
        elif isinstance(node, nng.Linear):
            wn, bn = f"{node.prefix}.weight", f"{node.prefix}.bias"
            has_b = node.bias
            eb = fmt_obj.exp_bits if fmt_obj is not None else None
            mb = fmt_obj.man_bits if fmt_obj is not None else None
            plan.record_kernel(mm_e.name + (":relu" if fuse_relu else ""))

            def step(x, w, wn=wn, bn=bn, has_b=has_b, fr=fuse_relu,
                     eb=eb, mb=mb):
                # loop-nest semantics: out = x @ W.T + b (W.T is a strided
                # view the kernel reads in place)
                return mm_e.fn(x, w[wn].T, w[bn] if has_b else None,
                               exp_bits=eb, man_bits=mb, fuse_relu=fr,
                               out_fmt=fmt_tuple)
        elif isinstance(node, nng.Softmax):
            plan.record_kernel(sm_e.name)

            def step(x, w, node=node, fr=fuse_relu):
                y = sm_e.fn(x, taylor_order=node.taylor_order)
                return torch.relu(y) if fr else y
        elif isinstance(node, nng.NonLocalBlock):
            steps.append(_nlb_step(node, conv_e, sm_e, fmt_tuple, plan))
            step_labels.append(_node_label(node))
            i += 1
            continue
        elif isinstance(node, nng.BatchNorm2d):
            plan.fallbacks.append(f"{node.name}: BatchNorm2d via torch")
            pre = node.prefix

            def step(x, w, pre=pre, node=node, fr=fuse_relu):
                ga, be = w[f"{pre}.gamma"], w[f"{pre}.beta"]
                mu, va = w[f"{pre}.mean"], w[f"{pre}.var"]
                if fmt_obj is not None:
                    x, ga, be = q(x), q(ga), q(be)
                    mu, va = q(mu), q(va)
                den = torch.sqrt(va + node.eps)
                y = ga[None, :, None, None] \
                    * (x - mu[None, :, None, None]) \
                    / den[None, :, None, None] + be[None, :, None, None]
                if fr:
                    y = torch.relu(y)
                return q(y)
        elif isinstance(node, nng.MaxPool2d):
            plan.fallbacks.append(f"{node.label}: MaxPool2d via "
                                  f"max_pool2d")

            def step(x, w, node=node, fr=fuse_relu):
                y = F.max_pool2d(x, node.kernel, node.stride)
                return torch.relu(y) if fr else y
        elif isinstance(node, nng.RMSNorm):
            plan.fallbacks.append(f"{node.name}: RMSNorm via torch")
            pre = node.prefix

            def step(x, w, pre=pre, node=node):
                ga = w[f"{pre}.gamma"]
                if fmt_obj is not None:
                    x, ga = q(x), q(ga)
                ms = torch.sum(x * x, dim=-1, keepdim=True) \
                    * (1.0 / x.shape[-1])
                return q(x * (1.0 / torch.sqrt(ms + node.eps)) * ga)
            fuse_relu = False
        elif isinstance(node, (nng.Attention, nng.MLP)):
            raise NotImplementedError(
                f"{node.name}: the nest tier's {type(node).__name__} step "
                f"comes with the transformer slice (ROADMAP queue 1 item "
                f"12; its attention needs kernel K5)")
        elif isinstance(node, (nng.ReLU, nng.OutputReLU)):
            def step(x, w):
                return torch.relu(x)
            fuse_relu = False
        elif isinstance(node, nng.Flatten):
            def step(x, w):
                return x.reshape(x.shape[0], -1)
            fuse_relu = False
        else:  # pragma: no cover - ModuleGraph validates the vocabulary
            raise NotImplementedError(type(node).__name__)
        steps.append(step)
        step_labels.append(_node_label(node) + (":relu" if fuse_relu
                                                else ""))
        i += 2 if fuse_relu else 1

    # the output memref is the last allocating node's (OutputReLU rewrites
    # it in place) — mirror hls.bridge.emit_module
    last_alloc = max(j for j, n in enumerate(nodes)
                     if not isinstance(n, nng.OutputReLU))
    out_name = nodes[last_alloc].out_name
    out_shape = module.shapes()[-1]

    def run(x, weights):
        for step in steps:
            x = step(x, weights)
        return {out_name: x.reshape((x.shape[0],) + tuple(out_shape))}

    def profile(x, weights):
        # twin of ``run``: one span + device sync per registry kernel, so
        # the per-kernel cost is observable
        for label, step in zip(step_labels, steps):
            with obs.span(f"cuda.kernel.{label}", cat="cuda"):
                x = step(x, weights)
                devices.synchronize(x.device)
        return {out_name: x.reshape((x.shape[0],) + tuple(out_shape))}

    run.profile = profile
    return run, weight_names, out_name


def _node_label(node) -> str:
    return str(getattr(node, "name", None) or getattr(node, "label", None)
               or type(node).__name__)


def _nlb_step(node, conv_e, sm_e, fmt_tuple, plan: KernelPlan):
    """The NonLocalBlock composite: three 1x1 convs -> attention ->
    out-projection -> residual, every stage but the two contractions
    through a registry kernel.

    The reference rounds theta/phi/g, the scores, the mix, the projection
    and the residual sum to ``fmt``.  Here the convs round their results
    and the residual sum in their epilogue, the softmax rounds the scores
    as it reads them, and the mix needs no rounding of its own: the
    out-projection conv rounds its input operand to the same format."""
    pre = node.prefix
    plan.record_kernel(conv_e.name)          # theta/phi/g (batched 1x1)
    plan.record_kernel(sm_e.name)

    def conv(x, wt, residual=None):
        return conv_e.fn(x, wt, None, fmt=fmt_tuple, out_fmt=fmt_tuple,
                         residual=residual)

    def step(x, w):
        b, c1, h, _ = x.shape
        n = h * h
        theta = conv(x, w[f"{pre}.theta.weight"])
        phi = conv(x, w[f"{pre}.phi.weight"])
        g = conv(x, w[f"{pre}.g.weight"])
        c2 = theta.shape[1]
        tf = theta.reshape(b, c2, n)
        pf = phi.reshape(b, c2, n)
        gf = g.reshape(b, c2, n)
        # scores[b,i,j] = sum_c theta[b,c,i] phi[b,c,j]
        scores = torch.bmm(tf.transpose(1, 2), pf)
        attn = sm_e.fn(scores, taylor_order=node.taylor_order,
                       in_fmt=fmt_tuple)
        # mix[b,c,i] = sum_j attn[b,i,j] g[b,c,j]
        yc = torch.bmm(gf, attn.transpose(1, 2))
        y4 = yc.reshape(b, c2, h, h)
        return conv(y4, w[f"{pre}.out_cnn.weight"], residual=x)

    return step


# ---------------------------------------------------------------------------
# Front door
# ---------------------------------------------------------------------------

def to_cuda_fn(g: Graph, *, module=None, fmt=None, mode: str = "auto",
               device=None, weights: Optional[dict] = None,
               nlb_flash: bool = False) -> Callable:
    """Compile a DFG plus its source ``ModuleGraph`` to a torch callable.

    The returned callable takes one batch — the input memref's array or
    tensor (``(B,) + shape``, one unbatched sample, or for image models
    the natural ``(B, C, H, W)``), or a feed dict holding only that
    memref — and returns
    ``{output name: (batch,) + shape}`` as tensors on ``device``.  It
    carries its :class:`KernelPlan` as ``.plan`` and its device as
    ``.device``.

    ``weights`` (memref name -> array or tensor, unbatched or with a
    batch axis that does not vary) defaults to the module's bound
    parameters; they are normalised and uploaded once, here.  ``fmt`` (a
    FloPoCo key or ``FloatFormat``) quantises each kernel's operands and
    result.  ``device`` defaults to ``"cuda"`` and raises without a GPU;
    ``device="cpu"`` runs the kernels' plain versions.
    """
    fmt_obj, fmt_key = _norm_fmt(fmt)
    if mode == "auto":
        mode = "nests" if module is not None else "dfg"
    if mode not in ("nests", "dfg"):
        raise ValueError(f"unknown cuda lowering mode {mode!r} "
                         f"(valid: auto, nests, dfg)")
    if mode == "dfg":
        raise NotImplementedError(
            "the generic DFG tier is not ported yet (ROADMAP queue 1 item "
            "8, kernel K4); compile from a ModuleGraph for the nest tier")
    if module is None:
        raise ValueError("mode='nests' needs the source ModuleGraph "
                         "(compile through repro_torch.hls with an nn "
                         "model)")
    if nlb_flash:
        raise NotImplementedError(
            "nlb_flash needs the flash_attention kernel (ROADMAP queue 2, "
            "K5)")
    dev = devices.resolve(device)
    plan = KernelPlan(mode=mode, use_kernels=dev.type == "cuda",
                      fmt=fmt_key)
    if dev.type == "cuda":
        torch.set_float32_matmul_precision("highest")
        plan.notes.append("NLB scores/mix: torch.bmm at float32 matmul "
                          "precision 'highest' (no TF32)")
    fmt_tuple = (fmt_obj.exp_bits, fmt_obj.man_bits) \
        if fmt_obj is not None else None
    with obs.span("emit.cuda", cat="cuda", mode=mode, fmt=fmt_key) as sp:
        core, weight_names, _ = _lower_module(
            module, fmt_obj=fmt_obj, fmt_tuple=fmt_tuple, plan=plan)
        sp.set(kernels=sum(plan.kernels.values()),
               fallbacks=len(plan.fallbacks))
    _plan_metrics(plan)

    if weights is None:
        weights = module.weight_feeds()
    missing = [n for n in weight_names if n not in weights]
    if missing:
        raise KeyError(f"missing weight feeds {missing}")
    host = {name: _host_array(weights[name]) for name in weight_names}
    wdev = {name: torch.as_tensor(arr, dtype=torch.float32).to(dev)
            for name, arr in _normalize_weights(host, module).items()}

    in_name = module.input_name
    in_shape = tuple(module.input_shape)
    rank = len(in_shape)
    profiled = [False]   # first obs-enabled call runs the span'd twin

    def run(inputs):
        x = inputs
        if isinstance(inputs, dict):
            extra = sorted(set(inputs) - {in_name})
            if extra:
                raise ValueError(
                    f"feeds {extra}: the runner reads only the input "
                    f"memref {in_name!r}; weights are bound when it is "
                    f"built (weights=)")
            x = inputs[in_name]
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        if in_shape[0] == 1 and tuple(x.shape[1:]) == in_shape[1:]:
            pass                               # a natural (B, C, H, W) batch
        elif x.dim() == rank:                  # unbatched sample
            x = x[None]
        if in_shape[0] == 1:
            # collapse the loop-nest's per-sample singleton batch axis
            x = x.reshape((x.shape[0],) + in_shape[1:])
        x = x.contiguous()
        with torch.inference_mode():
            if obs.enabled() and not profiled[0]:
                profiled[0] = True
                with obs.span("cuda.profile", cat="cuda", mode=mode):
                    return core.profile(x, wdev)
            return core(x, wdev)

    run.plan = plan
    run.device = dev
    return run


def _host_array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, dtype=np.float32)


def _plan_metrics(plan: KernelPlan) -> None:
    """Lift the lowering plan's counts into the process metrics."""
    obs.inc("cuda.lowerings")
    obs.inc("cuda.fallbacks", len(plan.fallbacks))
    for kname, n in plan.kernels.items():
        obs.inc(f"cuda.kernel.{kname}", n)


def _normalize_weights(w: dict[str, np.ndarray], module) -> dict:
    """Unbatch weight feeds (the nest tier shares one weight set across the
    batch, like the tensor path).  A *varying* batched weight feed cannot
    be expressed as shared kernel weights — fail loudly.
    """
    out = {}
    shapes = {}
    for n in module.nodes:
        sub = n.param_specs()
        if sub is None:
            continue
        for memref, path in n.weight_memrefs().items():
            leaf = sub
            for k in path:
                leaf = leaf[k]
            shapes[memref] = tuple(leaf.shape)
    for name, arr in w.items():
        want = shapes.get(name)
        if want is not None and arr.ndim == len(want) + 1:
            if arr.shape[0] > 1 and not np.all(arr == arr[0]):
                raise ValueError(
                    f"weight feed {name!r} varies across the batch; the "
                    f"nest-pattern tier shares one weight set (per-sample "
                    f"weights need the DFG tier, ROADMAP queue 1 item 8)")
            arr = arr[0]
        out[name] = arr
    return out
