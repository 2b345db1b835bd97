"""Declarative nn module graphs — the single-source model description.

A ``ModuleGraph`` is an ordered list of layer nodes (the BraggNN vocabulary:
conv2d, linear, batch-norm, relu, max-pool, softmax, the non-local attention
block — plus the sequence-model vocabulary: rms-norm, multi-head attention,
position-wise MLP) and the model's input memref shape.  One description
serves every consumer:

  * ``repro_torch.hls.bridge`` walks it and emits the corresponding
    ``repro_torch.core.frontend`` loop nests — the nn -> loop-nest auto-lowering
    that feeds ``repro_torch.hls.compile``;
  * ``specs()`` yields the ``ParamSpec`` tree for training
    (``repro_torch.nn.module.init_tree``);
  * ``weight_feeds()`` binds a trained param tree to the loop-nest memref
    names, so the compiled design runs with the trained weights.

Nodes are pure data (frozen dataclasses): no interp/compiler imports here —
emission lives in the bridge, keeping this importable from training code.

Naming: ``name`` keys the node's subtree in the param tree; ``prefix``
(default: ``name``) prefixes its weight memrefs (``{prefix}.weight`` ...);
``out_name``/``label`` name the node's result memref and loop-nest label.
``repro_torch.models.braggnn.build`` pins these to the hand-written
``frontend.braggnn`` names, which is what makes the bridged DFG
bit-identical (fingerprint-equal) to the hand-written one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np

from repro_torch.nn.module import ParamSpec


def _valid_out(n: int, k: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - k) // stride + 1


@dataclasses.dataclass(frozen=True)
class Node:
    """Base layer node: naming common to the whole vocabulary."""

    name: str = ""

    @property
    def prefix(self) -> str:
        return self.name

    @property
    def label(self) -> str:
        return self.name

    @property
    def out_name(self) -> str:
        return f"{self.name}_out"

    def param_specs(self) -> Optional[dict]:
        """ParamSpec subtree for this node (``None`` = parameter-free)."""
        return None

    def weight_memrefs(self) -> dict[str, tuple[str, ...]]:
        """memref name -> path of the param leaf inside ``param_specs()``."""
        return {}

    def out_shape(self, in_shape: tuple[int, ...]) -> tuple[int, ...]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Conv2d(Node):
    """Valid/zero-padded 2D convolution (``frontend.conv2d``)."""

    in_channels: int = 0
    out_channels: int = 0
    kernel: int = 3
    stride: int = 1
    padding: int = 0
    bias: bool = True
    prefix_: Optional[str] = None
    label_: Optional[str] = None
    out_name_: Optional[str] = None

    @property
    def prefix(self) -> str:
        return self.prefix_ or self.name

    @property
    def label(self) -> str:
        return self.label_ or self.name

    @property
    def out_name(self) -> str:
        return self.out_name_ or f"{self.name}_out"

    def param_specs(self) -> dict:
        d = {"w": ParamSpec((self.out_channels, self.in_channels,
                             self.kernel, self.kernel), (None,) * 4)}
        if self.bias:
            d["b"] = ParamSpec((self.out_channels,), (None,), init="zeros")
        return d

    def weight_memrefs(self) -> dict[str, tuple[str, ...]]:
        d = {f"{self.prefix}.weight": ("w",)}
        if self.bias:
            d[f"{self.prefix}.bias"] = ("b",)
        return d

    def out_shape(self, in_shape):
        b, c, h, w = in_shape
        assert c == self.in_channels, (in_shape, self)
        return (b, self.out_channels,
                _valid_out(h, self.kernel, self.stride, self.padding),
                _valid_out(w, self.kernel, self.stride, self.padding))


@dataclasses.dataclass(frozen=True)
class Linear(Node):
    """Dense layer ``x @ W.T + b`` (``frontend.linear``)."""

    in_features: int = 0
    out_features: int = 0
    bias: bool = True
    prefix_: Optional[str] = None
    label_: Optional[str] = None
    out_name_: Optional[str] = None

    @property
    def prefix(self) -> str:
        return self.prefix_ or self.name

    @property
    def label(self) -> str:
        return self.label_ or self.name

    @property
    def out_name(self) -> str:
        return self.out_name_ or f"{self.name}_out"

    def param_specs(self) -> dict:
        d = {"w": ParamSpec((self.out_features, self.in_features),
                            (None, None))}
        if self.bias:
            d["b"] = ParamSpec((self.out_features,), (None,), init="zeros")
        return d

    def weight_memrefs(self) -> dict[str, tuple[str, ...]]:
        d = {f"{self.prefix}.weight": ("w",)}
        if self.bias:
            d[f"{self.prefix}.bias"] = ("b",)
        return d

    def out_shape(self, in_shape):
        b, k = in_shape
        assert k == self.in_features, (in_shape, self)
        return (b, self.out_features)


@dataclasses.dataclass(frozen=True)
class BatchNorm2d(Node):
    """Inference-mode batch norm (``frontend.batch_norm_2d``)."""

    channels: int = 0
    eps: float = 1e-5
    prefix_: Optional[str] = None
    label_: Optional[str] = None
    out_name_: Optional[str] = None

    @property
    def prefix(self) -> str:
        return self.prefix_ or self.name

    @property
    def label(self) -> str:
        return self.label_ or self.name

    @property
    def out_name(self) -> str:
        return self.out_name_ or f"{self.name}_out"

    def param_specs(self) -> dict:
        c = (self.channels,)
        return {"gamma": ParamSpec(c, (None,), init="ones"),
                "beta": ParamSpec(c, (None,), init="zeros"),
                "mean": ParamSpec(c, (None,), init="zeros"),
                "var": ParamSpec(c, (None,), init="ones")}

    def weight_memrefs(self) -> dict[str, tuple[str, ...]]:
        return {f"{self.prefix}.{leaf}": (leaf,)
                for leaf in ("gamma", "beta", "mean", "var")}

    def out_shape(self, in_shape):
        assert in_shape[1] == self.channels, (in_shape, self)
        return in_shape


@dataclasses.dataclass(frozen=True)
class ReLU(Node):
    """Elementwise ReLU (``frontend.relu_layer``)."""

    label_: Optional[str] = None
    out_name_: Optional[str] = None

    @property
    def label(self) -> str:
        return self.label_ or self.name or "relu"

    @property
    def out_name(self) -> str:
        return self.out_name_ or f"{self.name or 'relu'}_out"

    def out_shape(self, in_shape):
        return in_shape


@dataclasses.dataclass(frozen=True)
class OutputReLU(Node):
    """In-place ReLU on the *output* memref written by the previous node.

    The bridged form of ``frontend.braggnn``'s final ReLU, which rewrites
    the output symbol table under per-element sequential nests instead of
    allocating a new memref.  Must be the last node of a ``ModuleGraph``.
    """

    label_: Optional[str] = None

    @property
    def label(self) -> str:
        return self.label_ or self.name or "final_relu"

    def out_shape(self, in_shape):
        return in_shape


@dataclasses.dataclass(frozen=True)
class MaxPool2d(Node):
    """k x k max pooling (``frontend.max_pool_2d``)."""

    kernel: int = 2
    stride: int = 2
    label_: Optional[str] = None
    out_name_: Optional[str] = None

    @property
    def label(self) -> str:
        return self.label_ or self.name or "max_pool"

    @property
    def out_name(self) -> str:
        return self.out_name_ or f"{self.name or 'max_pool'}_out"

    def out_shape(self, in_shape):
        b, c, h, w = in_shape
        # floor mode; frontend.max_pool_2d bounds-checks its taps, so any
        # smaller output window is also legal — this is the torch default
        ho = _valid_out(h, self.kernel, self.stride, 0)
        wo = _valid_out(w, self.kernel, self.stride, 0)
        return (b, c, ho, wo)


@dataclasses.dataclass(frozen=True)
class Softmax(Node):
    """Softmax over the last axis (``frontend.soft_max``)."""

    taylor_order: int = 8
    label_: Optional[str] = None
    out_name_: Optional[str] = None

    @property
    def label(self) -> str:
        return self.label_ or self.name or "soft_max"

    @property
    def out_name(self) -> str:
        return self.out_name_ or f"{self.name or 'soft_max'}_out"

    def out_shape(self, in_shape):
        return in_shape


@dataclasses.dataclass(frozen=True)
class NonLocalBlock(Node):
    """BraggNN's attention block (``frontend.non_local_block``).

    theta/phi/g 1x1 convs to ``mid_channels``, softmax attention over the
    spatial positions, out-projection back to ``channels``, residual add.
    """

    channels: int = 0
    mid_channels: int = 0
    taylor_order: int = 8
    prefix_: Optional[str] = None

    @property
    def prefix(self) -> str:
        return self.prefix_ or self.name

    def param_specs(self) -> dict:
        c1, c2 = self.channels, self.mid_channels
        return {
            "theta": {"w": ParamSpec((c2, c1, 1, 1), (None,) * 4)},
            "phi": {"w": ParamSpec((c2, c1, 1, 1), (None,) * 4)},
            "g": {"w": ParamSpec((c2, c1, 1, 1), (None,) * 4)},
            "out": {"w": ParamSpec((c1, c2, 1, 1), (None,) * 4)},
        }

    def weight_memrefs(self) -> dict[str, tuple[str, ...]]:
        return {
            f"{self.prefix}.theta.weight": ("theta", "w"),
            f"{self.prefix}.phi.weight": ("phi", "w"),
            f"{self.prefix}.g.weight": ("g", "w"),
            f"{self.prefix}.out_cnn.weight": ("out", "w"),
        }

    def out_shape(self, in_shape):
        b, c, h, w = in_shape
        assert c == self.channels and h == w, (in_shape, self)
        return in_shape


@dataclasses.dataclass(frozen=True)
class Flatten(Node):
    """Zero-cost reshape to (batch, -1) (``frontend.copy_reshape``)."""

    out_name_: Optional[str] = None

    @property
    def out_name(self) -> str:
        return self.out_name_ or f"{self.name or 'flatten'}_out"

    def out_shape(self, in_shape):
        n = 1
        for d in in_shape[1:]:
            n *= d
        return (in_shape[0], n)


@dataclasses.dataclass(frozen=True)
class RMSNorm(Node):
    """RMS normalisation over the last axis (``frontend.rms_norm``)."""

    dim: int = 0
    eps: float = 1e-5
    prefix_: Optional[str] = None
    label_: Optional[str] = None
    out_name_: Optional[str] = None

    @property
    def prefix(self) -> str:
        return self.prefix_ or self.name

    @property
    def label(self) -> str:
        return self.label_ or self.name

    @property
    def out_name(self) -> str:
        return self.out_name_ or f"{self.name}_out"

    def param_specs(self) -> dict:
        return {"gamma": ParamSpec((self.dim,), (None,), init="ones")}

    def weight_memrefs(self) -> dict[str, tuple[str, ...]]:
        return {f"{self.prefix}.gamma": ("gamma",)}

    def out_shape(self, in_shape):
        l, d = in_shape
        assert d == self.dim, (in_shape, self)
        return in_shape


@dataclasses.dataclass(frozen=True)
class Attention(Node):
    """Pre-norm residual multi-head self-attention (``frontend.attention``).

    Operates on (L, d_model) sequence memrefs.  With ``pre_norm`` the node
    applies an RMS norm before the attention body; with ``residual`` the
    input is added back after the out-projection — so the default node is
    the whole ``x + Attn(RMS(x))`` sub-block and a sequential node chain
    stays linear.  Weights follow the ``repro_torch.nn.attention.attn_specs``
    layout (q/k/v kernels (D, H, dh), o kernel (H, dh, D)).
    """

    d_model: int = 0
    n_heads: int = 0
    taylor_order: int = 8
    eps: float = 1e-5
    pre_norm: bool = True
    residual: bool = True
    prefix_: Optional[str] = None
    label_: Optional[str] = None
    out_name_: Optional[str] = None

    @property
    def prefix(self) -> str:
        return self.prefix_ or self.name

    @property
    def label(self) -> str:
        return self.label_ or self.name

    @property
    def out_name(self) -> str:
        return self.out_name_ or f"{self.name}_out"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def param_specs(self) -> dict:
        from repro_torch.nn.attention import attn_specs
        s = attn_specs(self.d_model, self.n_heads, self.n_heads,
                       self.head_dim)
        if self.pre_norm:
            s["norm"] = {"gamma": ParamSpec((self.d_model,), (None,),
                                            init="ones")}
        return s

    def weight_memrefs(self) -> dict[str, tuple[str, ...]]:
        d = {f"{self.prefix}.{nm}.kernel": (nm, "kernel")
             for nm in ("q", "k", "v", "o")}
        if self.pre_norm:
            d[f"{self.prefix}.norm.gamma"] = ("norm", "gamma")
        return d

    def out_shape(self, in_shape):
        l, d = in_shape
        assert d == self.d_model, (in_shape, self)
        assert self.d_model % self.n_heads == 0, self
        return in_shape


@dataclasses.dataclass(frozen=True)
class MLP(Node):
    """Pre-norm residual position-wise feed-forward (``frontend.mlp``).

    relu(x @ w1.T + b1) @ w2.T + b2 on (L, d_model) sequence memrefs, with
    the same pre-norm/residual sub-block structure as :class:`Attention`.
    """

    d_model: int = 0
    hidden: int = 0
    eps: float = 1e-5
    pre_norm: bool = True
    residual: bool = True
    prefix_: Optional[str] = None
    label_: Optional[str] = None
    out_name_: Optional[str] = None

    @property
    def prefix(self) -> str:
        return self.prefix_ or self.name

    @property
    def label(self) -> str:
        return self.label_ or self.name

    @property
    def out_name(self) -> str:
        return self.out_name_ or f"{self.name}_out"

    def param_specs(self) -> dict:
        s = {
            "fc1": {"w": ParamSpec((self.hidden, self.d_model),
                                   (None, None)),
                    "b": ParamSpec((self.hidden,), (None,), init="zeros")},
            "fc2": {"w": ParamSpec((self.d_model, self.hidden),
                                   (None, None)),
                    "b": ParamSpec((self.d_model,), (None,), init="zeros")},
        }
        if self.pre_norm:
            s["norm"] = {"gamma": ParamSpec((self.d_model,), (None,),
                                            init="ones")}
        return s

    def weight_memrefs(self) -> dict[str, tuple[str, ...]]:
        d = {
            f"{self.prefix}.fc1.weight": ("fc1", "w"),
            f"{self.prefix}.fc1.bias": ("fc1", "b"),
            f"{self.prefix}.fc2.weight": ("fc2", "w"),
            f"{self.prefix}.fc2.bias": ("fc2", "b"),
        }
        if self.pre_norm:
            d[f"{self.prefix}.norm.gamma"] = ("norm", "gamma")
        return d

    def out_shape(self, in_shape):
        l, d = in_shape
        assert d == self.d_model, (in_shape, self)
        return in_shape


#: The supported layer vocabulary, in one place for error messages.
NODE_TYPES = (Conv2d, Linear, BatchNorm2d, ReLU, OutputReLU, MaxPool2d,
              Softmax, NonLocalBlock, Flatten, RMSNorm, Attention, MLP)


class ModuleGraph:
    """An ordered nn module graph plus its interface metadata.

    ``input_shape`` is the *memref* shape of one sample (e.g.
    ``(1, 1, img, img)`` for BraggNN — the leading singleton is the
    per-sample batch axis of the loop-nest program).  ``params`` optionally
    binds a trained param tree (structure of :meth:`specs`); bound modules
    compile to designs that :meth:`~repro_torch.hls.Design.run` with the trained
    weights without the caller passing weight feeds.  ``forward_fn`` is the
    optional fused tensor-level twin ``(params, x, fmt=None) -> y`` used by
    ``Design.serve``'s tensor backend.
    """

    def __init__(self, name: str, input_shape: Sequence[int],
                 nodes: Sequence[Node], *, input_name: str = "input",
                 params: Any = None,
                 forward_fn: Optional[Callable] = None,
                 meta: Optional[dict] = None):
        if not nodes:
            raise ValueError("ModuleGraph needs at least one node")
        for n in nodes:
            if not isinstance(n, NODE_TYPES):
                raise TypeError(
                    f"unsupported node {type(n).__name__}; vocabulary: "
                    f"{[t.__name__ for t in NODE_TYPES]}")
        if any(isinstance(n, OutputReLU) for n in nodes[:-1]):
            raise ValueError("OutputReLU must be the last node")
        self.name = name
        self.input_shape = tuple(input_shape)
        self.input_name = input_name
        self.nodes = tuple(nodes)
        self.params = params
        self.forward_fn = forward_fn
        self.meta = dict(meta or {})

    # -- shapes & parameters -------------------------------------------------

    def shapes(self) -> list[tuple[int, ...]]:
        """Per-node output shapes (index-aligned with ``nodes``)."""
        out, cur = [], self.input_shape
        for n in self.nodes:
            cur = n.out_shape(cur)
            out.append(cur)
        return out

    @property
    def output_shape(self) -> tuple[int, ...]:
        return self.shapes()[-1]

    def specs(self) -> dict:
        """The ``ParamSpec`` tree: ``{node.name: node subtree}``."""
        d = {}
        for n in self.nodes:
            sub = n.param_specs()
            if sub is None:
                continue
            if not n.name:
                raise ValueError(f"parameterised node {n} needs a name")
            if n.name in d:
                raise ValueError(f"duplicate node name {n.name!r}")
            d[n.name] = sub
        return d

    def init_params(self, key) -> Any:
        from repro_torch.nn.module import init_tree
        return init_tree(self.specs(), key)

    def bind(self, params) -> "ModuleGraph":
        """A copy of this module with ``params`` bound as the weights."""
        return ModuleGraph(self.name, self.input_shape, self.nodes,
                           input_name=self.input_name, params=params,
                           forward_fn=self.forward_fn, meta=self.meta)

    # -- feeds ---------------------------------------------------------------

    def weight_feeds(self, params: Any = None) -> dict[str, np.ndarray]:
        """memref-name feed dict for the bound (or given) param tree.

        Feeds are unbatched — ``emit.evaluate`` / ``to_jax_fn`` broadcast
        weight feeds across the batch axis.
        """
        params = self.params if params is None else params
        if params is None:
            return {}
        feeds: dict[str, np.ndarray] = {}
        for n in self.nodes:
            if n.param_specs() is None:
                continue
            sub = params[n.name]
            for memref, path in n.weight_memrefs().items():
                leaf = sub
                for k in path:
                    leaf = leaf[k]
                feeds[memref] = np.asarray(leaf, dtype=np.float32)
        return feeds

    def describe(self) -> str:
        lines = [f"module {self.name!r}: input {self.input_shape}"]
        for n, shp in zip(self.nodes, self.shapes()):
            lines.append(f"  {type(n).__name__:14s} {n.name or n.label:20s} "
                         f"-> {shp}")
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"ModuleGraph({self.name!r}, {len(self.nodes)} nodes, "
                f"params={'bound' if self.params is not None else 'unbound'})")
