"""Sharding resolution: logical axes -> NamedShardings on a concrete mesh.

The reference's ``repro.launch.shardings`` in torch.  This is where the
paper's K_i binding rule meets real shapes: a logical binding is *pruned*
where the tensor dimension does not divide the mesh axes' extent (batch 1
cannot shard over 16 data rows; 60 experts do not split 16 ways).
Pruning is per tensor and deterministic, so checkpoints, the elastic
resharder and the train step agree, and every block a rank holds is
whole: the port never relies on DTensor's uneven shards, so
``bytes_per_device`` is each rank's true footprint.

``shard_tree`` turns a tree of whole tensors into DTensors under a tree of
shardings, each rank keeping its block; a tensor the sharding leaves
whole is wrapped as it is, with no copy (every leaf on a 1 x 1 mesh).

:func:`model_split` decides, from the pruned shardings alone, which plan
the sharded steps (``launch.steps``) take over ``model``: the split plan,
which computes on each rank's blocks (``nn.tensor_parallel``), where every
leaf split over ``model`` is an attention, MLP, RG-LRU, MoE expert or
vocabulary leaf (``nn.tensor_parallel.SPLIT_LEAVES``); else the gather
plan, which gathers the split leaves whole for the compute.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.binding import BindingRules, NamedSharding, \
    PartitionSpec, entry_axes
from repro_torch.nn import module as module_lib
from repro_torch.nn import tensor_parallel as tp


def rules_for(cfg) -> BindingRules:
    overrides = dict(getattr(cfg, "rules_overrides", ()) or ())
    rules = BindingRules()
    if overrides:
        rules = rules.with_overrides(**overrides)
    return rules


def prune_spec(shape: tuple[int, ...], spec: PartitionSpec, mesh
               ) -> PartitionSpec:
    """Drop mesh axes that don't evenly divide the tensor dimension."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        kept = []
        extent = 1
        for a in entry_axes(entry):
            sz = mesh.shape[a]
            if dim % (extent * sz) == 0:
                kept.append(a)
                extent *= sz
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return PartitionSpec(*out)


def sharding_for(shape: tuple[int, ...], axes: tuple, mesh,
                 rules: BindingRules) -> NamedSharding:
    spec = rules.spec(axes, mesh)
    return NamedSharding(mesh, prune_spec(shape, spec, mesh))


def _zip_map(fn, a: Any, b: Any) -> Any:
    """``fn(leaf_a, leaf_b)`` over two nested dicts of one structure, the
    second's leaves axes tuples or shardings."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            raise ValueError(f"trees differ: {sorted(a)} against "
                             f"{sorted(b) if isinstance(b, dict) else b}")
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def tree_shardings(abstract_tree: Any, axes_tree: Any, mesh,
                   rules: BindingRules) -> Any:
    """Shardings for a tree of tensors (``meta`` ones will do) and its
    matching axes tree."""
    return _zip_map(lambda a, x: sharding_for(tuple(a.shape), x, mesh,
                                              rules), abstract_tree,
                    axes_tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def bytes_per_device(abstract_tree: Any, shardings: Any) -> int:
    """The bytes each device holds of a sharded tree (every block is the
    same size: the specs divide their shapes)."""
    sizes: list[int] = []

    def one(a, s):
        n = math.prod(a.shape)
        for entry in s.spec:
            for ax in entry_axes(entry):
                n //= s.mesh.shape[ax]
        sizes.append(n * a.dtype.itemsize)
    _zip_map(one, abstract_tree, shardings)
    return sum(sizes)


def model_param_shardings(cfg: ModelConfig, mesh):
    """(abstract_params, shardings) for an LM config."""
    from repro_torch.models import encdec
    from repro_torch.nn import transformer
    rules = rules_for(cfg)
    specs = encdec.model_specs(cfg) if cfg.is_encoder_decoder else \
        transformer.model_specs(cfg)
    abstract = module_lib.abstract_tree(specs)
    axes = module_lib.axes_tree(specs)
    return abstract, tree_shardings(abstract, axes, mesh, rules)


def spec_shardings(cfg: ModelConfig, mesh) -> Any:
    """A decoder's parameter shardings (``model_param_shardings``'
    second half) from its specs' shapes alone, with no stand-in tensor
    made: a dry-run's memory tracker would count meta tensors."""
    from repro_torch.nn import transformer
    rules = rules_for(cfg)
    return module_lib.map_specs(
        lambda sp: sharding_for(tuple(sp.shape), tuple(sp.axes), mesh,
                                rules), transformer.model_specs(cfg))


def model_split(cfg: ModelConfig, mesh) -> Optional[frozenset]:
    """The logical axes whose compute the sharded steps split over
    ``model`` (``nn.tensor_parallel.ModelShard.split``) where ``cfg``
    takes the split plan on ``mesh``; None where it takes the gather plan.

    The split plan: the mesh has a ``model`` axis, no parameter is split
    over any other, and every leaf the pruned rules split over ``model``
    is one of ``nn.tensor_parallel.SPLIT_LEAVES`` under its axis (an
    attention ``q``/``k``/``v``/``o`` kernel or bias over ``heads`` and
    ``kv_heads``, or over ``head_dim``, the head width, where the rules
    split that instead: Qwen2.5-3B, Qwen2-7B, Qwen2-VL-2B, whose KV heads
    do not divide ``model``; an MLP's or the MoE shared expert's
    ``wi``/``wg``/``wo`` over ``mlp``; an RG-LRU leaf over ``mlp`` or,
    its gates' kernels, ``heads``; an expert's ``wi``/``wg``/``wo`` over
    ``experts``; ``embed/table`` or ``unembed/kernel`` over ``vocab``);
    each of those axes is split in every leaf that has it; and the blocks
    a layer combines line up: an RG-LRU's heads are split where its
    channels are (a rank's heads of its block-diagonal gates are then
    exactly its channels'), and an MoE's experts where its shared
    expert's columns are (one sum over ``model`` takes both).  The head
    width is split only where every layer is attention: xlstm-1.3b's
    mLSTM ``q``/``k``/``v`` end their paths as the attention's do, but its
    head width also runs through the sLSTM's recurrence, whose leaves the
    table does not hold.  A 1 x 1 mesh keeps ``model`` at extent 1, so a
    config takes the same plan there as on the production
    mesh.  An encoder-decoder takes the gather plan."""
    if "model" not in mesh.shape or cfg.is_encoder_decoder:
        return None
    from repro_torch.nn import transformer
    axes = module_lib.axes_tree(transformer.model_specs(cfg))
    split: set = set()
    carried: list = []

    def walk(s, ax, path):
        if isinstance(s, dict):
            return all(walk(s[k], ax[k], path + (k,)) for k in s)
        for entry, name in zip(tuple(s.spec) + (None,) * len(ax), ax):
            names = entry_axes(entry)
            if any(m != "model" for m in names):
                return False
            if names:
                if not tp.splits_leaf(path, name):
                    return False
                split.add(name)
            carried.append((name, bool(names)))
        return True
    if not walk(spec_shardings(cfg, mesh), axes, ()):
        return None
    if any(name in split and not on for name, on in carried):
        return None
    if "rglru" in cfg.attn_pattern and ("heads" in split) != ("mlp" in split):
        return None
    if cfg.n_experts and cfg.n_shared_experts and \
            ("experts" in split) != ("mlp" in split):
        return None
    if "head_dim" in split and not set(cfg.attn_pattern) <= {"global",
                                                              "local"}:
        return None
    return frozenset(split)


def cache_abstract_and_axes(cfg: ModelConfig, batch: int, max_len: int
                            ) -> tuple[Any, Any]:
    """(the decode cache's ``meta`` stand-ins, its logical-axes tree) for
    an LM config or an encoder-decoder."""
    from repro_torch.models import encdec
    from repro_torch.nn import transformer
    mod = encdec if cfg.is_encoder_decoder else transformer
    return mod.cache_specs(cfg, batch, max_len), mod.cache_axes(cfg)


def cache_axes_for(cfg: ModelConfig, mesh) -> Any:
    """The logical axes the decode cache's shardings bind: all of them
    under the split plan, only ``batch`` under the gather plan (see
    :func:`cache_shardings`)."""
    from repro_torch.models import encdec
    from repro_torch.nn import transformer
    axes = (encdec if cfg.is_encoder_decoder else transformer).cache_axes(cfg)
    if model_split(cfg, mesh) is not None:
        return axes
    return module_lib.map_tree(
        lambda ax: tuple(a if a == "batch" else None for a in ax), axes)


def cache_shardings(cfg: ModelConfig, batch: int, max_len: int, mesh
                    ) -> Any:
    """The decode cache's shardings, by the plan the config takes
    (:func:`model_split`).

    * The split plan computes each rank's KV heads (or head-width
      columns) and RG-LRU channels, so its cache takes the binding rules'
      split, the reference's: ``batch`` over the data axes, ``kv_heads``
      or ``head_dim`` over ``model`` (``kv_heads`` whole where
      ``prune_spec`` drops it: every rank then projects and writes all
      the KV heads), and an RG-LRU layer's ``h`` and ``conv`` over
      ``model`` along ``mlp``.
    * The gather plan runs each rank's rows on whole, gathered parameters,
      so its cache keeps only the ``batch`` split and each rank holds its
      rows' whole cache; split over the heads it would be gathered and
      scattered on every tick.  The values are the reference's, the
      memory per rank is not (ROADMAP.md item 8.8's known
      differences)."""
    abstract, _ = cache_abstract_and_axes(cfg, batch, max_len)
    return tree_shardings(abstract, cache_axes_for(cfg, mesh), mesh,
                          rules_for(cfg))


def init_sharded_cache(cfg: ModelConfig, batch: int, max_len: int, mesh
                       ) -> Any:
    """A decoder's zero decode cache as DTensors under
    :func:`cache_shardings`, each rank allocating only its own blocks: its
    rows, and its KV heads, head-width columns and RG-LRU channels where
    the split plan splits them."""
    from torch.distributed.tensor import DTensor

    from repro_torch.nn import transformer
    abstract, _ = cache_abstract_and_axes(cfg, batch, max_len)
    c_sh = cache_shardings(cfg, batch, max_len, mesh)
    rows = mesh.block(sharding_for((batch,), ("batch",), mesh,
                                   rules_for(cfg)), (batch,))[0]
    local_cfg = cfg
    split = model_split(cfg, mesh) or frozenset()
    ways = mesh.shape.get("model", 1)
    if "kv_heads" in split and cfg.n_kv_heads % ways == 0:
        local_cfg = local_cfg.replace(n_kv_heads=cfg.n_kv_heads // ways)
    if "head_dim" in split:
        local_cfg = local_cfg.replace(
            head_dim=cfg.resolved_head_dim // ways)
    if "mlp" in split and "rglru" in cfg.attn_pattern:
        local_cfg = local_cfg.replace(
            lru_width=(cfg.lru_width or cfg.d_model) // ways)
    local = transformer.init_cache(local_cfg, rows.stop - rows.start,
                                   max_len, device=mesh.device_type)

    def wrap(t, a, s):
        want = tuple(b.stop - b.start for b in mesh.block(s, a.shape))
        if tuple(t.shape) != want:
            raise ValueError(f"a local cache block {tuple(t.shape)} where "
                             f"{s.spec} gives {want}")
        return DTensor.from_local(
            t, mesh.device_mesh, s.placements, run_check=False,
            shape=a.shape, stride=torch.empty(a.shape, device="meta").stride())
    return _zip_map(lambda t, pair: wrap(t, *pair), local, _zip_map(
        lambda a, s: (a, s), abstract, c_sh))


def state_shardings(abstract_params: Any, param_axes: Any, mesh,
                    rules: BindingRules) -> dict:
    """The AdamW state's shardings (ZeRO: ``optim.adamw.state_axes``)."""
    from repro_torch.optim import adamw
    return tree_shardings(adamw.abstract_state(abstract_params),
                          adamw.state_axes(param_axes), mesh, rules)


def shard(t: torch.Tensor, sharding: NamedSharding):
    """A DTensor of the whole tensor ``t`` under ``sharding``, holding
    this rank's block (on the mesh's device): ``t`` itself where the block
    is all of it and ``t`` lies there already."""
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    local = t[mesh.block(sharding, t.shape)].to(mesh.device_type)
    return DTensor.from_local(
        local.contiguous(), mesh.device_mesh, sharding.placements,
        run_check=False, shape=t.shape,
        stride=torch.empty(t.shape, device="meta").stride())


def shard_tree(tree: Any, shardings: Any) -> Any:
    """:func:`shard` over a nested dict of tensors and its shardings."""
    return _zip_map(shard, tree, shardings)


def local(t) -> torch.Tensor:
    """A DTensor's local block (the tensor itself, not a copy), or a
    plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def sharding_of(t, mesh) -> NamedSharding:
    """The NamedSharding a DTensor's placements say on ``mesh``."""
    from torch.distributed.tensor import Shard
    spec: list = [()] * t.ndim
    for name, pl in zip(mesh.axis_names, t.placements):
        if isinstance(pl, Shard):
            spec[pl.dim] = spec[pl.dim] + (name,)
    return NamedSharding(mesh, PartitionSpec(*(
        None if not e else e[0] if len(e) == 1 else e for e in spec)))

