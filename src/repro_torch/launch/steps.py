"""Step-function factories: the reference's ``repro.launch.steps`` for the
port.

train_step  — forward, backward and AdamW update, written in place
prefill     — full-sequence forward, last-position logits
serve_step  — one cached decode step

The reference jits the train step with ``donate_argnums=(0, 1)``: XLA
updates the parameters and the optimizer state in their own buffers.  The
port's counterpart is one captured CUDA graph per batch shape
(:class:`~repro_torch.core.graphs.GraphRunner`) whose static inputs are
the live parameters and optimizer state themselves: the step writes them
in place, and only the batch is copied in.  That is also what lets
Qwen2.5-3B train on one 80 GB card: its parameters, gradients and two
moments are 49.4 GB in fp32, and a second copy of any of them does not
fit beside the activations.

**On a mesh.**  The reference's sharded step is one GSPMD program whose
values are the unsharded step's.  The port's is data parallel over the
mesh axes the batch binds to, with the parameters and the AdamW state
stored in the shardings the binding rules give (DTensors, ZeRO for the
state).  Over ``model`` it takes one of two plans, decided once from the
pruned shardings (``launch.shardings.model_split``; no flag chooses it):

* **the split plan**, where every leaf the rules split over ``model`` is
  an attention, MLP, RG-LRU, MoE expert or vocabulary leaf (gemma2-27b,
  stablelm-3b, recurrentgemma-9b, qwen2-moe-a2.7b, and over the head
  width qwen2.5-3b, qwen2-7b and qwen2-vl-2b): each rank computes on its
  own blocks, as the reference's tensor-parallel program does
  (``nn.tensor_parallel``: column- and row-parallel projections, the
  attention on a rank's block of whole-width rows where the head width is
  split, the RG-LRU's channels and the MoE's experts local to a rank, the
  vocabulary split over the ranks, the decode cache split over its KV
  heads or head width and RG-LRU channels), entered around each
  microbatch's forward and backward;
* **the gather plan**, for every other config: each rank gathers every
  parameter that is split over ``model`` into a whole buffer and runs its
  data block's whole step on it; the same values, other memory and
  traffic.

Each rank:

1. (gather plan) gathers every split parameter into a whole buffer;
2. runs its rows of every microbatch through the model code and kernels
   on plain local tensors (a DTensor never reaches a kernel), weighing its
   loss by its share of the microbatch's counted targets, so that the sum
   over ranks is the reference's loss over the global ``sum(mask)``;
3. sums the fp32 gradients over the data axes (one all-reduce per leaf)
   and updates the block of each leaf its optimizer state holds: the
   int8 compression under one per-tensor scale (the blocks' maxima
   reduced), the global norm counting every element once (one rank of
   each block's holders counts it), AdamW in place;
4. gathers the updated blocks (over the data axes alone under the split
   plan, into its parameter blocks) and keeps its parameter blocks.

What the port does not copy: the data reduction is an all-reduce of each
fp32 gradient (each rank keeps it while it updates its blocks), where
GSPMD reduce-scatters into the gradient's shardings (ROADMAP.md item
8.9e); and the split plan covers the leaves of
``nn.tensor_parallel.SPLIT_LEAVES`` only, so a config whose rules split
``expert_mlp`` over ``model`` (mixtral-8x7b, item 8.9c-ii), or a head
width that runs through the sLSTM (xlstm-1.3b, item 8.9b's other part),
takes the gather plan.

An MoE layer's capacity counts the whole microbatch.  Each rank routes its
rows as the whole microbatch would, exchanging the per-(chunk, expert)
counts over the data axes (``nn.moe.batch_shard``, entered around each
microbatch's forward and backward), and weighs the aux loss, the whole
microbatch's on every rank, by 1/ways.

On the card the sharded step is captured and replayed like the unsharded
one, its NCCL collectives inside the graph; on the CPU (gloo) it runs
eagerly.

**Serving on a mesh.**  The prefill and the serve step shard the same
way: each rank runs its rows of the global batch through the model code
and returns its rows of the result as a DTensor split over the data axes.
The pieces the train step has besides are shared with it, not copied
(:class:`_Placement`): the row selection, the plan over ``model`` and the
parameter gather, which serving's plan makes once per parameter set (its
weights do not change between calls).  The decode cache takes
``launch.shardings.cache_shardings``: the rules' split under the split
plan (rows over the data axes, KV heads or head width and RG-LRU
channels over ``model``), the rows' alone under the gather plan, each
rank then writing its rows' whole cache in place where the reference's
GSPMD program splits its heads over ``model`` as well: the same values,
other memory.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional

import torch

import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.binding import NamedSharding, PartitionSpec, \
    entry_axes
from repro_torch.core.graphs import GraphRunner, copy_all
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import mesh_of
from repro_torch.models import encdec, lm
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import tensor_parallel as tp
from repro_torch.nn import transformer
from repro_torch.nn.module import tree_flatten, tree_unflatten
from repro_torch.optim import adamw, compress


def _grad_leaves(params: dict, grads: dict, stacked: tuple) -> dict:
    """``params`` as autograd leaves whose ``.grad`` is the matching
    (preallocated, fp32) gradient, so ``backward`` adds into it in place.
    A stacked leaf becomes a tuple of per-layer leaves, views of its
    slices: each layer's gradient then lands in its own slice of the
    stacked gradient, where a leaf indexed per layer would get a full-size
    gradient per layer."""
    def leaf(p, g):
        t = p.detach().requires_grad_()
        t.grad = g
        return t

    def walk(p, g, split):
        if isinstance(p, dict):
            return {k: walk(p[k], g[k], split or k in stacked) for k in p}
        if split:
            return tuple(leaf(p[i], g[i]) for i in range(p.shape[0]))
        return leaf(p, g)
    return walk(params, grads, False)


def _as_batch(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _entry_of(axes: tuple):
    """A spec entry of ``axes``: None, one axis, or a tuple of them."""
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _view(t: torch.Tensor, block: tuple) -> torch.Tensor:
    """``t[block]``, or ``t`` itself where the block is all of it."""
    whole = all(b.start == 0 and b.stop == n for b, n in zip(block, t.shape))
    return t if whole else t[block]


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


class _Placement:
    """What the train plan and the serving plan share: the mesh of a tree
    of DTensor parameters, each parameter's local block and the tensor
    the compute reads for it (the block itself under the split plan, the
    whole buffer it gathers into under the gather plan), and this rank's
    rows of a global batch."""

    def __init__(self, cfg: ModelConfig, params: Any):
        p_leaves, self.treedef = tree_flatten(params)
        first = next(p for p in p_leaves if _is_dtensor(p))
        self.mesh = mesh = mesh_of(first.device_mesh)
        if dist.get_world_size() != mesh.size:
            raise ValueError(f"the mesh {mesh.shape} does not span the "
                             f"process group's {dist.get_world_size()} "
                             f"ranks")
        self.leaves = p_leaves
        self.p_local = [sh.local(p) for p in p_leaves]
        self.p_sh = [self._sharding(p) for p in p_leaves]
        self.rules = sh.rules_for(cfg)
        split = sh.model_split(cfg, mesh)
        #: the split plan's place along ``model`` (None: the gather plan)
        self.model: Optional[tp.ModelShard] = None
        if split is not None:
            self._check_rules(cfg)
            self.model = tp.ModelShard(
                index=dict(zip(mesh.axis_names,
                               mesh.coordinate()))["model"],
                ways=mesh.shape["model"], split=split,
                reduce=self._reduce_model, gather=self._gather_model,
                all_to_all=self._all_to_all_model)
            self.full = self.p_local
        else:
            self.full = [loc if tuple(loc.shape) == tuple(p.shape) else
                         torch.empty(p.shape, dtype=loc.dtype,
                                     device=loc.device)
                         for loc, p in zip(self.p_local, p_leaves)]
        self.data_axes: tuple = ()
        self.ways = 1
        self.moe = cfg.n_experts > 0
        #: this rank's block of the (micro)batch, for the MoE routing
        self.shard: Optional[moe_lib.BatchShard] = None

    @property
    def model_split(self) -> str:
        """The plan over ``model``: "compute" or "gather"."""
        return "gather" if self.model is None else "compute"

    def _check_rules(self, cfg: ModelConfig) -> None:
        """The split plan computes on the blocks the rules give: the
        parameters must be sharded so."""
        want = tree_flatten(sh.spec_shardings(cfg, self.mesh))[0]
        bad = [i for i, (got, w) in enumerate(zip(self.p_sh, want))
               if tuple(got.spec) != tuple(w.spec)]
        if bad:
            raise ValueError(
                f"{cfg.name} splits its compute over model: its parameters "
                f"must be sharded by launch.shardings.model_param_shardings "
                f"(leaves {bad[:5]} are not)")

    def _reduce_model(self, t: torch.Tensor, op: str) -> torch.Tensor:
        return self.mesh.reduce(t, ("model",), {
            "sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op])

    def _gather_model(self, t: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(t) for _ in range(self.mesh.shape["model"])]
        dist.all_gather(parts, t, group=self.mesh.group("model"))
        return torch.cat(parts, dim=-1)

    def _all_to_all_model(self, t: torch.Tensor, send: list, recv: list
                          ) -> torch.Tensor:
        """``tp.ModelShard.all_to_all`` over the ``model`` group."""
        out = t.new_empty(sum(recv))
        dist.all_to_all_single(out, t, output_split_sizes=recv,
                               input_split_sizes=send,
                               group=self.mesh.group("model"))
        return out

    def _sharding(self, t) -> NamedSharding:
        return sh.sharding_of(t, self.mesh) if _is_dtensor(t) else \
            NamedSharding(self.mesh, PartitionSpec())

    def _entry(self, key: str, per: int):
        """The mesh axes that split a (micro)batch of ``per`` rows: the
        rules' ``batch`` axes, pruned to those ``per`` divides."""
        return sh.prune_spec((per,), self.rules.spec(("batch",), self.mesh),
                             self.mesh)[0]

    def rows(self, batch: dict, n_micro: int = 1) -> dict:
        """This rank's rows of each microbatch, microbatch after
        microbatch (all of them where no data axis divides the rows)."""
        key = "tokens" if "tokens" in batch else next(iter(batch))
        n = batch[key].shape[0]
        if n % n_micro:
            raise ValueError(f"batch {n} does not split into {n_micro} "
                             f"microbatches")
        per = n // n_micro
        entry = self._entry(key, per)
        self.split = NamedSharding(self.mesh, PartitionSpec(entry))
        self.data_axes = entry_axes(entry)
        rows = self.mesh.block(self.split, (per,))[0]
        size = rows.stop - rows.start
        self.ways = per // size
        if self.moe:
            self.shard = moe_lib.BatchShard(
                index=rows.start // size, ways=self.ways,
                reduce=lambda t: self.mesh.reduce(t, self.data_axes))
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            v = v.reshape(n_micro, per, *v.shape[1:])[:, rows]
            out[k] = v.reshape(-1, *v.shape[2:])
        return out

    def full_tree(self) -> Any:
        """The parameter tree the compute reads."""
        return tree_unflatten(self.treedef, self.full)

    def gather_params(self) -> None:
        """Every split parameter into its whole buffer (none under the
        split plan)."""
        for loc, full, s_ in zip(self.p_local, self.full, self.p_sh):
            if full is not loc:
                full[self.mesh.block(s_, full.shape)].copy_(loc)
                self.mesh.gather_into(full, s_)

    def sharded(self):
        """The contexts a call's forward and backward run in: this rank's
        block of the batch for the MoE routing, its place along
        ``model``."""
        stack = contextlib.ExitStack()
        stack.enter_context(moe_lib.batch_shard(self.shard))
        stack.enter_context(tp.model_shard(self.model))
        return stack


class _MeshPlan(_Placement):
    """One rank's layout of the sharded train step: beside the parameters
    and the rows, the blocks its optimizer state holds and the collectives
    over them."""

    def __init__(self, cfg: ModelConfig, params: Any, opt_state: dict,
                 microbatch_shardings: Optional[dict],
                 grad_shardings: Optional[Any]):
        super().__init__(cfg, params)
        mesh = self.mesh
        s_leaves = tree_flatten(opt_state["mu"])[0]
        self.s_sh = [self._sharding(m) for m in s_leaves]
        if grad_shardings is not None:
            g_sh = tree_flatten(grad_shardings)[0]
            bad = [i for i, (g, s_) in enumerate(zip(g_sh, self.s_sh))
                   if tuple(g.spec) != tuple(s_.spec)]
            if len(g_sh) != len(s_leaves) or bad:
                raise ValueError(
                    "the port reduces each gradient into the blocks its "
                    "optimizer state holds: grad_shardings must be the "
                    "state's shardings (leaves "
                    f"{bad[:5]} differ)")
        self.s_block = [mesh.block(s_, p.shape)
                        for s_, p in zip(self.s_sh, self.leaves)]
        if self.model is not None:
            self._local_blocks()
        coord = dict(zip(mesh.axis_names, mesh.coordinate()))
        # a block is counted in the global norm by the one of its holders
        # at index 0 along every axis the state's spec does not split
        self.owned = [all(coord[a] == 0 for a in mesh.axis_names
                          if a not in self._axes(s_))
                      for s_ in self.s_sh]
        leaves, treedef = tree_flatten(opt_state)
        self.state = tree_unflatten(treedef, [sh.local(x) for x in leaves])
        self.microbatch_shardings = microbatch_shardings

    @staticmethod
    def _axes(s: NamedSharding) -> tuple:
        return tuple(a for e in s.spec for a in entry_axes(e))

    def _local_blocks(self) -> None:
        """Under the split plan the update works on the local parameter
        blocks: each state block taken inside its parameter's block, and
        the sharding (``self.s_rel``) that gathers the updated blocks over
        the state's axes the parameter does not split (``data``)."""
        self.s_rel = []
        for i, (s_, p_s, p) in enumerate(zip(self.s_sh, self.p_sh,
                                             self.leaves)):
            p_block = self.mesh.block(p_s, p.shape)
            self.s_block[i] = tuple(slice(b.start - a.start, b.stop - a.start)
                                    for a, b in zip(p_block, self.s_block[i]))
            spec = tuple(s_.spec) + (None,) * (p.ndim - len(s_.spec))
            p_spec = tuple(p_s.spec) + (None,) * (p.ndim - len(p_s.spec))
            rel = NamedSharding(self.mesh, PartitionSpec(*(
                _entry_of(tuple(a for a in entry_axes(e)
                                if a not in entry_axes(pe)))
                for e, pe in zip(spec, p_spec))))
            # the state's block must lie inside the parameter's, as the
            # block of the state's other axes
            if self.mesh.block(rel, self.p_local[i].shape) != \
                    self.s_block[i]:
                raise ValueError(f"leaf {i}: the state's block does not "
                                 f"split its parameter's over {rel.spec}")
            self.s_rel.append(rel)

    def _entry(self, key: str, per: int):
        """The split the microbatch shardings give dim 1 of the split
        batch; else the rules' ``batch`` axes, pruned."""
        if self.microbatch_shardings is None:
            return super()._entry(key, per)
        spec = self.microbatch_shardings[key].spec
        return spec[1] if len(spec) > 1 else None

    def weigh(self, m: dict, targets: torch.Tensor) -> torch.Tensor:
        """This rank's part of the microbatch's loss, also written as
        ``m["loss"]``: its mean over its counted targets times their
        share of the microbatch's; plus the MoE aux loss, the whole
        microbatch's on every rank, over the number of data ranks."""
        count = torch.sum((targets >= 0).to(torch.float32))
        total = self.mesh.reduce(count.clone(), self.data_axes)
        w = count / torch.clamp(total, min=1.0)
        m["loss"] = m["loss"] * w
        out = m["loss"]
        if "aux_loss" in m:
            out = out + lm.AUX_WEIGHT * m["aux_loss"] / self.ways
        return out

    def reduce_metrics(self, metrics: dict) -> dict:
        keys = [k for k in ("loss", "tokens") if k in metrics]
        summed = self.mesh.reduce(torch.stack([metrics[k] for k in keys]),
                                  self.data_axes)
        return {**metrics, **dict(zip(keys, summed.unbind()))}

    def reduce_grads(self, flat_g: list) -> None:
        for g in flat_g:
            self.mesh.reduce(g, self.data_axes)

    def blocks(self, tree: Any) -> Any:
        """The state's blocks of the whole tensors of a param-shaped
        tree."""
        leaves = tree_flatten(tree)[0]
        return tree_unflatten(self.treedef, [
            _view(t, b) for t, b in zip(leaves, self.s_block)])

    def reduce_max(self, i: int):
        """The max of leaf ``i``'s block across the ranks holding its
        other blocks, in place."""
        axes = self._axes(self.s_sh[i])
        return lambda t: self.mesh.reduce(t, axes, dist.ReduceOp.MAX)

    def norm_leaves(self, g_blocks: list) -> list:
        return [g if own else g.new_empty(0)
                for g, own in zip(g_blocks, self.owned)]

    def combine(self, norms: torch.Tensor) -> torch.Tensor:
        """Every rank's leaf norms, rank after rank."""
        parts = [torch.empty_like(norms) for _ in range(self.mesh.size)]
        dist.all_gather(parts, norms)
        return torch.cat(parts)

    def scatter_params(self) -> None:
        """Every rank's updated blocks into each whole buffer, then this
        rank's parameter blocks out of it; under the split plan the
        updated blocks straight into each local block."""
        if self.model is not None:
            for loc, rel in zip(self.p_local, self.s_rel):
                self.mesh.gather_into(loc, rel)
            return
        for loc, full, p_s, s_s in zip(self.p_local, self.full, self.p_sh,
                                       self.s_sh):
            self.mesh.gather_into(full, s_s)
            if full is not loc:
                loc.copy_(full[self.mesh.block(p_s, full.shape)])


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    grad_compression: bool = False,
                    microbatch_shardings: Optional[dict] = None,
                    grad_shardings: Optional[dict] = None) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss of ``lm.train_loss`` (``encdec.train_loss`` for an
    encoder-decoder) and its gradients over ``cfg.microbatches``
    microbatches (fp32 gradients summed, then divided), int8 compression
    with error feedback where ``grad_compression`` (``opt_state["err"]``,
    from ``compress.init_error_state``), then one AdamW update.

    The step writes ``params`` and ``opt_state`` in place and returns
    them, with ``metrics`` ({"loss", "grad_norm", "lr"} and the loss's
    own, fp32 scalars the caller may keep).  ``batch``: {tokens, targets[,
    patches | frames]}, numpy arrays or tensors, split into microbatches
    along dim 0.

    On the card the first call adopts the given tensors as the live
    state, allocates the fp32 gradients once, runs one step eagerly and
    captures it; each later call copies the batch in and replays, after
    copying the given parameters and state into the live ones if they are
    other tensors (a restore).  Nothing in the step waits for the host.
    On the CPU it runs eagerly.  ``step.eager`` runs one step without a
    graph on the given tensors anywhere; ``step.in_place`` is True (the
    ``TrainingDriver`` checkpoints step 0 for it).

    **Sharded** when the parameters are DTensors
    (``launch.shardings.shard_tree``; the state too, in its own
    shardings): ``batch`` is then the global batch, the same on every
    rank, and each rank takes its rows (see the module docstring).
    ``microbatch_shardings``: shardings of the split batch (n_micro, rows,
    ...), whose dim 1 picks the rows (default: the rules' ``batch`` axes).
    ``grad_shardings``: the gradients' blocks, which must be the
    optimizer state's (the ZeRO shardings, as the reference's callers
    pass).
    """
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    loss_fn = encdec.train_loss if cfg.is_encoder_decoder else \
        lm.train_loss
    # the top-level subtrees whose leaves stack layers on dim 0
    stacked = ("encoder", "decoder") if cfg.is_encoder_decoder else \
        ("blocks",)
    n_micro = max(1, cfg.microbatches)

    def update(params: Any, opt_state: dict, batch: dict, grads: Any,
               plan: Optional[_MeshPlan] = None) -> dict:
        """One step, written into ``params``, ``opt_state`` and the
        scratch ``grads``; returns the metrics.  With a ``plan`` the trees
        are this rank's: ``params`` the whole buffers, ``opt_state`` the
        local blocks, ``batch`` its rows."""
        flat_g = tree_flatten(grads)[0]
        torch._foreach_zero_(flat_g)
        if plan is not None:
            plan.gather_params()
        live = _grad_leaves(params, grads, stacked)
        n = next(iter(batch.values())).shape[0]
        if n % n_micro:
            raise ValueError(f"batch {n} does not split into "
                             f"{n_micro} microbatches")
        metrics: dict = {}
        for i in range(n_micro):
            mb = {k: v.reshape(n_micro, n // n_micro, *v.shape[1:])[i]
                  for k, v in batch.items()}
            with plan.sharded() if plan else contextlib.nullcontext():
                total, m = loss_fn(cfg, live, mb)
                if plan is not None:
                    total = plan.weigh(m, mb["targets"])
                total.backward()
            for k, v in m.items():
                metrics[k] = metrics[k] + v.detach() if k in metrics \
                    else v.detach()
        if plan is not None:
            metrics = plan.reduce_metrics(metrics)
            plan.reduce_grads(flat_g)
        if n_micro > 1:
            torch._foreach_div_(flat_g, float(n_micro))
            metrics = {k: v / n_micro for k, v in metrics.items()}
        state = {k: v for k, v in opt_state.items() if k != "err"}
        kw: dict = {}
        if plan is not None:
            params, grads = plan.blocks(params), plan.blocks(grads)
            flat_g = tree_flatten(grads)[0]
            kw = dict(norm_leaves=plan.norm_leaves(flat_g),
                      combine=plan.combine)
        if grad_compression:
            with torch.no_grad():
                for i, (g, e) in enumerate(zip(
                        flat_g, tree_flatten(opt_state["err"])[0])):
                    deq, err = compress.compress_with_feedback(
                        g, e, plan.reduce_max(i) if plan else None)
                    g.copy_(deq)
                    e.copy_(err)
        _, _, om = adamw.apply_updates(opt_cfg, params, grads, state, **kw)
        if plan is not None:
            plan.scatter_params()
        return {**metrics, **om}

    def zeros_like(params):
        leaves, treedef = tree_flatten(params)
        return tree_unflatten(treedef, [torch.zeros(
            p.shape, dtype=torch.float32, device=p.device) for p in leaves])

    def planned(params, opt_state):
        """(the trees ``update`` works on, the plan or None)."""
        if not any(_is_dtensor(p) for p in tree_flatten(params)[0]):
            if microbatch_shardings is not None or \
                    grad_shardings is not None:
                raise ValueError("shardings given for parameters that are "
                                 "not DTensors: shard them with "
                                 "launch.shardings.shard_tree")
            return (params, opt_state), None
        plan = _MeshPlan(cfg, params, opt_state, microbatch_shardings,
                         grad_shardings)
        return (plan.full_tree(), plan.state), plan

    def eager(params, opt_state, batch):
        (p, st), plan = planned(params, opt_state)
        dev = tree_flatten(p)[0][0].device
        if plan is not None:
            batch = plan.rows(batch, n_micro)
        metrics = update(p, st, _as_batch(batch, dev), zeros_like(p), plan)
        return params, opt_state, metrics

    held: dict = {}          #: the live state on the card, and its runner

    def step(params, opt_state, batch):
        leaves, treedef = tree_flatten((params, opt_state))
        leaves = [sh.local(x) for x in leaves]
        dev = leaves[0].device
        if dev.type != "cuda":
            return eager(params, opt_state, batch)
        if not held:
            (p, st), plan = planned(params, opt_state)
            live = (p, st, zeros_like(p))
            held.update(treedef=treedef, leaves=leaves,
                        tree=(params, opt_state), plan=plan,
                        run=GraphRunner(lambda feeds: update(
                            live[0], live[1], feeds, live[2], plan), dev))
        elif treedef != held["treedef"]:
            raise ValueError("this step trains one model's tree: make a "
                             "step for another")
        elif any(a is not b for a, b in zip(leaves, held["leaves"])):
            copy_all(held["leaves"], leaves)
        if held["plan"] is not None:
            batch = held["plan"].rows(batch, n_micro)
        metrics = held["run"](batch)
        params, opt_state = held["tree"]
        return params, opt_state, {k: v.clone() for k, v in metrics.items()}

    step.eager = eager
    step.in_place = True
    step.runner = lambda: held.get("run")
    return step


class _ServePlan(_Placement):
    """One rank's layout of a sharded prefill or serve step: the split
    parameters gathered into whole buffers once, when the plan is made
    (serving's weights do not change between calls), this rank's rows of
    each batch, and the runner that replays the step on the card."""

    def __init__(self, cfg: ModelConfig, params: Any):
        super().__init__(cfg, params)
        self.cfg = cfg
        self.gather_params()
        self.cache_axes = sh.cache_axes_for(cfg, self.mesh)
        self.runner: Optional[GraphRunner] = None
        self.bound: list = []        #: the cache blocks the graphs write

    def holds(self, params: Any) -> bool:
        """Whether ``params`` are the tensors this plan gathered."""
        leaves = tree_flatten(params)[0]
        return len(leaves) == len(self.leaves) and all(
            a is b for a, b in zip(leaves, self.leaves))

    def release(self) -> None:
        if self.runner is not None:
            self.runner.release()
            self.runner = None

    def run(self, call: Callable, feeds: dict, graph: bool,
            bound: Optional[list] = None):
        """``call(feeds)`` on this rank's rows: replayed from one captured
        graph per batch shape on the card where ``graph`` (a new runner
        for cache blocks other than the last call's), else eagerly."""
        dev = next(iter(feeds.values())).device
        if not graph or dev.type != "cuda":
            return call(feeds)
        bound = bound or []
        if self.runner is None or len(bound) != len(self.bound) or any(
                a is not b for a, b in zip(bound, self.bound)):
            self.release()
            self.runner, self.bound = GraphRunner(call, dev), bound
        return self.runner(feeds)

    def output(self, local: torch.Tensor, n: int):
        """``local``, this rank's rows of a result of ``n`` rows, as a
        DTensor split over the data axes."""
        from torch.distributed.tensor import DTensor
        shape = (n, *local.shape[1:])
        return DTensor.from_local(
            local, self.mesh.device_mesh, self.split.placements,
            run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())

    def check_cache(self, cache: dict) -> None:
        """Each cache leaf must be split as
        ``launch.shardings.cache_shardings`` splits it: over the rows'
        data axes along its ``batch`` dimension, and under the split plan
        over ``model`` along its ``kv_heads``, ``head_dim`` and ``mlp``
        dimensions where the rules keep them, nowhere else."""
        want_rows = entry_axes(self.split.spec[0])

        def one(t, ax):
            if not _is_dtensor(t):
                raise ValueError("a sharded serve step takes the cache as "
                                 "DTensors: shard it with "
                                 "launch.shardings.cache_shardings")
            got = tuple(sh.sharding_of(t, self.mesh).spec)
            need = tuple(sh.sharding_for(tuple(t.shape), ax, self.mesh,
                                         self.rules).spec)
            rows = [entry_axes(got[d]) for d, a in enumerate(ax)
                    if a == "batch"]
            if got != need or any(r != want_rows for r in rows):
                raise ValueError(
                    f"a cache leaf split {got} where this rank's rows "
                    f"want {need}: use launch.shardings.cache_shardings")
        sh._zip_map(one, cache, self.cache_axes)


def _sharded(params: Any) -> bool:
    return any(_is_dtensor(p) for p in tree_flatten(params)[0])


def _serve_plan(held: dict, cfg: ModelConfig, params: Any) -> _ServePlan:
    """The plan of ``params``: the held one, or a new one (gathering them)
    for other parameter tensors."""
    plan = held.get("plan")
    if plan is None or not plan.holds(params):
        if plan is not None:
            plan.release()
        plan = held["plan"] = _ServePlan(cfg, params)
    return plan


def make_prefill(cfg: ModelConfig) -> Callable:
    """``prefill(params, batch) -> (B, vocab)`` fp32 logits at the last
    position: ``lm.prefill`` (patches in front where the batch has them),
    or the encoder-decoder's encode and teacher-forced decode.

    **Sharded** when the parameters are DTensors (``shard_tree``):
    ``batch`` is the global batch, the same on every rank; each rank runs
    its rows (the rules' ``batch`` axes, pruned; all of them where the
    batch does not divide the data ways) through the model code, on its
    parameter blocks under the split plan, else on whole parameters
    gathered once per parameter set, its MoE layers routing its rows as
    the whole batch would (``nn.moe.batch_shard``).
    Returns the logits as a DTensor split over the data axes.  On the card
    it replays one captured graph per batch shape, the collectives inside;
    on the CPU it runs eagerly.  ``prefill.eager`` runs without a graph
    anywhere; ``prefill.prepare(params)`` makes the plan of DTensor
    ``params`` and gathers them, which the first call does otherwise."""
    if cfg.is_encoder_decoder:
        def run(params: Any, batch: dict):
            enc = encdec.encode(cfg, params, batch["frames"])
            logits = encdec.decode_forward(cfg, params, batch["tokens"], enc,
                                           last_logit_only=True)
            return logits[:, -1, :]
    else:
        def run(params: Any, batch: dict):
            return lm.prefill(cfg, params, batch["tokens"],
                              patches=batch.get("patches"))

    held: dict = {}

    def step(params: Any, batch: dict, graph: bool):
        if not _sharded(params):
            return run(params, batch)
        plan = _serve_plan(held, cfg, params)
        n = batch["tokens"].shape[0]
        rows = _as_batch(plan.rows(batch), plan.p_local[0].device)

        def call(feeds):
            with plan.sharded():
                return run(plan.full_tree(), feeds)
        return plan.output(plan.run(call, rows, graph).clone(), n)

    def prefill_step(params: Any, batch: dict):
        return step(params, batch, True)

    prefill_step.eager = lambda params, batch: step(params, batch, False)
    prefill_step.prepare = lambda params: _serve_plan(held, cfg, params)
    prefill_step.runner = lambda: held["plan"].runner if held else None
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """``serve_step(params, cache, batch) -> (next tokens (B,), cache)``:
    one greedy decode step at ``batch["pos"]``, the cache written in
    place.

    **Sharded** when the parameters and the cache are DTensors (the cache
    under ``launch.shardings.cache_shardings``): as :func:`make_prefill`,
    each rank runs its rows, on its parameter blocks under the split plan
    (its KV heads' and RG-LRU channels' cache blocks), else on the whole
    parameters gathered once per parameter set (its rows' whole cache),
    and writes its local cache blocks in place; the logits' vocabulary is
    gathered whole before the greedy token.  An MoE layer's capacity
    counts every lane of the whole batch (ROADMAP.md R7), its counts
    exchanged over the data axes.  Returns the tokens as a DTensor split
    over the data axes, and the cache.  On the card each call replays one
    captured graph per batch shape and cache; on the CPU it runs
    eagerly.
    ``serve_step.eager`` runs without a graph anywhere;
    ``serve_step.prepare`` is ``make_prefill``'s; ``serve_step.logits()``
    gives the last sharded call's (B, vocab) fp32 logits as a DTensor."""
    step = encdec.serve_step if cfg.is_encoder_decoder else lm.serve_step
    decode = encdec.decode_step if cfg.is_encoder_decoder else \
        transformer.decode_step
    held: dict = {}

    def run_step(params: Any, cache: dict, batch: dict, graph: bool):
        if not _sharded(params) and not _sharded(cache):
            return step(cfg, params, batch["tokens"], cache, batch["pos"])
        if not (_sharded(params) and _sharded(cache)):
            raise ValueError("a sharded serve step takes DTensor parameters "
                             "and a DTensor cache (launch.shardings."
                             "shard_tree, cache_shardings); one of them is "
                             "not")
        plan = _serve_plan(held, cfg, params)
        n = batch["tokens"].shape[0]
        rows = _as_batch(plan.rows(batch), plan.p_local[0].device)
        blocks, treedef = tree_flatten(cache)
        bound = [sh.local(t) for t in blocks]
        plan.check_cache(cache)
        local = tree_unflatten(treedef, bound)

        def call(feeds):
            with plan.sharded():
                logits, _ = decode(cfg, plan.full_tree(), feeds["tokens"],
                                   local, feeds["pos"])
            return {"tokens": torch.argmax(logits, dim=-1).to(torch.int32),
                    "logits": logits}
        out = plan.run(call, rows, graph, bound)
        held["logits"] = plan.output(out["logits"].clone(), n)
        return plan.output(out["tokens"].clone(), n), cache

    def serve_step(params: Any, cache: dict, batch: dict):
        return run_step(params, cache, batch, True)

    serve_step.eager = lambda params, cache, batch: run_step(
        params, cache, batch, False)
    serve_step.prepare = lambda params: _serve_plan(held, cfg, params)
    serve_step.logits = lambda: held.get("logits")
    serve_step.runner = lambda: held["plan"].runner if held else None
    return serve_step


def metrics_structure(train: bool = True) -> dict:
    """The scalar metrics every train step reports, as the reference
    names them."""
    return {"loss": 0.0, "grad_norm": 0.0, "lr": 0.0}
