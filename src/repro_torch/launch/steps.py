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
state).  Each rank:

1. gathers every parameter that is split (over ``model``) into a whole
   buffer, for the compute;
2. runs its rows of every microbatch through the unchanged model code and
   kernels on plain local tensors (a DTensor never reaches a kernel),
   weighing its loss by its share of the microbatch's counted targets, so
   that the sum over ranks is the reference's loss over the global
   ``sum(mask)``;
3. sums the fp32 gradients over the data axes (one all-reduce per leaf)
   and updates the block of each leaf its optimizer state holds: the
   int8 compression under one per-tensor scale (the blocks' maxima
   reduced), the global norm counting every element once (one rank of
   each block's holders counts it), AdamW in place;
4. gathers the updated blocks and keeps its parameter blocks.

What the port does not copy: over ``model`` the rules bind the storage
here, and the compute runs on gathered parameters, where GSPMD may split
the matmuls over ``model`` instead (tensor parallelism): the same values,
other memory and traffic.  The data reduction is an all-reduce of each
whole fp32 gradient (each rank keeps it while it updates its blocks),
where GSPMD reduce-scatters into the gradient's shardings.

An MoE layer's capacity counts the whole microbatch.  Each rank routes its
rows as the whole microbatch would, exchanging the per-(chunk, expert)
counts over the data axes (``nn.moe.batch_shard``, entered around each
microbatch's forward and backward), and weighs the aux loss, the whole
microbatch's on every rank, by 1/ways.

On the card the sharded step is captured and replayed like the unsharded
one, its NCCL collectives inside the graph; on the CPU (gloo) it runs
eagerly.
"""

from __future__ import annotations

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


def _view(t: torch.Tensor, block: tuple) -> torch.Tensor:
    """``t[block]``, or ``t`` itself where the block is all of it."""
    whole = all(b.start == 0 and b.stop == n for b, n in zip(block, t.shape))
    return t if whole else t[block]


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


class _MeshPlan:
    """One rank's layout of the sharded step: its parameter blocks and
    the whole buffers they gather into, the blocks its optimizer state
    holds, its rows of each microbatch, and the collectives over them."""

    def __init__(self, cfg: ModelConfig, params: Any, opt_state: dict,
                 microbatch_shardings: Optional[dict],
                 grad_shardings: Optional[Any]):
        p_leaves, self.treedef = tree_flatten(params)
        first = next(p for p in p_leaves if _is_dtensor(p))
        self.mesh = mesh = mesh_of(first.device_mesh)
        if dist.get_world_size() != mesh.size:
            raise ValueError(f"the mesh {mesh.shape} does not span the "
                             f"process group's {dist.get_world_size()} "
                             f"ranks")

        def sharding(t) -> NamedSharding:
            return sh.sharding_of(t, mesh) if _is_dtensor(t) else \
                NamedSharding(mesh, PartitionSpec())
        self.p_local = [sh.local(p) for p in p_leaves]
        self.p_sh = [sharding(p) for p in p_leaves]
        self.full = [loc if tuple(loc.shape) == tuple(p.shape) else
                     torch.empty(p.shape, dtype=loc.dtype, device=loc.device)
                     for loc, p in zip(self.p_local, p_leaves)]
        s_leaves = tree_flatten(opt_state["mu"])[0]
        self.s_sh = [sharding(m) for m in s_leaves]
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
                        for s_, p in zip(self.s_sh, p_leaves)]
        coord = dict(zip(mesh.axis_names, mesh.coordinate()))
        # a block is counted in the global norm by the one of its holders
        # at index 0 along every axis the state's spec does not split
        self.owned = [all(coord[a] == 0 for a in mesh.axis_names
                          if a not in self._axes(s_))
                      for s_ in self.s_sh]
        leaves, treedef = tree_flatten(opt_state)
        self.state = tree_unflatten(treedef, [sh.local(x) for x in leaves])
        self.microbatch_shardings = microbatch_shardings
        self.rules = sh.rules_for(cfg)
        self.data_axes: tuple = ()
        self.ways = 1
        self.moe = cfg.n_experts > 0
        #: this rank's block of each microbatch, for the MoE routing
        self.shard: Optional[moe_lib.BatchShard] = None

    @staticmethod
    def _axes(s: NamedSharding) -> tuple:
        return tuple(a for e in s.spec for a in entry_axes(e))

    def rows(self, batch: dict, n_micro: int) -> dict:
        """This rank's rows of each microbatch, microbatch after
        microbatch (the split the microbatch shardings give dim 1 of the
        split batch; else the rules' ``batch`` axes, pruned)."""
        key = "tokens" if "tokens" in batch else next(iter(batch))
        n = batch[key].shape[0]
        if n % n_micro:
            raise ValueError(f"batch {n} does not split into {n_micro} "
                             f"microbatches")
        per = n // n_micro
        if self.microbatch_shardings is not None:
            spec = self.microbatch_shardings[key].spec
            entry = spec[1] if len(spec) > 1 else None
        else:
            entry = sh.prune_spec((per,), self.rules.spec(
                ("batch",), self.mesh), self.mesh)[0]
        split = NamedSharding(self.mesh, PartitionSpec(entry))
        self.data_axes = entry_axes(entry)
        rows = self.mesh.block(split, (per,))[0]
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
        return tree_unflatten(self.treedef, self.full)

    def gather_params(self) -> None:
        """Every split parameter into its whole buffer."""
        for loc, full, s_ in zip(self.p_local, self.full, self.p_sh):
            if full is not loc:
                full[self.mesh.block(s_, full.shape)].copy_(loc)
                self.mesh.gather_into(full, s_)

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
        rank's parameter blocks out of it."""
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
            with moe_lib.batch_shard(plan.shard if plan else None):
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


def make_prefill(cfg: ModelConfig) -> Callable:
    """``prefill(params, batch) -> (B, vocab)`` fp32 logits at the last
    position: ``lm.prefill`` (patches in front where the batch has them),
    or the encoder-decoder's encode and teacher-forced decode."""
    if cfg.is_encoder_decoder:
        def prefill_step(params: Any, batch: dict):
            enc = encdec.encode(cfg, params, batch["frames"])
            logits = encdec.decode_forward(cfg, params, batch["tokens"], enc,
                                           last_logit_only=True)
            return logits[:, -1, :]
        return prefill_step

    def prefill_step(params: Any, batch: dict):
        return lm.prefill(cfg, params, batch["tokens"],
                          patches=batch.get("patches"))
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """``serve_step(params, cache, batch) -> (next tokens (B,), cache)``:
    one greedy decode step at ``batch["pos"]``, the cache written in
    place."""
    step = encdec.serve_step if cfg.is_encoder_decoder else lm.serve_step

    def serve_step(params: Any, cache: dict, batch: dict):
        return step(cfg, params, batch["tokens"], cache, batch["pos"])
    return serve_step


def metrics_structure(train: bool = True) -> dict:
    """The scalar metrics every train step reports, as the reference
    names them."""
    return {"loss": 0.0, "grad_norm": 0.0, "lr": 0.0}
