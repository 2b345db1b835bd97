"""AdamW with a cosine schedule and global-norm clipping, over trees of
tensors (nested dicts, lists and tuples, as the models' param trees are).

The update runs in place, leaf by leaf: parameters, moments and the step
count are written where they lie; the gradients are only read.
The reference's pytree update is functional; here a second copy of the
state does not fit: Qwen2.5-3B's parameters, gradients and two moments
are 49.4 GB in fp32 on an 80 GB card, and the largest leaf's temporaries
(the stacked MLP weight, 3.2 GB) are the update's whole overhead.  A
caller that keeps the old state (BraggNN's functional step) copies it
first.  An async checkpoint snapshots to host memory before it returns,
so the next step's writes never race with it.  The optimizer state has
the parameters' tree and lies on their device.  Leaves are visited in the
reference's pytree order (dict keys sorted), so the global norm sums in
the same order, and each leaf's arithmetic is the reference's, op for op.

The state is sharded like the parameters, and further (ZeRO):
:func:`state_axes` binds each moment's ``embed`` dimension to the data
axis too.  On a mesh each rank updates its own blocks; the sharded train
step (``launch.steps``) hands :func:`apply_updates` the blocks and the
collective that sums the global norm across ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.nn.module import map_tree, tree_flatten, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    end_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine to ``end_lr`` at
    ``total_steps`` (fp32; ``step`` a tensor of any shape, or an int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.end_lr + 0.5 * (cfg.peak_lr - cfg.end_lr) * (
        1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params: Any) -> dict:
    """Zero first and second moments shaped like ``params``, and step 0
    (int32), on the parameters' device."""
    leaves, treedef = tree_flatten(params)
    device = leaves[0].device if leaves else None
    return {"mu": tree_unflatten(treedef, [torch.zeros_like(p)
                                           for p in leaves]),
            "nu": tree_unflatten(treedef, [torch.zeros_like(p)
                                           for p in leaves]),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_state(abstract_params: Any) -> dict:
    """``meta`` stand-ins of :func:`init_state`'s tree."""
    z = map_tree(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                       device="meta"), abstract_params)
    return {"mu": z, "nu": z,
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def state_axes(param_axes: Any) -> dict:
    """Optimizer-state logical axes: the parameters' axes, with ``embed``
    additionally bound to the data axis (rule ``opt_embed -> data``).

    This is ZeRO-style optimizer-state sharding: mu/nu shard over BOTH
    mesh axes wherever a tensor has an embed dimension (every projection,
    norm and embedding does), cutting per-device optimizer bytes by the
    data axis's size.
    """
    mapped = map_tree(lambda axes: tuple(
        "opt_embed" if a == "embed" else a for a in axes), param_axes)
    return {"mu": mapped, "nu": mapped, "step": ()}


def _clip_scale(flat: list, max_norm: float, combine=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(``min(1, max_norm / global norm)``, the norm) of the leaves,
    summed in fp32: a handful of launches for all the leaves together,
    and no wait for the host.  ``combine``, on a mesh, maps this rank's
    vector of leaf norms to every rank's, whose norm is the global one."""
    g32 = [g.to(torch.float32) for g in flat]
    norms = torch.stack(torch._foreach_norm(g32))
    if combine is not None:
        norms = combine(norms)
    gn = torch.linalg.vector_norm(norms)
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / global norm)``; returns
    the scaled tree (new tensors) and the norm before scaling."""
    leaves, treedef = tree_flatten(grads)
    scale, gn = _clip_scale(leaves, max_norm)
    return tree_unflatten(treedef, [(g.to(torch.float32) * scale).to(
        g.dtype) for g in leaves]), gn


def apply_updates(cfg: AdamWConfig, params: Any, grads: Any, state: dict,
                  *, norm_leaves: Optional[list] = None, combine=None
                  ) -> tuple[Any, dict, dict]:
    """One AdamW step, in place.  Returns ``(params, state, metrics)``:
    the given trees, written, and ``metrics = {"grad_norm", "lr"}`` as
    tensors.  ``grads`` are only read.

    The ops and their order are the reference's, leaf by leaf, so each
    leaf's temporaries are the update's whole overhead; nothing waits for
    the host, so a captured step holds the update.

    On a mesh the trees are this rank's blocks; the global norm is then
    that of ``norm_leaves`` (the blocks this rank alone counts: a block
    held by several ranks counted by one, empty tensors elsewhere)
    gathered across ranks by ``combine`` (see :func:`_clip_scale`).
    """
    flat_p, treedef = tree_flatten(params)
    flat_g, flat_mu, flat_nu = (tree_flatten(t)[0] for t in (
        grads, state["mu"], state["nu"]))
    if not len(flat_p) == len(flat_g) == len(flat_mu) == len(flat_nu):
        raise ValueError(
            f"params, grads and moments differ in leaves: {len(flat_p)}, "
            f"{len(flat_g)}, {len(flat_mu)}, {len(flat_nu)}")
    with torch.no_grad():
        scale, gnorm = _clip_scale(
            flat_g if norm_leaves is None else norm_leaves, cfg.clip_norm,
            combine)
        step = state["step"]
        step.add_(1)
        lr = cosine_lr(cfg, step)
        b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
        b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
        for p, g, mu, nu in zip(flat_p, flat_g, flat_mu, flat_nu):
            g = g.to(torch.float32) * scale          # the clipped gradient
            mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            nu.mul_(cfg.b2).add_(g.mul_(g).mul_(1 - cfg.b2))
            # g is free now: it holds sqrt(nu / b2c) + eps
            delta = torch.div(mu, b1c).div_(
                g.copy_(nu).div_(b2c).sqrt_().add_(cfg.eps))
            p32 = p.to(torch.float32)
            delta.add_(p32 * cfg.weight_decay)
            if p.dtype == torch.float32:
                p.sub_(delta.mul_(lr))
            else:
                p.copy_(p32 - delta.mul_(lr))
    return params, state, {"grad_norm": gnorm, "lr": lr}
