"""AdamW with a cosine schedule and global-norm clipping, over trees of
tensors (nested dicts, lists and tuples, as the models' param trees are).

Functional, as the reference's pytree implementation is: every call returns
new tensors and writes none of its inputs in place, so the host snapshot an
async checkpoint takes of one step's state never races with the next step.
The optimizer state has the parameters' tree and lies on their device.
Leaves are visited in the reference's pytree order (dict keys sorted), so
the global norm sums in the same order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.nn.module import tree_flatten, tree_unflatten


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


def _clip(flat: list, max_norm: float) -> tuple[list, torch.Tensor]:
    """fp32 copies of ``flat`` scaled by ``min(1, max_norm / global norm)``,
    and the norm: a handful of launches for all the leaves together."""
    g32 = [g.to(torch.float32) for g in flat]
    gn = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g32)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return torch._foreach_mul(g32, scale), gn


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / global norm)``; returns
    the scaled tree and the norm before scaling."""
    leaves, treedef = tree_flatten(grads)
    scaled, gn = _clip(leaves, max_norm)
    return tree_unflatten(treedef, [s.to(g.dtype) for s, g in
                                    zip(scaled, leaves)]), gn


def apply_updates(cfg: AdamWConfig, params: Any, grads: Any, state: dict,
                  ) -> tuple[Any, dict, dict]:
    """One AdamW step.  Returns ``(new_params, new_state, metrics)`` with
    ``metrics = {"grad_norm", "lr"}`` as tensors; the inputs are left as
    they were.

    Each elementwise op runs over every leaf at once (``torch._foreach_*``,
    out of place): a step is bound by the host's launches, and this takes
    about 20 of them where one per op and leaf took about 300.  The ops
    and their order are the reference's.
    """
    flat_p, treedef = tree_flatten(params)
    flat_g, flat_mu, flat_nu = (tree_flatten(t)[0] for t in (
        grads, state["mu"], state["nu"]))
    if not len(flat_p) == len(flat_g) == len(flat_mu) == len(flat_nu):
        raise ValueError(
            f"params, grads and moments differ in leaves: {len(flat_p)}, "
            f"{len(flat_g)}, {len(flat_mu)}, {len(flat_nu)}")
    add, mul, div = (torch._foreach_add, torch._foreach_mul,
                     torch._foreach_div)
    with torch.no_grad():
        g, gnorm = _clip(flat_g, cfg.clip_norm)
        step = state["step"] + 1
        lr = cosine_lr(cfg, step)
        b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
        b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
        mu = add(mul(flat_mu, cfg.b1), mul(g, 1 - cfg.b1))
        nu = add(mul(flat_nu, cfg.b2), mul(mul(g, g), 1 - cfg.b2))
        delta = div(div(mu, b1c),
                    add(torch._foreach_sqrt(div(nu, b2c)), cfg.eps))
        p32 = [p.to(torch.float32) for p in flat_p]
        delta = add(delta, mul(p32, cfg.weight_decay))
        new_p = [q.to(p.dtype) for q, p in zip(
            torch._foreach_sub(p32, mul(delta, lr)), flat_p)]
    return tree_unflatten(treedef, new_p), {
        "mu": tree_unflatten(treedef, mu), "nu": tree_unflatten(treedef, nu),
        "step": step}, {"grad_norm": gnorm, "lr": lr}
