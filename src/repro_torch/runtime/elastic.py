"""Elastic scaling: reshard a checkpoint onto a different mesh.

The reference's ``repro.runtime.elastic`` in torch.  The checkpoint stores
leaves whole (``checkpoint.ckpt``), so moving a job from mesh A to mesh B
is: rebuild the parameter and optimizer-state shardings from the SAME
logical axes on the new mesh (divisibility pruning adapts), then restore
each leaf as a DTensor holding this rank's block.  The binding rules
being the single source of truth (``core.binding``) is what makes this
safe: there is no per-mesh layout to migrate.
"""

from __future__ import annotations

from typing import Any

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.launch import shardings as sh
from repro_torch.nn import module as module_lib


def reshard_checkpoint(ckpt: CheckpointManager, cfg, new_mesh, *,
                       step=None) -> tuple[Any, int]:
    """Restore {params, opt} onto ``new_mesh`` with freshly derived
    shardings.  Works across any device count whose axes divide (pruned
    otherwise)."""
    from repro_torch.models import encdec
    from repro_torch.nn import transformer
    from repro_torch.optim import adamw

    rules = sh.rules_for(cfg)
    specs = encdec.model_specs(cfg) if cfg.is_encoder_decoder else \
        transformer.model_specs(cfg)
    abstract = module_lib.abstract_tree(specs)
    axes = module_lib.axes_tree(specs)
    p_sh = sh.tree_shardings(abstract, axes, new_mesh, rules)
    o_sh = sh.state_shardings(abstract, axes, new_mesh, rules)
    like = {"params": abstract, "opt": adamw.abstract_state(abstract)}
    return ckpt.restore(like, step, shardings={"params": p_sh, "opt": o_sh})
