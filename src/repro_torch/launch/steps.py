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
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graphs import GraphRunner, copy_all
from repro_torch.models import encdec, lm
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

    The shardings wait for the port's mesh (``ROADMAP.md`` queue 1 item
    8.6): given, they raise.
    """
    if microbatch_shardings is not None or grad_shardings is not None:
        raise NotImplementedError(
            "microbatch and gradient shardings come with the port's mesh, "
            "ROADMAP.md queue 1 item 8.6")
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    loss_fn = encdec.train_loss if cfg.is_encoder_decoder else \
        lm.train_loss
    # the top-level subtrees whose leaves stack layers on dim 0
    stacked = ("encoder", "decoder") if cfg.is_encoder_decoder else \
        ("blocks",)
    n_micro = max(1, cfg.microbatches)

    def update(params: Any, opt_state: dict, batch: dict, grads: Any
               ) -> dict:
        """One step, written into ``params``, ``opt_state`` and the
        scratch ``grads``; returns the metrics."""
        flat_g = tree_flatten(grads)[0]
        torch._foreach_zero_(flat_g)
        live = _grad_leaves(params, grads, stacked)
        n = next(iter(batch.values())).shape[0]
        if n % n_micro:
            raise ValueError(f"batch {n} does not split into "
                             f"{n_micro} microbatches")
        metrics: dict = {}
        for i in range(n_micro):
            mb = {k: v.reshape(n_micro, n // n_micro, *v.shape[1:])[i]
                  for k, v in batch.items()}
            total, m = loss_fn(cfg, live, mb)
            total.backward()
            for k, v in m.items():
                metrics[k] = metrics[k] + v.detach() if k in metrics \
                    else v.detach()
        if n_micro > 1:
            torch._foreach_div_(flat_g, float(n_micro))
            metrics = {k: v / n_micro for k, v in metrics.items()}
        if grad_compression:
            with torch.no_grad():
                for g, e in zip(flat_g, tree_flatten(opt_state["err"])[0]):
                    deq, err = compress.compress_with_feedback(g, e)
                    g.copy_(deq)
                    e.copy_(err)
        _, _, om = adamw.apply_updates(
            opt_cfg, params, grads,
            {k: v for k, v in opt_state.items() if k != "err"})
        return {**metrics, **om}

    def zeros_like(params):
        leaves, treedef = tree_flatten(params)
        return tree_unflatten(treedef, [torch.zeros(
            p.shape, dtype=torch.float32, device=p.device) for p in leaves])

    def eager(params, opt_state, batch):
        dev = tree_flatten(params)[0][0].device
        metrics = update(params, opt_state, _as_batch(batch, dev),
                         zeros_like(params))
        return params, opt_state, metrics

    held: dict = {}          #: the live state on the card, and its runner

    def step(params, opt_state, batch):
        leaves, treedef = tree_flatten((params, opt_state))
        dev = leaves[0].device
        if dev.type != "cuda":
            return eager(params, opt_state, batch)
        if not held:
            live = (params, opt_state, zeros_like(params))
            held.update(treedef=treedef, leaves=leaves, tree=live[:2],
                        run=GraphRunner(lambda feeds: update(
                            live[0], live[1], feeds, live[2]), dev))
        elif treedef != held["treedef"]:
            raise ValueError("this step trains one model's tree: make a "
                             "step for another")
        elif any(a is not b for a, b in zip(leaves, held["leaves"])):
            copy_all(held["leaves"], leaves)
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
