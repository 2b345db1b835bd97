"""LM continuous-batching engine: lanes over one decode step.

A fixed pool of ``max_batch`` lanes shares one decode step (one token per
lane per tick).  Requests queue; a free lane feeds the prompt through the
decode path (teacher-forced, KV written per token: one program, no dynamic
shapes), then the lane switches to generation.  Finished lanes are
refilled from the queue at the next tick — no global barrier between
requests.

Per-lane state lives in the batched KV cache, on the parameters' device,
allocated once; a lane's reset writes its init values (zeros, and -1 for a
rolling window's key positions) into that lane's slice in place, outside
the step: the KV caches and the RG-LRU's recurrent state alike.  Queue and request bookkeeping and the latency percentiles are
the shared :mod:`repro_torch.serving.common` machinery.

The decode step is ``models.lm.serve_step`` behind a
:class:`~repro_torch.core.graphs.GraphRunner`, the counterpart of the
reference's ``jax.jit``: on the card the first tick runs eagerly and
captures the step, which writes the cache in place, and every later tick
copies the tokens and positions into the graph's static inputs and
replays it; on the CPU the step runs eagerly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from repro_torch.core.graphs import GraphRunner
from repro_torch.models import lm
from repro_torch.nn import transformer
from repro_torch.nn.module import tree_leaves
from repro_torch.serving.common import QueuedRequest, RequestQueue, \
    percentiles

if TYPE_CHECKING:                                    # annotation-only import
    from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class Request(QueuedRequest):
    """One generation request: shared lifecycle + LM-specific fields."""

    prompt: list = dataclasses.field(default_factory=list)
    max_new_tokens: int = 32
    eos_id: int = -1               # -1: no early stop
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    first_token_t: float = 0.0


@dataclasses.dataclass
class _Lane:
    req: Optional[Request] = None
    pos: int = 0


class ServingEngine:
    def __init__(self, cfg: "ModelConfig", params, *, max_batch: int = 8,
                 max_len: int = 512):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = params["embed"]["table"].device
        self.cache = transformer.init_cache(cfg, max_batch, max_len,
                                            self.device)
        # one lane's init values, written into a lane when it is refilled
        self._fresh = transformer.init_cache(cfg, 1, max_len, self.device)
        self.lanes = [_Lane() for _ in range(max_batch)]
        self.queue = RequestQueue()
        self.finished: list[Request] = []
        self._ticks = 0
        cache = self.cache       # not self: no cycle to keep params alive
        self._step = GraphRunner(
            lambda feeds: lm.serve_step(cfg, params, feeds["tokens"], cache,
                                        feeds["pos"])[0],
            self.device)

    # -- API ---------------------------------------------------------------

    def submit(self, prompt: list[int], max_new_tokens: int = 32,
               eos_id: int = -1) -> int:
        if not prompt:
            raise ValueError("a request needs at least one prompt token")
        req = Request(rid=-1, payload=None, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, eos_id=eos_id)
        return self.queue.push(req).rid

    def run_until_drained(self, max_ticks: int = 10_000) -> list[Request]:
        while (len(self.queue) or any(l.req for l in self.lanes)) \
                and self._ticks < max_ticks:
            self.tick()
        return self.finished

    def release(self) -> None:
        """Drop the decode step's captured graphs and their memory pool."""
        self._step.release()

    # -- internals ---------------------------------------------------------

    def _reset_lane_cache(self, lane_idx: int) -> None:
        """Write one lane's init values into its cache slice.

        The attention caches would not need it: a previous request's
        entries are masked by position (a full cache's slots past ``pos``,
        and a rolling window's, whose stored position is at least its slot,
        are never in the past of a new request's ``pos``).  The RG-LRU's
        state is not: its ``h`` and conv state carry the last request's
        sequence into the next unless they are zeroed here, so this reset
        is what keeps a refilled lane's tokens those of its request alone.
        It runs eagerly, outside the captured step, on the cache the step
        holds.  Stacked leaves carry the lane on axis 1 (after the
        layer-stack dim), remainder leaves on axis 0.
        """
        for axis, part in ((1, "blocks"), (0, "extra")):
            for full, one in zip(tree_leaves(self.cache[part]),
                                 tree_leaves(self._fresh[part])):
                full.narrow(axis, lane_idx, 1).copy_(one)

    def tick(self) -> None:
        """One engine step: schedule lanes, decode one token for all."""
        self._ticks += 1
        # 1) admit queued requests into free lanes
        for li, lane in enumerate(self.lanes):
            if lane.req is None and len(self.queue):
                lane.req = self.queue.pop()
                lane.pos = 0
                self._reset_lane_cache(li)

        # 2) assemble the token batch
        tokens = np.zeros((self.max_batch, 1), np.int64)
        pos = np.zeros((self.max_batch,), np.int64)
        for li, lane in enumerate(self.lanes):
            if lane.req is None:
                continue
            req = lane.req
            if lane.pos < len(req.prompt):
                tokens[li, 0] = req.prompt[lane.pos]
            else:
                tokens[li, 0] = req.output[-1]
            pos[li] = lane.pos

        # 3) one decode step for the whole pool (the cache in place)
        next_tok = self._step({"tokens": torch.from_numpy(tokens),
                               "pos": torch.from_numpy(pos)})
        next_tok = next_tok.cpu().numpy()

        # 4) per-lane bookkeeping
        for lane, tok in zip(self.lanes, next_tok):
            if lane.req is None:
                continue
            req = lane.req
            lane.pos += 1
            if lane.pos < len(req.prompt):
                continue                      # still feeding the prompt
            tok = int(tok)
            if not req.output:
                req.first_token_t = time.monotonic()
            req.output.append(tok)
            if (len(req.output) >= req.max_new_tokens
                    or tok == req.eos_id
                    or lane.pos >= self.max_len - 1):
                req.finish(result=req.output)
                self.finished.append(req)
                lane.req = None

    # -- metrics -----------------------------------------------------------

    def stats(self) -> dict:
        lat = [r.latency_s for r in self.finished if r.done_t]
        ttft = [r.first_token_t - r.submit_t for r in self.finished
                if r.first_token_t]
        toks = sum(len(r.output) for r in self.finished)
        pct = percentiles(lat)
        return {"requests": len(self.finished), "generated_tokens": toks,
                "ticks": self._ticks,
                "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
                "p50_latency_s": pct["p50"], "p95_latency_s": pct["p95"],
                "p99_latency_s": pct["p99"],
                "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
                "max_queue_depth": self.queue.max_depth,
                "mean_queue_depth": self.queue.mean_depth}
