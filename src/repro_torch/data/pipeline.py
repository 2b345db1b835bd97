"""Sharded, seekable, deterministic data pipeline.

A numpy-only copy of the reference package's pipeline, batch for batch.
Design constraints from the fault-tolerance story (``runtime/fault.py``):

  * **Seekable**: ``batch_at(step)`` is a pure function of (seed, step,
    shard) — restart from a checkpoint at step k reproduces the exact
    stream, bit for bit, with no state to persist beyond the step counter.
  * **Sharded**: each host materialises only its ``(host_id, num_hosts)``
    slice of the global batch (here exercised with one host; the slicing
    logic is the multi-host contract).
  * **Prefetched with a deadline**: a background thread keeps a bounded
    queue ahead of the consumer; if a fetch misses its deadline (straggler
    I/O), the pipeline substitutes the deterministic backup batch and
    records the event — decode of the batch never blocks the step loop.

Token content is a synthetic Zipf-ish mixture (hash-PRNG), which keeps the
container hermetic while exercising the real pipeline machinery.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    prefetch: int = 2
    deadline_s: float = 5.0


class SyntheticTokenPipeline:
    """Deterministic host-sharded token stream with prefetch."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {cfg.num_hosts} hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts
        self._queue: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._next_step = 0
        self.straggler_substitutions = 0
        self.fetch_delay_s = 0.0          # test hook: injected latency

    # -- pure, seekable core -------------------------------------------------

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The global-step batch, host-sharded.  Pure in (seed, step)."""
        cfg = self.cfg
        lo = self.cfg.host_id * self.local_batch
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, lo]))
        # Zipf-ish unigram mixture; documents delimited by token 0
        z = rng.zipf(1.3, size=(self.local_batch, cfg.seq_len + 1))
        tokens = (z % (cfg.vocab_size - 1)) + 1
        doc_ends = rng.random((self.local_batch, cfg.seq_len + 1)) < 1e-3
        tokens = np.where(doc_ends, 0, tokens).astype(np.int32)
        return {"tokens": tokens[:, :-1],
                "targets": tokens[:, 1:].copy()}

    # -- prefetching ----------------------------------------------------------

    def _producer(self) -> None:
        step = self._next_step
        while not self._stop.is_set():
            if self.fetch_delay_s:
                time.sleep(self.fetch_delay_s)
            batch = self.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._queue.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self, step: int = 0) -> None:
        self.seek(step)

    def seek(self, step: int) -> None:
        """Restart the stream at ``step`` (checkpoint-restore path)."""
        self.stop()
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self.cfg.prefetch)
        self._next_step = step
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2.0)
            self._thread = None

    def get(self, step: int) -> dict[str, np.ndarray]:
        """Batch for ``step`` — from the prefetch queue when in sequence,
        recomputed on the spot otherwise.  Applies the straggler deadline."""
        if self._thread is None:
            return self.batch_at(step)
        deadline = time.monotonic() + self.cfg.deadline_s
        while True:
            try:
                got_step, batch = self._queue.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                # straggler: deterministic backup (compute inline) and move on
                self.straggler_substitutions += 1
                return self.batch_at(step)
            if got_step == step:
                return batch
            if got_step > step:            # consumer rewound: recompute
                return self.batch_at(step)
            # got_step < step: drain stale entries
            if time.monotonic() > deadline:
                self.straggler_substitutions += 1
                return self.batch_at(step)
