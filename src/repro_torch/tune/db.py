"""The persistent tuning database.

One JSON file holding the best-known configuration (and the trial log that
produced it) per **(design content hash, search-space hash, run context)**
— the same content-addressing discipline as the design cache, so a
retrained model, an edited space, a cache-format bump, or a different
experiment (strategy, strategy parameters, evaluation settings — the
*context*) each get a fresh entry instead of overwriting another's.  The
default location is the port's versioned cache root
(``core.cachedir.cache_root("tune")``, under ``repro_torch_cache_<uid>``),
next to the design cache and subject to the same stale-version eviction;
a reference package's TuningDB is never read.

Serving and benchmarks auto-load wins via :func:`lookup_best` /
``repro_torch.tune.best_config_for`` — a tuned run is a file read, not a
search.
The lookup scans every context recorded for the design, skips entries
whose best failed the numerics gate, and prefers measured (measure mode,
timed on the card) results over dry ones.
"""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path
from typing import Optional, Union

from repro_torch.core.cachedir import CACHE_FORMAT_VERSION, cache_root

DB_FILENAME = "tuning_db.json"


class TuningDB:
    """Tiny persistent key-value store of tuning results.

    Entries are plain JSON (assignments, metrics, trial summaries) — never
    pickles — so the file is diffable and safe to share.  Writes are
    atomic (tmp + rename) and re-read the file first, so concurrent tuners
    lose at most their own entry, never the whole DB.
    """

    def __init__(self, path: Optional[Union[str, Path]] = None):
        self.path = (Path(path) if path is not None
                     else cache_root("tune") / DB_FILENAME)

    # -- storage ------------------------------------------------------------

    @staticmethod
    def key(design_fingerprint: str, space_hash: str,
            context: str = "") -> str:
        return f"{design_fingerprint}|{space_hash}|{context}"

    @staticmethod
    def context_hash(context: dict) -> str:
        """Stable digest of a run context (strategy, params, eval settings).

        Runs with different contexts are different experiments: they must
        not overwrite each other's entries or serve each other's reruns.
        """
        canon = json.dumps(context, sort_keys=True, default=str)
        return hashlib.sha256(canon.encode()).hexdigest()[:16]

    def _read(self) -> dict:
        if not self.path.exists():
            return {"version": CACHE_FORMAT_VERSION, "entries": {}}
        try:
            data = json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            return {"version": CACHE_FORMAT_VERSION, "entries": {}}
        if data.get("version") != CACHE_FORMAT_VERSION:
            # stale schema: discard rather than misread
            return {"version": CACHE_FORMAT_VERSION, "entries": {}}
        return data

    def _write(self, data: dict) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(data, indent=1, sort_keys=True))
        tmp.replace(self.path)

    # -- API ----------------------------------------------------------------

    def get(self, design_fingerprint: str, space_hash: str,
            context: str = "") -> Optional[dict]:
        return self._read()["entries"].get(
            self.key(design_fingerprint, space_hash, context))

    def put(self, design_fingerprint: str, space_hash: str,
            entry: dict, context: str = "") -> None:
        data = self._read()
        entry = dict(entry)
        entry.setdefault("created_at", time.strftime("%Y-%m-%dT%H:%M:%S"))
        entry["updated_at"] = time.strftime("%Y-%m-%dT%H:%M:%S")
        data["entries"][self.key(design_fingerprint, space_hash,
                                 context)] = entry
        self._write(data)

    def entries_for(self, design_fingerprint: str,
                    space_hash: str) -> dict[str, dict]:
        """All run-context entries for one (design, space) pair."""
        prefix = self.key(design_fingerprint, space_hash, "")
        return {k[len(prefix):]: v for k, v in self._read()["entries"].items()
                if k.startswith(prefix)}

    def entries(self) -> dict[str, dict]:
        return self._read()["entries"]

    def clear(self) -> None:
        if self.path.exists():
            self.path.unlink()

    def __len__(self) -> int:
        return len(self.entries())


def best_entry(db: TuningDB, design_fingerprint: str,
               space_hash: str) -> Optional[dict]:
    """The winning entry across every recorded run context, or ``None``.

    Entries whose best failed the numerics gate — or the trigger-budget
    feasibility gate — never win (the tuner logs them, but an invalid or
    over-budget config must not reach serving).  Wall-clocked
    (measure-mode) results beat dry ones; ties break on latency.
    """
    candidates = []
    for ctx, entry in db.entries_for(design_fingerprint, space_hash).items():
        best = entry.get("best") or {}
        if not best.get("valid") or "candidate" not in best:
            continue
        if best.get("feasible", True) is False:
            continue
        ev = (entry.get("context") or {}).get("eval") or {}
        candidates.append(((0 if ev.get("mode") == "measure" else 1,
                            float(best.get("latency_us", float("inf")))),
                           entry))
    if not candidates:
        return None
    return min(candidates, key=lambda t: t[0])[1]


def lookup_best(db: TuningDB, design_fingerprint: str,
                space_hash: str) -> Optional[dict]:
    """The stored best-candidate assignment (JSON form), or ``None``."""
    entry = best_entry(db, design_fingerprint, space_hash)
    if entry is None:
        return None
    return entry["best"]["candidate"]
