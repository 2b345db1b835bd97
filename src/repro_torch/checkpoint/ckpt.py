"""Atomic, async checkpointing of trees of tensors.

Layout, the reference package's (each package restores the other's)::

    <dir>/step_000123/           (atomic: written as .tmp_step_000123, renamed)
        manifest.json            tree structure, shapes, dtypes, step
        leaf_00000.npy ...       one file per leaf, in pytree order

Guarantees:
  * **Atomicity** — a checkpoint directory either exists completely (the
    rename happened after fsync of every leaf) or not at all; a crash
    during a save never corrupts the latest complete checkpoint.
  * **Async** — ``save_async`` copies every tensor to host memory (a
    consistent point: the step loop may then overwrite or free its
    tensors), then writes on a background thread.  ``wait()`` joins.
  * **Elastic restore** — leaves are stored whole (gathered); ``restore``
    places them on a device, or, given shardings for ANY mesh shape, as
    DTensors, each rank keeping its block, so a job checkpointed on N
    devices resumes on M (``runtime.elastic``).
  * **Retention** — the newest ``keep`` checkpoints stay.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import pathlib
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import device as devices
from repro_torch.nn.module import tree_flatten, tree_unflatten


def _leaf_paths(tree: Any) -> list[str]:
    """``"a/b/0"``-style names of the leaves, in flatten order (the
    reference checkpoint manifest's ``names``)."""
    if isinstance(tree, dict):
        return [f"{k}/{p}" if p else str(k)
                for k in sorted(tree) for p in _leaf_paths(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [f"{i}/{p}" if p else str(i)
                for i, v in enumerate(tree) for p in _leaf_paths(v)]
    return [""]


def _treedef_str(tree: Any) -> str:
    """The structure as the reference's manifest spells it
    (``PyTreeDef({'a': *, 'b': [*, *]})``)."""
    def walk(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(walk(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _host_copy(x) -> np.ndarray:
    """A host copy of one leaf that no later write to ``x`` reaches."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone().numpy()
    return np.array(x)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[cf.Future] = None

    # -- save ------------------------------------------------------------------

    def save(self, step: int, tree: Any) -> pathlib.Path:
        leaves, treedef = tree_flatten(tree)
        return self._write(step, [_host_copy(x) for x in leaves],
                           _leaf_paths(tree), _treedef_str(tree))

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        # snapshot to host memory synchronously (consistent point), write
        # on the pool's thread
        leaves, _ = tree_flatten(tree)
        self._pending = self._pool.submit(
            self._write, step, [_host_copy(x) for x in leaves],
            _leaf_paths(tree), _treedef_str(tree))

    def wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def _write(self, step: int, leaves: list, names: list[str],
               treedef: str) -> pathlib.Path:
        final = self.dir / f"step_{step:09d}"
        tmp = self.dir / f".tmp_step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "n_leaves": len(leaves), "names": names,
                    "shapes": [list(x.shape) for x in leaves],
                    "dtypes": [str(x.dtype) for x in leaves],
                    "treedef": treedef}
        for i, leaf in enumerate(leaves):
            with open(tmp / f"leaf_{i:05d}.npy", "wb") as f:
                np.save(f, leaf)
                f.flush()
                os.fsync(f.fileno())
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                    # atomic commit
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Optional[Any] = None, device=None
                ) -> tuple[Any, int]:
        """Restore the checkpoint at ``step`` (default: the latest) into
        the structure of ``like``, as tensors.

        With ``shardings`` (a tree of ``NamedSharding``s matching
        ``like``) every rank reads each whole leaf and keeps its block:
        DTensors on the shardings' meshes (``distribute_tensor`` with
        their placements, split locally).  Else each leaf goes to
        ``device`` when given, else to the device of ``like``'s tensor in
        its place (a leaf of ``like`` that is not a tensor: the default
        device, the card).  A checkpoint whose leaf count or shapes differ
        from ``like``'s raises ``ValueError``.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:09d}"
        manifest = json.loads((path / "manifest.json").read_text())
        leaves_like, treedef = tree_flatten(like)
        if manifest["n_leaves"] != len(leaves_like):
            raise ValueError(
                f"checkpoint/tree structure mismatch: {path} holds "
                f"{manifest['n_leaves']} leaves, the tree has "
                f"{len(leaves_like)}")
        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor
            place = tree_flatten(shardings)[0]
            if len(place) != len(leaves_like):
                raise ValueError(f"{len(place)} shardings for "
                                 f"{len(leaves_like)} leaves")
        dev = devices.resolve(device) if device is not None else None
        loaded = []
        for i, ref in enumerate(leaves_like):
            arr = np.load(path / f"leaf_{i:05d}.npy", allow_pickle=False)
            want = tuple(ref.shape) if isinstance(ref, torch.Tensor) else \
                np.shape(ref)
            if arr.shape != want:
                raise ValueError(
                    f"leaf {i} ({manifest['names'][i]}): shape "
                    f"{arr.shape} != {want}")
            if shardings is not None:
                s = place[i]
                loaded.append(distribute_tensor(
                    torch.from_numpy(arr), s.mesh.device_mesh, s.placements,
                    src_data_rank=None))
                continue
            where = dev or (ref.device if isinstance(ref, torch.Tensor)
                            else devices.resolve(None))
            loaded.append(torch.from_numpy(arr).to(where))
        return tree_unflatten(treedef, loaded), step
