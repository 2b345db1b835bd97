"""Design emission + functional simulation (paper §3.1 item 4, §3.2).

Execution backends for a scheduled DFG:

  * ``evaluate``      — numpy functional simulation.  With a ``FloatFormat``
                        this becomes the FloPoCo functional model (quantise
                        after every operation), i.e. the reference the
                        paper's testbenches compare RTL against.  The DFG is
                        levelised and each (level, opcode) group executes as
                        one vectorised gather/compute/scatter over a dense
                        ``(n_values, batch)`` value matrix — bit-identical
                        to a per-op program-order loop.
  * ``to_torch_fn``   — the emitted design as a torch callable.
                        ``backend='simd'`` renders the levelised DFG as one
                        gather/compute/scatter per (level, opcode) group
                        in plain torch; ``backend='cuda'`` is the compiled
                        rendering on the hand-written kernels
                        (:mod:`repro_torch.core.emit_cuda`, the counterpart
                        of the reference's ``'pallas'``).
  * the tensor path   — production inference uses the tensor-level model
                        (``repro_torch.models``) with ``precision.quantize``
                        inserted per the chosen format; the scalar DFG
                        backends above serve as its behavioural oracle.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.core.ir import OPCODES, Graph, GraphCols
from repro_torch.core.precision import FloatFormat, quantize_np


def _input_arrays(g: Graph, feeds: dict[str, np.ndarray], batch: int
                  ) -> dict[int, np.ndarray]:
    """Scatter feed tensors into per-value (batch,) vectors."""
    vals: dict[int, np.ndarray] = {}
    for name, table in g.inputs.items():
        if name not in feeds:
            raise KeyError(f"missing feed for input memref '{name}'")
        arr = np.asarray(feeds[name], dtype=np.float32)
        for idx, vid in table.items():
            if arr.ndim == len(idx):          # unbatched feed: broadcast
                vals[vid] = np.full((batch,), arr[idx], dtype=np.float32)
            else:                              # leading batch dimension
                vals[vid] = np.ascontiguousarray(
                    arr[(slice(None),) + idx], dtype=np.float32)
    return vals


def levelize(c: GraphCols, n_values: int) -> np.ndarray:
    """ASAP levels (unit delays) per op, computed as Kahn waves.

    An op's level is 1 + the max level of its operand values (inputs and
    constants sit at level 0) — the longest-path depth the historical per-op
    loop computed sequentially.  Each wave resolves every op whose operands
    are all known, so total work is linear in edges with one numpy step per
    DAG level.
    """
    n = c.n
    op_level = np.zeros(n, dtype=np.int64)
    if n == 0:
        return op_level
    args = c.args
    am = args >= 0
    pa = np.where(am, c.producer[np.clip(args, 0, None)], -1)
    dep = pa >= 0
    indeg = dep.sum(axis=1)
    # consumer CSR: edges producer-op -> consumer-op
    pe = pa[dep]
    ce = np.broadcast_to(np.arange(n)[:, None], pa.shape)[dep]
    order = np.argsort(pe, kind="stable")
    ce_s = ce[order]
    counts = np.bincount(pe[order], minlength=n)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    val_level = np.zeros(max(n_values, 1), dtype=np.int64)
    frontier = np.flatnonzero(indeg == 0)
    remaining = indeg
    while frontier.size:
        fa = args[frontier]
        lv = np.where(fa >= 0, val_level[np.clip(fa, 0, None)] + 1, 0) \
            .max(axis=1)
        op_level[frontier] = lv
        fr = c.result[frontier]
        rmask = fr >= 0
        val_level[fr[rmask]] = lv[rmask]
        lens = counts[frontier]
        tot = int(lens.sum())
        if not tot:
            break
        base = np.repeat(offs[frontier], lens)
        within = np.arange(tot) - np.repeat(np.cumsum(lens) - lens, lens)
        cons = ce_s[base + within]
        remaining = remaining - np.bincount(cons, minlength=n)
        frontier = np.unique(cons[remaining[cons] == 0])
    return op_level


def _level_groups(c: GraphCols, n_values: int):
    """Rows grouped by (level, opcode), levels ascending, rows in program
    order within each group."""
    if c.n == 0:      # passthrough design: outputs wired straight to inputs
        return
    op_level = levelize(c, n_values)
    order = np.lexsort((np.arange(c.n), c.opcode, op_level))
    lv_s = op_level[order]
    oc_s = c.opcode[order]
    brk = np.flatnonzero((np.diff(lv_s) != 0) | (np.diff(oc_s) != 0)) + 1
    for rows in np.split(order, brk):
        yield int(op_level[rows[0]]), OPCODES[c.opcode[rows[0]]], rows


def compile_groups(c: GraphCols, n_values: int
                   ) -> list[tuple[int, str, list[np.ndarray], np.ndarray]]:
    """Precompute the gather/scatter index arrays per (level, opcode) group.

    Returns ``(level, opcode, [arg index arrays], result index array)``
    tuples in level order — the shared unit of emission for the SIMD
    rendering (:func:`to_torch_fn`) and the generic DFG tier
    (``repro_torch.core.emit_cuda``), which fuses contiguous runs of them
    into one launch of the DFG segment kernel.
    """
    groups = []
    for lv, oc, rows in _level_groups(c, n_values):
        ga = c.args[rows]
        n_args = int((ga >= 0).sum(axis=1).max()) if len(rows) else 0
        arg_idx = [np.where(ga[:, i] >= 0, ga[:, i], 0).astype(np.int32)
                   for i in range(n_args)]
        res_idx = c.result[rows].astype(np.int32)
        groups.append((lv, oc, arg_idx, res_idx))
    return groups


def io_tables(g: Graph):
    """Constant / input-scatter / output-gather index tables of a DFG.

    Shared by every vectorised emitter: ``const_idx``/``const_val`` seed the
    value buffer, ``input_scatter[name] = (vids, idx tuples)`` place feeds,
    ``output_gather[name] = (vids, shape)`` assemble outputs.
    """
    const_idx = np.array(sorted(g.consts), dtype=np.int32)
    const_val = np.array([g.consts[int(i)] for i in const_idx],
                         dtype=np.float32)
    input_scatter = {
        name: (np.array([vid for _, vid in sorted(table.items())],
                        dtype=np.int32),
               [idx for idx, _ in sorted(table.items())])
        for name, table in g.inputs.items()
    }
    output_gather = {
        name: (np.array([vid for _, vid in sorted(table.items())],
                        dtype=np.int32),
               tuple(max(i[d] for i in table) + 1
                     for d in range(len(next(iter(table))))))
        for name, table in g.outputs.items()
    }
    return const_idx, const_val, input_scatter, output_gather


def _assemble_outputs(g: Graph, batch: int, value_of
                      ) -> dict[str, np.ndarray]:
    """Scatter per-value (batch,) vectors, ``value_of(vid)``, into output
    tensors."""
    outs: dict[str, np.ndarray] = {}
    for name, table in g.outputs.items():
        shape = tuple(max(i[d] for i in table) + 1
                      for d in range(len(next(iter(table)))))
        out = np.zeros((batch,) + shape, dtype=np.float32)
        for idx, vid in table.items():
            out[(slice(None),) + idx] = value_of(vid)
        outs[name] = out
    return outs


def evaluate(g: Graph, feeds: dict[str, np.ndarray], *,
             fmt: Optional[FloatFormat] = None,
             batch: Optional[int] = None) -> dict[str, np.ndarray]:
    """Functional simulation of the DFG on a batch of input vectors.

    feeds: memref name -> array of shape ``shape`` or ``(batch,) + shape``.
    fmt:   if given, every input, constant and op result is quantised —
           the FloPoCo functional-model mode (paper §3.1 item 4).
    """
    if batch is None:
        batch = 1
        for name, arr in feeds.items():
            arr = np.asarray(arr)
            want = g.inputs.get(name)
            if want and arr.ndim == len(next(iter(want))) + 1:
                batch = arr.shape[0]
                break
    q = (lambda x: quantize_np(x, fmt)) if fmt is not None else (lambda x: x)

    vals = _input_arrays(g, feeds, batch)
    c = g.cols()
    M = np.zeros((max(g.n_values, 1), batch), dtype=np.float32)
    if vals:
        ivids = np.fromiter(vals.keys(), dtype=np.int64, count=len(vals))
        M[ivids] = q(np.stack(list(vals.values()), axis=0))
    if g.consts:
        cvids = np.fromiter(g.consts.keys(), dtype=np.int64,
                            count=len(g.consts))
        cvals = np.fromiter(g.consts.values(), dtype=np.float32,
                            count=len(g.consts))
        M[cvids] = q(np.broadcast_to(cvals[:, None],
                                     (len(cvals), batch)).copy())

    args, res = c.args, c.result
    for _lv, oc, rows in _level_groups(c, g.n_values):
        a0 = M[args[rows, 0]]
        if oc == "mulf":
            r = a0 * M[args[rows, 1]]
        elif oc == "addf":
            r = a0 + M[args[rows, 1]]
        elif oc == "subf":
            r = a0 - M[args[rows, 1]]
        elif oc == "divf":
            r = a0 / M[args[rows, 1]]
        elif oc == "sqrtf":
            r = np.sqrt(a0)
        elif oc == "maxf":
            r = np.maximum(a0, M[args[rows, 1]])
        elif oc == "minf":
            r = np.minimum(a0, M[args[rows, 1]])
        elif oc == "negf":
            r = -a0
        elif oc == "relu":
            r = np.maximum(a0, 0.0)
        elif oc == "fmac":
            # fmac(b, c, a) = b*c + a, rounded once (fused on FPGA)
            r = a0 * M[args[rows, 1]] + M[args[rows, 2]]
        elif oc == "cmpugt":
            r = (a0 > M[args[rows, 1]]).astype(np.float32)
        elif oc == "select":
            r = np.where(a0 > 0.5, M[args[rows, 1]], M[args[rows, 2]])
        elif oc in ("load", "store", "copy"):
            r = a0
        else:  # pragma: no cover
            raise NotImplementedError(oc)
        if oc not in ("cmpugt", "load", "store", "copy"):
            r = q(r)
        rmask = res[rows] >= 0
        if rmask.all():
            M[res[rows]] = r
        elif rmask.any():
            M[res[rows][rmask]] = r[rmask]

    return _assemble_outputs(g, batch, M.__getitem__)


# ---------------------------------------------------------------------------
# The value buffer of the vectorised emitters
# ---------------------------------------------------------------------------

def unwritten_reads(g: Graph) -> np.ndarray:
    """Value ids that some op or output reads but no constant, no input and
    no op writes: ``evaluate`` reads them as 0 from its zeroed matrix."""
    c = g.cols()
    read = [c.args[c.args >= 0]]
    read += [vids for vids, _ in io_tables(g)[3].values()]
    written = [c.result[c.result >= 0],
               np.fromiter(g.consts, dtype=np.int64, count=len(g.consts))]
    written += [np.fromiter(t.values(), dtype=np.int64, count=len(t))
                for t in g.inputs.values()]
    return np.setdiff1d(np.concatenate(read).astype(np.int64),
                        np.concatenate(written).astype(np.int64))


def buffer_io(g: Graph, dev, q=None, bound=None):
    """``(prologue, epilogue)`` of a value-major ``(n_values, batch)`` fp32
    buffer on ``dev``, shared by the ``simd`` backend and the DFG tier.

    ``prologue(feeds) -> (buf, batch)`` takes the buffer uninitialised
    (rows on 16 bytes, as the segment kernel's ``value_buffer`` makes
    them), zeroes only the slots that are read but never written
    (:func:`unwritten_reads`), places the static slots with one operation,
    then every input feed (numpy or tensor; the batch is the leading axis
    of the first batched feed, and unbatched feeds broadcast on the
    device, never copied per sample).  The static slots are the constants
    and the unbatched ``bound`` inputs (memref name -> array or tensor,
    usually bound weights), gathered into one table and rounded by ``q``
    once, here; a feed of a bound input's name overrides it per call, and
    a batched bound input is placed per call like a feed.  ``q``, if given,
    rounds inputs and constants as ``evaluate`` does; per call it rounds
    each feed once.  ``epilogue(buf, batch)`` gathers
    ``{output: (batch,) + shape}``.
    """
    import torch

    from repro_torch.kernels.dfg_segment.dfg_segment import value_buffer

    const_idx, const_val, input_scatter, output_gather = io_tables(g)
    n_values = max(g.n_values, 1)
    places = {}
    for name, (vids, idxs) in input_scatter.items():
        rank = len(idxs[0])
        shape = tuple(max(i[d] for i in idxs) + 1 for d in range(rank))
        lin = np.ravel_multi_index(tuple(np.array(idxs).T), shape)
        places[name] = (torch.from_numpy(vids.astype(np.int64)).to(dev),
                        torch.from_numpy(lin.astype(np.int64)).to(dev),
                        rank)
    defaults = {}
    sidx = [torch.from_numpy(const_idx.astype(np.int64)).to(dev)]
    sval = [torch.from_numpy(const_val).to(dev)]
    for name, v in (bound or {}).items():
        if name not in places:
            continue
        vids, lin, rank = places[name]
        v = torch.as_tensor(v, dtype=torch.float32, device=dev)
        if v.dim() != rank:
            defaults[name] = v
            continue
        sidx.append(vids)
        sval.append(v.reshape(-1)[lin])
    sidx, sval = torch.cat(sidx), torch.cat(sval)
    if q is not None and len(sval):
        sval = q(sval)
    sval = sval[:, None]
    zero = torch.from_numpy(unwritten_reads(g)).to(dev)
    gathers = {name: (torch.from_numpy(vids.astype(np.int64)).to(dev), shape)
               for name, (vids, shape) in output_gather.items()}

    def prologue(feeds):
        feeds = {**defaults, **feeds}
        missing = [n for n in places
                   if n not in feeds and n not in (bound or {})]
        if missing:
            raise KeyError(f"missing feed for input memref '{missing[0]}'")
        arrs = {n: torch.as_tensor(feeds[n], dtype=torch.float32,
                                   device=dev) for n in places if n in feeds}
        batch = next((int(a.shape[0]) for n, a in arrs.items()
                      if a.dim() == places[n][2] + 1), 1)
        buf = value_buffer(n_values, batch, dev)
        if len(zero):
            buf[zero] = 0.0
        if len(sidx):
            buf[sidx] = sval
        for name, a in arrs.items():
            vids, lin, rank = places[name]
            if q is not None:
                a = q(a.contiguous())
            if a.dim() == rank:                  # unbatched: broadcast
                buf[vids] = a.reshape(-1)[lin][:, None]
            else:
                buf[vids] = a.reshape(a.shape[0], -1)[:, lin].T
        return buf, batch

    def epilogue(buf, batch):
        return {name: buf[vids].T.reshape((batch,) + shape)
                for name, (vids, shape) in gathers.items()}

    return prologue, epilogue


def _simd_fn(g: Graph, device) -> Callable:
    import torch

    from repro_torch.core import device as devices
    from repro_torch.kernels.registry import opcode_compute

    dev = devices.resolve(device)
    groups = []
    for _lv, oc, arg_idx, res_idx in compile_groups(g.cols(), g.n_values):
        keep = res_idx >= 0
        groups.append((
            oc, [torch.from_numpy(ai.astype(np.int64)).to(dev)
                 for ai in arg_idx],
            torch.from_numpy(res_idx[keep].astype(np.int64)).to(dev),
            # the kept rows as indices, not a mask: a mask's gather waits
            # for the card, which a captured CUDA graph cannot
            None if keep.all() else torch.from_numpy(np.flatnonzero(keep)).to(
                dev)))
    prologue, epilogue = buffer_io(g, dev)

    def run(feeds):
        with torch.inference_mode():
            buf, batch = prologue(feeds)
            for oc, args, res, keep in groups:
                r = opcode_compute(oc, [buf[ai] for ai in args])
                buf[res] = r if keep is None else r[keep]
            return epilogue(buf, batch)

    run.device = dev
    return run


# ---------------------------------------------------------------------------
# Emission front door
# ---------------------------------------------------------------------------

#: valid values for the ``backend=`` of :func:`to_torch_fn`: the SIMD
#: interpretation vs the compiled rendering on the CUDA kernels
EMIT_BACKENDS = ("simd", "cuda")


def to_torch_fn(g: Graph, *, backend: str = "cuda", **cuda_kw
                ) -> Callable[[dict], dict]:
    """Emit a torch callable that evaluates the DFG.

    ``backend='cuda'``: the compiled rendering —
    :func:`repro_torch.core.emit_cuda.to_cuda_fn`, which takes ``module=``
    for the nest-pattern tier (extra keywords are forwarded) and returns a
    callable carrying its lowering ``.plan``.

    ``backend='simd'``: the DFG is levelised (ASAP with unit delays) and
    each (level, opcode) group becomes one gather -> torch op -> scatter
    over a value-major buffer on ``device`` (default ``"cuda"``, which
    raises without a GPU), in fp32, exactly as ``evaluate`` rounds.  It
    takes a feed dict (weights batched or not) and returns
    ``{output: (batch,) + shape}`` tensors; it takes no other keyword.
    """
    if backend not in EMIT_BACKENDS:
        raise ValueError(f"unknown emission backend {backend!r} "
                         f"(valid: {', '.join(EMIT_BACKENDS)})")
    if backend == "simd":
        extra = sorted(set(cuda_kw) - {"device"})
        if extra:
            raise TypeError(f"backend='simd' takes only device=, got "
                            f"{extra}")
        return _simd_fn(g, cuda_kw.get("device"))
    from repro_torch.core.emit_cuda import to_cuda_fn
    return to_cuda_fn(g, **cuda_kw)
