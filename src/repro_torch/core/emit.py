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
                        ``backend='cuda'`` is the compiled rendering on the
                        hand-written kernels (:mod:`repro_torch.core.emit_cuda`,
                        the counterpart of the reference's ``'pallas'``).
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
    rendering and the generic DFG tier, which fuse contiguous runs of
    them into compiled kernels (both still to be ported).
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
    callable carrying its lowering ``.plan``.  ``backend='simd'``, the
    levelised gather/compute/scatter interpretation, is not ported yet.
    """
    if backend not in EMIT_BACKENDS:
        raise ValueError(f"unknown emission backend {backend!r} "
                         f"(valid: {', '.join(EMIT_BACKENDS)})")
    if backend == "simd":
        raise NotImplementedError(
            "the simd emission backend is not ported yet (ROADMAP queue 1, "
            "item 6); use backend='cuda'")
    from repro_torch.core.emit_cuda import to_cuda_fn
    return to_cuda_fn(g, **cuda_kw)
