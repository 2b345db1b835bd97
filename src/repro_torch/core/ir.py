"""SSA dataflow-graph IR for the OpenHLS compiler — struct-of-arrays layout.

The unit of representation is the *fully unrolled, scalar* dataflow graph
(DFG) of a DNN, exactly as recovered by symbolic interpretation of the
scf-dialect loop nests (paper §3.1).  Values are dense integer ids; ops are
flat records.  After interpretation with store-load forwarding there are no
load/store ops left — only arithmetic ops, graph inputs (hoisted weights and
activations), and graph outputs (final contents of output memrefs).

A second, optional mode (``forward=False`` in the interpreter) keeps explicit
``load``/``store`` ops with memory-port resource constraints.  That mode
models a conventional HLS tool that cannot forward through memory (the
paper's Vitis HLS baseline, §4.1) and is used by the Fig. 4 benchmark.

Storage layout
--------------
Unrolled graphs run to hundreds of thousands of ops, so the hot path —
tracing, the pass pipeline, scheduling, emission — operates on dense
*struct-of-arrays* columns rather than a Python list of ``Op`` objects.
A graph holds its op table in one of two interconvertible forms:

  * build form: one plain-``int`` Python list per column.  ``list.append``
    is the cheapest way to grow from the interpreter — the trace-time fast
    path — and no ``Op`` object is ever constructed.
  * sealed form: contiguous numpy ``int32`` arrays (``Graph.cols()``) that
    every pass/scheduler consumes with vectorised operations.  ``args`` is
    a packed ``(n, 3)`` matrix padded with ``-1`` (no opcode takes more than
    three operands); memref names are interned into ``array_names`` and
    stored as integer ids.  Pass outputs are built directly in this form
    via :meth:`Graph.from_columns` — no per-op rewriting.

``Graph.ops`` remains available as a sequence view that materialises ``Op``
records on demand — the compatibility surface for tests and record-level
inspection.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Opcodes
# ---------------------------------------------------------------------------

#: Floating-point arithmetic ops (bind to DSP-like units on FPGA; MXU/VPU
#: lanes on TPU).  Delay table below gives FloPoCo-ish pipeline depths in
#: cycles at the paper's 10 ns target clock.
ARITH_OPS = frozenset({
    "mulf", "addf", "subf", "divf", "sqrtf", "maxf", "minf", "negf",
    "relu", "fmac", "expf", "cmpugt", "select", "copy",
})

#: Memory ops — only present when store-load forwarding is disabled.
MEM_OPS = frozenset({"load", "store"})

#: Structural pseudo-ops.
META_OPS = frozenset({"input", "const", "output"})

ALL_OPS = ARITH_OPS | MEM_OPS | META_OPS

#: Stable opcode numbering for the integer ``opcode`` column.  Appending is
#: fine; reordering is a cache-format change (``CACHE_FORMAT_VERSION``).
OPCODES: tuple[str, ...] = (
    "mulf", "addf", "subf", "divf", "sqrtf", "maxf", "minf", "negf",
    "relu", "fmac", "expf", "cmpugt", "select", "copy",
    "load", "store", "input", "const", "output",
)
OPCODE_ID: dict[str, int] = {name: i for i, name in enumerate(OPCODES)}
N_OPCODES = len(OPCODES)
MAX_ARGS = 3

#: Build-form chunk size: every this-many appended ops, the tail lists are
#: frozen into dense ``int32`` chunk arrays (:meth:`Graph._flush_chunk`), so
#: a multi-million-op trace holds at most one chunk of boxed Python ints at
#: a time (~8 MB of arrays per 64k ops vs ~28 bytes per boxed int per
#: column) and ``cols()`` concatenates arrays instead of converting giant
#: lists.
TRACE_CHUNK = 1 << 16

#: Pipeline depth (cycles @ 10 ns) per op.  Calibrated against FloPoCo
#: (5,11)/(5,4) core latencies reported in the FloPoCo literature and tuned
#: so that the scheduled BraggNN(s=1) lands in the neighbourhood of the
#: paper's 1238-interval design (EXPERIMENTS.md §Paper-claims).
DEFAULT_DELAYS: dict[str, int] = {
    "mulf": 2,
    "addf": 3,
    "subf": 3,
    "fmac": 4,      # fused multiply-accumulate (paper §3.2 "Remove MACs")
    "divf": 12,
    "sqrtf": 12,
    "maxf": 1,
    "minf": 1,
    "negf": 0,      # sign-flip is free in FloPoCo encoding (paper §3)
    "relu": 0,      # combinational: mux on sign bit
    "expf": 0,      # never scheduled directly: expanded into Taylor series
    "cmpugt": 1,
    "select": 0,
    "copy": 0,
    "load": 1,
    "store": 1,
    "input": 0,
    "const": 0,
    "output": 0,
}

#: Resource class each opcode binds to.  ``None`` means unconstrained
#: (combinational / free).  The paper binds mulf and addf to separate DSP
#: instantiations ("2 K_i DSPs, assuming mulf, addf bind to one DSP each").
RESOURCE_CLASS: dict[str, Optional[str]] = {
    "mulf": "mul",
    "addf": "add",
    "subf": "add",
    "fmac": "mac",
    "divf": "div",
    "sqrtf": "sqrt",
    "maxf": "cmp",
    "minf": "cmp",
    "cmpugt": "cmp",
    "negf": None,
    "relu": None,
    "select": None,
    "copy": None,
    "expf": None,
    "load": "port",   # memory ports are per-array resources
    "store": "port",
    "input": None,
    "const": None,
    "output": None,
}

#: Resource-class numbering for the vectorised scheduler.  Class 0 is the
#: "unconstrained" pseudo-class (RESOURCE_CLASS is None).
RESOURCE_CLASSES: tuple[str, ...] = (
    "", "mul", "add", "mac", "div", "sqrt", "cmp", "port")
RESOURCE_CLASS_ID: dict[str, int] = {
    name: i for i, name in enumerate(RESOURCE_CLASSES)}
PORT_CLASS_ID = RESOURCE_CLASS_ID["port"]

# Dense per-opcode-id lookup tables shared by the vectorised passes and
# scheduler (index with an ``opcode`` column).
ARITH_MASK = np.array([name in ARITH_OPS for name in OPCODES], dtype=bool)
DELAY_TABLE = np.array([DEFAULT_DELAYS[name] for name in OPCODES],
                       dtype=np.int64)
CLASS_TABLE = np.array(
    [RESOURCE_CLASS_ID[RESOURCE_CLASS[name] or ""] for name in OPCODES],
    dtype=np.int64)

# Hot opcode ids for the pattern passes.
ID_MULF = OPCODE_ID["mulf"]
ID_ADDF = OPCODE_ID["addf"]
ID_MAXF = OPCODE_ID["maxf"]
ID_MINF = OPCODE_ID["minf"]
ID_RELU = OPCODE_ID["relu"]
ID_FMAC = OPCODE_ID["fmac"]
ID_CMPUGT = OPCODE_ID["cmpugt"]
ID_SELECT = OPCODE_ID["select"]
ID_STORE = OPCODE_ID["store"]


def delay_table(delays: Optional[dict[str, int]]) -> np.ndarray:
    """Per-opcode-id delay lookup array for a (possibly custom) delay map."""
    if delays is None or delays is DEFAULT_DELAYS:
        return DELAY_TABLE
    return np.array([delays.get(name, 0) for name in OPCODES], dtype=np.int64)


@dataclasses.dataclass(slots=True)
class Op:
    """One node of the DFG (the record view of one SoA row).

    idx:      position in program (interpretation) order — the linear order
              used to serialise same-resource operations (paper §3.3).
    opcode:   one of ALL_OPS.
    args:     operand value ids.
    result:   result value id (-1 for store/output).
    nest:     id of the originating loop nest (one per DNN operation).
    rank:     linear index of this op's parallel-iteration instance within
              its nest's parallel iteration space (the "j" in the paper's
              resource indexing), or -1 when not inside an scf.parallel.
    array:    for load/store: name of the memref accessed (port binding).
    """

    idx: int
    opcode: str
    args: tuple[int, ...]
    result: int
    nest: int = -1
    rank: int = -1
    array: str = ""


@dataclasses.dataclass(frozen=True)
class GraphCols:
    """The sealed struct-of-arrays view of a graph's op table.

    All columns are contiguous ``int32`` arrays of length ``n`` (``args`` is
    ``(n, 3)``, padded with -1); ``producer`` has length ``n_values`` and
    maps value id -> producing op row (-1 for inputs/consts).
    """

    opcode: np.ndarray
    args: np.ndarray
    result: np.ndarray
    nest: np.ndarray
    rank: np.ndarray
    array_id: np.ndarray
    producer: np.ndarray

    @property
    def n(self) -> int:
        return len(self.opcode)


def _producer_from(result: np.ndarray, n_values: int) -> np.ndarray:
    producer = np.full(n_values, -1, dtype=np.int32)
    has_res = result >= 0
    producer[result[has_res]] = np.flatnonzero(has_res)
    return producer


class _OpsView(Sequence):
    """Sequence view over the columns, materialising ``Op`` rows on demand.

    The int columns are fetched once per view (and on a sealed graph live
    only as long as the view), so indexed access inside a loop stays O(1)
    without the graph retaining dual storage.
    """

    __slots__ = ("_g", "_cache")

    def __init__(self, g: "Graph"):
        self._g = g
        self._cache: Optional[tuple[list, ...]] = None

    def _lists(self) -> tuple[list, ...]:
        if self._cache is None:
            self._cache = self._g._lists_view()
        return self._cache

    def __len__(self) -> int:
        return self._g.n_ops

    def _make(self, i: int, lists) -> Op:
        g = self._g
        o, a0, a1, a2, r, ne, rk, ai = lists
        if a0[i] < 0:
            args: tuple[int, ...] = ()
        elif a1[i] < 0:
            args = (a0[i],)
        elif a2[i] < 0:
            args = (a0[i], a1[i])
        else:
            args = (a0[i], a1[i], a2[i])
        return Op(i, OPCODES[o[i]], args, r[i], ne[i], rk[i],
                  g.array_names[ai[i]])

    def __getitem__(self, i):
        n = len(self)
        lists = self._lists()
        if isinstance(i, slice):
            return [self._make(j, lists) for j in range(*i.indices(n))]
        i = int(i)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self._make(i, lists)

    def __iter__(self) -> Iterator[Op]:
        g = self._g
        names = OPCODES
        arr_names = g.array_names
        o, a0, a1, a2, r, ne, rk, ai = self._lists()
        for i in range(len(o)):
            x0 = a0[i]
            if x0 < 0:
                args: tuple[int, ...] = ()
            else:
                x1 = a1[i]
                if x1 < 0:
                    args = (x0,)
                else:
                    x2 = a2[i]
                    args = (x0, x1) if x2 < 0 else (x0, x1, x2)
            yield Op(i, names[o[i]], args, r[i], ne[i], rk[i],
                     arr_names[ai[i]])


class Graph:
    """Flat SSA DFG plus interface metadata (struct-of-arrays storage)."""

    def __init__(self) -> None:
        # build-form columns: op id, arg0..2 (-1 pad), result, nest, rank,
        # interned array id.  ``None`` when the graph lives in sealed form.
        self._lists: Optional[tuple[list, ...]] = (
            [], [], [], [], [], [], [], [])
        # frozen prefix of the build form: every TRACE_CHUNK appends, the
        # tail lists flush into dense int32 arrays so tracing a multi-
        # million-op graph never holds more than one chunk of boxed ints
        self._chunks: list[tuple[np.ndarray, ...]] = []
        self._cols: Optional[GraphCols] = None
        self._n_ops: int = 0
        # interned memref-name table; id 0 is the empty name
        self.array_names: list[str] = [""]
        self._array_intern: dict[str, int] = {"": 0}
        self.n_values: int = 0
        # interface: memref name -> {index tuple -> value id}
        self.inputs: dict[str, dict[tuple[int, ...], int]] = {}
        self.outputs: dict[str, dict[tuple[int, ...], int]] = {}
        # value id -> python float for constants
        self.consts: dict[int, float] = {}
        # nest id -> size of its parallel iteration space (K_i, paper §3.3)
        self.nest_parallel_space: dict[int, int] = {}
        # nest id -> human-readable label (e.g. "conv2d_0")
        self.nest_labels: dict[int, str] = {}
        # subset of input memref names that are weights ("hoisted globals",
        # paper §3.2): exposed at the module interface like any input, but
        # bound to trained constants at deployment time.
        self.weight_names: set[str] = set()

    # -- storage ------------------------------------------------------------

    @property
    def n_ops(self) -> int:
        return self._n_ops

    @property
    def ops(self) -> _OpsView:
        return _OpsView(self)

    @property
    def producer(self) -> np.ndarray:
        """Value id -> producing op row (-1 for inputs/consts)."""
        return self.cols().producer

    def _thaw(self) -> tuple[list, ...]:
        c = self._cols
        return (c.opcode.tolist(), c.args[:, 0].tolist(),
                c.args[:, 1].tolist(), c.args[:, 2].tolist(),
                c.result.tolist(), c.nest.tolist(), c.rank.tolist(),
                c.array_id.tolist())

    def _flush_chunk(self) -> None:
        """Freeze the current build-list tail into int32 chunk arrays.

        The lists are cleared *in place* — ``Context._emit`` holds direct
        references to the list objects within a call.
        """
        lists = self._lists
        self._chunks.append(tuple(np.asarray(col, dtype=np.int32)
                                  for col in lists))
        for col in lists:
            col.clear()

    def _merge_chunks(self) -> None:
        """Fold frozen chunks back into the build lists (rare: list-form
        mutation of a mid-trace graph)."""
        if not self._chunks:
            return
        for k, col in enumerate(self._lists):
            head = np.concatenate(
                [ch[k] for ch in self._chunks]).tolist()
            head.extend(col)
            col[:] = head  # in place: _emit may hold references
        self._chunks = []

    def _mutable_lists(self) -> tuple[list, ...]:
        """The build-form columns, thawing from sealed form if needed.

        For *mutation* only: the thawed lists are installed as the graph's
        storage (the caller invalidates ``_cols`` after appending).
        """
        if self._lists is None:
            self._lists = self._thaw()
        else:
            self._merge_chunks()
        return self._lists

    def _lists_view(self) -> tuple[list, ...]:
        """Indexable int columns for the ``Op`` view.

        Read-only: a sealed graph thaws a *transient* copy that the view
        caches for its own lifetime — the graph keeps single (array)
        storage, so big cached designs don't retain boxed-int columns after
        someone iterates ``g.ops`` once.  A mid-trace chunked graph likewise
        merges into a transient copy, leaving the chunk storage intact.
        """
        if self._lists is None:
            return self._thaw()
        if self._chunks:
            merged = []
            for k, col in enumerate(self._lists):
                head = np.concatenate(
                    [ch[k] for ch in self._chunks]).tolist()
                head.extend(col)
                merged.append(head)
            return tuple(merged)
        return self._lists

    def cols(self) -> GraphCols:
        """Seal and return the dense column arrays (cached until mutation)."""
        if self._cols is None:
            if self._chunks:
                tail = tuple(np.asarray(col, dtype=np.int32)
                             for col in self._lists)
                o, a0, a1, a2, r, ne, rk, ai = (
                    np.concatenate([ch[k] for ch in self._chunks]
                                   + [tail[k]])
                    for k in range(len(tail)))
                self._chunks = []
            else:
                o, a0, a1, a2, r, ne, rk, ai = (
                    np.asarray(col, dtype=np.int32) for col in self._lists)
            opcode = o
            args = np.empty((len(opcode), MAX_ARGS), dtype=np.int32)
            args[:, 0] = a0
            args[:, 1] = a1
            args[:, 2] = a2
            result = r
            self._cols = GraphCols(
                opcode=opcode, args=args, result=result,
                nest=ne, rank=rk, array_id=ai,
                producer=_producer_from(result, self.n_values))
            # sealed graphs drop the build lists (thawed back on demand by
            # the Op view or a later add_op) — no dual storage for the big
            # raw/optimised graphs that live inside CompiledDesign
            self._lists = None
        return self._cols

    def intern_array(self, name: str) -> int:
        aid = self._array_intern.get(name)
        if aid is None:
            aid = len(self.array_names)
            self.array_names.append(name)
            self._array_intern[name] = aid
        return aid

    def _copy_meta(self, src: "Graph") -> None:
        """Deep-copy interface metadata from ``src`` (value-id space shared)."""
        self.n_values = src.n_values
        self.inputs = {k: dict(v) for k, v in src.inputs.items()}
        self.outputs = {k: dict(v) for k, v in src.outputs.items()}
        self.consts = dict(src.consts)
        self.nest_parallel_space = dict(src.nest_parallel_space)
        self.nest_labels = dict(src.nest_labels)
        self.weight_names = set(src.weight_names)
        self.array_names = list(src.array_names)
        self._array_intern = dict(src._array_intern)

    @classmethod
    def from_columns(cls, src: "Graph", opcode: np.ndarray, args: np.ndarray,
                     result: np.ndarray, nest: np.ndarray, rank: np.ndarray,
                     array_id: np.ndarray, *,
                     n_values: Optional[int] = None) -> "Graph":
        """Build a rewritten graph directly from column arrays.

        Interface metadata is copied from ``src``; the value-id space is
        preserved (``n_values`` may extend it, e.g. for reduction trees).
        This is the bulk constructor every vectorised pass uses — the graph
        is born in sealed form and never materialises ``Op`` objects unless a consumer asks.
        """
        g = cls()
        g._copy_meta(src)
        if n_values is not None:
            g.n_values = n_values
        opcode = np.ascontiguousarray(opcode, dtype=np.int32)
        args = np.ascontiguousarray(args, dtype=np.int32)
        result = np.ascontiguousarray(result, dtype=np.int32)
        g._lists = None
        g._n_ops = len(opcode)
        g._cols = GraphCols(
            opcode=opcode, args=args, result=result,
            nest=np.ascontiguousarray(nest, dtype=np.int32),
            rank=np.ascontiguousarray(rank, dtype=np.int32),
            array_id=np.ascontiguousarray(array_id, dtype=np.int32),
            producer=_producer_from(result, g.n_values))
        return g

    # -- construction -------------------------------------------------------

    def new_value(self) -> int:
        vid = self.n_values
        self.n_values += 1
        if self._cols is not None:
            self._mutable_lists()   # keep the op table before invalidating
            self._cols = None       # producer array length depends on n_values
        return vid

    def add_op(
        self,
        opcode: str,
        args: Sequence[int],
        *,
        nest: int = -1,
        rank: int = -1,
        array: str = "",
        result: Optional[int] = None,
    ) -> int:
        """Append an op; returns its result value id (or -1).

        This is the trace-time hot path: eight plain-list appends into the
        preallocated column buffers, no ``Op`` object construction.
        """
        try:
            opid = OPCODE_ID[opcode]
        except KeyError:
            raise AssertionError(opcode) from None
        if result is None:
            result = -1 if opcode in ("store", "output") else self.new_value()
        o, a0, a1, a2, r, ne, rk, ai = (self._lists if self._lists is not None
                                        else self._mutable_lists())
        n = len(args)
        o.append(opid)
        a0.append(args[0] if n > 0 else -1)
        a1.append(args[1] if n > 1 else -1)
        a2.append(args[2] if n > 2 else -1)
        r.append(result)
        ne.append(nest)
        rk.append(rank)
        ai.append(self.intern_array(array) if array else 0)
        self._n_ops += 1
        self._cols = None
        if len(o) >= TRACE_CHUNK:
            self._flush_chunk()
        return result

    def add_const(self, value: float) -> int:
        vid = self.new_value()
        self.consts[vid] = float(value)
        return vid

    # -- queries ------------------------------------------------------------

    def num_arith_ops(self) -> int:
        if not self._n_ops:
            return 0
        return int(ARITH_MASK[self.cols().opcode].sum())

    def op_histogram(self) -> dict[str, int]:
        if not self._n_ops:
            return {}
        counts = np.bincount(self.cols().opcode, minlength=N_OPCODES)
        return {OPCODES[i]: int(c) for i, c in enumerate(counts) if c}

    def use_counts(self) -> np.ndarray:
        """Per-value use count (args plus interface outputs), int64[n_values]."""
        c = self.cols()
        flat = c.args[c.args >= 0]
        uses = np.bincount(flat, minlength=self.n_values)
        out_vals = self.output_values()
        if out_vals:
            uses = uses + np.bincount(np.asarray(out_vals, dtype=np.int64),
                                      minlength=self.n_values)
        return uses

    def K(self) -> int:
        """Peak resource replication: K = max_i K_i (paper §3.3)."""
        if not self.nest_parallel_space:
            return 1
        return max(self.nest_parallel_space.values())

    def output_values(self) -> list[int]:
        out: list[int] = []
        for table in self.outputs.values():
            out.extend(table.values())
        return out

    def input_values(self) -> list[int]:
        out: list[int] = []
        for table in self.inputs.values():
            out.extend(table.values())
        return out

    # -- rewriting ----------------------------------------------------------

    def rewrite(self, live_ops: Iterable[Op]) -> "Graph":
        """Rebuild a graph from a subset/sequence of (possibly new) ops.

        ``live_ops`` must be topologically ordered.  Value ids are preserved
        (the new graph keeps the same value-id space), which keeps interface
        tables valid.  Producer indices are recomputed.
        """
        g = Graph()
        g._copy_meta(self)
        for op in live_ops:
            g.add_op(op.opcode, op.args, nest=op.nest, rank=op.rank,
                     array=op.array, result=op.result)
        return g

    def topo_check(self) -> None:
        """Assert program order is a valid topological order (SSA def-before-use)."""
        c = self.cols()
        n = c.n
        BIG = n + 1
        defined_at = np.full(max(self.n_values, 1), BIG, dtype=np.int32)
        iface = list(self.consts)
        for table in self.inputs.values():
            iface.extend(table.values())
        if iface:
            defined_at[np.asarray(iface, dtype=np.int64)] = -1
        has_res = c.result >= 0
        ridx = np.flatnonzero(has_res).astype(np.int32)
        # reversed scatter: the earliest definition position wins
        # (redefinition is tolerated, as in the historical per-op check)
        defined_at[c.result[has_res][::-1]] = ridx[::-1]
        # take(mode="clip") maps the -1 arg padding onto slot 0; the `am`
        # mask discards those lanes
        arg_def = defined_at.take(c.args, mode="clip")
        bad = arg_def >= np.arange(n, dtype=np.int32)[:, None]
        bad &= c.args >= 0
        if bad.any():
            i, j = np.argwhere(bad)[0]
            a = int(c.args[i, j])
            raise ValueError(
                f"op {int(i)} ({OPCODES[c.opcode[i]]}) uses undefined "
                f"value {a}")
        for name, table in self.outputs.items():
            for vid in table.values():
                if defined_at[vid] >= BIG:
                    raise ValueError(
                        f"output {name} reads undefined value {vid}")

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        h = self.op_histogram()
        return (f"Graph(ops={self.n_ops}, values={self.n_values}, "
                f"K={self.K()}, hist={h})")


def iter_edges(g: Graph) -> Iterator[tuple[int, int]]:
    """Yield (producer_op_idx, consumer_op_idx) data-dependence edges."""
    c = g.cols()
    prod = c.producer
    for i in range(c.n):
        for j in range(MAX_ARGS):
            a = c.args[i, j]
            if a < 0:
                continue
            p = prod[a]
            if p >= 0:
                yield (int(p), i)
