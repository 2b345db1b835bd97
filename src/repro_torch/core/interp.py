"""Symbolic interpretation of loop-nest DNN programs (paper §3.1).

The paper's key move: rather than statically analysing unrolled loop nests
(prohibitively expensive — Fig. 2), *execute* them under the Python
interpreter with arithmetic and memory operations overloaded to act on
symbols.  Memrefs become *geometric symbol tables* (symbol tables indexed by
array index rather than identifier), so:

  * store-load forwarding falls out for free — a load simply returns the
    symbol most recently stored at that address;
  * loop unrolling is just iteration — every executed arithmetic op appends
    a fresh SSA op to the graph;
  * memory-dependence verification becomes a runtime assertion — parallel
    loop bodies must write disjoint addresses (checked per nest).

Two functional modes (paper §3.1 item 4, "swap evaluation rules"):

  * ``forward=True``   — OpenHLS mode: no load/store ops survive.
  * ``forward=False``  — conventional-HLS baseline mode (models Vitis HLS in
    §4.1): loads/stores stay in the DFG, serialised per-address and bound to
    per-array memory-port resources.
"""

from __future__ import annotations

import itertools
from contextlib import contextmanager
from typing import Iterator, Optional, Sequence, Union

from repro_torch.core.ir import OPCODE_ID, TRACE_CHUNK, Graph

Number = Union[int, float]


class SymVal:
    """A scalar SSA symbol.  Arithmetic builds DFG ops (paper Fig. 3 rules)."""

    __slots__ = ("ctx", "id")

    def __init__(self, ctx: "Context", vid: int):
        self.ctx = ctx
        self.id = vid

    # -- helpers ------------------------------------------------------------

    def _coerce(self, other: Union["SymVal", Number]) -> "SymVal":
        if isinstance(other, SymVal):
            return other
        return self.ctx.const(float(other))

    def _bin(self, opcode: str, other: Union["SymVal", Number]) -> "SymVal":
        o = self._coerce(other)
        return self.ctx._emit(opcode, (self.id, o.id))

    # -- arith.* ------------------------------------------------------------

    def __mul__(self, other):  # arith.mulf
        return self._bin("mulf", other)

    __rmul__ = __mul__

    def __add__(self, other):  # arith.addf
        return self._bin("addf", other)

    __radd__ = __add__

    def __sub__(self, other):  # arith.subf
        return self._bin("subf", other)

    def __rsub__(self, other):
        return self._coerce(other)._bin("subf", self)

    def __truediv__(self, other):  # arith.divf
        return self._bin("divf", other)

    def __rtruediv__(self, other):
        return self._coerce(other)._bin("divf", self)

    def __neg__(self):
        return self.ctx._emit("negf", (self.id,))

    def sqrt(self) -> "SymVal":
        return self.ctx._emit("sqrtf", (self.id,))

    def max(self, other: Union["SymVal", Number]) -> "SymVal":
        return self._bin("maxf", other)

    def min(self, other: Union["SymVal", Number]) -> "SymVal":
        return self._bin("minf", other)

    def cmpugt(self, other: Union["SymVal", Number]) -> "SymVal":
        """arith.cmpf "ugt" — unordered greater-than."""
        return self._bin("cmpugt", other)

    def select(self, if_true: "SymVal", if_false: "SymVal") -> "SymVal":
        """arith.select %self, %if_true, %if_false."""
        return self.ctx._emit(
            "select", (self.id, if_true.id, self.ctx._as_val(if_false).id))

    def __repr__(self) -> str:  # pragma: no cover
        return f"%{self.id}"


class MemRef:
    """Geometric symbol table (paper §3.1 item 3).

    Indexed by concrete integer index tuples; each slot holds the SSA symbol
    most recently stored there.  Loads of input/weight memrefs lazily create
    interface ``input`` symbols; loads of uninitialised temps are a runtime
    memory-dependence error (paper §3.1 item 1).
    """

    __slots__ = ("ctx", "name", "shape", "kind", "table", "_mem_token")

    KINDS = ("input", "weight", "temp", "output")

    def __init__(self, ctx: "Context", name: str, shape: Sequence[int],
                 kind: str):
        assert kind in self.KINDS, kind
        self.ctx = ctx
        self.name = name
        self.shape = tuple(shape)
        self.kind = kind
        self.table: dict[tuple[int, ...], SymVal] = {}
        # per-address last-access token for no-forwarding mode (serialises
        # accesses to the same address — conservative WAR/WAW ordering)
        self._mem_token: dict[tuple[int, ...], int] = {}

    def _norm(self, idx) -> tuple[int, ...]:
        shape = self.shape
        if type(idx) is tuple and len(idx) == len(shape):
            # fast path: plain in-bounds int tuple (the interpreter's own
            # loop indices) — no copy, no per-axis int() coercion
            for x, n in zip(idx, shape):
                if type(x) is not int or x < 0 or x >= n:
                    break
            else:
                return idx
        if not isinstance(idx, tuple):
            idx = (idx,)
        if len(idx) != len(shape):
            raise IndexError(
                f"{self.name}: rank mismatch {idx} vs shape {shape}")
        out = []
        for i, (x, n) in enumerate(zip(idx, shape)):
            x = int(x)
            if not (0 <= x < n):
                raise IndexError(
                    f"{self.name}: index {idx} out of bounds {shape} "
                    f"(axis {i})")
            out.append(x)
        return tuple(out)

    # -- memref.load --------------------------------------------------------

    def __getitem__(self, idx) -> SymVal:
        ctx = self.ctx
        # fast path: a slot that already holds a symbol was bounds-checked
        # when it was created — skip renormalisation
        if type(idx) is tuple:
            try:
                sym = self.table.get(idx)
            except TypeError:       # unhashable element (e.g. 0-d ndarray)
                sym = None
        else:
            sym = None
        if sym is None:
            idx = self._norm(idx)
            sym = self.table.get(idx)
        if sym is None:
            if self.kind in ("input", "weight"):
                # lazily materialise an interface symbol
                vid = ctx.graph.new_value()
                ctx.graph.inputs.setdefault(self.name, {})[idx] = vid
                if self.kind == "weight":
                    ctx.graph.weight_names.add(self.name)
                sym = SymVal(ctx, vid)
                self.table[idx] = sym
            else:
                raise RuntimeError(
                    f"memory-dependence violation: load of uninitialised "
                    f"{self.kind} memref {self.name}{list(idx)} (paper §3.1: "
                    f"runtime dependence assertion)")
        if ctx.forward:
            return sym
        # no-forwarding mode: emit an explicit load, chained on the last
        # access to this address
        prev = self._mem_token.get(idx)
        args = (sym.id,) if prev is None else (sym.id, prev)
        loaded = ctx._emit("load", args, array=self.name)
        self._mem_token[idx] = loaded.id
        return loaded

    # -- memref.store -------------------------------------------------------

    def __setitem__(self, idx, value: Union[SymVal, Number]) -> None:
        # fast path mirrors __getitem__: rewriting a slot that already holds
        # a symbol needs no renormalisation
        try:
            known = type(idx) is tuple and idx in self.table
        except TypeError:           # unhashable element (e.g. 0-d ndarray)
            known = False
        if not known:
            idx = self._norm(idx)
        ctx = self.ctx
        val = ctx._as_val(value)
        ctx._record_write(self, idx)
        if ctx.forward:
            self.table[idx] = val
            return
        prev = self._mem_token.get(idx)
        args = (val.id,) if prev is None else (val.id, prev)
        tok_vid = ctx.graph.new_value()
        ctx._emit("store", args, array=self.name, result=tok_vid)
        self._mem_token[idx] = tok_vid
        # semantics: the stored symbol is what a forwarding load would see,
        # but in no-forward mode the *token* is what later loads read through.
        self.table[idx] = SymVal(ctx, tok_vid)

    def indices(self) -> Iterator[tuple[int, ...]]:
        return itertools.product(*[range(n) for n in self.shape])


class Context:
    """Interpretation context: owns the graph under construction."""

    def __init__(self, forward: bool = True):
        self.graph = Graph()
        self.forward = forward
        self.memrefs: dict[str, MemRef] = {}
        self._const_cache: dict[float, SymVal] = {}
        self._nest_counter = 0
        self._cur_nest = -1
        self._cur_rank = -1
        # (memref name, idx) -> rank of parallel instance that wrote it;
        # reset per parallel nest (disjoint-write assertion)
        self._parallel_writes: Optional[dict[tuple[str, tuple[int, ...]], int]] = None

    # -- values -------------------------------------------------------------

    def const(self, x: float) -> SymVal:
        x = float(x)
        sym = self._const_cache.get(x)
        if sym is None:
            vid = self.graph.add_const(x)
            sym = SymVal(self, vid)
            self._const_cache[x] = sym
        return sym

    def _as_val(self, v: Union[SymVal, Number]) -> SymVal:
        return v if isinstance(v, SymVal) else self.const(float(v))

    def _emit(self, opcode: str, args: tuple[int, ...], *, array: str = "",
              result: Optional[int] = None) -> SymVal:
        # trace-time fast path: append straight into the graph's column
        # buffers (the body of ``Graph.add_op``, inlined — this is the
        # hottest call in symbolic interpretation)
        g = self.graph
        if g._lists is None:
            g._mutable_lists()
        o, a0, a1, a2, r, ne, rk, ai = g._lists
        if result is None:
            if opcode in ("store", "output"):   # same default as Graph.add_op
                result = -1
            else:
                result = g.n_values
                g.n_values = result + 1
        n = len(args)
        o.append(OPCODE_ID[opcode])
        a0.append(args[0] if n > 0 else -1)
        a1.append(args[1] if n > 1 else -1)
        a2.append(args[2] if n > 2 else -1)
        r.append(result)
        ne.append(self._cur_nest)
        rk.append(self._cur_rank)
        ai.append(g.intern_array(array) if array else 0)
        g._n_ops += 1
        g._cols = None
        if len(o) >= TRACE_CHUNK:
            g._flush_chunk()
        return SymVal(self, result)

    # -- memrefs ------------------------------------------------------------

    def memref(self, name: str, shape: Sequence[int], kind: str) -> MemRef:
        if name in self.memrefs:
            raise ValueError(f"duplicate memref {name}")
        m = MemRef(self, name, shape, kind)
        self.memrefs[name] = m
        return m

    def temp(self, name: str, shape: Sequence[int]) -> MemRef:
        return self.memref(name, shape, "temp")

    # -- loop nests ---------------------------------------------------------

    def parallel(self, *dims: int, label: str = "") -> Iterator[tuple[int, ...]]:
        """scf.parallel loop nest: iterate the cartesian product of ``dims``.

        Each yielded instance gets a linear resource rank (the paper's
        ordering "according to their execution order during symbolic
        interpretation", §3.3).  On exit, asserts that distinct instances
        wrote disjoint addresses — the behavioural stand-in for static
        dependence analysis.
        """
        nest = self._nest_counter
        self._nest_counter += 1
        k_i = 1
        for d in dims:
            k_i *= int(d)
        self.graph.nest_parallel_space[nest] = k_i
        self.graph.nest_labels[nest] = label or f"parallel_{nest}"
        outer_nest, outer_rank = self._cur_nest, self._cur_rank
        outer_writes = self._parallel_writes
        self._parallel_writes = {}
        self._cur_nest = nest
        try:
            for rank, idx in enumerate(
                    itertools.product(*[range(int(d)) for d in dims])):
                self._cur_rank = rank
                yield idx
        finally:
            self._cur_nest, self._cur_rank = outer_nest, outer_rank
            self._parallel_writes = outer_writes

    @contextmanager
    def sequential(self, label: str = ""):
        """A sequential (scf.for-only) nest — e.g. a global reduction."""
        nest = self._nest_counter
        self._nest_counter += 1
        self.graph.nest_parallel_space[nest] = 1
        self.graph.nest_labels[nest] = label or f"seq_{nest}"
        outer_nest, outer_rank = self._cur_nest, self._cur_rank
        self._cur_nest, self._cur_rank = nest, -1
        try:
            yield
        finally:
            self._cur_nest, self._cur_rank = outer_nest, outer_rank

    def _record_write(self, mem: MemRef, idx: tuple[int, ...]) -> None:
        if self._parallel_writes is None or self._cur_rank < 0:
            return
        key = (mem.name, idx)
        prev = self._parallel_writes.get(key)
        if prev is not None and prev != self._cur_rank:
            raise RuntimeError(
                f"memory-dependence violation: parallel instances {prev} and "
                f"{self._cur_rank} both write {mem.name}{list(idx)} "
                f"(scf.parallel write sets must be disjoint)")
        self._parallel_writes[key] = self._cur_rank

    # -- transcendentals (paper §3: Taylor expansion) -------------------------

    def exp(self, x: SymVal, order: int = 6) -> SymVal:
        """exp(x) via k-th order Taylor series (paper §3).

        Powers are computed by binary decomposition (x^k as a product of
        x^(2^j) factors, CSE-shared across terms) so the series has O(log k)
        depth, and the term summation is a sequential chain the
        reduction-tree pass later balances.
        """
        # x^(2^j) ladder
        pow2: list[SymVal] = [x]
        j = 1
        while (1 << j) <= order:
            pow2.append(pow2[-1] * pow2[-1])
            j += 1

        def power(k: int) -> SymVal:
            factors = [pow2[j] for j in range(len(pow2)) if k & (1 << j)]
            acc = factors[0]
            for f in factors[1:]:
                acc = acc * f
            return acc

        terms: list[SymVal] = [self.const(1.0), x]
        fact = 1.0
        for k in range(2, order + 1):
            fact *= k
            terms.append(power(k) * self.const(1.0 / fact))
        acc = terms[0]
        for t in terms[1:]:
            acc = acc + t
        return acc

    def relu(self, x: SymVal) -> SymVal:
        """Emit relu the way scf lowering produces it: cmpf ugt + select.

        The AST pass ``relu_recompose`` (paper §3.2 item 2) later coalesces
        this pair back into a single combinational ``relu`` op.
        """
        zero = self.const(0.0)
        cond = x.cmpugt(zero)
        return cond.select(x, zero)

    # -- finalisation ---------------------------------------------------------

    def finalize(self) -> Graph:
        """Freeze the graph: collect output interfaces and validate SSA."""
        for m in self.memrefs.values():
            if m.kind != "output":
                continue
            table = self.graph.outputs.setdefault(m.name, {})
            for idx in m.indices():
                sym = m.table.get(idx)
                if sym is None:
                    raise RuntimeError(
                        f"output memref {m.name}{list(idx)} never written")
                table[idx] = sym.id
        self.graph.topo_check()
        return self.graph
