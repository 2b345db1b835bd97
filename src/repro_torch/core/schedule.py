"""Resource-constrained list scheduling (paper §3.3).

The paper's observation: in the resource-unconstrained case the scheduling
ILP's constraint matrix is totally unimodular, so an LP (equivalently, a
longest-path/ASAP computation) solves it optimally; resource constraints are
folded in as *precedence* constraints by fixing a linear order on the
operations bound to each resource.  OpenHLS derives resource capacity from
the explicit parallelism of scf.parallel nests:  K_i = |parallel iteration
space of nest i| functional units serve nest i, and K = max_i K_i units of
each class exist in the design.

Two binding disciplines are implemented:

  * ``binding="pool"``  (default, OpenHLS mode) — per-class pools of K units;
    each op in program order grabs the earliest-free unit.  Equivalent to
    list scheduling with the paper's capacity bound, and the discipline that
    reproduces the paper's interval counts.
  * ``binding="rank"``  — static binding of parallel instance ``rank`` to
    unit ``rank mod lanes``; this is the stricter literal reading of the
    linear-order construction and also serves, with small ``unroll_factor``,
    as the conventional-HLS (Vitis) baseline model of §4.1.

A final ALAP compaction retimes ops as late as their consumers and unit
successors allow (paper: ALAP "amongst the subtrees" of reduction trees),
which shortens register lifetimes — the FF-usage analogue.

Terminology mirrors the paper's evaluation: the *interval count* is the
makespan in clock cycles; end-to-end latency = interval count x achieved
clock period (10 ns target).

Implementation: the scheduler consumes the IR's struct-of-arrays columns.
Everything around the ASAP resource-serialisation core is an array program:
ALAP compaction runs as a reverse-Kahn *wave* relaxation (each dependency
wave retimes vectorised; ``latest`` updates are commuting minima), stage
partitioning is a numpy-batched DP with an incremental suffix-max cost
matrix, and nest spans / peak-live / unit counts are bulk reductions.  The
ASAP core itself is inherently order-serial — each op's issue slot depends
on every earlier allocation in its pool, and wave-batching it measurably
collapses to ~1 op per wave on rank-major traces (each parallel instance's
reduction chain is contiguous in program order) — so it runs as a compiled
C kernel (``_asap.c`` via :mod:`repro_torch.core.cext`, built lazily with the
system compiler) that is a literal port of the pure-Python reference loop
``_asap_scalar``, which remains the fallback and the rank-binding path;
both produce bit-identical schedules.
"""

from __future__ import annotations

import dataclasses
import heapq
import os
from typing import Optional

import numpy as np

from repro_torch.core import cext
from repro_torch.core.ir import (CLASS_TABLE, PORT_CLASS_ID, RESOURCE_CLASSES,
                           Graph, delay_table)

CLOCK_NS = 10.0  # paper §4: all designs synthesised for a 10 ns target clock

_EMPTY_I64 = np.empty(0, dtype=np.int64)

#: ALAP wave vectorisation bails to the scalar sweep when some unit's
#: program-order chain exceeds this many ops (wave count is bounded below
#: by the longest chain, so degenerate bindings — e.g. unroll_factor=4 on a
#: 100k-op graph — would decay into thousands of tiny waves).
_ALAP_WAVE_MAX_CHAIN = 2048


@dataclasses.dataclass(frozen=True)
class ScheduleParams:
    """The schedule-shaping knobs, bundled as one first-class value.

    These are exactly the parameters a design-space explorer mutates
    (``repro_torch.tune``): ``unroll_factor`` caps per-class unit capacity,
    ``n_stages`` is the pipeline-partition (tile) factor consumed by
    ``partition_stages``, and the remaining fields select the binding
    discipline and compaction.  ``list_schedule(g, params=...)`` accepts
    the bundle directly; ``n_stages`` is carried for the stage-partition
    step that follows scheduling.
    """

    binding: str = "pool"
    unroll_factor: Optional[int] = None
    ports_per_array: int = 2
    pipelined_units: bool = False
    alap_compact: bool = True
    n_stages: int = 1


@dataclasses.dataclass
class Schedule:
    """A fully scheduled design."""

    start: list[int]                      # per-op start cycle
    makespan: int                         # interval count
    resource_units: dict[str, int]        # units instantiated per class
    nest_spans: dict[int, tuple[int, int]]  # nest -> (min start, max end)
    peak_live: int                        # peak # of live values (FF analogue)
    n_ops: int

    @property
    def latency_us(self) -> float:
        return self.makespan * CLOCK_NS * 1e-3

    def resources(self) -> dict[str, int]:
        """FPGA-resource analogues (paper Fig. 4 bars).

        DSP  <- mul/add/mac/div/sqrt units
        LUT  <- cmp/select/relu units (combinational logic)
        FF   <- peak live values (registered symbols)
        BRAM <- arrays with surviving load/store traffic (0 in forwarding
                mode — the paper's headline resource result)
        """
        dsp = sum(n for c, n in self.resource_units.items()
                  if c in ("mul", "add", "mac", "div", "sqrt"))
        lut = sum(n for c, n in self.resource_units.items() if c == "cmp")
        bram = sum(n for c, n in self.resource_units.items() if c == "port")
        return {"DSP": dsp, "LUT_units": lut, "FF": self.peak_live,
                "BRAM_ports": bram}


class _UnitPool:
    """Earliest-free-unit allocator with lazy instantiation up to capacity."""

    __slots__ = ("capacity", "heap", "allocated")

    def __init__(self, capacity: int):
        self.capacity = max(1, capacity)
        self.heap: list[tuple[int, int]] = []  # (free_time, unit_id)
        self.allocated = 0

    def acquire(self, t_ready: int, occupancy: int) -> tuple[int, int]:
        """Returns (start_time, unit_id)."""
        if self.heap and self.heap[0][0] <= t_ready:
            _, uid = heapq.heappop(self.heap)
            start = t_ready
        elif self.allocated < self.capacity:
            uid = self.allocated
            self.allocated += 1
            start = t_ready
        else:
            free, uid = heapq.heappop(self.heap)
            start = max(free, t_ready)
        heapq.heappush(self.heap, (start + occupancy, uid))
        return start, uid


def list_schedule(
    g: Graph,
    *,
    params: Optional[ScheduleParams] = None,
    binding: str = "pool",
    unroll_factor: Optional[int] = None,
    ports_per_array: int = 2,
    pipelined_units: bool = False,
    delays: Optional[dict[str, int]] = None,
    alap_compact: bool = True,
) -> Schedule:
    """Schedule ``g``.

    params:
        a ``ScheduleParams`` bundle; when given it overrides the individual
        keyword knobs (``n_stages`` is ignored here — it parameterises the
        ``partition_stages`` step that follows).
    binding:
        "pool" — OpenHLS mode (per-class capacity K = max_i K_i, or
        ``unroll_factor`` when given).
        "rank" — static rank binding (paper's literal linear-order form).
    unroll_factor:
        caps per-class capacity (models a k-fold unrolled conventional-HLS
        design, paper §4.1); ``None`` = the design's own K.
    ports_per_array:
        memory ports per array for surviving load/store ops (baseline mode).
    pipelined_units:
        if True, units have initiation interval 1 (FloPoCo cores are fully
        pipelined); if False, a unit is busy for the op's full delay —
        matching the paper's precedence-constraint transformation
        (start_a + delay_a <= start_b, footnote 2).
    """
    if params is not None:
        binding = params.binding
        unroll_factor = params.unroll_factor
        ports_per_array = params.ports_per_array
        pipelined_units = params.pipelined_units
        alap_compact = params.alap_compact
    assert binding in ("pool", "rank"), binding

    c = g.cols()
    n = c.n
    if n == 0:
        return Schedule(start=[], makespan=0, resource_units={},
                        nest_spans={}, peak_live=0, n_ops=0)

    dtab = delay_table(delays)
    delay_arr = dtab[c.opcode]                       # int64[n]
    occ_arr = (np.ones(n, dtype=np.int64) if pipelined_units
               else np.maximum(delay_arr, 1))
    cls_arr = CLASS_TABLE[c.opcode]                  # 0 = unconstrained

    # resource keys are packed ints: (class axis) * STRIDE + unit.  The
    # class axis separates per-class pools, per-array port pools, and
    # rank-mode lanes so no two pools ever share a key.
    STRIDE = n + max(g.n_values, 1) + 2
    lane_arr = None
    if binding == "rank":
        nest_u, nest_inv = np.unique(c.nest, return_inverse=True)
        k_i = np.array([g.nest_parallel_space.get(int(t), 1) for t in nest_u],
                       dtype=np.int64)
        lanes = k_i[nest_inv]
        if unroll_factor is not None:
            lanes = np.maximum(1, np.minimum(unroll_factor, lanes))
        lane_arr = (np.where(c.rank >= 0, c.rank, 0) % lanes).tolist()

    K = g.K() if unroll_factor is None else max(1, unroll_factor)
    K = max(1, K)
    ports_cap = max(1, ports_per_array)

    rank_units: set[int] = set()
    out = None
    if binding == "pool" and os.environ.get("REPRO_TORCH_SCHED_SCALAR", "") != "1":
        out = _asap_c(g, c, delay_arr, occ_arr, cls_arr, K, ports_cap,
                      STRIDE)
    if out is not None:
        start_arr, key_arr, pool_alloc, port_alloc = out
    else:
        start_l, key_l, pool_alloc, port_alloc, rank_units = _asap_scalar(
            g, c, delay_arr, occ_arr, cls_arr, lane_arr,
            binding == "pool", K, ports_cap, STRIDE)
        start_arr = np.asarray(start_l, dtype=np.int64)
        key_arr = np.asarray(key_l, dtype=np.int64)

    makespan = int((start_arr + delay_arr).max())

    if alap_compact:
        start_arr = _alap_compact(g, c, start_arr, makespan,
                                  delay_arr, occ_arr, key_arr)

    # ---- vectorised post-processing ---------------------------------------
    ends = start_arr + delay_arr
    nest_u, nest_inv = np.unique(c.nest, return_inverse=True)
    lo = np.full(len(nest_u), np.iinfo(np.int64).max, dtype=np.int64)
    hi = np.full(len(nest_u), np.iinfo(np.int64).min, dtype=np.int64)
    np.minimum.at(lo, nest_inv, start_arr)
    np.maximum.at(hi, nest_inv, ends)
    nest_spans = {int(t): (int(a), int(b))
                  for t, a, b in zip(nest_u, lo, hi)}

    peak_live = _peak_live_values(c, start_arr, delay_arr, makespan,
                                  g.n_values)

    units: dict[str, int] = {}
    if port_alloc:
        units["port"] = sum(port_alloc.values())
    if binding == "pool":
        for cls, alloc in pool_alloc.items():
            units[RESOURCE_CLASSES[cls]] = alloc
    elif rank_units:
        per_cls = np.bincount(
            np.asarray(sorted(rank_units), dtype=np.int64) // STRIDE,
            minlength=len(RESOURCE_CLASSES))
        for cls in range(1, len(RESOURCE_CLASSES)):
            if per_cls[cls]:
                units[RESOURCE_CLASSES[cls]] = int(per_cls[cls])
    return Schedule(start=[int(t) for t in start_arr], makespan=makespan,
                    resource_units=units, nest_spans=nest_spans,
                    peak_live=peak_live, n_ops=n)


def _asap_scalar(g: Graph, c, delay_arr, occ_arr, cls_arr, lane_arr,
                 pool_mode: bool, K: int, ports_cap: int, STRIDE: int):
    """The historical one-op-at-a-time ASAP core over primitive lists.

    Still the implementation for ``binding="rank"`` (static lane binding has
    no pool state worth batching) and the reference for the wave-batched
    core (``REPRO_TORCH_SCHED_SCALAR=1`` forces it; the golden and property suites
    compare the two).
    """
    n = c.n
    a0l = c.args[:, 0].tolist()
    a1l = c.args[:, 1].tolist()
    a2l = c.args[:, 2].tolist()
    resl = c.result.tolist()
    dl = delay_arr.tolist()
    ol = occ_arr.tolist()
    cl = cls_arr.tolist()
    arrl = c.array_id.tolist()

    ready = [0] * max(g.n_values, 1)
    start = [0] * n
    key_l = [-1] * n                 # packed resource key per op (-1 = none)
    # Pool state, inlined for the hot loop.  Heap entries pack
    # (free_time, unit_id) into one int — free_time * capacity + uid orders
    # exactly like the historical tuple (free ascending, unit id tie-break)
    # but compares at machine-int speed instead of tuple speed.
    pool_heap: dict[int, list[int]] = {}   # class id -> packed heap
    pool_alloc: dict[int, int] = {}        # class id -> units instantiated
    port_heap: dict[int, list[int]] = {}   # array id -> packed heap
    port_alloc: dict[int, int] = {}
    unit_free: dict[int, int] = {}         # packed key -> free time (rank)
    rank_units: set[int] = set()           # packed keys seen in rank mode
    n_classes = len(RESOURCE_CLASSES)
    heappush = heapq.heappush
    heappop = heapq.heappop

    for i in range(n):
        t = 0
        a = a0l[i]
        if a >= 0:
            ta = ready[a]
            if ta > t:
                t = ta
            a = a1l[i]
            if a >= 0:
                ta = ready[a]
                if ta > t:
                    t = ta
                a = a2l[i]
                if a >= 0:
                    ta = ready[a]
                    if ta > t:
                        t = ta
        cls = cl[i]
        if cls:
            if cls == PORT_CLASS_ID:
                aid = arrl[i]
                heap = port_heap.get(aid)
                if heap is None:
                    heap = port_heap[aid] = []
                    port_alloc[aid] = 0
                cap = ports_cap
                alloc_map, pool_id = port_alloc, aid
                key_base = (n_classes + aid) * STRIDE
            elif pool_mode:
                heap = pool_heap.get(cls)
                if heap is None:
                    heap = pool_heap[cls] = []
                    pool_alloc[cls] = 0
                cap = K
                alloc_map, pool_id = pool_alloc, cls
                key_base = cls * STRIDE
            else:
                key = cls * STRIDE + lane_arr[i]
                tf = unit_free.get(key, 0)
                if tf > t:
                    t = tf
                unit_free[key] = t + ol[i]
                key_l[i] = key
                rank_units.add(key)
                start[i] = t
                r = resl[i]
                if r >= 0:
                    ready[r] = t + dl[i]
                continue
            # earliest-free-unit acquire (packed-int heap)
            if heap and heap[0] <= t * cap + cap - 1:
                packed = heappop(heap)
                uid = packed % cap
            else:
                alloc = alloc_map[pool_id]
                if alloc < cap:
                    uid = alloc
                    alloc_map[pool_id] = alloc + 1
                else:
                    packed = heappop(heap)
                    free = packed // cap
                    uid = packed % cap
                    if free > t:
                        t = free
            heappush(heap, (t + ol[i]) * cap + uid)
            key_l[i] = key_base + uid
        start[i] = t
        r = resl[i]
        if r >= 0:
            ready[r] = t + dl[i]

    return start, key_l, pool_alloc, port_alloc, rank_units


def _asap_c(g: Graph, c, delay_arr, occ_arr, cls_arr,
            K: int, ports_cap: int, STRIDE: int):
    """Run the ASAP core through the compiled kernel (pool binding only).

    Returns ``(start, key, pool_alloc, port_alloc)`` or ``None`` when the
    kernel is unavailable — callers then take the pure-Python loop.  The C
    source is a literal port of ``_asap_scalar``; bit-identity is covered
    by the golden suite (and ``REPRO_TORCH_SCHED_SCALAR=1`` A/Bs the two).
    """
    lib = cext.asap_pool_lib()
    if lib is None:
        return None
    import ctypes
    n = c.n
    nv = max(g.n_values, 1)
    n_classes = len(RESOURCE_CLASSES)

    def _i64(a):
        return np.ascontiguousarray(a, dtype=np.int64)

    a0 = _i64(c.args[:, 0])
    a1 = _i64(c.args[:, 1])
    a2 = _i64(c.args[:, 2])
    res = _i64(c.result)
    dl = _i64(delay_arr)
    ol = _i64(occ_arr)
    cl = _i64(cls_arr)
    aid = _i64(c.array_id)
    is_port = cls_arr == PORT_CLASS_ID
    n_arrays = int(aid[is_port].max()) + 1 if is_port.any() else 0

    start = np.zeros(n, dtype=np.int64)
    key = np.full(n, -1, dtype=np.int64)
    ready = np.zeros(nv, dtype=np.int64)
    class_alloc = np.zeros(n_classes, dtype=np.int64)
    port_alloc = np.zeros(max(n_arrays, 1), dtype=np.int64)

    p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.asap_pool(
        n, nv,
        a0.ctypes.data_as(p), a1.ctypes.data_as(p), a2.ctypes.data_as(p),
        res.ctypes.data_as(p), dl.ctypes.data_as(p), ol.ctypes.data_as(p),
        cl.ctypes.data_as(p), aid.ctypes.data_as(p),
        n_classes, K, ports_cap, STRIDE, n_arrays, PORT_CLASS_ID,
        start.ctypes.data_as(p), key.ctypes.data_as(p),
        ready.ctypes.data_as(p),
        class_alloc.ctypes.data_as(p), port_alloc.ctypes.data_as(p))
    if rc != 0:
        return None
    pool_alloc = {i: int(a) for i, a in enumerate(class_alloc) if a}
    port_alloc_d = {i: int(a)
                    for i, a in enumerate(port_alloc[:n_arrays]) if a}
    return start, key, pool_alloc, port_alloc_d


def _alap_compact(g: Graph, c, start_arr: np.ndarray, makespan: int,
                  delay_arr: np.ndarray, occ_arr: np.ndarray,
                  key_arr: np.ndarray) -> np.ndarray:
    """Retime ops as late as possible without growing the makespan.

    Implements the paper's ALAP scheduling "amongst the subtrees" of
    reduction trees — applied to every op, which subsumes it.  Safety: an op
    keeps its unit assignment and may not move past the next op scheduled on
    the same unit, so the forward schedule's resource feasibility and
    program order per unit are preserved.

    The sweep is a reverse-Kahn wave relaxation: an op's slack is final once
    every consumer of its result and its same-unit successor are retimed, so
    each wave retimes all such ops vectorised (``latest`` updates commute —
    they are minima).  When some unit's program-order chain is longer than
    ``_ALAP_WAVE_MAX_CHAIN`` (which lower-bounds the wave count) the scalar
    reverse sweep runs instead; both orders compute the same fixpoint.
    """
    n = len(start_arr)
    order = np.argsort(key_arr, kind="stable")
    next_same = np.full(n, -1, dtype=np.int64)
    if n > 1:
        same = key_arr[order[:-1]] == key_arr[order[1:]]
        same &= key_arr[order[:-1]] >= 0
        next_same[order[:-1][same]] = order[1:][same]

    keyed = key_arr[key_arr >= 0]
    max_chain = 0
    if keyed.size:
        _, counts = np.unique(keyed, return_counts=True)
        max_chain = int(counts.max())
    if max_chain > _ALAP_WAVE_MAX_CHAIN:
        return _alap_scalar(g, c, start_arr, makespan, delay_arr, occ_arr,
                            next_same)

    nv = max(g.n_values, 1)
    args64 = c.args.astype(np.int64)
    resv = c.result.astype(np.int64)
    prod = np.full(nv, -1, dtype=np.int64)
    has_r = resv >= 0
    prod[resv[has_r]] = np.flatnonzero(has_r)
    # producer op per arg slot (-1 where the arg is absent or an input)
    pa = prod[np.where(args64 >= 0, args64, 0)]
    pa[args64 < 0] = -1

    flat_pa = pa[pa >= 0]
    cnt = (np.bincount(flat_pa, minlength=n) if flat_pa.size
           else np.zeros(n, dtype=np.int64))
    cnt += (next_same >= 0).astype(np.int64)
    prev_same = np.full(n, -1, dtype=np.int64)
    has_nx = next_same >= 0
    prev_same[next_same[has_nx]] = np.flatnonzero(has_nx)

    new_start = start_arr.copy()
    latest = np.full(nv, makespan, dtype=np.int64)
    F = np.flatnonzero(cnt == 0)
    remaining = n
    while remaining:
        assert F.size, "ALAP wave made no progress"
        d = delay_arr[F]
        limit = makespan - d
        r = resv[F]
        mr = r >= 0
        lr = np.where(mr, latest[np.where(mr, r, 0)], 0) - d
        limit = np.where(mr, np.minimum(limit, lr), limit)
        nx = next_same[F]
        mn = nx >= 0
        l2 = np.where(mn, new_start[np.where(mn, nx, 0)], 0) - occ_arr[F]
        limit = np.where(mn, np.minimum(limit, l2), limit)
        t = np.maximum(new_start[F], limit)
        new_start[F] = t
        av = args64[F]
        am = av >= 0
        if am.any():
            np.minimum.at(latest, av[am],
                          np.broadcast_to(t[:, None], av.shape)[am])
        paf = pa[F]
        touched_p = paf[paf >= 0]
        ps = prev_same[F]
        touched = np.concatenate((touched_p, ps[ps >= 0]))
        remaining -= len(F)
        if touched.size:
            np.subtract.at(cnt, touched, 1)
            u = np.unique(touched)
            F = u[cnt[u] == 0]
        else:
            F = _EMPTY_I64
    return new_start


def _alap_scalar(g: Graph, c, start_arr, makespan: int, delay_arr, occ_arr,
                 next_same: np.ndarray) -> np.ndarray:
    """Reference reverse sweep over primitive lists (exact, order n-1..0)."""
    n = len(start_arr)
    a0l = c.args[:, 0].tolist()
    a1l = c.args[:, 1].tolist()
    a2l = c.args[:, 2].tolist()
    resl = c.result.tolist()
    dl = delay_arr.tolist()
    ol = occ_arr.tolist()
    nsl = next_same.tolist()
    new_start = start_arr.tolist()
    latest = [makespan] * max(g.n_values, 1)
    for i in range(n - 1, -1, -1):
        d = dl[i]
        limit = makespan - d
        r = resl[i]
        if r >= 0:
            lr = latest[r] - d
            if lr < limit:
                limit = lr
        nx = nsl[i]
        if nx >= 0:
            lim2 = new_start[nx] - ol[i]
            if lim2 < limit:
                limit = lim2
        t = new_start[i]
        if limit > t:
            t = limit
        new_start[i] = t
        a = a0l[i]
        if a >= 0:
            if t < latest[a]:
                latest[a] = t
            a = a1l[i]
            if a >= 0:
                if t < latest[a]:
                    latest[a] = t
                a = a2l[i]
                if a >= 0 and t < latest[a]:
                    latest[a] = t
    return np.asarray(new_start, dtype=np.int64)


def _peak_live_values(c, start_arr: np.ndarray, delay_arr: np.ndarray,
                      makespan: int, n_values: int) -> int:
    """Peak number of simultaneously live values — the FF-usage analogue."""
    if n_values == 0:
        return 0
    born = np.full(n_values, -1, dtype=np.int64)
    has_res = c.result >= 0
    born[c.result[has_res]] = (start_arr + delay_arr)[has_res]
    last_use = np.full(n_values, -1, dtype=np.int64)
    am = c.args >= 0
    flat_args = c.args[am].astype(np.int64)
    flat_t = np.broadcast_to(start_arr[:, None], c.args.shape)[am]
    np.maximum.at(last_use, flat_args, flat_t)
    mask = (born >= 0) & (last_use >= born)
    if not mask.any():
        return 0
    b = born[mask]
    e = last_use[mask] + 1
    hist = np.zeros(makespan + 2, dtype=np.int64)
    np.add.at(hist, b, 1)
    np.add.at(hist, e, -1)
    return int(np.cumsum(hist).max())


def partition_stages(g: Graph, sched: Schedule, n_stages: int
                     ) -> tuple[list[list[int]], int]:
    """Partition nests (in program order) into pipeline stages.

    Returns (stages as lists of nest ids, initiation interval = longest
    stage span).  This reproduces the paper's BraggNN deployment: a 3-stage
    pipeline whose throughput is set by the longest stage (480 intervals in
    the paper).  DP over contiguous partitions minimising the max stage span.

    The recurrence dp[s][j] = min_i max(dp[s-1][i], cost(i, j-1)) runs
    numpy-batched over ``i``: nests are sorted by span start, so
    cost(i, j-1) = max(E[i..j-1]) - S[i], and the max term is maintained as
    an incremental suffix-max as ``j`` grows — no per-pair recomputation.
    ``np.argmin``'s first-occurrence tie-break matches the scalar
    strict-less-than first minimiser (``_partition_stages_scalar``, kept as
    the property-test reference).
    """
    nests = sorted(sched.nest_spans, key=lambda t: sched.nest_spans[t][0])
    if not nests:
        return [[]], 0
    S = np.array([sched.nest_spans[t][0] for t in nests], dtype=np.int64)
    E = np.array([sched.nest_spans[t][1] for t in nests], dtype=np.int64)
    m = len(nests)
    n_stages = min(n_stages, m)

    INF = np.iinfo(np.int64).max // 4
    dp_prev = np.full(m + 1, INF, dtype=np.int64)
    dp_prev[0] = 0
    cut = np.zeros((n_stages + 1, m + 1), dtype=np.int64)
    for s in range(1, n_stages + 1):
        dp_cur = np.full(m + 1, INF, dtype=np.int64)
        gmax = np.full(m, np.iinfo(np.int64).min, dtype=np.int64)
        first = s - 1
        for j in range(1, m + 1):
            np.maximum(gmax[:j], E[j - 1], out=gmax[:j])
            if j <= first:
                continue
            cand = np.maximum(dp_prev[first:j], gmax[first:j] - S[first:j])
            k = int(np.argmin(cand))
            dp_cur[j] = cand[k]
            cut[s, j] = first + k
        dp_prev = dp_cur

    stages: list[list[int]] = []
    j = m
    for s in range(n_stages, 0, -1):
        i = int(cut[s, j])
        stages.append(nests[i:j])
        j = i
    stages.reverse()
    ii = int(dp_prev[m])
    return stages, ii


def _partition_stages_scalar(g: Graph, sched: Schedule, n_stages: int
                             ) -> tuple[list[list[int]], int]:
    """The historical O(nests^2 * stages) Python DP — reference for the
    vectorised ``partition_stages`` (property-tested equal)."""
    nests = sorted(sched.nest_spans, key=lambda t: sched.nest_spans[t][0])
    if not nests:
        return [[]], 0
    spans = [sched.nest_spans[t] for t in nests]
    m = len(nests)
    n_stages = min(n_stages, m)

    def stage_cost(i: int, j: int) -> int:  # nests i..j inclusive
        lo = min(s for s, _ in spans[i:j + 1])
        hi = max(e for _, e in spans[i:j + 1])
        return hi - lo

    INF = float("inf")
    dp = [[INF] * (m + 1) for _ in range(n_stages + 1)]
    cut = [[0] * (m + 1) for _ in range(n_stages + 1)]
    dp[0][0] = 0
    for s in range(1, n_stages + 1):
        for j in range(1, m + 1):
            for i in range(s - 1, j):
                c = max(dp[s - 1][i], stage_cost(i, j - 1))
                if c < dp[s][j]:
                    dp[s][j] = c
                    cut[s][j] = i
    stages: list[list[int]] = []
    j = m
    for s in range(n_stages, 0, -1):
        i = cut[s][j]
        stages.append(nests[i:j])
        j = i
    stages.reverse()
    ii = int(dp[n_stages][m])
    return stages, ii
