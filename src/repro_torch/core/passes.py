"""Graph transformations (paper §3.2 "AST transformations and verification").

All passes are *behaviourally* verified (see ``repro_torch.core.verify``) rather
than formally proven — the paper's explicit trade of formal correctness for
development-time performance.  Each pass is a linear rewrite over the op
table, preserving program order (and therefore topological validity and the
resource serialisation order of §3.3).

Pass inventory, mapped to the paper:
  * ``hoist_globals``    — structural in this implementation: weights are
                           declared as interface memrefs by the frontend, and
                           this pass *verifies* no weight-like constant tensor
                           remains inline.
  * ``relu_recompose``   — cmpf ugt + select  ->  relu        (§3.2 item 2)
  * ``reduction_tree``   — sequential add/max chains -> balanced trees,
                           scheduled ALAP among subtrees      (§3.2 item 4, §3.3)
  * ``fmac_coalesce``    — mul feeding a single add -> fmac   (§3.2 item 3)
  * ``cse`` / ``dce``    — standard cleanups enabled by SSA recovery.

Implementation notes
--------------------
The passes here are the *vectorised* struct-of-arrays implementations: each
consumes ``Graph.cols()`` (dense int32 columns), computes its rewrite with
numpy array operations — row hashing for CSE, a frontier liveness sweep for
DCE, pattern masks for relu/fmac, array chain-walking for reduction trees —
and builds its output in one shot with ``Graph.from_columns``.

Two contracts the incremental ``PassManager`` fixpoint relies on:

  * a pass that has nothing to rewrite returns its input ``Graph`` object
    *unchanged* (identity comparison = cheap "did anything happen");
  * a pass that does rewrite annotates the result with ``_touched`` — the
    frozenset of opcode names whose rows were added, removed, or had
    operands remapped — which drives the per-pass dirty bits.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.ir import (ARITH_MASK, ARITH_OPS, ID_ADDF, ID_CMPUGT,
                           ID_MAXF, ID_MINF, ID_MULF, ID_RELU, ID_SELECT,
                           ID_STORE, OPCODE_ID, OPCODES, Graph)

#: Opcodes whose operand order does not matter for CSE.
COMMUTATIVE_OPS = frozenset({"mulf", "addf", "maxf", "minf"})
_COMMUT_MASK = np.array([name in COMMUTATIVE_OPS for name in OPCODES],
                        dtype=bool)


def _opcode_names(opcode_rows: np.ndarray) -> frozenset:
    return frozenset(OPCODES[i] for i in np.unique(opcode_rows))


# ---------------------------------------------------------------------------
# dce
# ---------------------------------------------------------------------------


def _dce_impl(g: Graph) -> tuple[Graph, frozenset]:
    c = g.cols()
    n = c.n
    if n == 0:
        return g, frozenset()
    keep = c.opcode == ID_STORE
    live = np.zeros(max(g.n_values, 1), dtype=bool)
    seeds = []
    out_vals = g.output_values()
    if out_vals:
        seeds.append(np.asarray(out_vals, dtype=np.int64))
    if keep.any():
        sa = c.args[keep]
        seeds.append(sa[sa >= 0].astype(np.int64))
    frontier = (np.unique(np.concatenate(seeds)) if seeds
                else np.empty(0, dtype=np.int64))
    live[frontier] = True
    prod = c.producer
    # frontier liveness sweep: each round marks the producers of newly-live
    # values and enqueues their operands — linear total work (each op joins
    # the frontier at most once), O(DAG depth) numpy rounds
    while frontier.size:
        p = prod[frontier]
        p = p[p >= 0]
        p = p[~keep[p]]
        if p.size == 0:
            break
        keep[p] = True
        na = c.args[p]
        na = na[na >= 0]
        na = na[~live[na]]
        frontier = np.unique(na)
        live[frontier] = True
    if keep.all():
        return g, frozenset()
    touched = _opcode_names(c.opcode[~keep])
    idx = np.flatnonzero(keep)
    g2 = Graph.from_columns(g, c.opcode[idx], c.args[idx], c.result[idx],
                            c.nest[idx], c.rank[idx], c.array_id[idx])
    return g2, touched


def dce(g: Graph) -> Graph:
    """Dead-code elimination backwards from graph outputs.

    ``store`` ops are always considered live (baseline no-forwarding mode
    models a tool that cannot eliminate memory traffic).
    """
    out, touched = _dce_impl(g)
    if out is not g:
        out._touched = touched
        out.topo_check()   # SSA validation of the rewritten graph
    return out


# ---------------------------------------------------------------------------
# cse
# ---------------------------------------------------------------------------


def _cse_impl(g: Graph) -> tuple[Graph, frozenset]:
    c = g.cols()
    n = c.n
    arith_rows = ARITH_MASK[c.opcode] if n else np.zeros(0, dtype=bool)
    if not arith_rows.any():
        return g, frozenset()
    opc64 = c.opcode.astype(np.int64)
    commut = _COMMUT_MASK[c.opcode]
    args = c.args.astype(np.int64)
    res = c.result.astype(np.int64)
    repl = np.arange(g.n_values, dtype=np.int64)
    is_dup = np.zeros(n, dtype=bool)
    # Value-numbering to a fixpoint: each round canonicalises operands
    # through the replacement map, hashes the rows, and marks every row
    # whose (opcode, canonical args) key was first produced by an earlier
    # row.  Later rounds catch duplicates that only become apparent once
    # their operands were themselves deduplicated — the same closure the
    # sequential first-wins scan computed one op at a time.
    while True:
        rows = np.flatnonzero(arith_rows & ~is_dup)
        a = args[rows]
        m = np.where(a >= 0, repl[np.clip(a, 0, None)], np.int64(-1))
        cm = commut[rows]
        lo = np.minimum(m[:, 0], m[:, 1])
        hi = np.maximum(m[:, 0], m[:, 1])
        k0 = opc64[rows]
        k1 = np.where(cm, lo, m[:, 0])
        k2 = np.where(cm, hi, m[:, 1])
        k3 = m[:, 2]
        # group identical keys via one lexsort (stable: rows stay in program
        # order inside each group, so the group leader = first occurrence)
        order = np.lexsort((k3, k2, k1, k0))
        sr = rows[order]
        k0s, k1s, k2s, k3s = k0[order], k1[order], k2[order], k3[order]
        newgrp = np.empty(len(sr), dtype=bool)
        newgrp[:1] = True
        newgrp[1:] = ((k0s[1:] != k0s[:-1]) | (k1s[1:] != k1s[:-1])
                      | (k2s[1:] != k2s[:-1]) | (k3s[1:] != k3s[:-1]))
        grp_starts = np.flatnonzero(newgrp)
        grp_sizes = np.diff(np.append(grp_starts, len(sr)))
        owner_sorted = np.repeat(sr[grp_starts], grp_sizes)
        dupm = sr != owner_sorted
        if not dupm.any():
            break
        new_dups = sr[dupm]
        is_dup[new_dups] = True
        repl[res[new_dups]] = repl[res[owner_sorted[dupm]]]
    if not is_dup.any():
        return g, frozenset()
    # resolve replacement chains (a round-2 duplicate may point at a value
    # that round 3 itself deduplicated)
    while True:
        r2 = repl[repl]
        if np.array_equal(r2, repl):
            break
        repl = r2
    kept = np.flatnonzero(~is_dup)
    a = args[kept]
    new_args = np.where(a >= 0, repl[np.clip(a, 0, None)], np.int64(-1))
    remapped = (new_args != a).any(axis=1)
    g2 = Graph.from_columns(g, c.opcode[kept], new_args, res[kept],
                            c.nest[kept], c.rank[kept], c.array_id[kept])
    for table in g2.outputs.values():
        for k in table:
            table[k] = int(repl[table[k]])
    touched = (_opcode_names(c.opcode[is_dup])
               | _opcode_names(c.opcode[kept][remapped]))
    return g2, touched


def cse(g: Graph) -> Graph:
    """Common-subexpression elimination (commutative-aware, row-hashed)."""
    out, touched = _cse_impl(g)
    if out is not g:
        out._touched = touched
        out.topo_check()   # SSA validation of the rewritten graph
    return out


# ---------------------------------------------------------------------------
# relu_recompose
# ---------------------------------------------------------------------------


def _relu_impl(g: Graph) -> tuple[Graph, frozenset]:
    c = g.cols()
    n = c.n
    if n == 0 or not g.consts:
        return g, frozenset()
    zero = np.zeros(max(g.n_values, 1), dtype=bool)
    zvids = [vid for vid, v in g.consts.items() if v == 0.0]
    if not zvids:
        return g, frozenset()
    zero[np.asarray(zvids, dtype=np.int64)] = True
    opc = c.opcode
    a0, a1, a2 = c.args[:, 0], c.args[:, 1], c.args[:, 2]
    # candidate compares: cmpugt(x, 0)
    cmp_rows = (opc == ID_CMPUGT) & (a1 >= 0) \
        & np.take(zero, np.clip(a1, 0, None)) & (a2 < 0)
    if not cmp_rows.any():
        return g, frozenset()
    cmp_x = np.full(max(g.n_values, 1), -1, dtype=np.int64)
    cmp_x[c.result[cmp_rows]] = a0[cmp_rows]
    # matching selects: select(cmp, x, 0) with the same x
    sel = opc == ID_SELECT
    xv = np.take(cmp_x, np.clip(a0, 0, None))
    match = sel & (a0 >= 0) & (xv >= 0) & (a1 == xv) & (a2 >= 0) \
        & np.take(zero, np.clip(a2, 0, None))
    if not match.any():
        return g, frozenset()
    new_opc = opc.copy()
    new_opc[match] = ID_RELU
    new_args = c.args.copy()
    new_args[match, 0] = xv[match]
    new_args[match, 1] = -1
    new_args[match, 2] = -1
    g2 = Graph.from_columns(g, new_opc, new_args, c.result, c.nest, c.rank,
                            c.array_id)
    touched = frozenset({"select", "relu"})
    uses = g.use_counts()
    if (uses[a0[match]] == 1).any():    # the rewritten selects' compares died
        g3, t2 = _dce_impl(g2)
        return g3, touched | t2
    return g2, touched


def relu_recompose(g: Graph) -> Graph:
    """select(cmpf_ugt(x, 0), x, 0) -> relu(x)   (paper §3.2 item 2)."""
    out, touched = _relu_impl(g)
    if out is not g:
        out._touched = touched
        out.topo_check()   # SSA validation of the rewritten graph
    return out


# ---------------------------------------------------------------------------
# reduction_tree
# ---------------------------------------------------------------------------


def _reduction_tree_impl(g: Graph, threshold: int) -> tuple[Graph, frozenset]:
    c = g.cols()
    n = c.n
    if n == 0:
        return g, frozenset()
    opc = c.opcode
    assoc = (opc == ID_ADDF) | (opc == ID_MAXF) | (opc == ID_MINF)
    if not assoc.any():
        return g, frozenset()
    uses = g.use_counts()
    args, res, nest, rank = c.args, c.result, c.nest, c.rank
    prod = c.producer
    rows = np.flatnonzero(assoc)

    def link(acol: np.ndarray) -> np.ndarray:
        """Chain predecessor of each candidate row through one arg column."""
        ok = acol >= 0
        p = np.where(ok, prod[np.clip(acol, 0, None)], -1).astype(np.int64)
        ok &= p >= 0
        pc = np.clip(p, 0, None)
        ok &= opc[pc] == opc[rows]
        ok &= uses[np.clip(res[pc], 0, None)] == 1
        ok &= nest[pc] == nest[rows]
        ok &= rank[pc] == rank[rows]
        return np.where(ok, p, np.int64(-1))

    p0 = link(args[rows, 0])
    p1 = link(args[rows, 1])
    prev_rows = np.where(p0 >= 0, p0, p1)   # first matching arg wins
    chain_prev = np.full(n, -1, dtype=np.int64)
    chain_prev[rows] = prev_rows
    chain_next = np.full(n, -1, dtype=np.int64)
    linked = prev_rows >= 0
    chain_next[prev_rows[linked]] = rows[linked]

    heads = np.flatnonzero((chain_prev < 0) & (chain_next >= 0))
    cnl = chain_next.tolist()
    chains: list[list[int]] = []
    for h in heads.tolist():
        run = [h]
        cur = h
        while cnl[cur] >= 0:
            cur = cnl[cur]
            run.append(cur)
        if len(run) >= threshold - 1:   # n ops reduce n+1 leaves
            chains.append(run)
    if not chains:
        return g, frozenset()

    # splice layout: interior chain rows vanish, each tail expands into its
    # balanced tree (same op count: a chain of k ops has k+1 leaves)
    out_size = np.ones(n, dtype=np.int64)
    all_rows = np.concatenate([np.asarray(r, dtype=np.int64) for r in chains])
    out_size[all_rows] = 0
    for run in chains:
        out_size[run[-1]] = len(run)
    starts = np.zeros(n, dtype=np.int64)
    np.cumsum(out_size[:-1], out=starts[1:])
    total = int(out_size.sum())

    new_opc = np.empty(total, dtype=np.int32)
    new_args = np.full((total, 3), -1, dtype=np.int32)
    new_res = np.empty(total, dtype=np.int32)
    new_nest = np.empty(total, dtype=np.int32)
    new_rank = np.empty(total, dtype=np.int32)
    new_arr = np.zeros(total, dtype=np.int32)

    copy_src = np.flatnonzero(out_size == 1)
    copy_dst = starts[copy_src]
    new_opc[copy_dst] = opc[copy_src]
    new_args[copy_dst] = args[copy_src]
    new_res[copy_dst] = res[copy_src]
    new_nest[copy_dst] = nest[copy_src]
    new_rank[copy_dst] = rank[copy_src]
    new_arr[copy_dst] = c.array_id[copy_src]

    # per-chain tree emission, in tail program order (value-id allocation
    # order matches the sequential rewriter exactly); ops accumulate into
    # flat lists and scatter into the output columns in one shot
    a0l = args[:, 0].tolist()
    a1l = args[:, 1].tolist()
    resl = res.tolist()
    nestl = nest.tolist()
    rankl = rank.tolist()
    opcl = opc.tolist()
    nv = g.n_values
    touched: set[str] = set()
    t_op: list[int] = []
    t_a0: list[int] = []
    t_a1: list[int] = []
    t_res: list[int] = []
    t_nest: list[int] = []
    t_rank: list[int] = []
    by_tail = sorted(chains, key=lambda r: r[-1])
    for run in by_tail:
        tail = run[-1]
        ocode = opcl[tail]
        touched.add(OPCODES[ocode])
        tl_nest = nestl[tail]
        tl_rank = rankl[tail]
        tl_res = resl[tail]
        chain_res = {resl[i] for i in run}
        head = run[0]
        leaves = [a0l[head], a1l[head]]
        for i in run[1:]:
            a = a0l[i]
            if a not in chain_res:
                leaves.append(a)
            a = a1l[i]
            if a not in chain_res:
                leaves.append(a)
        level = leaves
        while len(level) > 1:
            nxt: list[int] = []
            L = len(level)
            for i in range(0, L - 1, 2):
                if L == 2:
                    vid = tl_res     # tree root takes over the chain result
                else:
                    vid = nv
                    nv += 1
                t_op.append(ocode)
                t_a0.append(level[i])
                t_a1.append(level[i + 1])
                t_res.append(vid)
                t_nest.append(tl_nest)
                t_rank.append(tl_rank)
                nxt.append(vid)
            if L % 2:
                nxt.append(level[-1])
            level = nxt

    tails = np.array([run[-1] for run in by_tail], dtype=np.int64)
    lens = np.array([len(run) for run in by_tail], dtype=np.int64)
    base = np.repeat(starts[tails], lens)
    within = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens,
                                                    lens)
    pos = base + within
    new_opc[pos] = t_op
    new_args[pos, 0] = t_a0
    new_args[pos, 1] = t_a1
    new_res[pos] = t_res
    new_nest[pos] = t_nest
    new_rank[pos] = t_rank

    g2 = Graph.from_columns(g, new_opc, new_args, new_res, new_nest,
                            new_rank, new_arr, n_values=nv)
    return g2, frozenset(touched)


def reduction_tree(g: Graph, *, threshold: int = 4) -> Graph:
    """Rebalance sequential reduction chains into binary trees (§3.2 item 4).

    A chain is a maximal run  o_1, ..., o_n  of the same associative opcode
    where each o_{t+1} consumes o_t's result and that result has no other
    use.  The chain is replaced by a balanced tree over its leaves, halving
    depth from O(n) to O(log n) — the dominant latency lever for the inner
    reduction loops of conv/linear layers.
    """
    out, touched = _reduction_tree_impl(g, threshold)
    if out is not g:
        out._touched = touched
        out.topo_check()   # SSA validation of the rewritten graph
    return out


# ---------------------------------------------------------------------------
# fmac_coalesce
# ---------------------------------------------------------------------------


def _fmac_impl(g: Graph) -> tuple[Graph, frozenset]:
    c = g.cols()
    n = c.n
    if n == 0:
        return _dce_impl(g)
    opc = c.opcode
    uses = g.use_counts()
    res = c.result
    mul_rows = (opc == ID_MULF) & (uses[np.clip(res, 0, None)] == 1) \
        & (res >= 0)
    if not mul_rows.any():
        return _dce_impl(g)
    mul_of = np.full(max(g.n_values, 1), -1, dtype=np.int64)
    mul_of[res[mul_rows]] = np.flatnonzero(mul_rows)
    a0, a1 = c.args[:, 0], c.args[:, 1]
    addf = opc == ID_ADDF
    m1 = np.where(addf & (a1 >= 0),
                  np.take(mul_of, np.clip(a1, 0, None)), np.int64(-1))
    m0 = np.where(addf & (a0 >= 0),
                  np.take(mul_of, np.clip(a0, 0, None)), np.int64(-1))
    use1 = m1 >= 0                 # mul on the right wins, as in the original
    use0 = ~use1 & (m0 >= 0)
    match = use1 | use0
    if not match.any():
        return _dce_impl(g)
    mrow = np.where(use1, m1, m0)[match]
    addend = np.where(use1, a0, a1)[match]
    new_opc = opc.copy()
    new_opc[match] = OPCODE_ID["fmac"]
    new_args = c.args.copy()
    new_args[match, 0] = c.args[mrow, 0]
    new_args[match, 1] = c.args[mrow, 1]
    new_args[match, 2] = addend
    g2 = Graph.from_columns(g, new_opc, new_args, res, c.nest, c.rank,
                            c.array_id)
    touched = frozenset({"addf", "fmac"})
    g3, t2 = _dce_impl(g2)          # the fused muls are dead now
    return g3, touched | t2


def fmac_coalesce(g: Graph) -> Graph:
    """addf(a, mulf(b, c)) with single-use mul -> fmac(b, c, a) (§3.2 item 3)."""
    out, touched = _fmac_impl(g)
    if out is not g:
        out._touched = touched
        out.topo_check()   # SSA validation of the rewritten graph
    return out


# ---------------------------------------------------------------------------


def hoist_globals_check(g: Graph) -> None:
    """Verify weights live at the interface, not inline (paper §3.2 item 1).

    In this implementation hoisting happens by construction (the frontend
    declares weights as interface memrefs), so the pass is an assertion:
    every weight name must appear in ``graph.inputs``.
    """
    for name in g.weight_names:
        if name not in g.inputs:
            raise AssertionError(f"weight {name} not hoisted to interface")


DEFAULT_PIPELINE = ("cse", "relu_recompose", "reduction_tree",
                    "fmac_coalesce", "dce")


def optimize(g: Graph, *, pipeline: Sequence[str] = DEFAULT_PIPELINE,
             tree_threshold: int = 4, max_rounds: int = 4) -> Graph:
    """Run the standard pass pipeline to a fixpoint (the OpenHLS 'opt' flow).

    Compatibility wrapper: the flow now lives in
    ``repro_torch.core.pipeline.PassManager`` (decorator-registered passes,
    per-pass ``PassReport`` instrumentation, fixpoint driving).  This
    wrapper produces bit-identical graphs and is kept for callers that only
    want the optimised graph.
    """
    from repro_torch.core.pipeline import PassManager  # deferred: avoids cycle
    pm = PassManager(
        pipeline, max_rounds=max_rounds,
        pass_options={"reduction_tree": {"threshold": tree_threshold}})
    g, _reports = pm.run(g)
    return g
