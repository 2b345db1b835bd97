"""CUDA emission: compile the scheduled design, don't interpret it.

The counterpart of the reference's ``repro/core/emit_pallas.py``, with its
two tiers.

**Nest-pattern tier** (``mode='nests'``; ``_lower_module``, ``_nlb_step``,
``_attention_step``, ``_mlp_step``, ``_normalize_weights``).  When the
design carries the ``ModuleGraph`` it was bridged from, each node lowers
through the kernel registry (:mod:`repro_torch.kernels.registry`):
``Conv2d`` -> the weights-resident conv, ``Linear`` and the transformer
block's projections and MLP -> the smallfloat matmul, ``Softmax`` and the
NLB and ``Attention`` softmaxes -> the fused Taylor softmax, or, with
``nlb_flash=True`` at fp32, the NLB and ``Attention`` cores -> flash
attention.  ReLU nodes fuse into the preceding conv/matmul kernel.  Nodes
without a registered kernel (batch norm, pooling, strided/padded conv,
RMS norm, the pre-norms inside ``Attention`` and ``MLP``) run as plain
PyTorch; the plan records the nodes among them as fallbacks and the
kernels the composites launch through, exactly as the reference's plan
does, so the two plans compare key for key.  The attention contractions
(scores and mix) are ``torch.bmm``/``torch.matmul`` calls outside any
kernel, as the reference leaves them to ``jnp.einsum``.

With a ``fmt`` every kernel result is rounded to the format, as the
reference rounds it after each kernel.  The kernels do that rounding
themselves — conv and matmul in their epilogue, the NLB residual in the
out-projection conv's epilogue, the NLB scores as the softmax reads them
— so BraggNN's quantised path launches the same kernels as the fp32 one
and nothing beside them but the two ``torch.bmm``.  The transformer
block's residual sums and RMS norms are rounded by the kernels' shared
device quantiser, one launch each.

**Generic DFG tier** (``mode='dfg'``; ``_plan_segments``,
``_segment_layout``, ``_lower_dfg``) — works for *any* traced design.  The
levelised (level, opcode) groups of ``core/emit.py`` are partitioned into
contiguous runs of groups whose opcode is in ``registry.OPCODE_KERNELS``;
each run becomes ONE launch of the DFG segment kernel
(:mod:`repro_torch.kernels.dfg_segment`) over a value-major
``(n_values, batch)`` buffer.  The planner, carried over verbatim, also
marks a group's scatter as elided when every read of its results is an
aligned gather later in the same segment; the segment kernel then
forwards the result to those gathers and never writes it.  The layout
cuts each segment into stages that need no barrier inside them, and the
plan reports their count.  Groups
whose opcode is missing from the table fall back per group to plain torch
(``registry.opcode_compute``) and are recorded.  With
``fmt`` every group result is re-quantised — the per-op FloPoCo functional
model, equal to ``emit.evaluate`` value for value.

On a CUDA device every registry step and every segment launches a
hand-written kernel; on the CPU (only when asked for with
``device="cpu"``) the same steps run the kernels' plain versions.  Bound
weights are uploaded to the device once, when the runner is built; per
batch only the input moves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core import device as devices
from repro_torch.core import emit
from repro_torch.core.ir import Graph
from repro_torch.core.precision import FORMATS, FloatFormat, quantize
from repro_torch.kernels import registry as kreg
from repro_torch.kernels.smallfloat_matmul import ops as mm_ops
from repro_torch.kernels.smallfloat_matmul import \
    smallfloat_matmul as mm_kernel
from repro_torch.kernels.smallfloat_matmul.ref import Dense


def _norm_fmt(fmt) -> tuple[Optional[FloatFormat], Optional[str]]:
    """-> (FloatFormat or None, format key or None)."""
    if fmt is None or fmt == "fp32":
        return None, None
    if isinstance(fmt, str):
        return FORMATS[fmt], fmt
    if isinstance(fmt, FloatFormat):
        key = next((k for k, v in FORMATS.items() if v == fmt), None)
        return fmt, key or f"{fmt.exp_bits}_{fmt.man_bits}"
    raise TypeError(f"fmt must be None, a FORMATS key or a FloatFormat, "
                    f"got {type(fmt).__name__}")


@dataclasses.dataclass
class KernelPlan:
    """What the lowering actually did — serving telemetry + test surface.

    The reference's ``PallasPlan`` field for field, minus ``interpret``;
    ``use_kernels`` (the reference's ``use_pallas``) says whether the
    hand-written CUDA kernels serve (False: their plain versions on the
    CPU).
    """

    mode: str                                  #: 'nests' | 'dfg'
    use_kernels: bool                          #: CUDA kernels launched?
    fmt: Optional[str] = None                  #: FloPoCo key, None = fp32
    n_groups: int = 0                          #: levelised groups (dfg tier)
    n_segments: int = 0                        #: fused kernels (dfg tier)
    fused_scatters: int = 0                    #: scatter->gather pairs elided
    n_stages: int = 0                          #: barrier stages (dfg tier)
    kernels: dict = dataclasses.field(default_factory=dict)
    fallbacks: list = dataclasses.field(default_factory=list)
    notes: list = dataclasses.field(default_factory=list)

    def record_kernel(self, name: str) -> None:
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def summary(self) -> str:
        kern = ", ".join(f"{k}x{v}" for k, v in sorted(self.kernels.items()))
        parts = [f"cuda[{self.mode}]"]
        if self.mode == "dfg":
            parts.append(f"{self.n_segments} fused kernels over "
                         f"{self.n_groups} groups "
                         f"({self.fused_scatters} scatters elided)")
        if kern:
            parts.append(kern)
        parts.append(f"{len(self.fallbacks)} fallbacks")
        if self.n_stages:
            parts.append(f"{self.n_stages} stages")
        if not self.use_kernels:
            parts.append("plain versions (CPU tensors)")
        return "; ".join(parts)


# ---------------------------------------------------------------------------
# Generic tier: fuse levelised op groups into DFG segment kernels
# ---------------------------------------------------------------------------

def _plan_segments(groups, output_vids: np.ndarray, opcode_table,
                   plan: KernelPlan):
    """Partition the level-ordered groups into fused segments + fallbacks.

    Returns ``steps``: a list of ``('segment', [(oc, arg_idx, res_idx,
    forward_keys, skip_scatter), ...])`` and ``('fallback', (oc, arg_idx,
    res_idx))`` entries, plus per-group scatter-elision already resolved.
    """
    # consumer bookkeeping: how often each value id is read by later groups,
    # and through which (group, arg-position) gathers
    refs: dict[int, int] = {}
    for _lv, _oc, arg_idx, _res in groups:
        for ai in arg_idx:
            for v in ai:
                refs[int(v)] = refs.get(int(v), 0) + 1
    out_set = set(int(v) for v in output_vids)

    raw_steps: list[tuple[str, Any]] = []
    cur: list[int] = []          # group indices of the open segment
    for gi, (lv, oc, arg_idx, res_idx) in enumerate(groups):
        if oc in opcode_table:
            cur.append(gi)
        else:
            if cur:
                raw_steps.append(("segment", cur))
                cur = []
            raw_steps.append(("fallback", gi))
            plan.fallbacks.append(f"L{lv}:{oc} ({len(res_idx)} ops)")
    if cur:
        raw_steps.append(("segment", cur))

    # scatter elision: a group's scatter is dropped iff its results are not
    # design outputs and every read of them happens through a later gather
    # *in the same segment* whose index array matches bit-for-bit (those
    # gathers can then be served from the forwarded value).
    steps = []
    for kind, payload in raw_steps:
        if kind == "fallback":
            lv, oc, arg_idx, res_idx = groups[payload]
            steps.append(("fallback", (oc, arg_idx, res_idx)))
            continue
        seg_groups = payload
        produced: dict[bytes, int] = {}      # res bytes -> group position
        matched_reads: dict[int, int] = {}   # producer pos -> forwarded reads
        gathers = []                         # per group: arg keys
        for pos, gi in enumerate(seg_groups):
            _lv, oc, arg_idx, res_idx = groups[gi]
            keys = []
            for ai in arg_idx:
                k = ai.tobytes()
                keys.append(k if k in produced else None)
                if k in produced:
                    matched_reads[produced[k]] = \
                        matched_reads.get(produced[k], 0) + len(ai)
            gathers.append(keys)
            produced[res_idx.tobytes()] = pos
        seg = []
        for pos, gi in enumerate(seg_groups):
            _lv, oc, arg_idx, res_idx = groups[gi]
            valid = res_idx >= 0
            total_reads = sum(refs.get(int(v), 0) for v in res_idx[valid])
            is_output = any(int(v) in out_set for v in res_idx[valid])
            skip = (valid.all() and not is_output
                    and matched_reads.get(pos, 0) == total_reads
                    and total_reads > 0)
            if skip:
                plan.fused_scatters += 1
            seg.append((oc, arg_idx, res_idx, gathers[pos], skip))
        steps.append(("segment", seg))
    plan.n_segments = sum(1 for k, _ in steps if k == "segment")
    return steps


def _segment_layout(seg, n_values: int, quant: bool
                    ) -> tuple[np.ndarray, np.ndarray]:
    """One fused segment -> ``(desc, idx_flat)`` for the segment kernel.

    ``idx_flat`` is the layout half of the reference's ``_segment_body``:
    all gather and scatter index arrays of the segment concatenated into
    ONE int32 vector addressed by per-group offsets, with the result slots
    of ops without a destination redirected one past the buffer
    (``n_values``) and dropped.  ``desc`` holds one row per entry in the
    kernel's format (``kernels/dfg_segment/dfg_segment.py``):

    * **stages.**  Walking the groups in order, a group opens a new stage
      when it gathers from the buffer a slot that a group of the current
      stage scatters.  Forwarded operands do not count: they do not touch
      the buffer.  The kernel puts a barrier between stages only.
    * **forwarding.**  An operand the planner forwards (its gather matches
      an earlier group's results) is taken from that group's result,
      held per element, when the producer is in the same stage; read from
      the buffer when the producer is in an earlier stage and was
      scattered; and otherwise, for an elided producer of an earlier
      stage, computed again by a *recompute* entry in the consumer's unit
      (recursively, down to operands in the buffer).
    * **units.**  Within a stage, entries linked by forwarded operands form
      a unit (one length, one loop over its elements); its entries keep
      the segment's order, a recompute entry just before its first reader,
      and the values held per element get register slots by liveness.
    * elided groups are not scattered.
    """
    from repro_torch.kernels.dfg_segment.dfg_segment import \
        SEGMENT_OPCODE_ID

    arg_off, res_off, chunks = [], [], []
    off = 0
    for oc, arg_idx, res_idx, _keys, _skip in seg:
        if oc not in SEGMENT_OPCODE_ID or not 1 <= len(arg_idx) <= 3:
            raise ValueError(f"the segment kernel has no opcode {oc!r} of "
                             f"arity {len(arg_idx)}")
        arg_off.append([])
        for ai in arg_idx:
            arg_off[-1].append(off)
            chunks.append(ai.astype(np.int32))
            off += len(ai)
        res_off.append(off)
        chunks.append(np.where(res_idx >= 0, res_idx,
                               n_values).astype(np.int32))
        off += len(res_idx)
    idx_flat = (np.concatenate(chunks) if chunks
                else np.zeros(1, np.int32))

    # the group each forwarded operand comes from (-1: the buffer)
    produced: dict[bytes, int] = {}
    src = []
    for pos, (_oc, _a, res_idx, keys, _skip) in enumerate(seg):
        src.append([produced[k] if k is not None else -1 for k in keys])
        produced[res_idx.tobytes()] = pos
    elided = [bool(s[4]) for s in seg]

    # stages: the last group of the segment that scatters each slot
    writer = np.full(n_values + 1, -1, np.int64)
    stage_of, start = [], 0
    for pos, (_oc, arg_idx, res_idx, _keys, _skip) in enumerate(seg):
        gathered = [ai for ai, p in zip(arg_idx, src[pos]) if p < 0]
        if gathered and max(int(writer[ai].max()) for ai in gathered) \
                >= start:
            start = pos
        stage_of.append(start)
        if not elided[pos]:
            writer[res_idx[res_idx >= 0]] = pos
    stages: dict[int, list[int]] = {}
    for pos, s in enumerate(stage_of):
        stages.setdefault(s, []).append(pos)

    rows = []
    for first, members in stages.items():
        # the stage's entries: (group, recompute?) -> one source per
        # operand, (group forwarded from or -1, the entry holding the value
        # or None for a gather from the buffer)
        ents: dict[tuple[int, bool], list] = {}

        def sources(pos, in_stage):
            out = []
            for p in src[pos]:
                if p >= 0 and in_stage(p):
                    out.append((p, (p, False)))
                elif p >= 0 and elided[p]:
                    out.append((p, recompute(p)))
                else:
                    out.append((p, None))
            return out

        def recompute(p):
            if (p, True) not in ents:
                ents[(p, True)] = sources(p, lambda q: False)
            return (p, True)

        for pos in members:
            ents[(pos, False)] = sources(
                pos, lambda q: stage_of[q] == first)
        # units: entries linked by held operands (union-find)
        parent = {k: k for k in ents}

        def find(k):
            while parent[k] != k:
                parent[k] = parent[parent[k]]
                k = parent[k]
            return k
        for k, ops in ents.items():
            for _p, holder in ops:
                if holder is not None:
                    parent[find(holder)] = find(k)
        # a unit's order: the stage's groups in segment order, each
        # recompute entry just before the first entry that reads it
        order: dict = {}

        def place(k):
            if k not in order:
                for _p, holder in ents[k]:
                    if holder is not None and holder[1]:
                        place(holder)
                order[k] = None
        for pos in members:
            place((pos, False))
        units: dict = {}
        for k in order:
            units.setdefault(find(k), []).append(k)
        for u_i, unit in enumerate(units.values()):
            rows += _unit_rows(unit, ents, seg, arg_off, res_off, elided,
                               quant, opens_stage=u_i == 0)
    desc = np.stack(rows).astype(np.int32)
    return desc, idx_flat


def _unit_rows(unit, ents, seg, arg_off, res_off, elided, quant: bool,
               opens_stage: bool) -> list[np.ndarray]:
    """The descriptor rows of one unit, its held values given register
    slots by liveness (an entry reads its operands before it writes its
    result, so a slot freed by its last reader can take that reader's
    result)."""
    from repro_torch.kernels.dfg_segment.dfg_segment import (
        COL_GROUP, COL_RES_SLOT, COL_SLOT, COL_SRC, COL_UNIT, DESC_WIDTH,
        FLAG_DROPS, FLAG_ELIDED, FLAG_QUANT, FLAG_RECOMPUTE, FLAG_STAGE,
        MAX_SLOTS, SEGMENT_OPCODE_ID)

    last = {}
    for i, k in enumerate(unit):
        for _p, holder in ents[k]:
            if holder is not None:
                last[holder] = i
    rows, slot, free, top = [], {}, [], 0
    for i, k in enumerate(unit):
        pos, rec = k
        oc, arg_idx, res_idx, _keys, _skip = seg[pos]
        row = np.full(DESC_WIDTH, -1, np.int64)
        row[0], row[1] = SEGMENT_OPCODE_ID[oc], len(arg_idx)
        row[2:5] = (arg_off[pos] + [0, 0, 0])[:3]
        row[5], row[6] = res_off[pos], len(res_idx)
        row[7] = ((FLAG_QUANT if quant and oc not in kreg.NO_QUANT_OPCODES
                   else 0)
                  | (FLAG_DROPS if (res_idx < 0).any() else 0)
                  | (FLAG_ELIDED if elided[pos] or rec else 0)
                  | (FLAG_RECOMPUTE if rec else 0)
                  | (FLAG_STAGE if opens_stage and i == 0 else 0))
        for j, (p, holder) in enumerate(ents[k]):
            row[COL_SRC + j] = p
            if holder is not None:
                row[COL_SLOT + j] = slot[holder]
        free += [slot[h] for h in {h for _p, h in ents[k] if h is not None}
                 if last[h] == i]
        if k in last:
            free.sort()
            slot[k] = free.pop(0) if free else top
            top = max(top, slot[k] + 1)
            row[COL_RES_SLOT] = slot[k]
        row[COL_UNIT] = len(unit) if i == 0 else 0
        row[COL_GROUP] = pos
        rows.append(row)
    if top > MAX_SLOTS:
        raise ValueError(f"a unit of the segment holds {top} forwarded "
                         f"values per element at once; the segment kernel "
                         f"holds at most {MAX_SLOTS}")
    return rows


def _lower_dfg(g: Graph, *, fmt_obj, fmt_tuple, dev: torch.device,
               opcode_table, plan: KernelPlan, bound=None):
    from repro_torch.kernels.dfg_segment import ops as seg_ops
    from repro_torch.kernels.dfg_segment.dfg_segment import FLAG_STAGE

    groups = emit.compile_groups(g.cols(), g.n_values)
    plan.n_groups = len(groups)
    _, _, _, output_gather = emit.io_tables(g)
    all_out_vids = (np.concatenate([v for v, _ in output_gather.values()])
                    if output_gather else np.zeros(0, np.int32))
    q = _quantizer(fmt_obj, fmt_tuple) if fmt_obj is not None else None
    steps = _plan_segments(groups, all_out_vids, opcode_table, plan)

    n_values = max(g.n_values, 1)
    compiled = []
    step_labels = []      # one label per compiled step, for profiling spans
    segments = []         # (idx, desc) on the device, per fused segment
    for kind, payload in steps:
        if kind == "segment":
            desc, idx_flat = _segment_layout(payload, n_values,
                                             quant=q is not None)
            plan.n_stages += int((desc[:, 7] & FLAG_STAGE != 0).sum())
            tdesc = torch.from_numpy(desc).to(dev)
            tidx = torch.from_numpy(idx_flat).to(dev)

            def seg(buf, tidx=tidx, tdesc=tdesc):
                return seg_ops.segment(buf, tidx, tdesc, fmt=fmt_tuple)

            compiled.append(seg)
            step_labels.append(f"segment{len(segments)}[{len(payload)} "
                               f"groups]")
            segments.append((tidx, tdesc))
        else:
            oc, arg_idx, res_idx = payload
            args = [torch.from_numpy(ai.astype(np.int64)).to(dev)
                    for ai in arg_idx]
            keep = res_idx >= 0
            res = torch.from_numpy(res_idx[keep].astype(np.int64)).to(dev)
            # indices, not a mask (a mask's gather waits for the card)
            tkeep = None if keep.all() else torch.from_numpy(
                np.flatnonzero(keep)).to(dev)

            def fb(buf, oc=oc, args=args, res=res, tkeep=tkeep):
                r = kreg.opcode_compute(oc, [buf[a] for a in args])
                if q is not None and oc not in kreg.NO_QUANT_OPCODES:
                    r = q(r)
                buf[res] = r if tkeep is None else r[tkeep]
                return buf

            compiled.append(fb)
            step_labels.append(f"fallback[{oc}]")
    prologue, epilogue = emit.buffer_io(g, dev, q, bound=bound)

    def run(feeds):
        buf, batch = prologue(feeds)
        for step in compiled:
            buf = step(buf)
        return epilogue(buf, batch)

    def profile(feeds):
        # twin of ``run``: one span + device sync per fused segment /
        # fallback step, so the per-kernel cost is observable
        buf, batch = prologue(feeds)
        for label, step in zip(step_labels, compiled):
            with obs.span(f"cuda.{label}", cat="cuda"):
                buf = step(buf)
                devices.synchronize(dev)
        return epilogue(buf, batch)

    run.profile = profile
    run.prologue = prologue
    run.segments = segments
    return run


# ---------------------------------------------------------------------------
# Nest-pattern tier: registry kernels per bridged module node
# ---------------------------------------------------------------------------

def _lower_module(module, *, fmt_obj, fmt_tuple, nlb_flash: bool,
                  plan: KernelPlan, device):
    from repro_torch.nn import graph as nng

    if module.input_shape[0] != 1 and len(module.input_shape) != 2:
        raise ValueError(
            f"nest tier expects a per-sample memref input shape with a "
            f"leading 1 (image models) or a 2-D (L, D) sequence shape, "
            f"got {module.input_shape}")

    conv_e = kreg.for_pattern("Conv2d")
    mm_e = kreg.for_pattern("Linear")
    sm_e = kreg.for_pattern("Softmax")
    fa_e = kreg.for_pattern("NonLocalBlock.attention")
    q = _quantizer(fmt_obj, fmt_tuple) if fmt_obj is not None \
        else (lambda x: x)

    nodes = list(module.nodes)
    weight_names: list[str] = []
    for n in nodes:
        weight_names.extend(n.weight_memrefs())

    steps: list[Callable] = []   # each: (x, w: dict) -> x
    step_labels: list[str] = []  # one per step, for profiling spans
    i = 0
    while i < len(nodes):
        node = nodes[i]
        fuse_relu = (i + 1 < len(nodes)
                     and isinstance(nodes[i + 1],
                                    (nng.ReLU, nng.OutputReLU)))
        if isinstance(node, nng.Conv2d):
            wn, bn = f"{node.prefix}.weight", f"{node.prefix}.bias"
            has_b = node.bias
            if node.stride == 1 and node.padding == 0:
                plan.record_kernel(conv_e.name + (":relu" if fuse_relu
                                                 else ""))

                def step(x, w, wn=wn, bn=bn, has_b=has_b, fr=fuse_relu):
                    return conv_e.fn(x, w[wn], w[bn] if has_b else None,
                                     fmt=fmt_tuple, fuse_relu=fr,
                                     out_fmt=fmt_tuple)
            else:
                plan.fallbacks.append(
                    f"{node.name}: Conv2d(stride={node.stride}, "
                    f"padding={node.padding}) via torch")

                def step(x, w, wn=wn, bn=bn, has_b=has_b, fr=fuse_relu,
                         node=node):
                    xq, wq = x, w[wn]
                    if fmt_obj is not None:
                        xq, wq = q(xq), q(wq)
                    y = F.conv2d(xq, wq, stride=node.stride,
                                 padding=node.padding)
                    if has_b:
                        y = y + w[bn][None, :, None, None]
                    if fr:
                        y = torch.relu(y)
                    return q(y)
        elif isinstance(node, nng.Linear):
            # the maximal run of consecutive Linear nodes, each with its
            # following ReLU fused, goes to one chain launch where the
            # kernel takes it; else each node is a chain of one
            run, j = [], i
            while j < len(nodes) and isinstance(nodes[j], nng.Linear):
                relu = (j + 1 < len(nodes)
                        and isinstance(nodes[j + 1],
                                       (nng.ReLU, nng.OutputReLU)))
                run.append((nodes[j], relu))
                plan.record_kernel(mm_e.name + (":relu" if relu else ""))
                j += 2 if relu else 1
            dims = [run[0][0].in_features] + [n.out_features
                                              for n, _ in run]
            chains = ([run] if len(run) > 1 and mm_kernel.chain_fits(
                dims, device) else [[r] for r in run])
            eb = fmt_obj.exp_bits if fmt_obj is not None else None
            mb = fmt_obj.man_bits if fmt_obj is not None else None
            for chain in chains:
                spec = [(f"{n.prefix}.weight", f"{n.prefix}.bias" if n.bias
                         else None, relu) for n, relu in chain]

                def step(x, w, spec=spec, eb=eb, mb=mb):
                    # loop-nest semantics: out = x @ W.T + b (W.T is a
                    # strided view the kernel reads in place)
                    return mm_ops.matmul_chain(
                        x, [Dense(w[wn].T, w[bn] if bn else None, relu,
                                  fmt_tuple) for wn, bn, relu in spec],
                        exp_bits=eb, man_bits=mb)
                steps.append(step)
                label = _node_label(chain[0][0])
                if len(chain) > 1:
                    label += f"..{_node_label(chain[-1][0])}"
                step_labels.append(label + (":relu" if chain[-1][1]
                                            else ""))
            i = j
            continue
        elif isinstance(node, nng.Softmax):
            plan.record_kernel(sm_e.name)

            def step(x, w, node=node, fr=fuse_relu):
                y = sm_e.fn(x, taylor_order=node.taylor_order)
                return torch.relu(y) if fr else y
        elif isinstance(node, nng.NonLocalBlock):
            steps.append(_nlb_step(node, conv_e, sm_e, fa_e, fmt_tuple,
                                   nlb_flash, plan))
            step_labels.append(_node_label(node))
            i += 1
            continue
        elif isinstance(node, nng.BatchNorm2d):
            plan.fallbacks.append(f"{node.name}: BatchNorm2d via torch")
            pre = node.prefix

            def step(x, w, pre=pre, node=node, fr=fuse_relu):
                ga, be = w[f"{pre}.gamma"], w[f"{pre}.beta"]
                mu, va = w[f"{pre}.mean"], w[f"{pre}.var"]
                if fmt_obj is not None:
                    x, ga, be = q(x), q(ga), q(be)
                    mu, va = q(mu), q(va)
                den = torch.sqrt(va + node.eps)
                y = ga[None, :, None, None] \
                    * (x - mu[None, :, None, None]) \
                    / den[None, :, None, None] + be[None, :, None, None]
                if fr:
                    y = torch.relu(y)
                return q(y)
        elif isinstance(node, nng.MaxPool2d):
            plan.fallbacks.append(f"{node.label}: MaxPool2d via "
                                  f"max_pool2d")

            def step(x, w, node=node, fr=fuse_relu):
                y = F.max_pool2d(x, node.kernel, node.stride)
                return torch.relu(y) if fr else y
        elif isinstance(node, nng.RMSNorm):
            plan.fallbacks.append(f"{node.name}: RMSNorm via torch")
            pre = node.prefix

            def step(x, w, pre=pre, node=node):
                return _rms(x, w[f"{pre}.gamma"], node.eps, q)
            fuse_relu = False
        elif isinstance(node, nng.Attention):
            steps.append(_attention_step(node, mm_e, sm_e, fa_e, q,
                                         fmt_obj, fmt_tuple, nlb_flash,
                                         plan))
            step_labels.append(_node_label(node))
            i += 1
            continue
        elif isinstance(node, nng.MLP):
            steps.append(_mlp_step(node, mm_e, q, fmt_obj, fmt_tuple, plan,
                                   device))
            step_labels.append(_node_label(node))
            i += 1
            continue
        elif isinstance(node, (nng.ReLU, nng.OutputReLU)):
            def step(x, w):
                return torch.relu(x)
            fuse_relu = False
        elif isinstance(node, nng.Flatten):
            def step(x, w):
                return x.reshape(x.shape[0], -1)
            fuse_relu = False
        else:  # pragma: no cover - ModuleGraph validates the vocabulary
            raise NotImplementedError(type(node).__name__)
        steps.append(step)
        step_labels.append(_node_label(node) + (":relu" if fuse_relu
                                                else ""))
        i += 2 if fuse_relu else 1

    # the output memref is the last allocating node's (OutputReLU rewrites
    # it in place) — mirror hls.bridge.emit_module
    last_alloc = max(j for j, n in enumerate(nodes)
                     if not isinstance(n, nng.OutputReLU))
    out_name = nodes[last_alloc].out_name
    out_shape = module.shapes()[-1]

    def run(x, weights):
        for step in steps:
            x = step(x, weights)
        return {out_name: x.reshape((x.shape[0],) + tuple(out_shape))}

    def profile(x, weights):
        # twin of ``run``: one span + device sync per registry kernel, so
        # the per-kernel cost is observable
        for label, step in zip(step_labels, steps):
            with obs.span(f"cuda.kernel.{label}", cat="cuda"):
                x = step(x, weights)
                devices.synchronize(x.device)
        return {out_name: x.reshape((x.shape[0],) + tuple(out_shape))}

    run.profile = profile
    return run, weight_names, out_name


def _node_label(node) -> str:
    return str(getattr(node, "name", None) or getattr(node, "label", None)
               or type(node).__name__)


def _nlb_step(node, conv_e, sm_e, fa_e, fmt_tuple, nlb_flash: bool,
              plan: KernelPlan):
    """The NonLocalBlock composite: three 1x1 convs -> attention ->
    out-projection -> residual, every stage but the two contractions
    through a registry kernel (with ``nlb_flash`` at fp32 the attention is
    one flash-attention kernel, contractions included).

    The reference rounds theta/phi/g, the scores, the mix, the projection
    and the residual sum to ``fmt``.  Here the convs round their results
    and the residual sum in their epilogue, the softmax rounds the scores
    as it reads them, and the mix needs no rounding of its own: the
    out-projection conv rounds its input operand to the same format."""
    pre = node.prefix
    use_flash = nlb_flash and fmt_tuple is None
    plan.record_kernel(conv_e.name)          # theta/phi/g (batched 1x1)
    if use_flash:
        plan.record_kernel(fa_e.name)
        plan.notes.append(
            f"{node.name}: flash-attention throughput mode — true-exp "
            f"softmax, not the order-{node.taylor_order} Taylor model")
    else:
        plan.record_kernel(sm_e.name)

    def conv(x, wt, residual=None):
        return conv_e.fn(x, wt, None, fmt=fmt_tuple, out_fmt=fmt_tuple,
                         residual=residual)

    def step(x, w):
        b, c1, h, _ = x.shape
        n = h * h
        theta = conv(x, w[f"{pre}.theta.weight"])
        phi = conv(x, w[f"{pre}.phi.weight"])
        g = conv(x, w[f"{pre}.g.weight"])
        c2 = theta.shape[1]
        tf = theta.reshape(b, c2, n)
        pf = phi.reshape(b, c2, n)
        gf = g.reshape(b, c2, n)
        if use_flash:
            # A = softmax(theta^T phi) — flash divides logits by sqrt(D),
            # so pre-scale q to keep the DFG's unscaled scores.  The kernel
            # reads q, k, v as (B, n, 1, c2) views of their (B, c2, n)
            # layout and writes its result in that layout, which the
            # out-projection conv then reads as it is
            qv = tf * float(np.sqrt(np.float32(c2)))
            yc = torch.empty_like(qv)                          # (B, c2, n)

            def heads(t):
                return t.transpose(1, 2)[:, :, None, :]
            fa_e.fn(heads(qv), heads(pf), heads(gf), causal=False,
                    out=heads(yc))
        else:
            # scores[b,i,j] = sum_c theta[b,c,i] phi[b,c,j]
            scores = torch.bmm(tf.transpose(1, 2), pf)
            attn = sm_e.fn(scores, taylor_order=node.taylor_order,
                           in_fmt=fmt_tuple)
            # mix[b,c,i] = sum_j attn[b,i,j] g[b,c,j]
            yc = torch.bmm(gf, attn.transpose(1, 2))
        y4 = yc.reshape(b, c2, h, h)          # a view of a contiguous yc
        # the residual sum goes in the out-projection conv's epilogue
        return conv(y4, w[f"{pre}.out_cnn.weight"], residual=x)

    return step


def _quantizer(fmt_obj: FloatFormat, fmt_tuple) -> Callable:
    """Rounding to ``fmt``: the kernels' shared device quantiser on the card
    (one launch), the torch quantiser on the CPU — bit for bit the same."""
    from repro_torch.kernels.quantize import device_quantize

    def q(x):
        if x.is_cuda:
            return device_quantize(x.contiguous(), fmt_tuple)
        return quantize(x, fmt_obj)
    return q


def _rms(x, gamma, eps: float, q):
    """RMSNorm as the reference's nest tier computes it, in plain torch
    (the reference in jnp): input and gain rounded to ``fmt``, then
    ``x * (1 / sqrt(sum(x*x) * (1/D) + eps)) * gamma`` rounded."""
    x, gamma = q(x), q(gamma)
    ms = torch.sum(x * x, dim=-1, keepdim=True) * (1.0 / x.shape[-1])
    return q(x * (1.0 / torch.sqrt(ms + eps)) * gamma)


def _attention_step(node, mm_e, sm_e, fa_e, q, fmt_obj, fmt_tuple,
                    flash: bool, plan: KernelPlan):
    """The Attention composite: optional pre-norm -> q/k/v projections ->
    scaled scores -> softmax -> mix -> out-projection -> residual.

    The q, k and v projections are one smallfloat-matmul launch over the
    concatenated (D, 3*H*dh) weight (``{prefix}.qkv``, made when the
    weights are bound): each output is the same ascending fmaf chain as in
    three launches, so the results are equal value for value.  Scores and
    mix are ``torch.matmul`` outside any kernel, as the reference leaves
    them to ``jnp.einsum``; the softmax is the fused Taylor-mode kernel,
    which rounds the scores to ``fmt`` as it reads them.  With ``flash`` at
    fp32 the attention core is one flash-attention launch on the
    projections' (B, L, H, dh) views, read in place as (B, H, L, dh).

    The reference rounds q/k/v, the scores, the mix, the projection and
    the residual sum to ``fmt``.  Here the matmul rounds its results in
    its epilogue and its operands as it loads them (so the mix needs no
    rounding of its own), the softmax rounds the scores, and the residual
    sum is rounded after the add."""
    pre = node.prefix
    h, dh = node.n_heads, node.head_dim
    eb = fmt_obj.exp_bits if fmt_obj is not None else None
    mb = fmt_obj.man_bits if fmt_obj is not None else None
    use_flash = flash and fmt_tuple is None
    plan.record_kernel(mm_e.name)            # q/k/v and out projections
    if use_flash:
        plan.record_kernel(fa_e.name)
        plan.notes.append(
            f"{node.name}: flash-attention throughput mode — true-exp "
            f"softmax, not the order-{node.taylor_order} Taylor model")
    else:
        plan.record_kernel(sm_e.name)
    # the reference's 1 / sqrt(float32(dh)), rounded to fp32
    inv_sqrt = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    hd = h * dh

    def mm(x2, wt):
        return mm_e.fn(x2, wt, None, exp_bits=eb, man_bits=mb,
                       out_fmt=fmt_tuple)

    def step(x, w):
        b, l, d = x.shape
        src = x
        if node.pre_norm:
            src = _rms(src, w[f"{pre}.norm.gamma"], node.eps, q)
        qkv = mm(src.reshape(b * l, d), w[f"{pre}.qkv"])   # (B*L, 3*H*dh)
        # (B, L, H, dh) views of the three column blocks
        qh, kh, vh = (qkv[:, i * hd:(i + 1) * hd].view(b, l, h, dh)
                      for i in range(3))
        if use_flash:
            # flash divides logits by sqrt(dh) — exactly the DFG's scale
            y = torch.empty((b, l, h, dh), device=x.device,
                            dtype=torch.float32)
            fa_e.fn(qh, kh, vh, causal=False, out=y)
        else:
            scores = torch.matmul(qh.transpose(1, 2),
                                  kh.permute(0, 2, 3, 1)) * inv_sqrt
            attn = sm_e.fn(scores, taylor_order=node.taylor_order,
                           in_fmt=fmt_tuple)
            y = torch.matmul(attn, vh.transpose(1, 2)).transpose(1, 2)
        z = mm(y.reshape(b * l, hd), w[f"{pre}.o.kernel"].reshape(hd, d))
        z = z.reshape(b, l, d)
        return q(x + z) if node.residual else z

    return step


def _mlp_step(node, mm_e, q, fmt_obj, fmt_tuple, plan: KernelPlan, device):
    """The MLP composite: optional pre-norm -> fc1 + ReLU -> fc2 ->
    residual.  Both layers go to one smallfloat-matmul chain launch where
    the kernel takes the widths (as the BraggNN dense layers do; each
    output is the same fmaf chain as with the layers one at a time), else
    to one launch each."""
    pre = node.prefix
    eb = fmt_obj.exp_bits if fmt_obj is not None else None
    mb = fmt_obj.man_bits if fmt_obj is not None else None
    plan.record_kernel(mm_e.name + ":relu")  # fc1
    plan.record_kernel(mm_e.name)            # fc2
    one_launch = mm_kernel.chain_fits(
        [node.d_model, node.hidden, node.d_model], device)

    def step(x, w):
        b, l, d = x.shape
        src = x
        if node.pre_norm:
            src = _rms(src, w[f"{pre}.norm.gamma"], node.eps, q)
        layers = [Dense(w[f"{pre}.fc1.weight"].T, w[f"{pre}.fc1.bias"],
                        True, fmt_tuple),
                  Dense(w[f"{pre}.fc2.weight"].T, w[f"{pre}.fc2.bias"],
                        False, fmt_tuple)]
        z = src.reshape(b * l, d)
        for chain in ([layers] if one_launch else [[ly] for ly in layers]):
            z = mm_ops.matmul_chain(z, chain, exp_bits=eb, man_bits=mb)
        z = z.reshape(b, l, d)
        return q(x + z) if node.residual else z

    return step


# ---------------------------------------------------------------------------
# Front door
# ---------------------------------------------------------------------------

def to_cuda_fn(g: Graph, *, module=None, fmt=None, mode: str = "auto",
               device=None, weights: Optional[dict] = None,
               nlb_flash: bool = False, opcode_table=None) -> Callable:
    """Compile a DFG (plus optional source ``ModuleGraph``) to a torch
    callable returning ``{output name: (batch,) + shape}`` as tensors on
    ``device``.  It carries its :class:`KernelPlan` as ``.plan`` and its
    device as ``.device``.

    ``mode='auto'`` picks the nest-pattern tier when ``module`` is given,
    else the generic DFG tier.

    * ``'nests'``: the callable takes one batch — the input memref's array
      or tensor (``(B,) + shape``, one unbatched sample, or for image
      models the natural ``(B, C, H, W)``), or a feed dict holding only
      that memref.  ``fmt`` quantises each kernel's operands and result.
      ``nlb_flash=True`` serves the NLB attention through flash attention
      (fp32 only: with ``fmt`` the Taylor softmax stays).
    * ``'dfg'``: the callable takes a feed dict (memref name -> array or
      tensor, weights batched or not; a batched weight feed may vary per
      sample).  ``fmt`` re-quantises every op, as ``emit.evaluate`` does.
      ``opcode_table`` overrides the opcodes the segments take (tests use
      it to force per-group fallbacks).

    ``weights`` (memref name -> array or tensor) default to the module's
    bound parameters and are uploaded once, here: the nest tier normalises
    them to one shared set; the DFG tier places unbatched ones with the
    constants, rounded to ``fmt`` once, here, and a feed of the same name
    at call time takes precedence.
    ``device`` defaults to ``"cuda"`` and raises without a GPU;
    ``device="cpu"`` runs the kernels' plain versions.
    """
    fmt_obj, fmt_key = _norm_fmt(fmt)
    if mode == "auto":
        mode = "nests" if module is not None else "dfg"
    if mode not in ("nests", "dfg"):
        raise ValueError(f"unknown cuda lowering mode {mode!r} "
                         f"(valid: auto, nests, dfg)")
    if mode == "nests" and module is None:
        raise ValueError("mode='nests' needs the source ModuleGraph "
                         "(compile through repro_torch.hls with an nn "
                         "model, or use mode='dfg')")
    dev = devices.resolve(device)
    plan = KernelPlan(mode=mode, use_kernels=dev.type == "cuda",
                      fmt=fmt_key)
    fmt_tuple = (fmt_obj.exp_bits, fmt_obj.man_bits) \
        if fmt_obj is not None else None
    if weights is None and module is not None:
        weights = module.weight_feeds()
    if mode == "dfg":
        return _dfg_runner(g, fmt_obj, fmt_key, fmt_tuple, dev, weights,
                           opcode_table or kreg.OPCODE_KERNELS, plan)

    if dev.type == "cuda":
        torch.set_float32_matmul_precision("highest")
        plan.notes.append("NLB scores/mix: torch.bmm at float32 matmul "
                          "precision 'highest' (no TF32)")
    with obs.span("emit.cuda", cat="cuda", mode=mode, fmt=fmt_key) as sp:
        core, weight_names, _ = _lower_module(
            module, fmt_obj=fmt_obj, fmt_tuple=fmt_tuple,
            nlb_flash=nlb_flash, plan=plan, device=dev)
        sp.set(kernels=sum(plan.kernels.values()),
               fallbacks=len(plan.fallbacks))
    _plan_metrics(plan)

    missing = [n for n in weight_names if n not in weights]
    if missing:
        raise KeyError(f"missing weight feeds {missing}")
    host = {name: _host_array(weights[name]) for name in weight_names}
    wdev = {name: torch.as_tensor(arr, dtype=torch.float32).to(dev)
            for name, arr in _normalize_weights(host, module).items()}

    in_name = module.input_name
    in_shape = tuple(module.input_shape)
    rank = len(in_shape)
    profiled = [False]   # first obs-enabled call runs the span'd twin

    def run(inputs):
        x = inputs
        if isinstance(inputs, dict):
            extra = sorted(set(inputs) - {in_name})
            if extra:
                raise ValueError(
                    f"feeds {extra}: the runner reads only the input "
                    f"memref {in_name!r}; weights are bound when it is "
                    f"built (weights=)")
            x = inputs[in_name]
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        if in_shape[0] == 1 and tuple(x.shape[1:]) == in_shape[1:]:
            pass                               # a natural (B, C, H, W) batch
        elif x.dim() == rank:                  # unbatched sample
            x = x[None]
        if in_shape[0] == 1:
            # collapse the loop-nest's per-sample singleton batch axis
            x = x.reshape((x.shape[0],) + in_shape[1:])
        x = x.contiguous()
        with torch.inference_mode():
            # the twin synchronises per step: never inside a graph capture
            if (obs.enabled() and not profiled[0]
                    and not devices.capturing(dev)):
                profiled[0] = True
                with obs.span("cuda.profile", cat="cuda", mode=mode):
                    return core.profile(x, wdev)
            return core(x, wdev)

    run.plan = plan
    run.device = dev
    return run


def _dfg_runner(g: Graph, fmt_obj, fmt_key, fmt_tuple, dev, weights,
                opcode_table, plan: KernelPlan) -> Callable:
    """The DFG tier's callable: bound weights on the device, rounded to
    ``fmt`` once, here; per call only the feeds move."""
    bound = {name: v for name, v in (weights or {}).items()
             if name in g.inputs}
    with obs.span("emit.cuda", cat="cuda", mode="dfg", fmt=fmt_key) as sp:
        core = _lower_dfg(g, fmt_obj=fmt_obj, fmt_tuple=fmt_tuple, dev=dev,
                          opcode_table=opcode_table, plan=plan, bound=bound)
        sp.set(segments=plan.n_segments, groups=plan.n_groups,
               stages=plan.n_stages, fused_scatters=plan.fused_scatters,
               fallbacks=len(plan.fallbacks))
    _plan_metrics(plan)
    profiled = [False]       # first obs-enabled call runs the span'd twin

    def run(feeds):
        if not isinstance(feeds, dict):
            raise TypeError("the DFG tier takes a feed dict (memref name "
                            "-> array or tensor)")
        with torch.inference_mode():
            # the twin synchronises per step: never inside a graph capture
            if (obs.enabled() and not profiled[0]
                    and not devices.capturing(dev)):
                profiled[0] = True
                with obs.span("cuda.profile", cat="cuda", mode="dfg"):
                    return core.profile(feeds)
            return core(feeds)

    run.plan = plan
    run.device = dev
    # what the runner launches, for checks that hold K4 to its plain version
    run.segments = core.segments
    run.prologue = core.prologue
    return run


def _host_array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, dtype=np.float32)


def _plan_metrics(plan: KernelPlan) -> None:
    """Lift the lowering plan's counts into the process metrics."""
    obs.inc("cuda.lowerings")
    obs.inc("cuda.segments", plan.n_segments)
    obs.inc("cuda.groups", plan.n_groups)
    obs.inc("cuda.scatter_elisions", plan.fused_scatters)
    obs.inc("cuda.fallbacks", len(plan.fallbacks))
    for kname, n in plan.kernels.items():
        obs.inc(f"cuda.kernel.{kname}", n)


def _normalize_weights(w: dict[str, np.ndarray], module) -> dict:
    """Unbatch weight feeds (the nest tier shares one weight set across the
    batch, like the tensor path).  A *varying* batched weight feed cannot
    be expressed as shared kernel weights — fail loudly.  Each
    ``Attention`` node also gets its q, k and v kernels side by side as
    ``{prefix}.qkv`` (D, 3*H*dh), the one weight of its projection launch.
    """
    from repro_torch.nn import graph as nng
    out = {}
    shapes = {}
    for n in module.nodes:
        sub = n.param_specs()
        if sub is None:
            continue
        for memref, path in n.weight_memrefs().items():
            leaf = sub
            for k in path:
                leaf = leaf[k]
            shapes[memref] = tuple(leaf.shape)
    for name, arr in w.items():
        want = shapes.get(name)
        if want is not None and arr.ndim == len(want) + 1:
            if arr.shape[0] > 1 and not np.all(arr == arr[0]):
                raise ValueError(
                    f"weight feed {name!r} varies across the batch; the "
                    f"nest-pattern tier shares one weight set — use "
                    f"mode='dfg' for per-sample weights")
            arr = arr[0]
        out[name] = arr
    for n in module.nodes:
        if isinstance(n, nng.Attention):
            out[f"{n.prefix}.qkv"] = np.concatenate(
                [out[f"{n.prefix}.{nm}.kernel"].reshape(n.d_model, -1)
                 for nm in ("q", "k", "v")], axis=1)
    return out
