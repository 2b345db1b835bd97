#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (``"phase": ...``):

1. device  — the card, its power limit, the torch/CUDA versions; TF32 off
             for matmuls and cuDNN convolutions.
2. build   — nvcc builds the CUDA kernels of ``src/repro_torch/csrc`` for
             sm_90a (registers and spills from ``-Xptxas -v``).
3. quantizer — the kernels' shared device quantiser against the torch and
             numpy quantisers, bit for bit, on 1M probe values per format.
4. kernels — each kernel against its plain PyTorch version on the card at
             every BraggNN(s=1, img=11) shape of the serving path, at
             batch 256 and at a ragged 100, in fp32 and at (5,4); per-call
             device times of kernel, plain version and one PyTorch library
             call, beside the least time the card could take.
5. slice   — ``hls.compile(braggnn.build(1, 11))`` with seeded weights,
             then ``Design.serve`` over 8 batches of 256 and one of 100
             through ``backend="cuda"`` (fp32 and (5,4)) and
             ``backend="tensor"``.  The plan, the kernels' launch counts and
             the outputs (against the numpy functional model, and against
             the same backend run on the CPU) are asserted.

Then the ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and
the last line ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before that line; so does a run without a CUDA device or without
the repository's ``src/repro_torch`` beside this script.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: the card's published peaks (H100 SXM data sheet): HBM bytes/s and
#: float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

BATCH, RAGGED, N_BATCHES, IMG, S = 256, 100, 8, 11, 1
#: kernel vs plain version: the same operands (the quantiser is bitwise
#: equal), fp32 sums taken in another order
KERNEL_RTOL = KERNEL_ATOL = 1e-5
#: scale of the softmax check's rows (see phase_kernels)
SOFTMAX_SCALE = 4.0
#: served outputs vs the numpy functional model: the nest tier sums in
#: another order than the DFG's reduction trees
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-5
N_CHECKED = 16          # samples per batch held against ``Design.run``
#: (5,4) served outputs vs the CPU run: the share that may differ (by at
#: most one (5,4) ulp); a missing or extra rounding moves far more
MAX_DIFFER_SHARE = 0.01
TIMED_RUNS = 120


class SmokeFailure(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def device_ms(torch, fn, runs: int = TIMED_RUNS, chunk: int = 20) -> float:
    """Median device time of ``fn()`` over ``runs`` CUDA-event-timed calls.

    The calls are queued in chunks behind a spin kernel that outlasts the
    host's enqueueing of the chunk, so the card runs them back to back and
    each pair of events brackets one call's device work, not the host's
    launch gaps.  Chunks keep each queue within the CUDA launch queue's
    depth.
    """
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    times: list[float] = []
    tries = 0
    while len(times) < runs:
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(chunk)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(chunk)]
        s0 = torch.cuda.Event(enable_timing=True)
        s1 = torch.cuda.Event(enable_timing=True)
        s0.record()
        torch.cuda._sleep(cycles)
        s1.record()
        t0 = time.perf_counter()
        for a, b in zip(starts, ends):
            a.record()
            fn()
            b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if s0.elapsed_time(s1) > host_ms:
            times.extend(a.elapsed_time(b) for a, b in zip(starts, ends))
            continue
        tries += 1
        check(tries < 8, "the host could not keep the card's queue full")
        cycles *= 2
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    info = {"phase": "device", "nvidia_smi": smi.stdout.strip(),
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                           "cudnn": torch.backends.cudnn.allow_tf32},
            "float32_matmul_precision":
                torch.get_float32_matmul_precision()}
    emit(info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    regs = [ln.strip() for ln in build.info.log.splitlines()
            if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": build.info.compiled, "library": build.info.path.name,
          "sources": [p.name for p in build.sources()], "ptxas": regs})


def phase_quantizer(torch) -> None:
    import numpy as np
    from repro_torch.core.precision import FORMATS, quantize, quantize_np
    from repro_torch.kernels.quantize import device_quantize, probe_values

    res = {}
    for key, fmt in FORMATS.items():
        x = probe_values(fmt, 1 << 20, seed=11)
        xd = torch.from_numpy(x).cuda()
        kern = device_quantize(xd, (fmt.exp_bits, fmt.man_bits))
        plain = quantize(xd, fmt)
        with np.errstate(over="ignore"):
            host = quantize_np(x, fmt)
        kb = kern.cpu().numpy().view(np.int32)
        bad_t = int((kb != plain.cpu().numpy().view(np.int32)).sum())
        bad_n = int((kb != host.view(np.int32)).sum())
        res[key] = {"values": int(x.size), "differ_from_torch": bad_t,
                    "differ_from_numpy": bad_n}
        check(bad_t == 0 and bad_n == 0,
              f"device quantiser differs bitwise at {key}: {res[key]}")
    emit({"phase": "quantizer", "formats": res})


def conv_calls(b: int) -> list[dict]:
    """conv2d_vmem's calls in one BraggNN(s=1, img=11) batch of ``b``."""
    c1, c2, h1 = 16 * S, 8 * S, IMG - 2
    spec = [("conv1", (b, 1, IMG, IMG), (c1, 1, 3, 3), True, False),
            ("nlb.theta", (b, c1, h1, h1), (c2, c1, 1, 1), False, False),
            ("nlb.phi", (b, c1, h1, h1), (c2, c1, 1, 1), False, False),
            ("nlb.g", (b, c1, h1, h1), (c2, c1, 1, 1), False, False),
            ("nlb.out", (b, c2, h1, h1), (c1, c2, 1, 1), False, False),
            ("conv2a", (b, c1, h1, h1), (c2, c1, 3, 3), True, True),
            ("conv2b", (b, c2, h1 - 2, h1 - 2), (2 * S, c2, 3, 3), True,
             True)]
    # nlb.out adds the block's input (B, c1, h1, h1) in its epilogue
    return [{"call": n, "x": x, "w": w, "bias": bias, "relu": relu,
             "residual": n == "nlb.out"}
            for n, x, w, bias, relu in spec]


def matmul_calls(b: int) -> list[dict]:
    dims = [2 * S * (IMG - 6) ** 2, 16 * S, 8 * S, 4 * S, 2]
    return [{"call": f"dense{i}", "m": b, "k": dims[i], "n": dims[i + 1]}
            for i in range(4)]


def softmax_calls(b: int) -> list[dict]:
    n = (IMG - 2) ** 2
    return [{"call": "nlb.softmax", "rows": b * n, "cols": n, "order": 8}]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def phase_kernels(torch) -> dict:
    """Hold each kernel against its plain version at the serving path's
    shapes; time kernel, plain version and library call at batch 256."""
    import torch.nn.functional as F
    from repro_torch.kernels.conv2d_vmem.conv2d_vmem import conv2d_vmem
    from repro_torch.kernels.conv2d_vmem.ref import conv2d_ref
    from repro_torch.kernels.fused_softmax.fused_softmax import \
        fused_softmax
    from repro_torch.kernels.fused_softmax.ref import fused_softmax_ref
    from repro_torch.kernels.smallfloat_matmul.ref import \
        smallfloat_matmul_ref
    from repro_torch.kernels.smallfloat_matmul.smallfloat_matmul import \
        smallfloat_matmul

    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    out = {}
    details = []

    def compare(name, call, b, fmt, got, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=KERNEL_RTOL,
                                 atol=KERNEL_ATOL))
        details.append({"kernel": name, "call": call, "batch": b,
                        "fmt": fmt, "max_abs_err": err, "ok": ok})
        check(ok, f"{name} {call} batch {b} fmt {fmt}: kernel differs from "
                  f"its plain version by {err}")
        rec = out.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                    "plain_ms": 0.0, "library_ms": 0.0,
                                    "bytes": 0.0, "flops": 0.0,
                                    "calls": []})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        return rec

    def timed(rec, call, nbytes, flops, kern, plain, lib):
        t = {"call": call, "ms": device_ms(torch, kern),
             "plain_ms": device_ms(torch, plain),
             "library_ms": device_ms(torch, lib)}
        t["bound_ms"], t["bound_by"] = bound(nbytes, flops)
        for k in ("ms", "plain_ms", "library_ms"):
            rec[k] += t[k]
        rec["bytes"] += nbytes
        rec["flops"] += flops
        rec["calls"].append(t)

    for b in (BATCH, RAGGED):
        for fmt in (None, (5, 4)):
            for c in conv_calls(b):
                x = randn(*c["x"])
                w = randn(*c["w"], scale=0.3)
                bias = randn(c["w"][0]) if c["bias"] else None
                ho = c["x"][2] - c["w"][2] + 1
                out_shape = (b, c["w"][0], ho, ho)
                res = randn(*out_shape) if c["residual"] else None
                # the serving path's arguments: the result rounded to fmt
                kw = {"fmt": fmt, "fuse_relu": c["relu"], "out_fmt": fmt,
                      "residual": res}
                rec = compare("conv2d_vmem", c["call"], b, fmt,
                              conv2d_vmem(x, w, bias, **kw),
                              conv2d_ref(x, w, bias, **kw))
                if b == BATCH and fmt is None:
                    n_out = b * c["w"][0] * ho * ho
                    nbytes = 4 * (x.numel() + w.numel() + c["w"][0] * (
                        c["bias"]) + n_out * (1 + c["residual"]))
                    flops = 2 * n_out * w[0].numel() + n_out * (
                        c["residual"])
                    # the library call: F.conv2d, plus the residual's add
                    # where the kernel fuses one
                    lib = ((lambda: torch.add(res, F.conv2d(x, w, bias)))
                           if res is not None else
                           (lambda: F.conv2d(x, w, bias)))
                    timed(rec, c["call"], nbytes, flops,
                          lambda: conv2d_vmem(x, w, bias, **kw),
                          lambda: conv2d_ref(x, w, bias, **kw), lib)
            for c in matmul_calls(b):
                x = torch.relu(randn(c["m"], c["k"]))
                wt = randn(c["n"], c["k"], scale=c["k"] ** -0.5)
                w = wt.T                    # the nest tier's W.T view
                bias = randn(c["n"], scale=0.1)
                eb, mb = fmt if fmt is not None else (None, None)
                kw = {"exp_bits": eb, "man_bits": mb, "fuse_relu": True,
                      "out_fmt": fmt}
                rec = compare("smallfloat_matmul", c["call"], b, fmt,
                              smallfloat_matmul(x, w, bias, **kw),
                              smallfloat_matmul_ref(x, w, bias, **kw))
                if b == BATCH and fmt is None:
                    m, k, n = c["m"], c["k"], c["n"]
                    nbytes = 4 * (m * k + k * n + n + m * n)
                    timed(rec, c["call"], nbytes, 2 * m * k * n,
                          lambda: smallfloat_matmul(x, w, bias, **kw),
                          lambda: smallfloat_matmul_ref(x, w, bias, **kw),
                          lambda: torch.addmm(bias, x, w))
        for c in softmax_calls(b):
            # scale 4: rows span about 20, so z / 4 reaches -5, where the
            # order-8 series is far from exp and a kernel that took the
            # true exp would fail the order-8 check below
            x = randn(c["rows"], c["cols"], scale=SOFTMAX_SCALE)
            for order in (c["order"], 0):
                for fmt in (None, (5, 4)):
                    kw = {"taylor_order": order, "range_reduce": 2,
                          "in_fmt": fmt}
                    rec = compare("fused_softmax",
                                  f"{c['call']}.order{order}", b, fmt,
                                  fused_softmax(x, **kw),
                                  fused_softmax_ref(x, **kw))
            taylor = fused_softmax(x, taylor_order=c["order"])
            true = fused_softmax_ref(x, taylor_order=0)
            gap = float((taylor - true).abs().max())
            rec["taylor_vs_exp"] = max(rec.get("taylor_vs_exp", 0.0), gap)
            check(not torch.allclose(taylor, true, rtol=KERNEL_RTOL,
                                     atol=100 * KERNEL_ATOL),
                  f"fused_softmax order {c['order']} agrees with the true "
                  f"exp within 100x the limit (max gap {gap}): the check "
                  f"cannot tell the Taylor series from exp")
            if b == BATCH:
                kw = {"taylor_order": c["order"], "range_reduce": 2}
                per_elem = 3 * c["order"] + 2 + 4   # Taylor + max/sub/sum/div
                nel = c["rows"] * c["cols"]
                timed(rec, c["call"], 8 * nel, per_elem * nel,
                      lambda: fused_softmax(x, **kw),
                      lambda: fused_softmax_ref(x, **kw),
                      lambda: torch.softmax(x, dim=-1))
    emit({"phase": "kernels", "tolerance": {"rtol": KERNEL_RTOL,
                                            "atol": KERNEL_ATOL},
          "softmax_taylor_vs_exp_max_gap":
              out["fused_softmax"]["taylor_vs_exp"],
          "checks": len(details), "worst": max(
              details, key=lambda d: d["max_abs_err"]),
          "per_call_at_batch": BATCH,
          "calls": {k: v["calls"] for k, v in out.items()}})
    return out


def phase_slice(torch) -> dict:
    import numpy as np
    import repro_torch.hls as hls
    from repro_torch.kernels import registry
    from repro_torch.models import braggnn
    from repro_torch.nn.module import init_tree

    model = braggnn.build(S, IMG)
    params = init_tree(model.specs(), torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    design = hls.compile(model.bind(params))
    compile_s = time.perf_counter() - t0
    emit({"phase": "compile", "seconds": compile_s,
          "timings": design.timings, "ops": len(design.graph_opt.ops),
          "values": design.graph_opt.n_values,
          "design_hash": design.design_hash[:16]})

    gen = torch.Generator().manual_seed(1)
    batches = [braggnn.synthetic_peaks(n, IMG, gen)[0]
               for n in [BATCH] * N_BATCHES + [RAGGED]]
    want_plan = {"conv2d_vmem": 2, "conv2d_vmem:relu": 2,
                 "fused_softmax": 1, "smallfloat_matmul:relu": 4}
    per_batch = {"conv2d_vmem": 7, "fused_softmax": 1,
                 "smallfloat_matmul": 4}
    runs = len(batches) + 1            # serve warms up on the first batch
    evaluated = [design.run(x[:N_CHECKED].numpy()) for x in batches]
    out_name = next(iter(evaluated[0]))
    launches = {}
    results = {}
    for backend, fmt in (("cuda", None), ("cuda", "5_4"), ("tensor", None)):
        tag = f"{backend}:{fmt or 'fp32'}"
        registry.reset_launch_counts()
        rep = design.serve(batches, backend=backend, fmt=fmt, collect=True)
        torch.cuda.synchronize()
        counts = registry.launch_counts()
        outs = [o[out_name] if isinstance(o, dict) else o
                for o in rep.outputs]
        check(all(tuple(o.shape[:1]) == (len(x),) and o.is_cuda
                  and bool(torch.isfinite(o).all())
                  for o, x in zip(outs, batches)),
              f"{tag}: outputs not finite CUDA tensors of the batch size")
        line = {"phase": "serve", "backend": backend, "fmt": fmt,
                "batches": rep.batches, "samples": rep.samples,
                "us_per_sample": rep.us_per_sample, "p50_ms": rep.p50_ms,
                "p99_ms": rep.p99_ms, "warmup_s": rep.warmup_s,
                "served": rep.served, "launches": counts}
        if backend == "cuda":
            fn = design.torch_fn(backend="cuda", fmt=fmt)
            check(fn.plan.kernels == want_plan and not fn.plan.fallbacks,
                  f"{tag}: plan {fn.plan.summary()}")
            want = {k: v * runs for k, v in per_batch.items()}
            check(counts == want, f"{tag}: launches {counts}, want {want}")
            if fmt is None:
                launches = counts
        else:
            check(not any(counts.values()),
                  f"tensor backend launched kernels: {counts}")
        if fmt is None and backend == "cuda":
            # fp32: against the numpy functional model of the design
            err = 0.0
            for o, ref in zip(outs, evaluated):
                got = o[:N_CHECKED].reshape(ref[out_name].shape).cpu()
                err = max(err, float(np.abs(got.numpy()
                                            - ref[out_name]).max()))
                check(np.allclose(got.numpy(), ref[out_name],
                                  rtol=SLICE_RTOL, atol=SLICE_ATOL),
                      f"{tag}: differs from Design.run by {err}")
            line["vs_evaluate"] = {"max_abs_err": err, "rtol": SLICE_RTOL,
                                   "atol": SLICE_ATOL,
                                   "samples_per_batch": N_CHECKED}
        else:
            # the same backend on the CPU (the kernels' plain versions)
            cpu = design.serve([x[:N_CHECKED] for x in batches],
                               backend=backend, fmt=fmt, device="cpu",
                               collect=True)
            err, scale, n_diff, n_all = 0.0, 0.0, 0, 0
            for o, c in zip(outs, cpu.outputs):
                c = c[out_name] if isinstance(c, dict) else c
                got = o[:N_CHECKED].cpu().reshape(c.shape)
                err = max(err, float((got - c).abs().max()))
                scale = max(scale, float(c.abs().max()))
                n_diff += int((got != c).sum())
                n_all += c.numel()
            # (5,4): the operands of every sum are on the (5,4) lattice, so
            # most fp32 sums are exact in any order and the two runs agree
            # bit for bit; only a sum that is not exact (the softmax's, the
            # mix) can land a later rounding one (5,4) ulp apart
            tol = (2.0 ** (np.floor(np.log2(max(scale, 2 ** -14))) - 4)
                   if fmt else SLICE_ATOL + SLICE_RTOL * scale)
            check(err <= tol, f"{tag}: differs from the CPU run by {err} "
                              f"(tolerance {tol})")
            if fmt:
                check(n_diff <= MAX_DIFFER_SHARE * n_all,
                      f"{tag}: {n_diff} of {n_all} outputs differ from the "
                      f"CPU run")
            line["vs_cpu"] = {"max_abs_err": err, "tolerance": tol,
                              "outputs_differing": n_diff,
                              "outputs": n_all, "output_scale": scale,
                              "samples_per_batch": N_CHECKED}
        emit(line)
        results[tag] = line
    for fmt in (None, "5_4"):
        phase_profile(torch, design, batches[0], fmt)
    return {"launches": launches, "serve": results}


def phase_profile(torch, design, x, fmt, reps: int = 5) -> None:
    """Where one batch's time goes: ``torch.profiler`` over ``reps``
    batches of the cuda backend at ``fmt``, after the counted runs.  Device
    time and launches by kernel name, the device's busy and idle share of
    the host's wall time, and the host time per batch."""
    from torch.profiler import ProfilerActivity, profile
    fn = design.torch_fn(backend="cuda", fmt=fmt)
    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(x)
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []
    for e in prof.key_averages():
        # device-side events only: a host op (aten::bmm) also reports its
        # kernels' time as its own, which would count them twice; CUPTI's
        # own buffer requests are the profiler's cost, not the batch's
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.key == "Activity Buffer Request":
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            kernels.append({"name": e.key[:90], "calls": e.count / reps,
                            "device_us_per_batch": dev_us / reps})
    kernels.sort(key=lambda k: -k["device_us_per_batch"])
    busy = sum(k["device_us_per_batch"] for k in kernels)
    emit({"phase": "profile", "fmt": fmt, "batch": int(x.shape[0]),
          "reps": reps,
          "device_launches_per_batch": sum(k["calls"] for k in kernels),
          "host_us_per_batch": wall_us / reps,
          "device_busy_us_per_batch": busy,
          "device_idle_share": (1.0 - busy * reps / wall_us
                                if kernels else None),
          "device_time_seen": bool(kernels), "kernels": kernels})


KERNEL_META = {
    "conv2d_vmem": ("src/repro_torch/csrc/conv2d_vmem.cu",
                    "src/repro/kernels/conv2d_vmem/conv2d_vmem.py:82"),
    "fused_softmax": ("src/repro_torch/csrc/fused_softmax.cu",
                      "src/repro/kernels/fused_softmax/fused_softmax.py:52"),
    "smallfloat_matmul": (
        "src/repro_torch/csrc/smallfloat_matmul.cu",
        "src/repro/kernels/smallfloat_matmul/smallfloat_matmul.py:111"),
}


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: FAIL: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    try:
        dev = phase_device(torch)
        phase_build()
        phase_quantizer(torch)
        kern = phase_kernels(torch)
        sl = phase_slice(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    rows = []
    for name, (source, replaces) in KERNEL_META.items():
        rec = kern[name]
        bound_ms, bound_by = bound(rec["bytes"], rec["flops"])
        n = sl["launches"].get(name, 0)
        if n == 0:
            print(f"chip_smoke: FAIL: {name} was not launched on the main "
                  f"path", file=sys.stderr)
            return 1
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": n,
                     "max_abs_err": rec["max_abs_err"],
                     "tolerance": {"rtol": KERNEL_RTOL,
                                   "atol": KERNEL_ATOL},
                     "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": rec["library_ms"],
                     "per": f"one batch of {BATCH}: the sum over the "
                            f"kernel's {len(rec['calls'])} calls"})
    emit({"kernels": rows})
    print(dev["nvidia_smi"])
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
