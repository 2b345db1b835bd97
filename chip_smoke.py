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
4. compile — ``hls.compile(braggnn.build(1, 11))`` with seeded weights.
5. kernels — each kernel against its plain PyTorch version on the card at
             the shapes its serving path gives it, at batch 256 and at a
             ragged 100: K1 and K2 at every BraggNN(s=1, img=11) call in
             fp32 and at (5,4); K3 as the nest tier launches it, one chain
             over the four dense layers (fp32 and (5,4); also value for
             value against its layers launched one at a time), and one
             large single layer; K4, the design's DFG segment, value for
             value in fp32 and at (5,4); K5 at the NLB shape on the NLB's
             strided views, at head dims 24, 40 and 128, and at one
             transformer case (causal, window, soft-cap).  Device times of
             kernel, plain version and one PyTorch library call, beside the
             least time the card could take.
6. slice   — ``Design.serve`` over 8 batches of 256 and one of 100 through
             ``backend="cuda"`` (fp32 and (5,4)), ``backend="tensor"`` and
             the NLB flash mode (``cuda_kw={"nlb_flash": True}``); over two
             batches of 256 and one of 100 through the generic DFG tier
             (``cuda_kw={"mode": "dfg"}``, fp32 and (5,4)) and
             ``backend="simd"``; then ``design.verify()`` on the card.  The
             plans, the kernels' launch counts and the outputs (against the
             numpy functional model, and against the same backend run on
             the CPU) are asserted.
7. wide    — BraggNN(s=3, img=11), whose NLB head dim is 24, served in
             the NLB flash mode and held to its CPU run and to
             ``Design.run``.
8. profile — ``torch.profiler`` over a few batches of the nest tier (fp32,
             (5,4)), of its NLB flash mode (fp32) and of the DFG tier
             (fp32, (5,4)): device operations and time per batch.
9. graphs  — the serving runner's captured CUDA graphs on every path (nest
             fp32 and (5,4), the flash mode, the DFG tier fp32 and (5,4),
             ``simd``, ``tensor``): at batch 256 and the ragged 100 a replay
             equals the eager runner value for value and launches what an
             eager batch launches; ``Design.serve`` p50 and p99 over 200
             batches of 256; the profiler over replayed batches.
10. engine — ``DesignEngine`` (nest fp32, ``default_buckets(256)``,
             threaded) over 4,096 requests, equal to ``Design.serve``
             bitwise; then the same run with one poisoned dispatch, and
             with two, each restarting the replica from a saved artifact.
11. trigger — ``check_budget(part="alveo_u280")``; ``TriggerLoop`` over
             2,000 frames of ``DetectorFeed(img=11, seed=11)`` at windows 1
             and 64, against the same loop on the CPU; then in real time at
             the feed's 1 kHz against a stated deadline.
12. transformer — the transformer encoder block at full width (seq 16,
             d_model 64, 4 heads, ffn 256): ``hls.compile``; the nest tier
             (K3 for the projections and the MLP, K2; fp32 and (5,4)), its
             flash mode (K3, K5), ``tensor`` and the DFG tier (K4; fp32 and
             (5,4)) served over batches of 256 and a ragged 100, launch
             counts and outputs held, each path's replay against its eager
             run, p50/p99 and device operations per batch; the block's
             kernel calls against their plain versions, timed;
             ``design.verify()`` on the card.
13. tune   — ``Design.tune`` on BraggNN(s=1, img=11): the dry bisection
             over ``braggnn_space()``, its rerun served from the TuningDB,
             measure mode timing each candidate's DFG tier (K4) on the
             card; ``apply_tuned`` and the tuned design served at its
             precision, held to ``Design.run``.
14. train  — ``ste_quantize`` on the card (the device quantiser, bitwise;
             the identity gradient); BraggNN(s=1, img=11) trained with the
             reference convergence test's recipe (200 AdamW steps at batch
             64, each replayed from the step's captured CUDA graph), its
             held-out loss drop, step times and one step profiled replayed
             and eager, its first 20 steps against the same steps on the
             CPU; under deterministic cuDNN/cuBLAS 5 replayed steps against
             the eager step, losses and state bit for bit; the
             Fig. 7 exponent histogram and the pixel error at fp32, (5,11),
             (5,4), (5,3); the trained weights bound, compiled and served
             through the nest tier (fp32, (5,4)), the NLB flash mode and
             the DFG tier at (5,4), held as phase serve holds them; the
             ``TrainingDriver`` with a failure injected, bit for bit
             against an uninterrupted run; ``examples/quickstart``,
             ``examples/braggnn_serve`` (``--save``, then ``--load
             --engine``) and ``examples/train_lm --steps 40`` (lm-100m,
             a failure injected at step 20: one restart, the loss
             falls).
15. lm     — the decoder LM's serving path at Qwen2.5-3B's full width
             (3,085,938,688 parameters drawn on the card from a seed,
             bf16 activations, nothing cut): K5 at the LM's shapes (B*H
             64, S 1,024, D 128, causal; S 333 with window 128 and cap 50)
             against its plain version, beside SDPA and the bound;
             ``lm.prefill`` at batch 4 x 1,024 timed, profiled and counted
             (36 K5 launches a call, nothing else of the port's);
             ``forward`` against 64 cached decode steps (1% of the logit
             scale); one 8-lane decode tick replayed from its captured
             graph against the eager step (tokens, logits and cache value
             for value), both profiled; ``ServingEngine`` (8 lanes,
             max_len 1,024, its step a captured graph) over 32 requests of
             16-256 prompt tokens and 64 new tokens, and one of them again
             alone; the card against the CPU at two layers (2% of the
             logit scale); ``python -m repro_torch.launch.serve --arch
             qwen2.5-3b --no-tiny --requests 8`` in a subprocess.
16. moe    — the MoE family's serving path: K5 at Mixtral's prefill shape
             (B*H 128, S 1,024, D 128, window 4,096) against its plain
             version, beside SDPA and the bound; qwen2-moe-a2.7b at its
             published width and depth (15,146,452,992 parameters drawn on
             the card, nothing cut): ``lm.prefill`` at 4 x 1,024 timed,
             profiled and counted (24 K5 launches a call, nothing else of
             the port's), one 8-lane decode tick replayed against eager
             and profiled, the share of routed assignments kept within
             the capacity in both, ``forward`` against 64 cached decode
             steps at ``capacity_factor = n_experts`` (dropless, 1%), the
             engine over the lm phase's 32 requests, the card against the
             CPU at two layers (2%), the launcher's CLI at ``--no-tiny``
             and ``examples/serve_moe`` in subprocesses; Mixtral-8x7b at
             full width cut to 4 of its 32 layers (prefill with 4 K5
             launches, 16 engine ticks); the kept shares held to 0.933
             (qwen2-moe) and 0.996 (Mixtral).
17. recurrent — the RG-LRU hybrid at RecurrentGemma-9b's published width
             and depth (8,578,519,040 parameters drawn on the card,
             nothing cut), after the MoE weights are freed: K5 at its
             prefill shape (B*H 32, S 4,096, D 256, window 2,048) against
             its plain version, beside SDPA with the window as a boolean
             mask and the bound; ``lm.prefill`` at 2 x 4,096 timed,
             profiled and counted (12 K5 launches a call, nothing else of
             the port's); one 8-lane decode tick replayed against eager
             (tokens, logits, and every cache leaf ``h``, ``conv``, ``k``,
             ``v``, ``kpos`` value for value); ``forward`` against 64
             cached decode steps (1%); the engine over the lm phase's 32
             requests, one of them served again alone and held equal;
             the card against the CPU at one superblock (2%); ``python -m
             repro_torch.launch.serve --arch recurrentgemma-9b --no-tiny
             --requests 8`` in a subprocess.
18. xlstm  — xLSTM at xlstm-1.3b's published width and depth
             (3,503,016,272 parameters drawn on the card, nothing cut:
             42 mLSTM and 6 sLSTM layers), after the previous weights are
             freed: the sLSTM kernel (``slstm_scan``, one launch per layer
             call) against its plain step loop at the prefill's call (B 4,
             S 1,024, H 4, W 512) and the tick's (B 8, S 1), hs and the
             state, beside the bound; ``lm.prefill`` at 4 x 1,024 timed,
             profiled and counted (6 sLSTM kernel launches a call,
             nothing else of the port's); one 8-lane decode tick replayed
             against eager (tokens, logits, every cache leaf; 6 kernel
             launches a replay); ``forward`` against 64 cached decode
             steps (1%); the engine over the lm phase's 32 requests, one
             of them served again alone and held equal;
             the card against the CPU at one superblock (8 layers, 2%);
             ``python -m repro_torch.launch.serve --arch xlstm-1.3b
             --no-tiny --requests 8`` in a subprocess.
19. encdec — the encoder-decoder at whisper-tiny's published width and
             depth (38,599,680 parameters, nothing cut): K5 at the
             encoder's shape (B*H 48, S 1,500, D 64, non-causal) against
             its plain version, beside SDPA and the bound; ``encode`` over
             8 x 1,500 seeded frames timed, profiled and counted (4 K5
             launches a call); ``decode_forward`` (4 K5 launches) against
             64 steps replayed from ``step_runner``'s captured graph (1%),
             each replay against the eager step value for value (tokens,
             logits, the KV cache); the card against the CPU at full width
             (2%); ``generate``: 64 greedy tokens for 8 sequences from a
             4-token prompt, its steps timed.
20. vlm    — Qwen2-VL at qwen2-vl-2b's published width and depth
             (1,543,715,840 parameters drawn on the card, nothing cut):
             K5 at its prefill's shape (B*H 48, S 2,048, D 128, causal)
             against its plain version, beside SDPA and the bound;
             ``lm.prefill`` of 4 x (1,024 seeded patch embeddings + 1,024
             tokens) timed, profiled and counted (28 K5 launches a call,
             nothing else of the port's); ``forward`` against 64 cached
             decode steps on text (1%); the engine at 8 lanes over 16 text
             requests; the card against the CPU at two layers with the
             1,024 patches in front of 256 tokens (2%).
21. train_lm — the LM's training: one attention layer at Qwen2.5-3B's
             microbatch shape (B 1, S 1,024, 16 heads over 2, D 128,
             causal, fp32): K5's forward with the rows' log-sum-exp and
             the torch backward against autograd through
             ``full_attention`` (rtol 1e-4 / atol 1e-5), the lse against
             the plain version, the forward, the backward and SDPA's
             forward and forward + backward timed, K5 at the LM prefill's
             shape with and without the lse store; the training loss at
             the same microbatch (1,024 positions over 151,936 words):
             ``lm.next_token_loss`` against ``log_softmax`` and
             ``nll_loss``, forward and backward timed with the memory
             each adds (loss 1e-5, gradient 1e-6); Qwen2.5-3B trained at
             full width and depth (3,085,938,688 parameters drawn on the
             card, batch 4 x 1,024 of ``SyntheticTokenPipeline`` tokens in
             4 microbatches, full remat, AdamW in place): the first call
             (an eager step, then the capture) with its loss held to the
             no-grad forward's, and the first microbatch's loss over its
             first 64 positions held to the CPU's at full depth
             (1.5e-4 relative), 5 replayed
             steps timed (finite losses, the parameters moved, 288 K5
             launches a step and nothing else of the port's), tokens/s,
             6·N·tokens over the step time against the bf16 dense peak,
             peak memory, one step profiled; 2 replayed steps against 2
             eager ones at 4 layers of the same width under deterministic
             algorithms (losses, parameters and moments value for value);
             one step on the card against the CPU at 2 layers, B 1 x 256
             (loss 1e-4, grad norm 2%, each gradient leaf within 5% of
             its max |gradient|); whisper-tiny's training steps
             (finite losses, K5 launches per step); xLSTM's training: the
             sLSTM's backward kernel (``slstm_scan_backward``) against
             its plain reverse loop on the forward kernel's saves at
             xlstm-1.3b's training call (B 1, S 1,024, H 4, W 512) and a
             ragged one (W 36), timed beside the plain loop and the
             bound, the forward timed with and without its saves;
             xlstm-1.3b trained at full width (3,503,016,272 parameters
             checked) cut to 16 of 48 layers (2 of 6 superblocks), batch
             8 x 1,024 in 8 microbatches, full remat:
             the first call with its loss held to the no-grad forward's,
             3 replayed steps timed (32 forward and 16 backward sLSTM
             launches a step and nothing else of the port's), one
             profiled; 2 replayed steps against 2 eager ones at one
             superblock (8 layers, 2 microbatches) under deterministic
             algorithms; ``lm.train_loss``'s loss and gradients on the
             card against the CPU at one superblock, with fp32
             activations (loss 1e-4, grad norm 2%,
             each gradient leaf within 5% of its max |gradient|, floored
             at 1e-3 of the largest: the sLSTM's input-gate bias has a
             zero gradient), then with the config's bf16 activations
             beside a witness of bf16's own noise (the CPU run again on
             one intra-op thread): loss, grad norm and worst leaf each
             within max(the fp32 bar, 2x the witness's reading).
22. mesh   — the sharded pieces on a 1 x 1 (data, model) NCCL mesh:
             Qwen2.5-3B at full width cut to 4 layers (619,474,944
             parameters; two full-depth states side by side do not fit),
             its parameters and AdamW state sharded by
             ``model_param_shardings`` and ``state_axes`` (no leaf
             copied), the split batch by ``input_axes``; under
             deterministic algorithms the sharded step (first call, then
             replays of its captured graph, the NCCL collectives inside)
             against the unsharded step from the same seed, 3 calls
             each, metrics and every parameter and moment value for
             value, without and then with ``grad_compression``; 32 K5
             launches per replayed sharded step and nothing else of the
             port's; 5 replays of each timed, tokens/s, the peak memory
             each step adds, held within 5%; ``compressed_psum`` over
             ``data`` on the embedding table against its one-rank value,
             the dequantised int8, bit for bit; ``reshard_checkpoint`` of
             tiny Qwen2.5-3B's saved state onto the mesh, bit for bit.
23. moe_mesh — expert routing over a sharded batch on a 1 x 1 NCCL mesh:
             qwen2-moe-a2.7b at full width cut to 2 layers (1,832,675,328
             parameters), batch 4 x 1,024 in 4 microbatches, its state
             sharded; under deterministic algorithms the sharded step,
             whose MoE layers route each rank's rows through
             ``nn.moe.batch_shard`` (counts and probabilities summed over
             the data axis inside the captured graph), against the
             unsharded step from the same seed, 3 calls each, metrics and
             every parameter and moment value for value; 16 K5 launches
             per replayed sharded step; p50 and peak memory side by side.
24. serve_mesh — data-parallel prefill and decode on a 1 x 1 NCCL mesh,
             under deterministic algorithms, the sharded parameters the
             unsharded tensors (``shard_tree`` copies nothing): Qwen2.5-3B
             at full width and depth, the sharded prefill at 4 x 1,024
             (first call, then 5 replays of its captured graph) against
             ``lm.prefill`` on the same tensors value for value, 36 K5
             launches per replay and nothing else; 16 ticks of the sharded
             8-lane serve step (replayed) against 16 unsharded ticks from
             the same zero cache, tokens, logits and every cache leaf value
             for value; p50 of each beside the other; one eager call of
             each, its peak memory and launches for phase dryrun; all
             of it through the split plan over the head width.
             qwen2-vl-2b cut to 4 layers: its prefill of 4 x (1,024
             patches + 1,024 tokens) against ``lm.prefill`` value for
             value, 4 K5 launches per replay.  For both, the attention's
             path over the head width's rows (which one rank does not
             take) called alone at their prefill shapes in a model shard
             that splits ``head_dim`` one way, against the unsplit RoPE
             and K5 value for value, one K5 launch a call.
             qwen2-moe-a2.7b cut to 2 layers: its tick, the counts
             exchange inside the graph, held the same way, its kept share
             the unsharded tick's.  recurrentgemma-9b cut to one
             superblock: its tick (the ``h``, ``conv``, ``k``, ``v`` and
             ``kpos`` leaves).  whisper-tiny: the prefill (encode and
             decode, 8 K5 launches) and its tick.
25. tp     — tensor parallelism over ``model`` (the split plan,
             ``nn.tensor_parallel``) on a 1 x 1 NCCL mesh, under
             deterministic algorithms: gemma2-27b at full width, whose
             default rules split its attention, MLP and vocabulary over
             ``model`` (kept at extent 1 here).  The train step cut to 2
             layers (one local, one global; 2,312,151,552 parameters),
             4 x 1,024 in 4 microbatches: the sharded step (first call,
             then replays of its captured graph, the model-group
             all-reduces inside) against the unsharded one from the same
             seed, run one after the other (two states do not fit: the
             first's parameters and first moments stay on the card, its
             second moments wait on the host), 3 calls, metrics and every
             parameter and moment value for value; 16 K5 launches per
             replayed step; peaks above what each run found on the card
             within 5%;
             p50 of each.  The prefill cut to 4 layers at 4 x 1,024
             (replayed, 4 K5 launches) against the unsharded one, and 16
             replayed 8-lane ticks against 16 unsharded ones: tokens,
             logits and every cache leaf value for value.
26. dryrun — phase mesh's step traced by ``launch.dryrun`` on fake CUDA
             tensors over a 1 x 1 fake world: its predicted peak within
             15% of the card's eager step's (run once after
             ``reset_peak_memory_stats``), its K5 launches equal to the
             eager step's and phase mesh's 32, the launch counters
             untouched by the fake kernels, the rate its FLOPs imply at
             phase mesh's p50; the reference test's tiny cell (gemma2-27b
             on a 2 x 2 x 2 fake world) traced "ok"; Qwen2.5-3B's sharded
             prefill and serve step (phase serve_mesh's shapes, full
             depth) traced on the 1 x 1 fake world, each predicted peak
             within 15% of phase serve_mesh's eager call's and its
             launches equal to that call's; the split plan's serving
             cells on the 16 x 16 fake world (``DRY_TP_CELLS``: ten
             ``prefill_32k`` and ``decode_32k`` cells of seven configs),
             traced by the dry-run's CLI in one process each, all at once
             beside the rest of the phase: each fits in 80 GB with nothing
             gathered, gemma2-27b's prefill FLOPs per device within 10% of
             a sixteenth of the gather plan's, qwen2-7b's at most 1.1 x
             the split by rows.

Then the script's seconds, the ``{"kernels": [...]}`` line, the card's
``nvidia-smi`` line, and
the last line ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before that line; so does a run without a CUDA device or without
the repository's ``src/repro_torch`` beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
#: the wide BraggNN served in the NLB flash mode (head dim 8 * WIDE_S)
WIDE_S = 3
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
#: K5 vs its plain version: the reference's own kernel-vs-oracle tolerance
FLASH_RTOL = FLASH_ATOL = 1e-4
#: the NLB flash mode (true exp) vs the Taylor functional model
FLASH_VS_TAYLOR_ATOL = 5e-2
#: the nest tier's plan on BraggNN, and its launches per batch (the four
#: dense layers are one K3 chain launch)
NEST_PLAN = {"conv2d_vmem": 2, "conv2d_vmem:relu": 2, "fused_softmax": 1,
             "smallfloat_matmul:relu": 4}
NEST_PER_BATCH = {"conv2d_vmem": 7, "fused_softmax": 1,
                  "smallfloat_matmul": 1}
#: batches for the DFG tier and simd: two of 256 and the ragged 100
DFG_BATCHES = (0, 1, -1)
#: the DFG tier's plan at img 11: segments, groups, elided scatters
DFG_PLAN = (1, 138, 68)
#: the serving paths whose runners capture CUDA graphs: (label, backend,
#: fmt, cuda_kw)
GRAPH_PATHS = (("nest fp32", "cuda", None, None),
               ("nest 5_4", "cuda", "5_4", None),
               ("flash fp32", "cuda", None, {"nlb_flash": True}),
               ("dfg fp32", "cuda", None, {"mode": "dfg"}),
               ("dfg 5_4", "cuda", "5_4", {"mode": "dfg"}),
               ("simd", "simd", None, None),
               ("tensor", "tensor", None, None))
#: batches of 256 each captured path serves for its p50 and p99
GRAPH_SERVE_BATCHES = 200
#: the engine's load: requests, its bucket ceiling, and its deadline
#: trigger (long enough that the size trigger cuts every dispatch)
ENGINE_REQUESTS, ENGINE_MAX_BATCH, ENGINE_DELAY_MS = 4096, 256, 50.0
#: the trigger's stream: frames per run, the windows, and the decision
#: deadline in real time (one frame period of the 1 kHz feed)
TRIGGER_FRAMES, TRIGGER_WINDOWS, TRIGGER_DEADLINE_US = 2000, (1, 64), 1000.0
#: card vs CPU trigger decisions may differ only this close to the
#: threshold (relative to max(1, |threshold|))
DECISION_BAND = 1e-4
#: phase train: the recipe of the reference's convergence test (steps and
#: batch), its bar (the held-out loss drops by more than 5x), and the
#: steps run again on the CPU from the same init and batches
TRAIN_STEPS, TRAIN_BATCH, TRAIN_MIN_DROP, TRAIN_CPU_STEPS = 200, 64, 5.0, 20
#: card against CPU losses over those steps: the same operands, summed in
#: another order by cuDNN/cuBLAS than by ATen on the CPU, and Adam's
#: normalised update amplifies the differences where a gradient is near 0
TRAIN_LOSS_RTOL = 1e-3
#: the TrainingDriver's run: steps, a checkpoint every so many, and the
#: step a failure is injected at
DRIVER_STEPS, DRIVER_EVERY, DRIVER_FAIL_AT = 12, 4, 7
#: steps of the captured training step held against the eager one
GRAPHED_STEPS = 5


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

#: timing method per label where ``device_ms`` could not queue the calls
#: behind a spin (the function waits for the card)
TIMING_NOTES: dict = {}


def device_ms(torch, fn, runs: int = TIMED_RUNS, chunk: int = 20,
              label: str = "") -> float:
    """Median device time of ``fn()`` over ``runs`` CUDA-event-timed calls.

    The calls are queued in chunks behind a spin kernel that outlasts the
    host's enqueueing of the chunk, so the card runs them back to back and
    each pair of events brackets one call's device work, not the host's
    launch gaps.  A spin that ends too soon is lengthened in proportion to
    the host's time and the chunk is timed again.  Chunks keep each queue
    within the CUDA launch queue's depth.  A function that waits for the
    card (the host's time then follows the spin's) cannot be queued: it
    is timed call by call between events, host gaps included, and the
    operation that waits is recorded in ``TIMING_NOTES``.
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
        spin_ms = s0.elapsed_time(s1)
        if spin_ms > host_ms:
            times.extend(a.elapsed_time(b) for a, b in zip(starts, ends))
            continue
        tries += 1
        if tries >= 2 and spin_ms > 0.9 * host_ms:
            return _blocking_ms(torch, fn, runs, label)
        check(tries < 6, f"{label}: the host could not keep the card's "
                         f"queue full (spin {spin_ms:.3f} ms, host "
                         f"{host_ms:.3f} ms per chunk of {chunk})")
        cycles = int(cycles * 2.0 * host_ms / max(spin_ms, 1e-3)) + 1
    return statistics.median(times)


def _blocking_ms(torch, fn, runs: int, label: str) -> float:
    """Per-call event timing of a function that waits for the card, and
    where it waits (``torch.cuda.set_sync_debug_mode``)."""
    import traceback
    torch.cuda.synchronize()
    where = "not found"
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError:
        frames = traceback.extract_tb(sys.exc_info()[2])
        where = " <- ".join(f"{Path(f.filename).name}:{f.lineno}"
                            for f in reversed(frames[-3:]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    TIMING_NOTES[label] = {"method": "events per call, host gaps "
                                     "included: the host's enqueueing "
                                     "follows the card (a wait, or more "
                                     "launches than the queue holds)",
                           "waits_at": where}
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
                torch.get_float32_matmul_precision(),
            "cublas_workspace_config":
                os.environ.get("CUBLAS_WORKSPACE_CONFIG")}
    emit(info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    # ptxas -v: each entry function's registers and spills, by name
    regs, fn, spills = [], "", ""
    for ln in build.info.log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "spill" in ln:
            spills = ln.strip()
        elif "registers" in ln:
            regs.append(f"{fn}: {ln.split(':', 1)[1].strip()}; {spills}")
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


def dense_dims(s: int) -> list[int]:
    """BraggNN(s, img=11)'s dense chain: 50 -> 16 -> 8 -> 4 -> 2 at s=1."""
    return [2 * s * (IMG - 6) ** 2, 16 * s, 8 * s, 4 * s, 2]


def softmax_calls(b: int) -> list[dict]:
    n = (IMG - 2) ** 2
    return [{"call": "nlb.softmax", "rows": b * n, "cols": n, "order": 8}]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def value_diff(torch, a, b) -> int:
    """Values of ``a`` and ``b`` that differ, NaN equal to NaN and a zero's
    sign not counted."""
    return int(((a != b) & ~(torch.isnan(a) & torch.isnan(b))).sum())


def dfg_segment_case(torch, design, feeds, fmt) -> dict:
    """The design's DFG segment as the DFG tier's runner launches it on
    the batch ``feeds``: the runner's own prologue buffer, index vector and
    descriptor table (and the table on the host, for the plain version),
    and the least traffic the segment needs: each slot it gathers and no
    group of it writes read once, each slot it scatters written once (the
    elided scatters are not written), the index spans it reads and the
    table read once.  ``bytes_every_scatter`` keeps the earlier definition,
    every group's results written and every index read, to compare with
    the rows of the kernel before forwarding."""
    import numpy as np
    from repro_torch.core.precision import FORMATS
    from repro_torch.kernels.dfg_segment.dfg_segment import (
        COL_SLOT, FLAG_ELIDED, FLAG_RECOMPUTE, FLAG_STAGE, SEGMENT_OPCODES)

    fn = design.torch_fn(backend="cuda", mode="dfg", fmt=fmt)
    check(len(fn.segments) == 1 and not fn.plan.fallbacks,
          f"the DFG tier's plan is {fn.plan.summary()}, not one segment")
    idx, desc = fn.segments[0]
    buf, b = fn.prologue(feeds)
    rows = desc.cpu().numpy()
    idx_np = idx.cpu().numpy()
    n_values = buf.shape[0]
    reads, writes, scatters, spans, flops = [], [], [], [], 0
    for row in rows.tolist():
        op, arity, offs, roff, n, flags = (row[0], row[1], row[2:5], row[5],
                                           row[6], row[7])
        for o, slot in zip(offs[:arity], row[COL_SLOT:COL_SLOT + arity]):
            if slot < 0:
                spans.append(idx_np[o:o + n])
        if not flags & FLAG_ELIDED:
            scatters.append(idx_np[roff:roff + n])
            spans.append(scatters[-1])
        if flags & FLAG_RECOMPUTE:
            continue
        reads += [idx_np[o:o + n] for o in offs[:arity]]
        writes.append(idx_np[roff:roff + n])
        oc = SEGMENT_OPCODES[op]
        if oc not in ("load", "store", "copy"):
            flops += b * n * (2 if oc == "fmac" else 1)
    out = np.unique(np.concatenate(writes))
    out = out[out < n_values]
    read = np.setdiff1d(np.concatenate(reads), out)
    kept = np.unique(np.concatenate(scatters))
    kept = kept[kept < n_values]
    fo = FORMATS[fmt] if fmt else None
    return {"buf": buf, "batch": b, "idx": idx, "desc": desc,
            "desc_host": torch.from_numpy(rows),
            "fmt": (fo.exp_bits, fo.man_bits) if fo is not None else None,
            "bytes": 4 * b * (read.size + kept.size) + 4 * (
                sum(s.size for s in spans) + rows.size),
            "bytes_every_scatter": 4 * b * (read.size + out.size) + 4 * (
                idx_np.size + rows.size),
            "gather_bytes": 4 * b * idx_np.size, "flops": flops,
            "groups": fn.plan.n_groups, "entries": len(rows),
            "stages": int(((rows[:, 7] & FLAG_STAGE) != 0).sum()),
            "elided": fn.plan.fused_scatters,
            "recomputed": int(((rows[:, 7] & FLAG_RECOMPUTE) != 0).sum()),
            "indices": int(idx_np.size)}


def phase_kernels(torch, design) -> dict:
    """Hold each kernel against its plain version at the serving path's
    shapes; time kernel, plain version and library call at batch 256."""
    import torch.nn.functional as F
    from repro_torch.kernels.conv2d_vmem.conv2d_vmem import conv2d_vmem
    from repro_torch.kernels.conv2d_vmem.ref import conv2d_ref
    from repro_torch.kernels.fused_softmax.fused_softmax import \
        fused_softmax
    from repro_torch.kernels.fused_softmax.ref import fused_softmax_ref
    from repro_torch.kernels.smallfloat_matmul.ref import (
        Dense, smallfloat_matmul_chain_ref, smallfloat_matmul_ref)
    from repro_torch.kernels.smallfloat_matmul.smallfloat_matmul import (
        smallfloat_matmul, smallfloat_matmul_chain)

    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    out = {}
    details = []

    def compare(name, call, b, fmt, got, want, exact=False,
                rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        torch.cuda.synchronize()
        err = float((got - want).abs().nan_to_num(0.0).max())
        n_diff = value_diff(torch, got, want)
        ok = n_diff == 0 if exact else bool(
            torch.allclose(got, want, rtol=rtol, atol=atol))
        details.append({"kernel": name, "call": call, "batch": b,
                        "fmt": fmt, "max_abs_err": err,
                        "values_differing": n_diff, "ok": ok})
        check(ok, f"{name} {call} batch {b} fmt {fmt}: kernel differs from "
                  f"its plain version by {err} ({n_diff} values differ)")
        rec = out.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                    "plain_ms": 0.0, "library_ms": 0.0,
                                    "bytes": 0.0, "flops": 0.0,
                                    "calls": []})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        return rec

    def timed(rec, call, nbytes, flops, kern, plain, lib, plain_runs=None,
              **extra):
        t = {"call": call, "ms": device_ms(torch, kern, label=call),
             "plain_ms": device_ms(torch, plain, plain_runs or TIMED_RUNS,
                                   chunk=10 if plain_runs else 20,
                                   label=f"{call} plain"),
             "library_ms": device_ms(torch, lib, label=f"{call} library")
             if lib else None}
        t.update({k: device_ms(torch, f, label=f"{call} {k}")
                  for k, f in extra.items()})
        t["bound_ms"], t["bound_by"] = bound(nbytes, flops)
        for k in ("ms", "plain_ms"):
            rec[k] += t[k]
        rec["library_ms"] = (None if t["library_ms"] is None
                             or rec["library_ms"] is None
                             else rec["library_ms"] + t["library_ms"])
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
            # K3: the four dense layers as the nest tier launches them,
            # one chain (BraggNN(s=1), and the wide model's at the ragged
            # batch), each weight a W.T view
            for s_, bb in ((S, b), (WIDE_S, RAGGED)):
                if s_ == WIDE_S and b != BATCH:
                    continue
                dims = dense_dims(s_)
                x = torch.relu(randn(bb, dims[0]))
                wts = [randn(n, k, scale=k ** -0.5)
                       for k, n in zip(dims[:-1], dims[1:])]
                biases = [randn(n, scale=0.1) for n in dims[1:]]
                layers = [Dense(w.T, bias, True, fmt)
                          for w, bias in zip(wts, biases)]
                eb, mb = fmt if fmt is not None else (None, None)
                kw = {"exp_bits": eb, "man_bits": mb}
                call = f"dense0..dense3 (s={s_})"
                got = smallfloat_matmul_chain(x, layers, **kw)
                rec = compare("smallfloat_matmul", call, bb, fmt, got,
                              smallfloat_matmul_chain_ref(x, layers, **kw))
                one = x
                for ly in layers:
                    one = smallfloat_matmul_chain(one, [ly], **kw)
                compare("smallfloat_matmul", f"{call} vs its layers one at "
                        f"a time", bb, fmt, got, one, exact=True)
                if bb == BATCH and s_ == S:
                    nbytes = 4 * (x.numel() + sum(
                        w.numel() + w.shape[0] for w in wts) + bb * dims[-1])
                    flops = 2 * bb * sum(w.numel() for w in wts)

                    def library(x=x, wts=wts, biases=biases):
                        y = x
                        for w, bias in zip(wts, biases):
                            y = torch.relu(torch.addmm(bias, y, w.T))
                        return y

                    if fmt is None:
                        timed(rec, call, nbytes, flops,
                              lambda: smallfloat_matmul_chain(x, layers, **kw),
                              lambda: smallfloat_matmul_chain_ref(
                                  x, layers, **kw), library)
                    else:
                        rec["ms_at_5_4"] = device_ms(
                            torch, lambda: smallfloat_matmul_chain(
                                x, layers, **kw), label=f"{call} at (5,4)")
        # K3 as a chain of one: a single layer larger than the block's
        # shared memory (K streamed, N split over the grid), fp32 and bf16
        for dt in (torch.float32, torch.bfloat16):
            x = randn(512, 256).to(dt)
            w = randn(1024, 256, scale=256 ** -0.5).to(dt).T
            bias = randn(1024)
            kw = {"exp_bits": None, "man_bits": None, "fuse_relu": True}
            compare("smallfloat_matmul", f"single layer (512, 256, 1024) "
                    f"{str(dt).split('.')[-1]}", 512, None,
                    smallfloat_matmul(x, w, bias, **kw),
                    smallfloat_matmul_ref(x, w, bias, **kw))
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
                # order0_ms: the kernel with the true exp, the function
                # torch.softmax computes (the like-for-like yardstick)
                timed(rec, c["call"], 8 * nel, per_elem * nel,
                      lambda: fused_softmax(x, **kw),
                      lambda: fused_softmax_ref(x, **kw),
                      lambda: torch.softmax(x, dim=-1),
                      order0_ms=lambda: fused_softmax(x, taylor_order=0))
    # K4: the design's DFG segment, value for value with its plain version
    from repro_torch.kernels.dfg_segment.dfg_segment import (dfg_segment,
                                                             launch_shape)
    from repro_torch.kernels.dfg_segment.ref import dfg_segment_ref
    from repro_torch.models import braggnn
    peaks = torch.Generator().manual_seed(7)
    for b in (BATCH, RAGGED):
        x = braggnn.synthetic_peaks(b, IMG, peaks)[0]
        for fmt in (None, "5_4"):
            c = dfg_segment_case(torch, design, {"input": x[:, None]}, fmt)
            kw = {"fmt": c["fmt"]}
            rec = compare(
                "dfg_segment", f"segment[{c['groups']} groups]", b, fmt,
                dfg_segment(c["buf"].clone(), c["idx"], c["desc"], **kw),
                dfg_segment_ref(c["buf"].clone(), c["idx"], c["desc_host"],
                                **kw), exact=True)
            if b == BATCH and fmt is None:
                buf, idx, desc = c["buf"], c["idx"], c["desc"]
                rec["segment"] = {k: c[k] for k in (
                    "groups", "entries", "stages", "elided", "recomputed",
                    "indices", "bytes", "bytes_every_scatter",
                    "gather_bytes", "flops")}
                rec["segment"]["bound_every_scatter_ms"] = bound(
                    c["bytes_every_scatter"], c["flops"])[0]
                rec["segment"]["gather_bound_ms"] = bound(
                    c["gather_bytes"], 0)[0]
                rec["segment"]["launch_shape"] = {
                    n: launch_shape(n) for n in (BATCH, RAGGED, 1)}
                # the prologue's own device work per batch, with the input
                # already on the card (its copy is the serve loop's)
                fn = design.torch_fn(backend="cuda", mode="dfg")
                feeds = {"input": x[:, None].cuda()}
                # the kernel updates the buffer in place; a repeat writes
                # the same values again
                timed(rec, f"segment[{c['groups']} groups]", c["bytes"],
                      c["flops"],
                      lambda: dfg_segment(buf, idx, desc),
                      lambda: dfg_segment_ref(buf, idx, c["desc_host"]),
                      None, plain_runs=20,
                      prologue_ms=lambda: fn.prologue(feeds))
            elif b == BATCH:
                # the kernel alone at the format, beside the fp32 time
                buf, idx, desc = c["buf"], c["idx"], c["desc"]
                rec["segment"][f"ms_at_{fmt}"] = device_ms(
                    torch, lambda: dfg_segment(buf, idx, desc, **kw),
                    label=f"segment at {fmt}")
            del c
    torch.cuda.empty_cache()

    # K5: the NLB attention core, and one transformer case
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, launch_shape)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    n, c2 = (IMG - 2) ** 2, 8 * S
    shapes = {}
    for b in (BATCH, RAGGED):
        # as the NLB passes them: (B, c2, n) buffers read, and the result
        # written, as (B, n, c2) views
        q, k, v = (randn(b, c2, n).transpose(1, 2) for _ in range(3))
        o = torch.empty(b, c2, n, device="cuda").transpose(1, 2)
        fkw = {"causal": False}
        rec = compare("flash_attention", "nlb.attention", b, None,
                      flash_attention(q, k, v, out=o, **fkw),
                      flash_attention_ref(q, k, v, **fkw),
                      rtol=FLASH_RTOL, atol=FLASH_ATOL)
        if b == BATCH:
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
            shapes["nlb"] = launch_shape(b, n, n, c2)
            timed(rec, "nlb.attention", 4 * 4 * q.numel(), 4 * b * n * n * c2,
                  lambda: flash_attention(q, k, v, out=o, **fkw),
                  lambda: flash_attention_ref(q, k, v, **fkw),
                  lambda: F.scaled_dot_product_attention(q, k, v),
                  contiguous_ms=lambda: flash_attention(qc, kc, vc, **fkw))
    # head dims the kernel once refused (fault P1), on strided views, and
    # the transformer case
    for bh, sl, d in ((8, 100, 24), (8, 100, 40), (4, 256, 128),
                      (8, 128, 32)):
        q, k, v = (randn(bh, d, sl).transpose(1, 2) for _ in range(3))
        shapes[f"d{d}"] = launch_shape(bh, sl, sl, d)
        for fkw in ({"causal": False},
                    {"causal": True, "window": 32, "logit_cap": 10.0}):
            compare("flash_attention",
                    f"({bh}, {sl}, {d}) " + ",".join(
                        f"{kk}={vv}" for kk, vv in fkw.items()), bh, None,
                    flash_attention(q, k, v, **fkw),
                    flash_attention_ref(q, k, v, **fkw),
                    rtol=FLASH_RTOL, atol=FLASH_ATOL)
    out["flash_attention"]["launch_shapes"] = shapes

    emit({"phase": "kernels", "tolerance": {"rtol": KERNEL_RTOL,
                                            "atol": KERNEL_ATOL},
          "softmax_taylor_vs_exp_max_gap":
              out["fused_softmax"]["taylor_vs_exp"],
          "checks": len(details), "worst": max(
              details, key=lambda d: d["max_abs_err"]),
          "per_call_at_batch": BATCH, "timing_notes": TIMING_NOTES,
          "dfg_segment": out["dfg_segment"]["segment"],
          "flash_attention_launch_shapes":
              out["flash_attention"]["launch_shapes"],
          "smallfloat_matmul_chain_ms_at_5_4":
              out["smallfloat_matmul"]["ms_at_5_4"],
          "calls": {k: v["calls"] for k, v in out.items()}})
    return out


def phase_compile(torch):
    import repro_torch.hls as hls
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
    return design


def phase_slice(torch, design) -> dict:
    from repro_torch.models import braggnn

    gen = torch.Generator().manual_seed(1)
    batches = [braggnn.synthetic_peaks(n, IMG, gen)[0]
               for n in [BATCH] * N_BATCHES + [RAGGED]]
    want_plan, per_batch = NEST_PLAN, NEST_PER_BATCH
    evaluated = [design.run(x[:N_CHECKED].numpy()) for x in batches]
    out_name = next(iter(evaluated[0]))
    launches = {}
    results = {}
    for backend, fmt in (("cuda", None), ("cuda", "5_4"), ("tensor", None)):
        line, counts, _ = serve_held(torch, design, batches, evaluated,
                                     out_name, backend, fmt, want_plan,
                                     per_batch)
        if backend == "cuda" and fmt is None:
            launches = counts
        results[f"{backend}:{fmt or 'fp32'}"] = line
    launches["flash_attention"] = serve_flash(
        torch, design, batches, evaluated, out_name, want_plan,
        per_batch)["flash_attention"]
    serve_wide(torch, want_plan, per_batch)
    dfg_batches = [batches[i] for i in DFG_BATCHES]
    launches["dfg_segment"] = serve_dfg(
        torch, design, dfg_batches, out_name)[None]["dfg_segment"]
    serve_simd(torch, design, dfg_batches, out_name)
    verify_on_card(torch, design)
    for fmt in (None, "5_4"):
        phase_profile(torch, design, batches[0], fmt)
    phase_profile(torch, design, batches[0], None, {"nlb_flash": True})
    for fmt in (None, "5_4"):
        phase_profile(torch, design, batches[0], fmt, {"mode": "dfg"})
    return {"launches": launches, "serve": results}


def serve_held(torch, design, batches, evaluated, out_name, backend, fmt,
               want_plan, per_batch, **extra):
    """``Design.serve`` over ``batches`` through ``backend`` at ``fmt``,
    its launches counted from 0: the cuda backend's plan and launches per
    batch, the tensor backend's none; fp32 on the cuda backend held to
    ``Design.run`` (``evaluated``), every other path to its own CPU run.
    Returns the emitted line, the counts and the outputs."""
    import numpy as np
    from repro_torch.kernels import registry

    runs = len(batches) + 1            # serve warms up on the first batch
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
        want = {k: per_batch.get(k, 0) * runs for k in counts}
        check(counts == want, f"{tag}: launches {counts}, want {want}")
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
    line.update(extra)
    emit(line)
    return line, counts, outs


def _outputs(torch, tag, rep, batches, out_name):
    outs = [o[out_name] for o in rep.outputs]
    check(all(tuple(o.shape[:1]) == (len(x),) and o.is_cuda
              and bool(torch.isfinite(o).all())
              for o, x in zip(outs, batches)),
          f"{tag}: outputs not finite CUDA tensors of the batch size")
    return outs


def _serve_line(rep, backend, fmt, counts, **extra) -> dict:
    line = {"phase": "serve", "backend": backend, "fmt": fmt,
            "batches": rep.batches, "samples": rep.samples,
            "us_per_sample": rep.us_per_sample, "p50_ms": rep.p50_ms,
            "p99_ms": rep.p99_ms, "warmup_s": rep.warmup_s,
            "served": rep.served, "launches": counts}
    line.update(extra)
    return line


def serve_flash(torch, design, batches, evaluated, out_name, nest_plan,
                per_batch, **extra) -> dict:
    """The NLB flash-attention mode: K5 in place of K2 and the two
    contractions.  Held against the CPU run of the same backend and, at
    the true-exp-vs-Taylor tolerance, against ``Design.run``.  Returns
    the launch counts."""
    import numpy as np
    from repro_torch.kernels import registry

    tag, kw = "cuda:nlb_flash", {"nlb_flash": True}
    if "model" in extra:
        tag += f" {extra['model']}"
    registry.reset_launch_counts()
    rep = design.serve(batches, backend="cuda", cuda_kw=kw, collect=True)
    torch.cuda.synchronize()
    counts = registry.launch_counts()
    outs = _outputs(torch, tag, rep, batches, out_name)
    plan = design.torch_fn(backend="cuda", **kw).plan
    want_plan = dict(nest_plan)
    del want_plan["fused_softmax"]
    want_plan["flash_attention"] = 1
    check(plan.kernels == want_plan and not plan.fallbacks
          and any("true-exp softmax" in n for n in plan.notes),
          f"{tag}: plan {plan.summary()} {plan.notes}")
    runs = len(batches) + 1
    want = {k: 0 for k in counts}
    want.update({k: v * runs for k, v in per_batch.items()
                 if k != "fused_softmax"})
    want["flash_attention"] = runs
    check(counts == want, f"{tag}: launches {counts}, want {want}")
    cpu = design.serve([x[:N_CHECKED] for x in batches], backend="cuda",
                       device="cpu", cuda_kw=kw, collect=True)
    err_cpu = err_run = 0.0
    for o, c, ref in zip(outs, cpu.outputs, evaluated):
        c = c[out_name]
        got = o[:N_CHECKED].cpu().reshape(c.shape)
        err_cpu = max(err_cpu, float((got - c).abs().max()))
        check(torch.allclose(got, c, rtol=SLICE_RTOL, atol=SLICE_ATOL),
              f"{tag}: differs from the CPU run by {err_cpu}")
        g = got.numpy().reshape(ref[out_name].shape)
        err_run = max(err_run, float(np.abs(g - ref[out_name]).max()))
        check(err_run <= FLASH_VS_TAYLOR_ATOL,
              f"{tag}: differs from Design.run by {err_run}")
    emit(_serve_line(rep, "cuda", None, counts, cuda_kw=kw,
                     vs_cpu={"max_abs_err": err_cpu, "rtol": SLICE_RTOL,
                             "atol": SLICE_ATOL},
                     vs_evaluate={"max_abs_err": err_run,
                                  "atol": FLASH_VS_TAYLOR_ATOL,
                                  "samples_per_batch": N_CHECKED},
                     **extra))
    return counts


def serve_wide(torch, nest_plan, per_batch) -> None:
    """BraggNN(s=WIDE_S, img=11) in the NLB flash mode: the NLB's head dim
    is 8 * WIDE_S = 24, which K5 once refused (fault P1).  Two batches of
    256 and the ragged 100, with the checks and launch counts of the s=1
    flash mode."""
    import repro_torch.hls as hls
    from repro_torch.models import braggnn
    from repro_torch.nn.module import init_tree

    model = braggnn.build(WIDE_S, IMG)
    t0 = time.perf_counter()
    design = hls.compile(model.bind(init_tree(
        model.specs(), torch.Generator().manual_seed(0))))
    compile_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(2)
    batches = [braggnn.synthetic_peaks(n, IMG, gen)[0]
               for n in (BATCH, BATCH, RAGGED)]
    evaluated = [design.run(x[:N_CHECKED].numpy()) for x in batches]
    serve_flash(torch, design, batches, evaluated, next(iter(evaluated[0])),
                nest_plan, per_batch,
                model=f"BraggNN(s={WIDE_S}, img={IMG})",
                head_dim=8 * WIDE_S, compile_s=compile_s)


def serve_dfg(torch, design, batches, out_name, fmts=(None, "5_4"),
              **extra) -> dict:
    """The generic DFG tier: one K4 launch per batch, outputs equal to the
    numpy functional model value for value, at each of ``fmts``.  Returns
    the launch counts by format."""
    import numpy as np
    from repro_torch.core.precision import FORMATS
    from repro_torch.kernels import registry

    launches = {}
    for fmt in fmts:
        tag, kw = f"cuda:dfg:{fmt or 'fp32'}", {"mode": "dfg"}
        plan = design.torch_fn(backend="cuda", fmt=fmt, **kw).plan
        got_plan = (plan.n_segments, plan.n_groups, plan.fused_scatters)
        check(got_plan == DFG_PLAN and not plan.fallbacks,
              f"{tag}: plan {plan.summary()}, want {DFG_PLAN}")
        registry.reset_launch_counts()
        rep = design.serve(batches, backend="cuda", fmt=fmt, cuda_kw=kw,
                           collect=True)
        torch.cuda.synchronize()
        counts = registry.launch_counts()
        outs = _outputs(torch, tag, rep, batches, out_name)
        want = {k: 0 for k in counts}
        want["dfg_segment"] = plan.n_segments * (len(batches) + 1)
        check(counts == want, f"{tag}: launches {counts}, want {want}")
        n_diff = 0
        for o, x in zip(outs, batches):
            ref = design.run(x[:N_CHECKED].numpy(),
                             fmt=FORMATS[fmt] if fmt else None)[out_name]
            got = o[:N_CHECKED].cpu().numpy().reshape(ref.shape)
            n_diff += int(((got != ref)
                           & ~(np.isnan(got) & np.isnan(ref))).sum())
        check(n_diff == 0, f"{tag}: {n_diff} outputs differ from Design.run")
        emit(_serve_line(rep, "cuda", fmt, counts, cuda_kw=kw,
                         plan={"segments": plan.n_segments,
                               "groups": plan.n_groups,
                               "scatters_elided": plan.fused_scatters,
                               "stages": plan.n_stages,
                               "fallbacks": len(plan.fallbacks)},
                         vs_evaluate={"outputs_differing": n_diff,
                                      "samples_per_batch": N_CHECKED},
                         **extra))
        launches[fmt] = counts
    return launches


def serve_simd(torch, design, batches, out_name) -> None:
    """The emitted SIMD design (plain torch, no kernel): value for value
    with the numpy functional model."""
    import numpy as np
    from repro_torch.kernels import registry

    registry.reset_launch_counts()
    rep = design.serve(batches, backend="simd", collect=True)
    torch.cuda.synchronize()
    counts = registry.launch_counts()
    check(not any(counts.values()), f"simd launched kernels: {counts}")
    outs = _outputs(torch, "simd", rep, batches, out_name)
    n_diff = 0
    for o, x in zip(outs, batches):
        ref = design.run(x[:N_CHECKED].numpy())[out_name]
        got = o[:N_CHECKED].cpu().numpy().reshape(ref.shape)
        n_diff += int(((got != ref) & ~(np.isnan(got) & np.isnan(ref))).sum())
    check(n_diff == 0, f"simd: {n_diff} outputs differ from Design.run")
    emit(_serve_line(rep, "simd", None, counts,
                     vs_evaluate={"outputs_differing": n_diff,
                                  "samples_per_batch": N_CHECKED}))


def verify_on_card(torch, design) -> None:
    """``Design.verify`` with the emitted SIMD design on the card, at the
    feed scale BraggNN's testbench uses (0.2: the Taylor exp of larger
    random weights overflows)."""
    import math
    t0 = time.perf_counter()
    rep = design.verify(scale=0.2)
    errs = {k: getattr(rep, k) for k in (
        "max_abs_err_opt", "max_abs_err_ref", "max_abs_err_quant",
        "max_abs_err_simd")}
    emit({"phase": "verify", "summary": rep.summary(), "passed": rep.passed,
          "seconds": time.perf_counter() - t0, **errs})
    check(rep.passed and all(math.isfinite(v) for v in errs.values()),
          f"design.verify failed on the card: {rep.summary()}")


def phase_profile(torch, design, x, fmt, cuda_kw=None,
                  reps: int = 5) -> None:
    """Where one batch's time goes: ``torch.profiler`` over ``reps``
    batches of the cuda backend at ``fmt`` (nest tier, or what
    ``cuda_kw`` selects), after the counted runs.  Device time and
    launches by kernel name, the device's busy and idle share of the
    host's wall time, and the host time per batch."""
    fn = design.torch_fn(backend="cuda", fmt=fmt, **(cuda_kw or {}))
    if fn.plan.mode == "dfg":
        x = {"input": x[:, None]}          # the DFG tier takes feed dicts
    emit({"phase": "profile", "fmt": fmt, "mode": fn.plan.mode,
          "cuda_kw": cuda_kw or {}, "batch": BATCH, "reps": reps,
          **device_profile(torch, lambda: fn(x), reps)})


def device_profile(torch, step, reps: int = 5, warm: bool = True) -> dict:
    """``torch.profiler`` over ``reps`` calls of ``step``, each ending in a
    synchronise, after one untraced call (``warm``; a caller whose step
    has just run passes False): device operations and device
    time per call by kernel name, busy time and idle share of the host's
    wall time, and the host operations that take the most of the host's
    own time (under the profiler, which adds its own)."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, host = profile_events(torch, prof)
    kernels = [{"name": k[:90], "calls": n / reps,
                "device_us_per_batch": ns / 1e3 / reps}
               for k, (n, ns) in kernels.items() if ns > 0]
    kernels.sort(key=lambda k: -k["device_us_per_batch"])
    host = [{"name": k[:60], "calls": n / reps,
             "host_us_per_batch": ns / 1e3 / reps}
            for k, (n, ns) in host.items() if ns > 0]
    busy = sum(k["device_us_per_batch"] for k in kernels)
    return {"device_operations_per_batch": sum(k["calls"] for k in kernels),
            "host_us_per_batch": wall_us / reps,
            "device_busy_us_per_batch": busy,
            "device_idle_share": (1.0 - busy * reps / wall_us
                                  if kernels else None),
            "device_time_seen": bool(kernels), "kernels": kernels,
            "host_top": sorted(host, key=lambda h: -h["host_us_per_batch"]
                               )[:6]}


def profile_events(torch, prof) -> tuple:
    """From a finished profile's raw events: per kernel name on the card,
    (events, device ns); per host operation, (events, self ns: its time
    less that of the operations nested in it on its thread).  The same
    sums as ``prof.key_averages()``'s device and self CPU totals, in
    seconds where that takes a minute at a training step's 468,177
    kernels.  CUPTI's own buffer requests are the profiler's cost, not
    the step's, and memory records are not operations."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    kernels, host, threads = {}, {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("[") or getattr(e, "is_hidden_event",
                                           lambda: False)():
            continue
        if e.device_type() == cuda:
            if name != "Activity Buffer Request":
                k = kernels.setdefault(name, [0, 0])
                k[0] += 1
                k[1] += e.duration_ns()
        elif e.device_type() == cpu and not e.is_async() \
                and e.start_thread_id() == e.end_thread_id():
            threads.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), -e.end_ns(), name))

    def close(item) -> None:
        h = host.setdefault(item[1], [0, 0])
        h[0] += 1
        h[1] += item[2]

    for evs in threads.values():
        evs.sort()                      # by start, the outer one first
        stack = []                      # [end, name, self ns]
        for start, neg_end, name in evs:
            while stack and stack[-1][0] <= start:
                close(stack.pop())
            if stack:
                stack[-1][2] -= -neg_end - start
            stack.append([-neg_end, name, -neg_end - start])
        for item in stack:
            close(item)
    return kernels, host


def _tensors(out) -> dict:
    return out if isinstance(out, dict) else {"out": out}


def replay_vs_eager(torch, label, run_one, xs) -> dict:
    """For each batch size ``b`` in ``xs`` (three batches each): the first
    batch runs eagerly and captures the shape's graph; then a replay on the
    second must equal the eager runner (``run_one.eager``, no graph) value
    for value and launch, per kernel, what the eager batch launched.
    Returns per batch size the values differing, the outputs and the
    launches per replay."""
    from repro_torch.kernels import registry
    checks = {}
    for b, (x0, x1, _) in xs.items():
        run_one(x0)                                # eager run, then capture
        registry.reset_launch_counts()
        want = {k: v.clone() for k, v in _tensors(run_one.eager(x1)).items()}
        torch.cuda.synchronize()
        eager = registry.launch_counts()
        registry.reset_launch_counts()
        got = _tensors(run_one(x1))
        torch.cuda.synchronize()
        replay = registry.launch_counts()
        diff = sum(value_diff(torch, got[k], want[k]) for k in want)
        check(diff == 0, f"{label} batch {b}: a replay differs from the "
                         f"eager runner in {diff} values")
        check(replay == eager, f"{label} batch {b}: a replay launched "
                               f"{replay}, an eager batch {eager}")
        checks[b] = {"value_diff": diff, "outputs": sum(
            v.numel() for v in want.values()),
            "launches_per_replay": {k: v for k, v in replay.items() if v}}
    check(len(run_one.graphs.replay_launches()) == len(xs),
          f"{label}: not one graph per batch shape")
    return checks


def phase_graphs(torch, design) -> None:
    """Every serving path through the runner that captures a CUDA graph
    per batch shape.  Per path, at batch 256 and the ragged 100: the first
    call runs eagerly and captures; then on new data a replay must equal
    the eager runner (``run_one.eager``, no graph) value for value and
    launch, per kernel, what the eager batch launched.  Then the profiler
    over replayed batches of 256, and ``Design.serve`` over
    ``GRAPH_SERVE_BATCHES`` batches of 256 (counts set to 0 just before,
    read just after: each replay adds its graph's launches)."""
    from repro_torch.kernels import registry
    from repro_torch.models import braggnn
    from repro_torch.serving.common import percentiles
    gen = torch.Generator().manual_seed(4)
    xs = {b: [braggnn.synthetic_peaks(b, IMG, gen)[0] for _ in range(3)]
          for b in (BATCH, RAGGED)}
    dev = design.device
    for label, backend, fmt, kw in GRAPH_PATHS:
        run_one, served, _ = design._runner(backend, fmt, dev, kw)
        checks = replay_vs_eager(torch, f"graphs {label}", run_one, xs)
        # the same loop eagerly, in this run: the graph's gain on the host
        eager_s = []
        for i in range(GRAPH_SERVE_BATCHES):
            t0 = time.perf_counter()
            run_one.eager(xs[BATCH][i % 3])
            torch.cuda.synchronize()
            eager_s.append(time.perf_counter() - t0)
        prof = device_profile(torch, lambda: run_one(xs[BATCH][2]))
        # a kernel in the trace, not only the input's copy
        prof["cupti_saw_graph_kernels"] = any(
            not k["name"].startswith("Memcpy") for k in prof["kernels"])
        run_one.release()
        del run_one
        batches = [xs[BATCH][i % 3] for i in range(GRAPH_SERVE_BATCHES)]
        registry.reset_launch_counts()
        rep = design.serve(batches, backend=backend, fmt=fmt, cuda_kw=kw)
        torch.cuda.synchronize()
        counts = {k: v for k, v in registry.launch_counts().items() if v}
        want_counts = {k: v * (GRAPH_SERVE_BATCHES + 1) for k, v in
                       checks[BATCH]["launches_per_replay"].items()}
        check(counts == want_counts, f"graphs {label}: serve launched "
                                     f"{counts}, want {want_counts}")
        torch.cuda.empty_cache()
        emit({"phase": "graphs", "path": label, "backend": backend,
              "fmt": fmt, "cuda_kw": kw or {}, "served": served,
              "replay_vs_eager": checks,
              "serve": {"batches": rep.batches, "batch": BATCH,
                        "p50_ms": rep.p50_ms, "p99_ms": rep.p99_ms,
                        "us_per_sample": rep.us_per_sample,
                        "warmup_s": rep.warmup_s, "launches": counts,
                        # the card's idle share of a served batch: device
                        # busy (profiler) against the serve p50
                        "device_idle_share_at_p50": 1.0 - prof[
                            "device_busy_us_per_batch"] / (rep.p50_ms * 1e3)},
              "eager": {"batches": len(eager_s),
                        "p50_ms": 1e3 * percentiles(eager_s)["p50"],
                        "p99_ms": 1e3 * percentiles(eager_s)["p99"]},
              "profile": prof})


def phase_engine(torch, design) -> None:
    """``DesignEngine`` on the nest tier (fp32), buckets
    ``default_buckets(256)`` each captured at boot, threaded: 4,096
    requests submitted while the dispatcher runs, every output equal to
    ``Design.serve``'s over the same batches of 256 bit for bit.  Then the
    same load with dispatch 3 poisoned and a saved artifact: the replica
    restarts from the file, no request is dropped, the outputs are the
    same; and once more with dispatches 3 and 9 poisoned, which must hold
    no more device memory than one restart (the old replica's graphs are
    released)."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.models import braggnn
    from repro_torch.runtime import FailureInjector
    from repro_torch.serving import default_buckets

    xs = braggnn.synthetic_peaks(ENGINE_REQUESTS, IMG,
                                 torch.Generator().manual_seed(5))[0].numpy()
    chunks = [xs[i:i + ENGINE_MAX_BATCH]
              for i in range(0, len(xs), ENGINE_MAX_BATCH)]
    ref = design.serve(chunks, backend="cuda", collect=True)
    want = {k: torch.cat([o[k] for o in ref.outputs]).cpu().numpy()
            for k in ref.outputs[0]}
    buckets = default_buckets(ENGINE_MAX_BATCH)
    tmp = Path(tempfile.mkdtemp(prefix=".smoke_engine_", dir=ROOT))
    try:
        artifact = design.save(tmp / "braggnn.design", backend="cuda",
                               buckets=buckets)
        held_after = {}
        for label, fail_at in (("uninterrupted", ()), ("restart", (3,)),
                               ("two restarts", (3, 9))):
            kw = {"injector": FailureInjector(fail_at=fail_at),
                  "artifact_path": artifact} if fail_at else {}
            eng = design.engine(backend="cuda", buckets=buckets,
                                max_delay_ms=ENGINE_DELAY_MS, **kw)
            torch.cuda.synchronize()
            held_boot = torch.cuda.memory_allocated()
            with eng:
                t0 = time.perf_counter()
                reqs = [eng.submit(x) for x in xs]
                submit_s = time.perf_counter() - t0
                outs = [r.wait(timeout=300) for r in reqs]
            torch.cuda.synchronize()
            held_end = torch.cuda.memory_allocated()
            rep = eng.report()
            n_diff = sum(int((o[k] != want[k][i]).sum())
                         for i, o in enumerate(outs) for k in want)
            served = sum(b * n for b, n in rep.batch_hist.items())
            line = {"phase": "engine", "run": label, "backend": "cuda",
                    "fmt": None, "requests": len(xs),
                    "buckets": list(buckets),
                    "max_delay_ms": ENGINE_DELAY_MS, "qps": rep.qps,
                    "p50_ms": rep.p50_ms, "p95_ms": rep.p95_ms,
                    "p99_ms": rep.p99_ms, "mean_ms": rep.mean_ms,
                    "submit_s": submit_s, "wall_s": rep.wall_s,
                    "compute_s": rep.compute_s,
                    "dispatches": rep.dispatches,
                    "batch_hist": {str(b): n for b, n in
                                   sorted(rep.batch_hist.items())},
                    "padded_samples": rep.padded_samples,
                    "bucket_fill": rep.completed / served if served else 0,
                    "boot_s": rep.boot_s, "boots": rep.boots,
                    "restarts": rep.restarts, "retried": rep.retried,
                    "dropped": rep.dropped, "completed": rep.completed,
                    "max_queue_depth": rep.max_queue_depth,
                    "outputs_differing_from_serve": n_diff,
                    "device_bytes_after_boot": held_boot,
                    "device_bytes_after_run": held_end,
                    "served": rep.served}
            emit(line)
            check(rep.completed == len(xs) and rep.dropped == 0,
                  f"engine {label}: {rep.completed} completed, "
                  f"{rep.dropped} dropped")
            check(n_diff == 0, f"engine {label}: {n_diff} outputs differ "
                               f"from Design.serve")
            held_after[label] = held_end
            check(rep.boots == ["memory"] + ["artifact"] * len(fail_at)
                  and rep.restarts == len(fail_at),
                  f"engine {label}: boots {rep.boots}")
            if label == "restart":
                # one replica's graphs held, not two
                check(held_end <= 1.1 * held_boot + (64 << 20),
                      f"engine restart: {held_end} device bytes held after "
                      f"the restart, {held_boot} after the first boot")
            if label == "two restarts":
                # a second restart holds no more than the first: the old
                # replica's graphs are released, not kept beside the new
                check(held_end <= held_after["restart"] + (1 << 20),
                      f"engine: {held_end} device bytes held after two "
                      f"restarts, {held_after['restart']} after one")
            del eng, reqs, outs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


def phase_trigger(torch, design) -> None:
    """The trigger: the design's budget against the Alveo U280; the loop on
    the card at windows 1 and 64 over ``TRIGGER_FRAMES`` frames, its
    scores and decisions against the same loop on the CPU (scores at the
    nest tier's kernel-vs-plain tolerance, decisions equal outside
    ``DECISION_BAND`` around the threshold); then in real time at the
    feed's 1 kHz with a deadline of ``TRIGGER_DEADLINE_US``."""
    import numpy as np
    from repro_torch import trigger

    budget = design.check_budget(part="alveo_u280")
    emit({"phase": "trigger", "check_budget": budget.to_json(),
          "summary": budget.summary()})
    feed = trigger.DetectorFeed(img=IMG, seed=11)
    threshold = None
    for window in TRIGGER_WINDOWS:
        loop = design.trigger(backend="cuda", window=window)
        if threshold is None:
            threshold = loop.calibrate(feed, 256)
        loop.threshold = threshold
        rep = loop.run(feed, TRIGGER_FRAMES)
        cpu = design.trigger(backend="cuda", window=window, device="cpu",
                             threshold=threshold).run(feed, TRIGGER_FRAMES)
        got = np.array([d.score for d in rep.decisions])
        want = np.array([d.score for d in cpu.decisions])
        err = float(np.abs(got - want).max())
        check(bool(np.allclose(got, want, rtol=SLICE_RTOL, atol=SLICE_ATOL)),
              f"trigger window {window}: scores differ from the CPU run by "
              f"{err}")
        band = np.abs(want - threshold) <= DECISION_BAND * max(
            1.0, abs(threshold))
        acc = np.array([d.accept for d in rep.decisions])
        acc_cpu = np.array([d.accept for d in cpu.decisions])
        n_diff = int((acc != acc_cpu)[~band].sum())
        check(n_diff == 0 and len(got) == TRIGGER_FRAMES,
              f"trigger window {window}: {n_diff} decisions differ from "
              f"the CPU run outside the band")
        emit({"phase": "trigger", "mode": "deterministic", "window": window,
              "frames": rep.frames, "processed": rep.processed,
              "threshold": threshold, "accepts": rep.accepts,
              "p50_us": rep.p50_us, "p99_us": rep.p99_us,
              "sustained_fps": rep.sustained_fps, "warmup_s": rep.warmup_s,
              "vs_cpu": {"max_score_err": err, "rtol": SLICE_RTOL,
                         "atol": SLICE_ATOL,
                         "decisions_differing_outside_band": n_diff,
                         "decisions_differing_inside_band": int(
                             (acc != acc_cpu)[band].sum()),
                         "frames_inside_band": int(band.sum()),
                         "band": DECISION_BAND}})
        del loop
    loop = design.trigger(backend="cuda", window=1, threshold=threshold,
                          budget=trigger.TriggerBudget(
                              max_latency_us=TRIGGER_DEADLINE_US))
    rep = loop.run(feed, TRIGGER_FRAMES, realtime=True)
    check(rep.processed + rep.dropped == rep.frames == TRIGGER_FRAMES,
          f"trigger realtime: {rep.processed} processed + {rep.dropped} "
          f"dropped of {rep.frames}")
    emit({"phase": "trigger", "mode": "realtime",
          "frame_rate_hz": feed.frame_rate_hz, "window": 1,
          "frames": rep.frames, "processed": rep.processed,
          "dropped": rep.dropped, "deadline_us": rep.deadline_us,
          "deadline_misses": rep.deadline_misses,
          "p50_us": rep.p50_us, "p95_us": rep.p95_us, "p99_us": rep.p99_us,
          "max_us": rep.max_us, "sustained_fps": rep.sustained_fps,
          "accepts": rep.accepts, "summary": rep.summary()})


# ---------------------------------------------------------------------------
# The transformer encoder block and the tuner
# ---------------------------------------------------------------------------

#: the transformer encoder block at ``transformer.build()``'s own width:
#: seq, d_model, heads, ffn (head dim 16), nothing cut
BLOCK = (16, 64, 4, 256)
#: samples per batch held against ``Design.run`` (the numpy functional
#: model evaluates the block's 1.26M ops at about 0.25 s per sample)
BLOCK_CHECKED = 4
#: the DFG tier's batch: the largest the paths take, 256.  The tier's
#: value buffer holds 2,696,524 fp32 values per sample (2.8 GB at 256) and
#: a batch of 256 took 1.6 ms on the card, so it costs the run seconds.
BLOCK_DFG_BATCH = 256
#: batches each block path serves, replayed, for its p50 and p99
BLOCK_SERVE_BATCHES = 100
#: the nest tier's plan for the block, as the reference records it
BLOCK_PLAN = {"smallfloat_matmul": 2, "smallfloat_matmul:relu": 1,
              "fused_softmax": 1}
_NEST = {"smallfloat_matmul": 3, "fused_softmax": 1}
_FLASH = {"smallfloat_matmul": 3, "flash_attention": 1}
#: (label, backend, fmt, cuda_kw, kernel launches per batch, hold).  K3
#: launches three times a batch: the q/k/v projection, the output
#: projection, the MLP chain.  hold: "run" against ``Design.run`` (fp32,
#: SLICE_RTOL / SLICE_ATOL); "cpu" against the same path on the CPU; "exact"
#: against ``Design.run(fmt)`` value for value
BLOCK_PATHS = (
    ("nest fp32", "cuda", None, None, _NEST, "run"),
    ("nest 5_4", "cuda", "5_4", None, _NEST, "cpu"),
    ("flash fp32", "cuda", None, {"nlb_flash": True}, _FLASH, "cpu"),
    ("tensor", "tensor", None, None, {}, "cpu"),
    ("dfg fp32", "cuda", None, {"mode": "dfg"}, {"dfg_segment": 1}, "exact"),
    ("dfg 5_4", "cuda", "5_4", {"mode": "dfg"}, {"dfg_segment": 1}, "exact"),
)
#: the tuner's trials: the dry bisection, and measure mode on the card
TUNE_BUDGET, TUNE_MEASURE_BUDGET = 8, 3
#: BraggNN's testbench feed scale, the tuner CLI's for BraggNN too
TUNE_SCALE = 0.2
#: a quantised nest tier against the per-op functional model at the same
#: format (the reference's tolerance for the quantised transformer block)
TUNED_RTOL, TUNED_ATOL = 5e-2, 5e-3


def ulp_at(scale: float, man_bits: int) -> float:
    """One ulp of a format with ``man_bits`` fraction bits at ``scale``."""
    import numpy as np
    return float(2.0 ** (np.floor(np.log2(max(scale, 2.0 ** -14)))
                         - man_bits))


def kernel_call(torch, call, kern, plain, library, nbytes, flops, *,
                got=None, want=None, exact=False, rtol=KERNEL_RTOL,
                atol=KERNEL_ATOL, plain_runs=TIMED_RUNS,
                runs=TIMED_RUNS) -> dict:
    """One kernel call held against its plain version (``got`` / ``want``
    where given, else one call of each), then the device times of kernel,
    plain version and library call beside the bound."""
    got = kern() if got is None else got
    want = plain() if want is None else want
    torch.cuda.synchronize()
    err = float((got - want).abs().nan_to_num(0.0).max())
    n_diff = value_diff(torch, got, want)
    ok = n_diff == 0 if exact else bool(
        torch.allclose(got, want, rtol=rtol, atol=atol))
    check(ok, f"{call}: kernel differs from its plain version by {err} "
              f"({n_diff} values differ)")
    bound_ms, bound_by = bound(nbytes, flops)
    return {"call": call, "max_abs_err": err, "values_differing": n_diff,
            "ms": device_ms(torch, kern, runs, chunk=min(20, runs),
                            label=call),
            "plain_ms": device_ms(torch, plain, plain_runs,
                                  chunk=min(20, plain_runs),
                                  label=f"{call} plain"),
            "library_ms": device_ms(torch, library, runs,
                                    chunk=min(20, runs),
                                    label=f"{call} library")
            if library else None,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": flops}


def block_kernels(torch, design, dfg_x) -> dict:
    """K3, K2 and K5 at the block's calls in one nest batch of 256 (M =
    4,096 rows), and K4 on the block's DFG segment at ``dfg_x``'s batch:
    each held against its plain version, then timed.  Kernel name -> its
    calls, and their sums per batch."""
    import torch.nn.functional as F
    from repro_torch.kernels.dfg_segment.dfg_segment import dfg_segment
    from repro_torch.kernels.dfg_segment.ref import dfg_segment_ref
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.fused_softmax.fused_softmax import \
        fused_softmax
    from repro_torch.kernels.fused_softmax.ref import fused_softmax_ref
    from repro_torch.kernels.smallfloat_matmul.ref import (
        Dense, smallfloat_matmul_chain_ref)
    from repro_torch.kernels.smallfloat_matmul.smallfloat_matmul import \
        smallfloat_matmul_chain

    seq, dm, heads, ffn = BLOCK
    dh, m = dm // heads, BATCH * seq
    gen = torch.Generator(device="cuda").manual_seed(9)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    calls = {"smallfloat_matmul": [], "fused_softmax": [],
             "flash_attention": [], "dfg_segment": []}
    kw = {"exp_bits": None, "man_bits": None}
    # K3: the q/k/v projection (one launch over the three kernels side by
    # side), the output projection, and the MLP as one chain
    x = randn(m, dm)
    for call, layers, lib in (
            ("attn.qkv", [(randn(dm, 3 * dm, scale=dm ** -0.5), None,
                           False)], None),
            ("attn.o", [(randn(dm, dm, scale=dm ** -0.5), None, False)],
             None),
            ("mlp.fc1..fc2", [(randn(ffn, dm, scale=dm ** -0.5).T,
                               randn(ffn, scale=0.1), True),
                              (randn(dm, ffn, scale=ffn ** -0.5).T,
                               randn(dm, scale=0.1), False)], None)):
        dense = [Dense(w, b, relu) for w, b, relu in layers]

        def library(layers=layers):
            # one PyTorch call per layer: torch.mm, or torch.addmm and
            # torch.relu
            y = x
            for w, b, relu in layers:
                y = torch.mm(y, w) if b is None else torch.addmm(b, y, w)
                y = torch.relu(y) if relu else y
            return y
        nbytes = 4 * (x.numel() + sum(w.numel() + (b.numel() if b is not None
                                                   else 0)
                                      for w, b, _ in layers)
                      + m * layers[-1][0].shape[1])
        flops = 2 * m * sum(w.numel() for w, _, _ in layers)
        calls["smallfloat_matmul"].append(kernel_call(
            torch, call,
            lambda dense=dense: smallfloat_matmul_chain(x, dense, **kw),
            lambda dense=dense: smallfloat_matmul_chain_ref(x, dense, **kw),
            library, nbytes, flops))
    # K2: the scores' rows, order 8
    scores = randn(BATCH, heads, seq, seq, scale=SOFTMAX_SCALE)
    nel = scores.numel()
    calls["fused_softmax"].append(kernel_call(
        torch, "attn.softmax",
        lambda: fused_softmax(scores.view(-1, seq), taylor_order=8),
        lambda: fused_softmax_ref(scores.view(-1, seq), taylor_order=8),
        lambda: torch.softmax(scores, dim=-1), 8 * nel,
        (3 * 8 + 2 + 4) * nel))
    # K5: the flash mode's core on the projection's (B, L, H, dh) column
    # blocks, read in place as (B, H, L, dh) views
    qkv = randn(m, 3 * dm)
    q, k, v = (qkv[:, i * dm:(i + 1) * dm].view(BATCH, seq, heads, dh)
               .transpose(1, 2) for i in range(3))
    out = torch.empty(BATCH, seq, heads, dh, device="cuda").transpose(1, 2)
    calls["flash_attention"].append(kernel_call(
        torch, "attn.flash",
        lambda: flash_attention(q, k, v, causal=False, out=out),
        lambda: flash_attention_ref(
            *(t.reshape(-1, seq, dh) for t in (q, k, v)),
            causal=False).view(BATCH, heads, seq, dh),
        lambda: F.scaled_dot_product_attention(q, k, v),
        4 * 4 * BATCH * seq * dm, 4 * BATCH * heads * seq * seq * dh,
        rtol=FLASH_RTOL, atol=FLASH_ATOL))
    # K4: the block's DFG segment, value for value
    for fmt in (None, "5_4"):
        c = dfg_segment_case(torch, design, {"input": dfg_x}, fmt)
        buf, idx, desc = c["buf"], c["idx"], c["desc"]
        fkw = {"fmt": c["fmt"]}
        got = dfg_segment(buf.clone(), idx, desc, **fkw)
        want = dfg_segment_ref(buf.clone(), idx, c["desc_host"], **fkw)
        call = f"segment[{c['groups']} groups]" + (f" at {fmt}" if fmt
                                                    else "")
        rec = kernel_call(
            torch, call,
            lambda: dfg_segment(buf, idx, desc, **fkw),
            lambda: dfg_segment_ref(buf, idx, c["desc_host"], **fkw), None,
            c["bytes"], c["flops"], got=got, want=want, exact=True,
            plain_runs=10)
        rec["segment"] = {k_: c[k_] for k_ in (
            "groups", "entries", "stages", "elided", "recomputed",
            "indices", "bytes_every_scatter")}
        rec["batch"] = c["batch"]
        calls["dfg_segment"].append(rec)
        del c, got, want, buf
        torch.cuda.empty_cache()
    rows = {}
    for name, cs in calls.items():
        # the fp32 calls of one batch (K4: its fp32 segment)
        per_batch = [c for c in cs if " at " not in c["call"]]
        nb = sum(c["bytes"] for c in per_batch)
        nf = sum(c["flops"] for c in per_batch)
        bound_ms, bound_by = bound(nb, nf)
        libs = [c["library_ms"] for c in per_batch]
        rows[name] = {
            "ms": sum(c["ms"] for c in per_batch),
            "plain_ms": sum(c["plain_ms"] for c in per_batch),
            "library_ms": None if None in libs else sum(libs),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "calls": cs}
    return rows


def phase_transformer(torch) -> dict:
    """The transformer encoder block at full width: ``hls.compile``, then
    every serving path — the nest tier (K3, K2; fp32 and (5,4)), the flash
    mode (K3, K5), ``tensor`` and the DFG tier (K4; fp32 and (5,4)) — over
    8 batches of 256 and one of 100 (the DFG tier: two of
    ``BLOCK_DFG_BATCH`` and one of 100), launch counts per batch and the
    outputs held (``BLOCK_PATHS``); per path a replay against the eager
    runner value for value at both batch sizes, ``Design.serve`` over
    ``BLOCK_SERVE_BATCHES`` replayed batches (p50, p99, us/sample) and the
    profiler over replays (device operations and busy time per batch);
    the block's kernel calls against their plain versions, timed; and
    ``design.verify()`` on the card.  Returns the launches per path and the
    kernels' rows."""
    import math

    import numpy as np
    import repro_torch.hls as hls
    from repro_torch.core.precision import FORMATS
    from repro_torch.kernels import registry
    from repro_torch.models import transformer
    from repro_torch.nn.module import init_tree

    seq, dm, heads, ffn = BLOCK
    model = transformer.build(*BLOCK)
    params = init_tree(model.specs(), torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    design = hls.compile(model.bind(params))
    emit({"phase": "transformer", "step": "compile",
          "block": {"seq": seq, "d_model": dm, "n_heads": heads,
                    "ffn": ffn}, "seconds": time.perf_counter() - t0,
          "timings": design.timings, "ops": len(design.graph_opt.ops),
          "values": design.graph_opt.n_values,
          "design_hash": design.design_hash[:16]})
    gen = torch.Generator().manual_seed(6)

    def batch(n):
        return torch.randn((n, seq, dm), generator=gen) * 0.5

    nest_batches = [batch(BATCH) for _ in range(N_BATCHES)] + [batch(RAGGED)]
    dfg_batches = [batch(BLOCK_DFG_BATCH) for _ in range(2)] + \
        [batch(RAGGED)]
    out_name = "ln_post_out"
    launches = {}
    for label, backend, fmt, kw, per_batch, hold in BLOCK_PATHS:
        tag = f"transformer {label}"
        dfg = bool(kw) and kw.get("mode") == "dfg"
        batches = dfg_batches if dfg else nest_batches
        registry.reset_launch_counts()
        rep = design.serve(batches, backend=backend, fmt=fmt, cuda_kw=kw,
                           collect=True)
        torch.cuda.synchronize()
        counts = registry.launch_counts()
        want = {k: per_batch.get(k, 0) * (len(batches) + 1) for k in counts}
        check(counts == want, f"{tag}: launches {counts}, want {want}")
        line = {"phase": "transformer", "path": label, "backend": backend,
                "fmt": fmt, "cuda_kw": kw or {}, "served": rep.served,
                "batches": rep.batches, "samples": rep.samples,
                "launches": {k: v for k, v in counts.items() if v}}
        if backend == "cuda":
            plan = design.torch_fn(backend="cuda", fmt=fmt,
                                   **(kw or {})).plan
            if dfg:
                check(plan.n_segments == 1 and not plan.fallbacks,
                      f"{tag}: plan {plan.summary()}")
                line["plan"] = {"segments": plan.n_segments,
                                "groups": plan.n_groups,
                                "scatters_elided": plan.fused_scatters,
                                "stages": plan.n_stages}
            else:
                want_plan = dict(BLOCK_PLAN)
                if kw:
                    del want_plan["fused_softmax"]
                    want_plan["flash_attention"] = 1
                check(plan.kernels == want_plan
                      and [f.split(":")[0] for f in plan.fallbacks]
                      == ["ln_post"], f"{tag}: plan {plan.summary()}")
        outs = [o[out_name] if isinstance(o, dict) else o
                for o in rep.outputs]
        check(all(tuple(o.shape) == (len(x), seq, dm) and o.is_cuda
                  and bool(torch.isfinite(o).all())
                  for o, x in zip(outs, batches)),
              f"{tag}: outputs not finite CUDA tensors of the batch shape")
        got = [o[:BLOCK_CHECKED].cpu() for o in outs]
        if hold == "cpu":
            cpu = design.serve([x[:BLOCK_CHECKED] for x in batches],
                               backend=backend, fmt=fmt, cuda_kw=kw,
                               device="cpu", collect=True)
            want_o = [c[out_name] if isinstance(c, dict) else c
                      for c in cpu.outputs]
            scale = max(float(c.abs().max()) for c in want_o)
            err = max(float((g - c).abs().max())
                      for g, c in zip(got, want_o))
            n_diff = sum(int((g != c).sum()) for g, c in zip(got, want_o))
            n_all = sum(c.numel() for c in want_o)
            tol = (ulp_at(scale, FORMATS[fmt].man_bits) if fmt
                   else SLICE_ATOL + SLICE_RTOL * scale)
            check(err <= tol and (not fmt
                                  or n_diff <= MAX_DIFFER_SHARE * n_all),
                  f"{tag}: differs from the CPU run by {err} (tolerance "
                  f"{tol}) in {n_diff} of {n_all} outputs")
            line["vs_cpu"] = {"max_abs_err": err, "tolerance": tol,
                              "outputs_differing": n_diff, "outputs": n_all,
                              "output_scale": scale,
                              "samples_per_batch": BLOCK_CHECKED}
        else:
            fo = FORMATS[fmt] if fmt else None
            err, n_diff = 0.0, 0
            for g, x in zip(got, batches):
                ref = design.run(x[:BLOCK_CHECKED].numpy(), fmt=fo)[out_name]
                g = g.numpy()
                err = max(err, float(np.abs(g - ref).max()))
                n_diff += int(((g != ref)
                               & ~(np.isnan(g) & np.isnan(ref))).sum())
                if hold == "run":
                    check(np.allclose(g, ref, rtol=SLICE_RTOL,
                                      atol=SLICE_ATOL),
                          f"{tag}: differs from Design.run by {err}")
            if hold == "exact":
                check(n_diff == 0, f"{tag}: {n_diff} outputs differ from "
                                   f"Design.run")
            line["vs_evaluate"] = {
                "max_abs_err": err, "outputs_differing": n_diff,
                "samples_per_batch": BLOCK_CHECKED,
                **({"rtol": SLICE_RTOL, "atol": SLICE_ATOL}
                   if hold == "run" else {"tolerance": "value for value"})}
        # replays against the eager runner, the profiler over replays,
        # then the served loop from captured graphs
        size = BLOCK_DFG_BATCH if dfg else BATCH
        xs = {b: [batch(b) for _ in range(3)] for b in (size, RAGGED)}
        run_one, _, _ = design._runner(backend, fmt, design.device, kw)
        line["replay_vs_eager"] = replay_vs_eager(torch, tag, run_one, xs)
        line["profile"] = device_profile(torch, lambda: run_one(xs[size][2]))
        run_one.release()
        del run_one
        registry.reset_launch_counts()
        served = design.serve([xs[size][i % 3]
                               for i in range(BLOCK_SERVE_BATCHES)],
                              backend=backend, fmt=fmt, cuda_kw=kw)
        torch.cuda.synchronize()
        counts = {k: v for k, v in registry.launch_counts().items() if v}
        want = {k: v * (BLOCK_SERVE_BATCHES + 1)
                for k, v in per_batch.items()}
        check(counts == want, f"{tag}: serve launched {counts}, want {want}")
        line["serve"] = {
            "batches": served.batches, "batch": size,
            "p50_ms": served.p50_ms, "p99_ms": served.p99_ms,
            "us_per_sample": served.us_per_sample,
            "device_idle_share_at_p50": 1.0 - line["profile"][
                "device_busy_us_per_batch"] / (served.p50_ms * 1e3)}
        emit(line)
        launches[label] = line["launches"]
        torch.cuda.empty_cache()
    kernels = block_kernels(torch, design, dfg_batches[0])
    emit({"phase": "transformer", "step": "kernels", "batch": BATCH,
          "dfg_batch": BLOCK_DFG_BATCH, "timing_notes": TIMING_NOTES,
          "kernels": kernels})
    t0 = time.perf_counter()
    rep = design.verify(scale=0.2)
    errs = {k: getattr(rep, k) for k in (
        "max_abs_err_opt", "max_abs_err_ref", "max_abs_err_quant",
        "max_abs_err_simd")}
    emit({"phase": "transformer", "step": "verify", "summary": rep.summary(),
          "passed": rep.passed, "seconds": time.perf_counter() - t0,
          **errs})
    check(rep.passed and all(math.isfinite(v) for v in errs.values()),
          f"transformer: design.verify failed on the card: "
          f"{rep.summary()}")
    return {"launches": launches, "kernels": kernels}


def phase_tune(torch, design) -> dict:
    """``Design.tune`` on BraggNN(s=1, img=11): the paper's bisection,
    dry, over ``braggnn_space()`` at ``TUNE_BUDGET`` trials, then the same
    call again, which the TuningDB serves without a search; then measure
    mode at ``TUNE_MEASURE_BUDGET`` trials, each candidate's DFG tier
    (K4) timed on the card; then ``apply_tuned`` (the measured entry wins)
    and the tuned design served through the DFG tier at its precision,
    equal to ``Design.run(fmt=design.precision)`` value for value, and
    through the nest tier at its precision, against its CPU run."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.core.precision import FORMATS
    from repro_torch.kernels import registry
    from repro_torch.models import braggnn
    from repro_torch.tune import TuningDB, braggnn_space

    space = braggnn_space()
    tmp = Path(tempfile.mkdtemp(prefix=".smoke_tune_", dir=ROOT))
    try:
        db = TuningDB(tmp / "tuning_db.json")
        kw = {"strategy": "bisect", "db": db, "scale": TUNE_SCALE}
        runs = {}
        for label, dry, budget in (("dry", True, TUNE_BUDGET),
                                   ("dry rerun", True, TUNE_BUDGET),
                                   ("measure", False, TUNE_MEASURE_BUDGET)):
            registry.reset_launch_counts()
            t0 = time.perf_counter()
            res = design.tune(space, budget=budget, dry=dry, **kw)
            torch.cuda.synchronize()
            counts = {k: v for k, v in registry.launch_counts().items()
                      if v}
            runs[label] = counts
            emit({"phase": "tune", "run": label, "budget": budget,
                  "seconds": time.perf_counter() - t0,
                  "from_db": res.from_db, "summary": res.summary(),
                  "launches": counts,
                  "trials": [{"candidate": t.candidate.label(),
                              "latency_us": t.latency_us,
                              "valid": t.valid, "err": t.err,
                              "est_roofline_us": t.est_roofline_us,
                              "measured_us": t.measured_us}
                             for t in res.trials]})
            check(res.from_db == (label == "dry rerun"),
                  f"tune {label}: from_db is {res.from_db}")
            check(res.best.valid, f"tune {label}: no valid candidate")
            if dry:
                check(not counts, f"tune {label} launched {counts}")
            else:
                check(counts.get("dfg_segment", 0) > 0
                      and set(counts) == {"dfg_segment"}
                      and all(t.measured_us is not None
                              and 0 < t.measured_us < 1e5
                              for t in res.trials),
                      f"tune measure: launches {counts}, measured "
                      f"{[t.measured_us for t in res.trials]}")
        tuned, cand = design.apply_tuned(space, db=db)
        check(cand is not None, "tune: apply_tuned found no entry")
        fmt = tuned.precision
        x = braggnn.synthetic_peaks(BATCH, IMG,
                                    torch.Generator().manual_seed(8))[0]
        fo = FORMATS[fmt] if fmt else None
        rep = tuned.serve([x, x[:RAGGED]], backend="cuda", fmt=fmt,
                          cuda_kw={"mode": "dfg"}, collect=True)
        out_name = next(iter(rep.outputs[0]))
        n_diff = 0
        for o, xb in zip(rep.outputs, (x, x[:RAGGED])):
            ref = tuned.run(xb[:N_CHECKED].numpy(), fmt=fo)[out_name]
            got = o[out_name][:N_CHECKED].cpu().numpy().reshape(ref.shape)
            n_diff += int(((got != ref)
                           & ~(np.isnan(got) & np.isnan(ref))).sum())
        check(n_diff == 0, f"tune: the tuned design's DFG tier differs from "
                           f"Design.run at {fmt} in {n_diff} outputs")
        # the nest tier rounds per kernel, the functional model per op: at
        # a format the two part by more than fp32 sums do, so the
        # reference's tolerance for a quantised design against its
        # functional model holds them
        nest = tuned.serve([x], backend="cuda", fmt=fmt, collect=True)
        got = nest.outputs[0][out_name][:N_CHECKED].cpu().numpy()
        ref = tuned.run(x[:N_CHECKED].numpy(), fmt=fo)[out_name]
        got = got.reshape(ref.shape)
        err = float(np.abs(got - ref).max())
        rtol, atol = ((TUNED_RTOL, TUNED_ATOL) if fo
                      else (SLICE_RTOL, SLICE_ATOL))
        check(bool(np.allclose(got, ref, rtol=rtol, atol=atol)),
              f"tune: the tuned nest tier differs from Design.run at {fmt} "
              f"by {err} (rtol {rtol}, atol {atol})")
        emit({"phase": "tune", "run": "apply_tuned",
              "candidate": cand.label(), "precision": fmt,
              "report": tuned.report().splitlines()[-1],
              "dfg_vs_evaluate": {"outputs_differing": n_diff,
                                  "samples_per_batch": N_CHECKED},
              "nest_vs_evaluate": {"max_abs_err": err, "rtol": rtol,
                                   "atol": atol},
              "served": [rep.served, nest.served]})
        return runs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class PeaksPipeline:
    """A seekable stream of synthetic-peak batches on the card for the
    ``TrainingDriver``: batch ``step`` comes from a generator seeded by
    (seed, step), so a seek replays the stream bit for bit."""

    def __init__(self, torch, batch: int, seed: int = 5):
        self.torch, self.batch, self.seed = torch, batch, seed

    def seek(self, step: int) -> None:
        pass

    def get(self, step: int) -> dict:
        from repro_torch.models import braggnn
        gen = self.torch.Generator().manual_seed(self.seed * 100_003 + step)
        x, y = braggnn.synthetic_peaks(self.batch, IMG, gen)
        return {"x": x.cuda(), "y": y.cuda()}

    def stop(self) -> None:
        pass


def pixel_error(torch, pred, y) -> float:
    """Mean localisation error in pixels (labels are centres / IMG, the
    model predicts 10x them), as the reference's precision study takes
    it."""
    pred = pred.reshape(len(y), -1).cpu()
    return float(torch.mean(torch.abs(pred / 10.0 - y.cpu()))) * IMG


def phase_train(torch) -> dict:
    """Training on the card, then the trained weights served through the
    kernels: ``ste_quantize``; the reference convergence test's recipe,
    timed per step, against its first steps on the CPU; the Fig. 7
    exponent histogram and the §4.2 precision sweep; the trained design
    through the nest tier (fp32, (5,4)), the NLB flash mode and the DFG
    tier at (5,4); the ``TrainingDriver``'s restart against an
    uninterrupted run, bit for bit; both examples."""
    import numpy as np
    from repro_torch.core.precision import (FORMATS, exponent_histogram,
                                            quantize, quantize_np,
                                            required_exponent_bits,
                                            ste_quantize)
    from repro_torch.kernels.quantize import probe_values
    from repro_torch.models import braggnn
    from repro_torch.nn.module import init_tree, map_tree
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    # 1. ste_quantize: the device quantiser forward, the identity backward
    res = {}
    for key, fmt in FORMATS.items():
        x = probe_values(fmt, 1 << 20, seed=12)
        xd = torch.from_numpy(x).cuda()
        got = ste_quantize(xd, fmt.exp_bits, fmt.man_bits)
        bits = got.cpu().numpy().view(np.int32)
        with np.errstate(over="ignore"):
            host = quantize_np(x, fmt)
        res[key] = {"values": int(x.size), "differ_from_quantize": int(
            (bits != quantize(xd, fmt).cpu().numpy().view(np.int32)).sum()),
            "differ_from_numpy": int((bits != host.view(np.int32)).sum())}
        check(not res[key]["differ_from_quantize"]
              and not res[key]["differ_from_numpy"],
              f"ste_quantize differs bitwise at {key}: {res[key]}")
    xg = torch.linspace(-2.0, 2.0, 4096, device="cuda", requires_grad=True)
    (grad,) = torch.autograd.grad(torch.sum(3.0 * ste_quantize(xg, 5, 4)),
                                  xg)
    check(bool((grad == 3.0).all()), "ste_quantize: the gradient of "
                                     "sum(3 q(x)) is not 3 everywhere")
    emit({"phase": "train", "step": "ste_quantize", "formats": res,
          "gradient_of_sum_3q": 3.0})

    # 2. the recipe of tests/test_braggnn_paper.py's convergence test
    model = braggnn.build(S, IMG)
    init = init_tree(model.specs(), torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batches = [braggnn.synthetic_peaks(TRAIN_BATCH, IMG, gen)
               for _ in range(TRAIN_STEPS)]
    eval_x, eval_y = braggnn.synthetic_peaks(
        BATCH, IMG, torch.Generator().manual_seed(99))
    cfg = adamw.AdamWConfig(peak_lr=3e-2, warmup_steps=20,
                            total_steps=10 * TRAIN_STEPS, weight_decay=0.0)
    step = braggnn.make_step(cfg)

    def held_out(params) -> float:
        with torch.no_grad():
            return float(braggnn.loss_fn(
                params, eval_x.to(params["conv1"]["w"].device),
                eval_y.to(params["conv1"]["w"].device)))

    def train(dev, n):
        params = map_tree(lambda t: t.to(dev), init)
        state = adamw.init_state(params)
        data = [(x.to(dev), y.to(dev)) for x, y in batches[:n]]
        losses, ms = [], []
        for x, y in data:
            t0 = time.perf_counter()
            params, state, loss = step(params, state, x, y)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
        return params, state, [float(v) for v in losses], ms

    cuda = torch.device("cuda")
    first = held_out(map_tree(lambda t: t.cuda(), init))
    params, state, losses, ms = train(cuda, TRAIN_STEPS)
    last = held_out(params)
    x0, y0 = batches[0][0].cuda(), batches[0][1].cuda()
    prof = device_profile(torch, lambda: step(params, state, x0, y0))
    prof_eager = device_profile(torch,
                                lambda: step.eager(params, state, x0, y0))
    _, _, cpu_losses, _ = train(torch.device("cpu"), TRAIN_CPU_STEPS)
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(losses[:TRAIN_CPU_STEPS], cpu_losses))
    emit({"phase": "train", "step": "train", "steps": TRAIN_STEPS,
          "batch": TRAIN_BATCH, "recipe": dataclasses.asdict(cfg),
          "held_out_loss_first": first, "held_out_loss_last": last,
          "held_out_drop": first / last, "loss_first": losses[0],
          "loss_last": losses[-1],
          "step_ms": {"first": ms[0], "p50": statistics.median(ms[1:]),
                      "p99": float(np.percentile(ms[1:], 99))},
          "step_profile": {k: v for k, v in prof.items()
                           if k not in ("kernels", "host_top")},
          "step_profile_host_top": prof["host_top"],
          "step_profile_top": prof["kernels"][:8],
          "step_profile_eager": {k: v for k, v in prof_eager.items()
                                 if k not in ("kernels", "host_top")},
          "vs_cpu": {"steps": TRAIN_CPU_STEPS, "max_rel_diff": rel,
                     "rtol": TRAIN_LOSS_RTOL, "cpu_losses": cpu_losses,
                     "card_losses": losses[:TRAIN_CPU_STEPS]}})
    check(last < first / TRAIN_MIN_DROP,
          f"train: held-out loss {first} -> {last}, not a "
          f"{TRAIN_MIN_DROP}x drop")
    check(rel <= TRAIN_LOSS_RTOL, f"train: the card's losses differ from "
                                  f"the CPU's by {rel} (rtol "
                                  f"{TRAIN_LOSS_RTOL})")

    # 3. Fig. 7 and the §4.2 precision sweep on the trained weights
    hist = exponent_histogram(params)
    ex, ey = eval_x.cuda(), eval_y.cuda()
    with torch.no_grad():
        pixel = {fmt or "fp32": pixel_error(
            torch, braggnn.forward(params, ex, fmt=fmt), ey)
            for fmt in (None, "5_11", "5_4", "5_3")}
    emit({"phase": "train", "step": "precision",
          "exponent_histogram": dict(sorted(hist.items())),
          "exp_min": min(hist), "exp_max": max(hist),
          "required_we_100": required_exponent_bits(hist, 1.0),
          "required_we_999": required_exponent_bits(hist, 0.999),
          "paper_we": 5, "pixel_error_tensor_twin": pixel})

    # 4. the trained weights through the kernels
    trained = served_trained(torch, model, params, (eval_x, eval_y))
    trained["pixel_error_tensor_twin_5_4"] = pixel["5_4"]

    # 5. under deterministic cuDNN/cuBLAS: the replayed step against the
    # eager one, and the TrainingDriver's restart against an uninterrupted
    # run
    deterministic_steps(torch, init, cfg, batches)

    # 6. the examples, in-process
    run_examples()
    emit({"phase": "train", "step": "done",
          "seconds": time.perf_counter() - t_phase})
    return trained


def served_trained(torch, model, params, held_out) -> dict:
    """The trained weights bound and compiled (the session's design cache
    serves the schedule phase compile made: the weights are feeds, not
    part of the design), then served: the nest tier at fp32 and (5,4)
    (K1, K2, K3), the NLB flash mode (K1, K3, K5) and the DFG tier at
    (5,4) (K4), each held as phase serve holds it.  Returns the launches
    of the four runs, each counted from 0, and the nest tier's (5,4)
    pixel error on the held-out peaks."""
    import repro_torch.hls as hls
    from repro_torch.models import braggnn
    from repro_torch.nn.module import map_tree

    eval_x, eval_y = held_out
    t0 = time.perf_counter()
    design = hls.compile(model.bind(map_tree(lambda t: t.detach().cpu(),
                                             params)))
    compile_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(3)
    batches = [eval_x, braggnn.synthetic_peaks(BATCH, IMG, gen)[0],
               braggnn.synthetic_peaks(RAGGED, IMG, gen)[0]]
    evaluated = [design.run(x[:N_CHECKED].numpy()) for x in batches]
    out_name = next(iter(evaluated[0]))
    tag = {"weights": "trained"}
    runs = {}
    for fmt in (None, "5_4"):
        _, runs[f"nest {fmt or 'fp32'}"], outs = serve_held(
            torch, design, batches, evaluated, out_name, "cuda", fmt,
            NEST_PLAN, NEST_PER_BATCH, **tag)
    nest_px = pixel_error(torch, outs[0], eval_y)
    runs["flash fp32"] = serve_flash(torch, design, batches, evaluated,
                                     out_name, NEST_PLAN, NEST_PER_BATCH,
                                     **tag)
    runs["dfg 5_4"] = serve_dfg(torch, design, batches, out_name,
                                fmts=("5_4",), **tag)["5_4"]
    launches = {}
    for counts in runs.values():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    emit({"phase": "train", "step": "serve trained", "compile_s": compile_s,
          "design_cache": design.session.stats(),
          "launches_by_run": runs, "launches": launches,
          "pixel_error_nest_5_4": nest_px})
    missing = [k for k in KERNEL_META if not launches.get(k)]
    check(not missing, f"train: {missing} not launched with the trained "
                       f"weights")
    return {"launches": launches, "pixel_error_nest_5_4": nest_px}


def deterministic_steps(torch, init, cfg, batches) -> None:
    """Deterministic cuDNN and cuBLAS for these runs only
    (``CUBLAS_WORKSPACE_CONFIG`` is set when the script starts, before
    cuBLAS is first used), with a step made and so captured under them:
    GRAPHED_STEPS steps replayed from the captured graph against
    ``step.eager``, losses and the final parameters and moments bit for
    bit; then the ``TrainingDriver``'s restart."""
    from repro_torch.models import braggnn
    from repro_torch.nn.module import map_tree, tree_leaves
    from repro_torch.optim import adamw

    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        step = braggnn.make_step(cfg)
        runs = {}
        for label, fn in (("replayed", step), ("eager", step.eager)):
            params = map_tree(lambda t: t.cuda(), init)
            state = adamw.init_state(params)
            losses = []
            for x, y in batches[:GRAPHED_STEPS]:
                params, state, loss = fn(params, state, x.cuda(), y.cuda())
                losses.append(loss)
            runs[label] = ([float(v) for v in losses],
                           tree_leaves((params, state)))
        differ = sum(value_diff(torch, a, b) for a, b in zip(
            runs["replayed"][1], runs["eager"][1]))
        emit({"phase": "train", "step": "replayed vs eager",
              "steps": GRAPHED_STEPS, "losses_replayed": runs["replayed"][0],
              "losses_eager": runs["eager"][0],
              "losses_equal": runs["replayed"][0] == runs["eager"][0],
              "state_values_differing": differ, "deterministic": True})
        check(runs["replayed"][0] == runs["eager"][0] and differ == 0,
              f"train: the replayed step's losses {runs['replayed'][0]} "
              f"and state ({differ} values differing) are not the eager "
              f"step's {runs['eager'][0]}")
        driver_restart(torch, init, step)
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic = saved[1]
        torch.backends.cudnn.benchmark = saved[2]


def driver_restart(torch, init, step) -> None:
    """``TrainingDriver`` for DRIVER_STEPS steps, a checkpoint every
    DRIVER_EVERY, once clean and once with a failure injected at
    DRIVER_FAIL_AT: the restarted run's losses and final checkpoint equal
    the clean run's bit for bit (``step`` replays its captured graph)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.nn.module import map_tree, tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.runtime import (DriverConfig, FailureInjector,
                                     TrainingDriver)

    def train_step(params, opt, batch):
        params, opt, loss = step(params, opt, batch["x"], batch["y"])
        return params, opt, {"loss": loss}

    tmp = Path(tempfile.mkdtemp(prefix=".smoke_train_", dir=ROOT))
    try:
        reps, drivers, t0 = {}, {}, time.perf_counter()
        for label, fail_at in (("clean", ()), ("failure", (DRIVER_FAIL_AT,))):
            params = map_tree(lambda t: t.cuda(), init)
            drivers[label] = TrainingDriver(
                DriverConfig(total_steps=DRIVER_STEPS,
                             checkpoint_every=DRIVER_EVERY, max_restarts=3),
                train_step=train_step,
                pipeline=PeaksPipeline(torch, TRAIN_BATCH),
                ckpt=CheckpointManager(str(tmp / label), keep=3),
                injector=FailureInjector(fail_at))
            reps[label] = drivers[label].run(params,
                                             adamw.init_state(params))
        seconds = time.perf_counter() - t0
        a, b = reps["clean"].losses, reps["failure"].losses
        # the failed run: steps 0..FAIL_AT-1, then from the last checkpoint
        resumed = DRIVER_FAIL_AT // DRIVER_EVERY * DRIVER_EVERY
        want = a[:DRIVER_FAIL_AT] + a[resumed:]
        final = [CheckpointManager(str(tmp / k)).restore(
            {"params": init, "opt": adamw.init_state(init)}, device="cpu")
            for k in ("clean", "failure")]
        differ = sum(x.numpy().tobytes() != y.numpy().tobytes()
                     for x, y in zip(tree_leaves(final[0][0]),
                                     tree_leaves(final[1][0])))
        emit({"phase": "train", "step": "driver", "steps": DRIVER_STEPS,
              "checkpoint_every": DRIVER_EVERY, "fail_at": DRIVER_FAIL_AT,
              "restarts": reps["failure"].restarts,
              "fired": drivers["failure"].injector.fired,
              "losses_clean": a, "losses_failure": b,
              "losses_equal_bitwise": b == want,
              "final_checkpoint_steps": [f[1] for f in final],
              "final_checkpoint_leaves_differing": differ,
              "seconds": seconds, "deterministic": True})
        check(reps["failure"].restarts == 1
              and drivers["failure"].injector.fired == [DRIVER_FAIL_AT],
              f"driver: restarts {reps['failure'].restarts}, fired "
              f"{drivers['failure'].injector.fired}")
        check(b == want, f"driver: the restarted run's losses {b} differ "
                         f"from the clean run's {a}")
        check(differ == 0 and final[0][1] == final[1][1] == DRIVER_STEPS,
              f"driver: final checkpoints differ in {differ} leaves")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_examples() -> None:
    """``quickstart.main([])``, ``braggnn_serve.main``: ``--save``, then
    ``--load ... --engine``, and ``train_lm.main(["--steps", "40"])`` (its
    restart happens and its loss falls), on the card, with the port's
    cache root and the checkpoints in a temporary directory of the
    checkout."""
    import os
    import shutil
    import tempfile

    from repro_torch.examples import braggnn_serve, quickstart, train_lm

    tmp = Path(tempfile.mkdtemp(prefix=".smoke_examples_", dir=ROOT))
    saved = os.environ.get("REPRO_TORCH_CACHE_DIR")
    os.environ["REPRO_TORCH_CACHE_DIR"] = str(tmp / "cache")
    try:
        art = tmp / "braggnn.design"
        wall, out = {}, {}
        for label, fn, argv in (
                ("quickstart", quickstart.main, []),
                ("braggnn_serve --save", braggnn_serve.main,
                 ["--save", str(art)]),
                ("braggnn_serve --load --engine", braggnn_serve.main,
                 ["--load", str(art), "--engine"]),
                ("train_lm --steps 40", train_lm.main,
                 ["--steps", "40", "--ckpt", str(tmp / "lm_ckpt")])):
            t0 = time.perf_counter()
            out[label] = fn(argv)
            wall[label] = time.perf_counter() - t0
        lm_report = out["train_lm --steps 40"]
        emit({"phase": "train", "step": "examples", "wall_s": wall,
              "artifact_bytes": art.stat().st_size,
              "train_lm": {"restarts": lm_report.restarts,
                           "first_loss": lm_report.losses[0],
                           "last_loss": lm_report.losses[-1],
                           "steps_run": len(lm_report.losses)}})
    finally:
        if saved is None:
            os.environ.pop("REPRO_TORCH_CACHE_DIR", None)
        else:
            os.environ["REPRO_TORCH_CACHE_DIR"] = saved
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# The decoder LM at Qwen2.5-3B's full width
# ---------------------------------------------------------------------------

#: phase lm serves the LM launcher's default architecture at its published
#: width and depth (36 layers, d_model 2048, 16 heads over 2 KV heads,
#: head dim 128, d_ff 11008, vocab 151936, bf16 activations), nothing cut
LM_ARCH, LM_PARAMS = "qwen2.5-3b", 3_085_938_688
#: K5 at the LM's shapes: a Qwen2.5-3B prefill of batch 4 (B*H = 64, S =
#: 1,024, D = 128, causal), and gemma2's local options at a ragged S
LM_FLASH_CASES = ((64, 1024, 128, {"causal": True}),
                  (64, 333, 128, {"causal": True, "window": 128,
                                  "logit_cap": 50.0}))
#: prefill: batch, sequence, timed calls (host clock, each synchronised)
LM_PREFILL_B, LM_PREFILL_S, LM_PREFILL_RUNS = 4, 1024, 7
#: forward against decode: batch and sequence; the reference's own bar
#: (tests/test_nn_blocks.py), relative to the logit scale (max |logit|)
LM_DECODE_B, LM_DECODE_S, LM_DECODE_TOL = 2, 64, 0.01
#: the card against the CPU at reduced depth: layers, sequence, and the
#: bf16 bar of PERF.md (max |difference| over the logit scale): the card's
#: cuBLAS GEMMs and K5 sum in other orders than the CPU's widened fp32
#: products and the plain attention, which moves bf16 roundings
LM_CPU_LAYERS, LM_CPU_S, LM_BF16_TOL = 2, 256, 0.02
#: the engine: lanes, cache length, requests, prompt lengths, new tokens
LM_LANES, LM_MAX_LEN, LM_REQUESTS, LM_PROMPT, LM_NEW = 8, 1024, 32, \
    (16, 256), 64


def attention_layers(cfg) -> int:
    """The layers of ``cfg`` that attend (``global``/``local``): each
    launches K5 once in a prefill."""
    period = cfg.attn_pattern
    kinds = [period[i % len(period)] for i in range(cfg.n_layers)]
    return sum(k in ("global", "local") for k in kinds)


def forward_launches(cfg) -> dict:
    """The port's kernel launches of one ``forward`` (a prefill) of
    ``cfg``: K5 once per attending layer, the sLSTM time loop once per
    ``slstm`` layer, nothing else (kernels launched 0 times left out)."""
    period = cfg.attn_pattern
    n_slstm = sum(period[i % len(period)] == "slstm"
                  for i in range(cfg.n_layers))
    return {k: n for k, n in (("flash_attention", attention_layers(cfg)),
                              ("slstm_scan", n_slstm)) if n}


def causal_pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs a causal (optionally windowed) head of S rows
    scores: the work K5's data needs."""
    if not window:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


def lm_flash(torch) -> dict:
    """K5 at the LM's shapes against its plain version, timed beside
    ``F.scaled_dot_product_attention`` (where one call computes the same
    function: not with a soft-cap) and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, launch_shape)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(20)
    calls, shapes = [], {}
    for bh, s, d, kw in LM_FLASH_CASES:
        q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda")
                   for _ in range(3))
        call = f"({bh}, {s}, {d}) " + ",".join(f"{a}={b}"
                                              for a, b in kw.items())
        library = None
        if "logit_cap" not in kw:
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True)
        pairs = causal_pairs(s, kw.get("window", 0))
        calls.append(kernel_call(
            torch, call, lambda: flash_attention(q, k, v, **kw),
            lambda: flash_attention_ref(q, k, v, **kw), library,
            4 * 4 * bh * s * d, 4 * bh * pairs * d,
            rtol=FLASH_RTOL, atol=FLASH_ATOL, plain_runs=20))
        if library is None:
            # no PyTorch call computes the soft-cap: SDPA with the window
            # as a boolean mask and no cap, a yardstick of the same size
            mask = windowed_mask(torch, s, kw["window"])
            calls[-1]["sdpa_window_mask_no_cap_ms"] = device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask), label=f"{call} sdpa, no cap")
        shapes[call] = launch_shape(bh, s, s, d)
        del q, k, v
    torch.cuda.empty_cache()
    return {"calls": calls, "launch_shapes": shapes}


def lm_forward_vs_decode(torch, cfg, params, dev, b: int, s: int) -> dict:
    """``transformer.forward``'s logits against ``s`` decode steps through
    the bf16 cache: the largest difference over the logit scale, and the
    share of positions whose greedy tokens agree."""
    from repro_torch.nn import transformer
    gen = torch.Generator().manual_seed(21)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen).to(dev)
    full = transformer.forward(cfg, params, toks)[0]
    cache = transformer.init_cache(cfg, b, s, device=dev)
    steps = []
    for t in range(s):
        lg, cache = transformer.decode_step(
            cfg, params, toks[:, t:t + 1], cache,
            torch.full((b,), t, device=dev))
        steps.append(lg)
    dec = torch.stack(steps, 1)
    scale = float(full.abs().max())
    return {"batch": b, "seq": s, "logit_scale": scale,
            "max_abs_err": float((dec - full).abs().max()),
            "err_over_scale": float((dec - full).abs().max()) / scale,
            "greedy_agree_share": float(
                (dec.argmax(-1) == full.argmax(-1)).float().mean())}


def lm_engine_run(torch, cfg, params, *, lanes: int, max_len: int,
                  requests: int, prompt: tuple, new: int,
                  hold_alone: bool = True, max_ticks: int = 0) -> dict:
    """The continuous-batching engine over ``requests`` seeded prompts,
    each tick timed on the host (a tick ends in the next tokens' copy to
    the host; the first captures the decode step's graph, the rest replay
    it); then the middle request again, alone in the same engine, whose
    tokens must equal those it got among the others where ``hold_alone``
    (an MoE's capacity drops depend on the other lanes' routing, so there
    the comparison is reported).  ``max_ticks`` > 0 stops after that many
    ticks and skips the rest."""
    from repro_torch.serving import ServingEngine, percentiles
    eng = ServingEngine(cfg, params, max_batch=lanes, max_len=max_len)
    gen = torch.Generator().manual_seed(22)
    prompts = []
    for _ in range(requests):
        n = int(torch.randint(prompt[0], prompt[1] + 1, (), generator=gen))
        prompts.append(torch.randint(1, cfg.vocab_size, (n,),
                                     generator=gen).tolist())
        eng.submit(prompts[-1], max_new_tokens=new)
    ticks = []
    t0 = time.perf_counter()
    while len(eng.queue) or any(lane.req for lane in eng.lanes):
        t1 = time.perf_counter()
        eng.tick()
        ticks.append((time.perf_counter() - t1) * 1e3)
        check(len(ticks) < 100_000, "the engine did not drain")
        if len(ticks) == max_ticks:
            break
    wall = time.perf_counter() - t0
    graphs = len(eng._step.replay_launches())
    check(graphs == 1, f"engine: {graphs} captured decode steps, want 1")
    if max_ticks:
        tick = percentiles(ticks[1:])
        eng.release()
        return {"lanes": lanes, "max_len": max_len, "ticks": len(ticks),
                "first_tick_ms": ticks[0], "tick_ms_p50": tick["p50"],
                "tick_ms_p99": tick["p99"],
                "generated_tokens": sum(len(r.output) for r in eng.finished)
                + sum(len(lane.req.output) for lane in eng.lanes
                      if lane.req)}
    done = {r.rid: r for r in eng.finished}
    check(len(done) == requests and all(
        len(r.output) == new for r in done.values()),
        f"engine: {len(done)} of {requests} requests finished, lengths "
        f"{sorted({len(r.output) for r in done.values()})} (want {new})")
    # the request packed in the middle of the run, so it shared its ticks
    # with others, again alone among idle lanes
    rid = requests // 2
    eng.finished.clear()
    eng.submit(prompts[rid], max_new_tokens=new)
    alone = eng.run_until_drained()[0].output
    packed = done[rid].output
    check(alone == packed or not hold_alone,
          f"engine: request {rid} alone gave {alone}, among the others "
          f"{packed}")
    eng.release()
    lat = percentiles([r.latency_s * 1e3 for r in done.values()])
    ttft = percentiles([(r.first_token_t - r.submit_t) * 1e3
                        for r in done.values()])
    tick = percentiles(ticks)
    return {"lanes": lanes, "max_len": max_len, "requests": requests,
            "prompt_tokens": sum(len(p) for p in prompts),
            "generated_tokens": requests * new, "ticks": len(ticks),
            "wall_s": wall,
            "generated_tokens_per_s": requests * new / wall,
            "first_tick_ms": ticks[0],
            "tick_ms_p50": tick["p50"], "tick_ms_p99": tick["p99"],
            "ttft_ms_p50": ttft["p50"], "request_ms_p50": lat["p50"],
            "request_ms_p99": lat["p99"],
            "alone_equals_packed": alone == packed,
            "alone_tokens_equal": sum(a == b for a, b in zip(alone, packed)),
            "alone_held": hold_alone, "request_checked": rid}


def phase_lm(torch) -> dict:
    """The decoder LM's serving path at Qwen2.5-3B's full width: K5 at the
    LM's shapes; the model drawn on the card; ``lm.prefill`` timed,
    profiled and counted (36 K5 launches a call); ``forward`` against the
    cached decode; the card against the CPU at two layers; the engine; the
    launcher's CLI in a subprocess."""
    from repro_torch.configs import registry as configs
    from repro_torch.kernels import registry
    from repro_torch.models import lm
    from repro_torch.nn import module, transformer

    t_phase = time.perf_counter()
    flash = lm_flash(torch)
    emit({"phase": "lm", "step": "flash_attention", **flash})

    # the model, drawn on the card from a seed
    cfg = configs.get_config(LM_ARCH)
    specs = transformer.model_specs(cfg)
    n_params = module.param_count(specs)
    check(n_params == LM_PARAMS and cfg.n_layers == 36,
          f"{LM_ARCH}: {n_params} parameters in {cfg.n_layers} layers, "
          f"want {LM_PARAMS} in 36")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = module.init_tree(
        specs, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cache_bytes = sum(t.numel() * t.element_size() for t in module.tree_leaves(
        transformer.init_cache(cfg, 1, 1, device="meta")))
    emit({"phase": "lm", "step": "model", "arch": LM_ARCH,
          "parameters": n_params, "param_bytes": module.param_bytes(specs),
          "activation_dtype": cfg.activation_dtype,
          "cache_bytes_per_token_slot": cache_bytes,
          "cache_bytes_engine": cache_bytes * LM_LANES * LM_MAX_LEN,
          "init_s": init_s,
          "device_bytes": torch.cuda.memory_allocated()})

    # prefill: ms per call, K5's launches, and where the time goes
    gen = torch.Generator(device="cuda").manual_seed(23)
    toks = torch.randint(0, cfg.vocab_size, (LM_PREFILL_B, LM_PREFILL_S),
                         generator=gen, device="cuda")
    logits = lm.prefill(cfg, params, toks)
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    times = []
    for _ in range(LM_PREFILL_RUNS):
        t0 = time.perf_counter()
        logits = lm.prefill(cfg, params, toks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = {k: v for k, v in registry.launch_counts().items() if v}
    per_call = {k: v / LM_PREFILL_RUNS for k, v in counts.items()}
    check(per_call == {"flash_attention": cfg.n_layers},
          f"prefill launched {per_call} per call, want flash_attention "
          f"{cfg.n_layers} and nothing else")
    check(tuple(logits.shape) == (LM_PREFILL_B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)} not finite")
    prof = device_profile(torch, lambda: lm.prefill(cfg, params, toks),
                          reps=2)
    k5_us = sum(k["device_us_per_batch"] for k in prof["kernels"]
                if "flash_attention" in k["name"])
    p50 = statistics.median(times)
    emit({"phase": "lm", "step": "prefill", "batch": LM_PREFILL_B,
          "seq": LM_PREFILL_S, "runs": LM_PREFILL_RUNS, "ms_p50": p50,
          "ms": times, "tokens_per_s": LM_PREFILL_B * LM_PREFILL_S / p50
          * 1e3, "launches_per_call": per_call,
          "flash_attention_share_of_busy":
              k5_us / prof["device_busy_us_per_batch"]
              if prof["device_time_seen"] else None,
          "flash_attention_us_per_call": k5_us,
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          **{k: v for k, v in prof.items() if k != "kernels"},
          "kernels_top": prof["kernels"][:12]})
    del logits, toks

    # forward (K5) against the cached decode (plain attention)
    registry.reset_launch_counts()
    fvd = lm_forward_vs_decode(torch, cfg, params, "cuda", LM_DECODE_B,
                               LM_DECODE_S)
    fvd["flash_attention_launches"] = registry.launch_counts()[
        "flash_attention"]
    emit({"phase": "lm", "step": "forward vs decode", **fvd,
          "tolerance_over_scale": LM_DECODE_TOL})
    check(fvd["flash_attention_launches"] == cfg.n_layers,
          f"forward launched K5 {fvd['flash_attention_launches']} times")
    check(fvd["err_over_scale"] <= LM_DECODE_TOL,
          f"forward against decode: {fvd['err_over_scale']:.4g} of the "
          f"logit scale, over {LM_DECODE_TOL}")

    # one decode tick of the engine's width: replayed against eager,
    # both profiled
    tick = decode_tick(torch, cfg, params, LM_LANES, LM_MAX_LEN, gen)
    emit({"phase": "lm", "step": "decode tick", **tick})

    # the engine
    registry.reset_launch_counts()
    eng = lm_engine_run(torch, cfg, params, lanes=LM_LANES,
                        max_len=LM_MAX_LEN, requests=LM_REQUESTS,
                        prompt=LM_PROMPT, new=LM_NEW)
    eng["port_kernel_launches"] = {
        k: v for k, v in registry.launch_counts().items() if v}
    emit({"phase": "lm", "step": "engine", **eng})
    del params
    free_card(torch)

    # the card against the CPU at reduced depth, the same numpy weights
    cpu_check = lm_card_vs_cpu(torch, cfg.replace(n_layers=LM_CPU_LAYERS))
    emit({"phase": "lm", "step": "card vs cpu", **cpu_check,
          "tolerance_over_scale": LM_BF16_TOL})

    # the launcher's CLI at the published config, in a subprocess
    cli = run_module(["repro_torch.launch.serve", "--arch", LM_ARCH,
                      "--no-tiny", "--requests", "8"])
    emit({"phase": "lm", "step": "cli", **cli})
    emit({"phase": "lm", "step": "done",
          "seconds": time.perf_counter() - t_phase})
    # the launches of one prefill, as counted over the timed calls
    return {"launches": {k: int(v) for k, v in per_call.items()},
            "flash": flash}


def free_card(torch) -> None:
    """Return what the dropped models, caches and graphs held to the card
    (a collection first: a cycle would keep them alive)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def decode_tick(torch, cfg, params, lanes: int, max_len: int, gen,
                kept=None) -> dict:
    """The engine's step (``decode_step`` and the greedy token) at
    ``lanes`` lanes, replayed from its captured CUDA graph and run eagerly
    on the same tokens and positions, each writing its own copy of one
    cache: over three ticks (the first captures, two replay) tokens,
    logits and finally the caches must be equal value for value.  Then
    one tick of each profiled, and ``kept`` (a :class:`KeptShare`) over
    one eager tick."""
    from repro_torch.core.graphs import GraphRunner
    from repro_torch.nn import transformer
    from repro_torch.nn.module import tree_leaves

    def tick_of(cache):
        def tick(f):
            logits, _ = transformer.decode_step(cfg, params, f["tokens"],
                                                cache, f["pos"])
            return {"tokens": torch.argmax(logits, dim=-1).to(torch.int32),
                    "logits": logits}
        return tick

    caches = [transformer.init_cache(cfg, lanes, max_len, device="cuda")
              for _ in range(2)]
    run = GraphRunner(tick_of(caches[0]), torch.device("cuda"))
    eager = tick_of(caches[1])
    differ = {"tokens": 0, "logits": 0}
    for t in range(3):
        feeds = {"tokens": torch.randint(1, cfg.vocab_size, (lanes, 1),
                                         generator=gen, device="cuda"),
                 "pos": torch.arange(lanes, device="cuda")
                 * (max_len // lanes) + 7 * t}
        got, want = run(feeds), eager(feeds)
        for k in differ:
            differ[k] += value_diff(torch, got[k], want[k])
    cache_differ = sum(value_diff(torch, a, b) for a, b in zip(
        tree_leaves(caches[0]), tree_leaves(caches[1])))
    check(differ == {"tokens": 0, "logits": 0} and cache_differ == 0,
          f"{cfg.name} decode tick: a replay differs from the eager step "
          f"in {differ} values and the caches in {cache_differ}")
    graphs = run.replay_launches()
    check(len(graphs) == 1, f"{cfg.name} decode tick: {len(graphs)} graphs")
    per_replay = next(iter(graphs.values()))
    profiles = {"replayed": device_profile(torch, lambda: run(feeds),
                                           reps=3),
                "eager": device_profile(torch, lambda: eager(feeds),
                                        reps=3)}
    share = None
    if kept is not None:
        with kept:
            eager(feeds)
        share = kept.share()
    run.release()
    del caches
    torch.cuda.empty_cache()
    return {"lanes": lanes, "positions": feeds["pos"].tolist(),
            "replays_checked": 2, "port_launches_per_replay": per_replay,
            "values_differing": differ,
            "cache_values_differing": cache_differ,
            "routed_kept_share": share,
            **{f"{label}_{k}": v for label, prof in profiles.items()
               for k, v in prof.items() if k not in ("kernels", "host_top")},
            "replayed_kernels_top": profiles["replayed"]["kernels"][:12],
            "eager_kernels_top": profiles["eager"]["kernels"][:12],
            "eager_host_top": profiles["eager"]["host_top"]}


def lm_card_vs_cpu(torch, cfg, patches: int = 0) -> dict:
    """``forward`` of ``cfg`` on the card (K5) and on the CPU (K5's plain
    version) from the same numpy weights and prompt (``patches`` seeded
    patch embeddings in front of it, the VLM's): the largest logit
    difference over the scale, held to ``LM_BF16_TOL``."""
    from repro_torch.kernels import registry
    from repro_torch.nn import module, transformer
    weights = module.map_tree(lambda t: t.numpy(), module.init_tree(
        transformer.model_specs(cfg), torch.Generator().manual_seed(24)))
    toks = torch.randint(0, cfg.vocab_size, (1, LM_CPU_S),
                         generator=torch.Generator().manual_seed(25))
    pt = torch.randn(1, patches, cfg.d_model,
                     generator=torch.Generator().manual_seed(26)) \
        if patches else None
    registry.reset_launch_counts()
    card = transformer.forward(cfg, module.params_from_numpy(
        weights, device="cuda"), toks.cuda(),
        patches=None if pt is None else pt.cuda())[0].cpu()
    launched = {k: v for k, v in registry.launch_counts().items() if v}
    want = forward_launches(cfg)
    check(launched == want, f"card forward launched {launched}, want "
                            f"{want}")
    launches = launched.get("flash_attention", 0)
    t0 = time.perf_counter()
    cpu = transformer.forward(cfg, module.params_from_numpy(weights), toks,
                              patches=pt)[0]
    cpu_s = time.perf_counter() - t0
    scale = float(cpu.abs().max())
    err = float((card - cpu).abs().max())
    check(bool(torch.isfinite(card).all()) and err <= LM_BF16_TOL * scale,
          f"card against CPU at {cfg.n_layers} layers: {err / scale:.4g} of "
          f"the logit scale, over {LM_BF16_TOL}")
    return {"layers": cfg.n_layers, "seq": LM_CPU_S, "patches": patches,
            "logit_scale": scale,
            "max_abs_err": err, "err_over_scale": err / scale,
            "greedy_agree_share": float(
                (card.argmax(-1) == cpu.argmax(-1)).float().mean()),
            "flash_attention_launches": launches,
            "port_kernel_launches": launched, "cpu_forward_s": cpu_s}


def run_module(argv: list) -> dict:
    """``python -m <argv>`` in a subprocess from the checkout: it must exit
    0."""
    cmd = [sys.executable, "-m", *argv]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ,
                                               PYTHONPATH=str(SRC)))
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"{' '.join(cmd[1:])} exited "
                               f"{res.returncode}: {res.stderr[-2000:]}")
    return {"command": " ".join(cmd[1:]), "returncode": res.returncode,
            "wall_s": wall, "stdout": res.stdout.strip()[-400:],
            "stderr_tail": res.stderr.strip()[-300:]}


# ---------------------------------------------------------------------------
# The MoE family: qwen2-moe-a2.7b at full width, Mixtral-8x7b cut in depth
# ---------------------------------------------------------------------------

#: qwen2-moe-a2.7b at its published width and depth, nothing cut (24
#: layers, d_model 2048, 16 heads of 128, 60 experts padded to 64, top 4,
#: expert d_ff 1,408, shared d_ff 5,632, vocab 151,936, bf16 activations)
MOE_ARCH, MOE_PARAMS = "qwen2-moe-a2.7b", 15_146_452_992
#: Mixtral-8x7b at full width; its 46.7 B parameters (186.8 GB in fp32)
#: cannot sit on one 80 GB card, so its depth is cut to 4 of 32 layers
MIXTRAL_ARCH, MIXTRAL_LAYERS, MIXTRAL_PARAMS = "mixtral-8x7b", 4, \
    6_067_228_672
#: K5 at Mixtral's prefill of batch 4: B*H 128, S 1,024, D 128, window
#: 4,096 (wider than S, so SDPA's causal call computes the same function)
MIXTRAL_FLASH = (128, 1024, 128, {"causal": True, "window": 4096})
#: prefill timed calls; Mixtral's engine ticks (the phase's time limit)
MOE_PREFILL_RUNS, MIXTRAL_TICKS = 5, 16
#: the share of a prefill's routed assignments kept within the capacity,
#: to three places: the reference's routing of these seeded weights and
#: tokens, which routing all chunks in one pass must not change
MOE_KEPT_SHARE = {MOE_ARCH: 0.933, MIXTRAL_ARCH: 0.996}


class KeptShare:
    """Within ``with``: the routed assignments ``nn.moe._plan`` plans (the
    routing of every ``moe`` call) and the share kept within the capacity
    (summed on the card, read once)."""

    def __enter__(self):
        from repro_torch.nn import moe
        self.moe, self.plan = moe, moe._plan
        self.kept, self.total = [], 0

        def plan(*a, **kw):
            out = self.plan(*a, **kw)
            self.kept.append(out[0].keep.sum())
            self.total += out[0].keep.numel()
            return out
        moe._plan = plan
        return self

    def __exit__(self, *exc):
        self.moe._plan = self.plan

    def share(self) -> float:
        return float(sum(self.kept)) / self.total


def prefill_run(torch, cfg, params, b: int, s: int, runs: int, seed: int,
                kept=None, patches: int = 0) -> dict:
    """``lm.prefill`` at b x s on seeded tokens (``patches`` seeded patch
    embeddings in front of each, the VLM's): p50 of ``runs`` calls,
    tokens/s over every position, K5 launched once per attending layer,
    the sLSTM kernel once per sLSTM layer and nothing else of the port's
    (:func:`forward_launches`), finite logits, one call profiled by kernel
    name; ``kept`` (a :class:`KeptShare`) over the first, untimed call."""
    import contextlib
    from repro_torch.kernels import registry
    from repro_torch.models import lm

    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device="cuda")
    pt = torch.randn(b, patches, cfg.d_model, generator=gen,
                     device="cuda") if patches else None

    def prefill():
        return lm.prefill(cfg, params, toks, patches=pt)
    torch.cuda.reset_peak_memory_stats()
    with kept or contextlib.nullcontext():
        logits = prefill()
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        logits = prefill()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    per_call = {k: v / runs for k, v in registry.launch_counts().items()
                if v}
    want = forward_launches(cfg)
    check(per_call == want,
          f"{cfg.name} prefill launched {per_call} per call, want {want} "
          f"and nothing else")
    check(tuple(logits.shape) == (b, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{cfg.name} prefill logits {tuple(logits.shape)} not finite")
    prof = device_profile(torch, prefill, reps=1)
    port_us = {name: sum(k["device_us_per_batch"] for k in prof["kernels"]
                         if name in k["name"]) for name in want}
    k5_us = port_us.get("flash_attention", 0.0)
    p50 = statistics.median(times)
    return {"arch": cfg.name, "layers": cfg.n_layers, "batch": b, "seq": s,
            "patches": patches, "runs": runs, "ms_p50": p50, "ms": times,
            "tokens_per_s": b * (patches + s) / p50 * 1e3,
            "launches_per_call": per_call,
            "flash_attention_us_per_call": k5_us,
            "flash_attention_share_of_busy":
                k5_us / prof["device_busy_us_per_batch"]
                if prof["device_time_seen"] else None,
            "port_kernel_us_per_call": port_us,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            **{k: v for k, v in prof.items() if k != "kernels"},
            "kernels_top": prof["kernels"][:14]}


def moe_prefill(torch, cfg, params) -> dict:
    """:func:`prefill_run` at LM_PREFILL_B x LM_PREFILL_S, and the routed
    share kept over one call, held to MOE_KEPT_SHARE."""
    kept = KeptShare()
    out = prefill_run(torch, cfg, params, LM_PREFILL_B, LM_PREFILL_S,
                      MOE_PREFILL_RUNS, 31, kept=kept)
    check(round(kept.share(), 3) == MOE_KEPT_SHARE[cfg.name],
          f"{cfg.name} prefill kept {kept.share():.4f} of its assignments, "
          f"want {MOE_KEPT_SHARE[cfg.name]}")
    return {**out, "routed_kept_share": kept.share(),
            "capacity_per_expert_per_chunk": max(1, int(
                LM_PREFILL_B * LM_PREFILL_S // cfg.moe_token_chunks
                * cfg.experts_per_token / cfg.n_experts
                * cfg.capacity_factor))}


def draw(torch, cfg, label: str, want: int) -> tuple:
    """The model's parameters drawn on the card from a seed: (params, the
    phase line's numbers)."""
    from repro_torch.nn import module, transformer
    specs = transformer.model_specs(cfg)
    n_params = module.param_count(specs)
    check(n_params == want, f"{label}: {n_params} parameters, want {want}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = module.init_tree(
        specs, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    return params, {"arch": label, "layers": cfg.n_layers,
                    "parameters": n_params,
                    "param_bytes": module.param_bytes(specs),
                    "init_s": time.perf_counter() - t0,
                    "peak_device_bytes_init":
                        torch.cuda.max_memory_allocated(),
                    "activation_dtype": cfg.activation_dtype}


def phase_moe(torch) -> dict:
    """The MoE family's serving path: K5 at Mixtral's prefill shape;
    qwen2-moe-a2.7b at full width drawn on the card (prefill timed,
    counted and profiled; one 8-lane decode tick replayed against eager
    and profiled; ``forward`` against 64 cached decode steps, dropless;
    the engine over the lm phase's 32 requests; the routed share kept);
    the card against the CPU at two layers; the launcher's CLI and
    ``examples/serve_moe`` in subprocesses; Mixtral at full width and 4
    of its 32 layers (prefill, 16 engine ticks)."""
    import torch.nn.functional as F
    from repro_torch.configs import registry as configs
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, launch_shape)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    t_phase = time.perf_counter()
    # K5 at Mixtral's prefill shape, against its plain version and SDPA
    bh, sq, d, kw = MIXTRAL_FLASH
    gen = torch.Generator(device="cuda").manual_seed(30)
    q, k, v = (torch.randn(bh, sq, d, generator=gen, device="cuda")
               for _ in range(3))
    call = f"({bh}, {sq}, {d}) " + ",".join(f"{a}={b}"
                                          for a, b in kw.items())
    flash = kernel_call(
        torch, call, lambda: flash_attention(q, k, v, **kw),
        lambda: flash_attention_ref(q, k, v, **kw),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        4 * 4 * bh * sq * d, 4 * bh * causal_pairs(sq, kw["window"]) * d,
        rtol=FLASH_RTOL, atol=FLASH_ATOL, plain_runs=20)
    flash["launch_shape"] = launch_shape(bh, sq, sq, d)
    del q, k, v
    torch.cuda.empty_cache()
    emit({"phase": "moe", "step": "flash_attention", **flash})

    # qwen2-moe-a2.7b at full width
    cfg = configs.get_config(MOE_ARCH)
    params, model = draw(torch, cfg, MOE_ARCH, MOE_PARAMS)
    emit({"phase": "moe", "step": "model", **model, "reduced": None,
          "n_experts": cfg.n_experts, "padded": cfg.n_experts_padded,
          "top_k": cfg.experts_per_token,
          "token_chunks": cfg.moe_token_chunks})
    pre = moe_prefill(torch, cfg, params)
    emit({"phase": "moe", "step": "prefill", **pre})

    gen = torch.Generator(device="cuda").manual_seed(32)
    tick = decode_tick(torch, cfg, params, LM_LANES, LM_MAX_LEN, gen,
                       kept=KeptShare())
    tick["capacity_per_expert"] = max(1, int(
        LM_LANES * cfg.experts_per_token / cfg.n_experts
        * cfg.capacity_factor))
    emit({"phase": "moe", "step": "decode tick", **tick})

    dropless = cfg.replace(capacity_factor=float(cfg.n_experts))
    fvd = lm_forward_vs_decode(torch, dropless, params, "cuda",
                               LM_DECODE_B, LM_DECODE_S)
    emit({"phase": "moe", "step": "forward vs decode, dropless", **fvd,
          "capacity_factor": dropless.capacity_factor,
          "tolerance_over_scale": LM_DECODE_TOL})
    check(fvd["err_over_scale"] <= LM_DECODE_TOL,
          f"{MOE_ARCH} forward against decode (dropless): "
          f"{fvd['err_over_scale']:.4g} of the logit scale, over "
          f"{LM_DECODE_TOL}")

    eng = lm_engine_run(torch, cfg, params, lanes=LM_LANES,
                        max_len=LM_MAX_LEN, requests=LM_REQUESTS,
                        prompt=LM_PROMPT, new=LM_NEW, hold_alone=False)
    emit({"phase": "moe", "step": "engine", **eng})
    del params
    free_card(torch)

    cpu_check = lm_card_vs_cpu(torch, cfg.replace(n_layers=LM_CPU_LAYERS))
    emit({"phase": "moe", "step": "card vs cpu", **cpu_check,
          "tolerance_over_scale": LM_BF16_TOL})
    free_card(torch)
    check(torch.cuda.memory_allocated() < 2 ** 30,
          f"{torch.cuda.memory_allocated()} bytes still held on the card "
          f"before the launcher's subprocess")

    cli = {name: run_module(argv) for name, argv in (
        ("cli", ["repro_torch.launch.serve", "--arch", MOE_ARCH,
                 "--no-tiny", "--requests", "8"]),
        ("serve_moe", ["repro_torch.examples.serve_moe"]))}
    emit({"phase": "moe", "step": "cli", **cli})

    # Mixtral at full width, cut in depth
    mcfg = configs.get_config(MIXTRAL_ARCH).replace(n_layers=MIXTRAL_LAYERS)
    params, model = draw(torch, mcfg, MIXTRAL_ARCH, MIXTRAL_PARAMS)
    reduced = (f"n_layers {MIXTRAL_LAYERS} of 32: 46.7 B parameters "
               f"(186.8 GB in fp32) cannot sit on one 80 GB card")
    emit({"phase": "moe", "step": "model", **model, "reduced": reduced})
    mpre = moe_prefill(torch, mcfg, params)
    emit({"phase": "moe", "step": "prefill", **mpre, "reduced": reduced})
    meng = lm_engine_run(torch, mcfg, params, lanes=LM_LANES,
                         max_len=LM_MAX_LEN, requests=LM_LANES,
                         prompt=LM_PROMPT, new=LM_NEW,
                         max_ticks=MIXTRAL_TICKS)
    emit({"phase": "moe", "step": "engine", "arch": MIXTRAL_ARCH, **meng,
          "reduced": reduced})
    del params
    free_card(torch)
    emit({"phase": "moe", "step": "done",
          "seconds": time.perf_counter() - t_phase})
    return {"flash": flash,
            "launches": {k: int(v) for k, v in
                         pre["launches_per_call"].items()},
            "mixtral_launches": {k: int(v) for k, v in
                                 mpre["launches_per_call"].items()}}


# ---------------------------------------------------------------------------
# The RG-LRU hybrid: RecurrentGemma-9b at full width and depth
# ---------------------------------------------------------------------------

#: recurrentgemma-9b at its published width and depth, nothing cut (38
#: layers in (rglru, rglru, local) x 12 + 2 rglru, d_model 4,096, 16 heads
#: over one KV head of 256, window 2,048, lru_width 4,096, d_ff 12,288,
#: vocab 256,000, bf16 activations)
RG_ARCH, RG_PARAMS = "recurrentgemma-9b", 8_578_519_040
#: its prefill: 2 x 4,096, so the window of 2,048 bites; timed calls
RG_PREFILL_B, RG_PREFILL_S, RG_PREFILL_RUNS = 2, 4096, 5
#: K5 at that prefill: B*H 32, S 4,096, D 256, causal, window 2,048
RG_FLASH = (32, 4096, 256, {"causal": True, "window": 2048})
#: the card against the CPU: one superblock (rglru, rglru, local)
RG_CPU_LAYERS = 3


def windowed_mask(torch, s: int, window: int):
    """The boolean (S, S) mask of a causal window: key j is seen by query
    i where 0 <= i - j < window."""
    i = torch.arange(s, device="cuda")
    d = i[:, None] - i[None, :]
    return (d >= 0) & (d < window)


def phase_recurrent(torch) -> dict:
    """The RG-LRU hybrid's serving path at RecurrentGemma-9b's published
    width and depth: K5 at its prefill shape (D 256, window 2,048) against
    its plain version, beside SDPA with the window as a boolean mask and
    the bound; the model drawn on the card; ``lm.prefill`` at 2 x 4,096
    (12 K5 launches a call); one 8-lane decode tick replayed against
    eager (every cache leaf: ``h``, ``conv``, ``k``, ``v``, ``kpos``);
    ``forward`` against 64 cached decode steps; the engine over the lm
    phase's 32 requests, one of them served again alone, equal; the card
    against the CPU at one superblock; the launcher's CLI at
    ``--no-tiny``."""
    import torch.nn.functional as F
    from repro_torch.configs import registry as configs
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, launch_shape)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    t_phase = time.perf_counter()
    free_card(torch)
    emit({"phase": "recurrent", "step": "card",
          "device_bytes_before": torch.cuda.memory_allocated(),
          "peak_device_bytes_so_far": torch.cuda.max_memory_allocated()})

    bh, sq, d, kw = RG_FLASH
    gen = torch.Generator(device="cuda").manual_seed(41)
    q, k, v = (torch.randn(bh, sq, d, generator=gen, device="cuda")
               for _ in range(3))
    mask = windowed_mask(torch, sq, kw["window"])
    call = f"({bh}, {sq}, {d}) " + ",".join(f"{a}={b}"
                                          for a, b in kw.items())
    flash = kernel_call(
        torch, call, lambda: flash_attention(q, k, v, **kw),
        lambda: flash_attention_ref(q, k, v, **kw),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
        4 * 4 * bh * sq * d, 4 * bh * causal_pairs(sq, kw["window"]) * d,
        rtol=FLASH_RTOL, atol=FLASH_ATOL, plain_runs=10, runs=20)
    flash["launch_shape"] = launch_shape(bh, sq, sq, d)
    flash["library"] = "F.scaled_dot_product_attention, boolean window mask"
    del q, k, v, mask
    torch.cuda.empty_cache()
    emit({"phase": "recurrent", "step": "flash_attention", **flash})

    cfg = configs.get_config(RG_ARCH)
    params, model = draw(torch, cfg, RG_ARCH, RG_PARAMS)
    emit({"phase": "recurrent", "step": "model", **model, "reduced": None,
          "attention_layers": attention_layers(cfg),
          "rglru_layers": cfg.n_layers - attention_layers(cfg)})
    pre = prefill_run(torch, cfg, params, RG_PREFILL_B, RG_PREFILL_S,
                      RG_PREFILL_RUNS, 40)
    emit({"phase": "recurrent", "step": "prefill", **pre})

    gen = torch.Generator(device="cuda").manual_seed(42)
    tick = decode_tick(torch, cfg, params, LM_LANES, LM_MAX_LEN, gen)
    emit({"phase": "recurrent", "step": "decode tick", **tick})

    fvd = lm_forward_vs_decode(torch, cfg, params, "cuda", LM_DECODE_B,
                               LM_DECODE_S)
    emit({"phase": "recurrent", "step": "forward vs decode", **fvd,
          "tolerance_over_scale": LM_DECODE_TOL})
    check(fvd["err_over_scale"] <= LM_DECODE_TOL,
          f"{RG_ARCH} forward against decode: {fvd['err_over_scale']:.4g} "
          f"of the logit scale, over {LM_DECODE_TOL}")

    registry.reset_launch_counts()
    eng = lm_engine_run(torch, cfg, params, lanes=LM_LANES,
                        max_len=LM_MAX_LEN, requests=LM_REQUESTS,
                        prompt=LM_PROMPT, new=LM_NEW)
    eng["port_kernel_launches"] = {
        k: v for k, v in registry.launch_counts().items() if v}
    emit({"phase": "recurrent", "step": "engine", **eng})
    del params
    free_card(torch)

    cpu_check = lm_card_vs_cpu(torch, cfg.replace(n_layers=RG_CPU_LAYERS))
    emit({"phase": "recurrent", "step": "card vs cpu", **cpu_check,
          "tolerance_over_scale": LM_BF16_TOL})
    free_card(torch)
    check(torch.cuda.memory_allocated() < 2 ** 30,
          f"{torch.cuda.memory_allocated()} bytes still held on the card "
          f"before the launcher's subprocess")
    cli = run_module(["repro_torch.launch.serve", "--arch", RG_ARCH,
                      "--no-tiny", "--requests", "8"])
    emit({"phase": "recurrent", "step": "cli", **cli})
    emit({"phase": "recurrent", "step": "done",
          "seconds": time.perf_counter() - t_phase})
    return {"flash": flash,
            "launches": {k: int(v) for k, v in
                         pre["launches_per_call"].items()}}


# ---------------------------------------------------------------------------
# xLSTM: xlstm-1.3b at full width and depth
# ---------------------------------------------------------------------------

#: xlstm-1.3b at its published width and depth, nothing cut (48 layers in
#: (mLSTM x 7, sLSTM) x 6, d_model 2,048, 4 heads, mLSTM head dim 1,024,
#: sLSTM head width 512, chunk 256, vocab 50,304, bf16 activations)
XL_ARCH, XL_PARAMS = "xlstm-1.3b", 3_503_016_272
#: the sLSTM kernel's calls on the main path: the prefill's (B 4, S 1,024)
#: and the engine tick's (B 8, S 1)
XL_SLSTM_CASES = ((LM_PREFILL_B, LM_PREFILL_S), (LM_LANES, 1))
#: the kernel against its plain version: the same fp32 operations, the
#: dot products summed in another order, carried through the recurrence
SLSTM_RTOL, SLSTM_ATOL = 1e-4, 1e-5
#: prefill timed calls
XL_PREFILL_RUNS = 5
#: the card against the CPU: one superblock (7 mLSTM layers, 1 sLSTM)
XL_CPU_LAYERS = 8


def slstm_kernel(torch, cfg) -> dict:
    """The sLSTM kernel against its plain version (the step loop) at the
    main path's calls, hs and the state written back; its device time
    beside the plain version's and the bound (the products h @ R_g: 8 W^2
    flops per (batch row, head, step); each input read and each output
    written once).  The prefill's plain version launches about 20
    kernels a step, more than the launch queue holds: it is timed call by
    call (``_blocking_ms``)."""
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref
    from repro_torch.kernels.slstm_scan.slstm_scan import slstm_scan
    nh, w = cfg.n_heads, cfg.d_model // cfg.n_heads
    gen = torch.Generator(device="cuda").manual_seed(50)
    calls = []
    for b, s in XL_SLSTM_CASES:
        x_pre = [torch.randn(b, s, nh, w, generator=gen, device="cuda")
                 for _ in range(4)]
        rec = [0.02 * torch.randn(nh, w, w, generator=gen, device="cuda")
               for _ in range(4)]       # the spec's scale
        if s > 1:                       # a prefill starts from the init state
            state = [torch.zeros(b, nh, w, device="cuda") for _ in range(3)]
            state.append(torch.full((b, nh, w), -1e30, device="cuda"))
        else:                           # a tick, mid-sequence
            state = [torch.randn(b, nh, w, generator=gen, device="cuda")
                     for _ in range(4)]
            state[2] = state[2].abs() + 1.0
        mine, theirs = [t.clone() for t in state], [t.clone() for t in state]
        got = slstm_scan(x_pre, rec, *mine)
        want = slstm_scan_ref(x_pre, rec, *theirs)
        torch.cuda.synchronize()
        pairs = [("hs", got, want)] + list(zip("hcnm", mine, theirs))
        err = max(float((a - b_).abs().max()) for _, a, b_ in pairs)
        bad = [n for n, a, b_ in pairs
               if not torch.allclose(a, b_, rtol=SLSTM_RTOL, atol=SLSTM_ATOL)]
        call = f"(B {b}, S {s}, H {nh}, W {w})"
        check(not bad, f"slstm_scan {call}: {bad} differ from the plain "
                       f"version (max |diff| {err})")
        nbytes = 4 * (4 * b * s * nh * w + 4 * nh * w * w + 8 * b * nh * w
                      + b * s * nh * w)
        flops = 8 * w * w * b * nh * s
        bound_ms, bound_by = bound(nbytes, flops)
        work = [t.clone() for t in state]
        kern = lambda: slstm_scan(x_pre, rec, *work)  # noqa: E731
        plain = lambda: slstm_scan_ref(x_pre, rec, *work)  # noqa: E731
        label = f"slstm_scan {call}"
        calls.append({
            "call": call, "max_abs_err": err,
            "tolerance": {"rtol": SLSTM_RTOL, "atol": SLSTM_ATOL},
            "ms": device_ms(torch, kern, 20 if s > 1 else TIMED_RUNS,
                            label=label),
            "plain_ms": _blocking_ms(torch, plain, 3, f"{label} plain")
            if s > 1 else device_ms(torch, plain, label=f"{label} plain"),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "flops": flops})
        calls[-1]["us_per_step"] = calls[-1]["ms"] * 1e3 / s
        del x_pre, rec, state, mine, theirs, work, got, want
    torch.cuda.empty_cache()
    return {"calls": calls}


def phase_xlstm(torch) -> dict:
    """xLSTM's serving path at xlstm-1.3b's published width and depth,
    after the previous phase's weights are freed: the sLSTM kernel
    against its plain version at the prefill's and the tick's calls; the
    model drawn on the card; ``lm.prefill`` at 4 x 1,024 (6 sLSTM kernel
    launches a call, nothing else of the port's); one 8-lane decode tick
    replayed against eager (every cache leaf: the mLSTM's ``C``, ``n``,
    ``m``, ``conv``, the sLSTM's ``h``, ``c``, ``n``, ``m``, ``conv``);
    ``forward`` against 64 cached decode steps; the engine over the lm
    phase's 32 requests, one of them served again alone, equal; the card
    against the CPU at one superblock; the launcher's CLI at
    ``--no-tiny``."""
    from repro_torch.configs import registry as configs
    from repro_torch.kernels import registry

    t_phase = time.perf_counter()
    free_card(torch)
    emit({"phase": "xlstm", "step": "card",
          "device_bytes_before": torch.cuda.memory_allocated()})
    cfg = configs.get_config(XL_ARCH)
    kern = slstm_kernel(torch, cfg)
    emit({"phase": "xlstm", "step": "slstm_scan", **kern,
          "timing": {k: v for k, v in TIMING_NOTES.items()
                     if k.startswith("slstm_scan")}})

    params, model = draw(torch, cfg, XL_ARCH, XL_PARAMS)
    launches = forward_launches(cfg)
    emit({"phase": "xlstm", "step": "model", **model, "reduced": None,
          "mlstm_layers": cfg.n_layers - launches["slstm_scan"],
          "slstm_layers": launches["slstm_scan"]})
    pre = prefill_run(torch, cfg, params, LM_PREFILL_B, LM_PREFILL_S,
                      XL_PREFILL_RUNS, 51)
    pre["slstm_scan_share_of_busy"] = (
        pre["port_kernel_us_per_call"]["slstm_scan"]
        / pre["device_busy_us_per_batch"] if pre["device_time_seen"]
        else None)
    emit({"phase": "xlstm", "step": "prefill", **pre})

    gen = torch.Generator(device="cuda").manual_seed(52)
    tick = decode_tick(torch, cfg, params, LM_LANES, LM_MAX_LEN, gen)
    emit({"phase": "xlstm", "step": "decode tick", **tick})
    check(tick["port_launches_per_replay"] == {"slstm_scan": 6},
          f"{XL_ARCH} tick: a replay launched "
          f"{tick['port_launches_per_replay']}, want slstm_scan 6")

    fvd = lm_forward_vs_decode(torch, cfg, params, "cuda", LM_DECODE_B,
                               LM_DECODE_S)
    emit({"phase": "xlstm", "step": "forward vs decode", **fvd,
          "tolerance_over_scale": LM_DECODE_TOL})
    check(fvd["err_over_scale"] <= LM_DECODE_TOL,
          f"{XL_ARCH} forward against decode: {fvd['err_over_scale']:.4g} "
          f"of the logit scale, over {LM_DECODE_TOL}")

    registry.reset_launch_counts()
    eng = lm_engine_run(torch, cfg, params, lanes=LM_LANES,
                        max_len=LM_MAX_LEN, requests=LM_REQUESTS,
                        prompt=LM_PROMPT, new=LM_NEW)
    eng["port_kernel_launches"] = {
        k: v for k, v in registry.launch_counts().items() if v}
    emit({"phase": "xlstm", "step": "engine", **eng})
    del params
    free_card(torch)

    cpu_check = lm_card_vs_cpu(torch, cfg.replace(n_layers=XL_CPU_LAYERS))
    emit({"phase": "xlstm", "step": "card vs cpu", **cpu_check,
          "tolerance_over_scale": LM_BF16_TOL})
    free_card(torch)
    check(torch.cuda.memory_allocated() < 2 ** 30,
          f"{torch.cuda.memory_allocated()} bytes still held on the card "
          f"before the launcher's subprocess")
    cli = run_module(["repro_torch.launch.serve", "--arch", XL_ARCH,
                      "--no-tiny", "--requests", "8"])
    emit({"phase": "xlstm", "step": "cli", **cli})
    emit({"phase": "xlstm", "step": "done",
          "seconds": time.perf_counter() - t_phase})
    return {"slstm": kern,
            "launches": {k: int(v) for k, v in
                         pre["launches_per_call"].items()},
            "tick_launches": tick["port_launches_per_replay"]}


# ---------------------------------------------------------------------------
# The encoder-decoder: whisper-tiny at full width and depth
# ---------------------------------------------------------------------------

#: whisper-tiny at its published width and depth, nothing cut (4 encoder
#: and 4 decoder layers, d_model 384, 6 heads of 64, d_ff 1,536, 1,500
#: frames, vocab 51,872, bf16 activations)
ED_ARCH, ED_PARAMS = "whisper-tiny", 38_599_680
#: sequences, the prompt and the greedy tokens generated after it
ED_B, ED_PROMPT, ED_NEW = 8, 4, 64
#: K5 at the encoder's self-attention: B*H 48, S 1,500, D 64, non-causal
#: (1,500 is a multiple of no tile: the ragged edge)
ED_FLASH = (ED_B * 6, 1500, 64, {"causal": False})
#: timed encoder calls
ED_ENCODE_RUNS = 10


def phase_encdec(torch) -> dict:
    """The encoder-decoder at whisper-tiny's published width and depth: K5
    at the encoder's shape against its plain version, beside SDPA and the
    bound; the model drawn on the card; ``encode`` over 8 x 1,500 seeded
    frames timed, profiled and counted (4 K5 launches a call);
    ``decode_forward`` (4 K5 launches) against 64 steps replayed from
    ``step_runner``'s graph, and each replayed step against the eager
    step value for value (tokens, logits, the KV cache); the card against
    the CPU at full width; greedy generation of 64 tokens for 8 sequences
    from a 4-token prompt."""
    import torch.nn.functional as F
    from repro_torch.configs import registry as configs
    from repro_torch.core.graphs import GraphRunner
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, launch_shape)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import encdec
    from repro_torch.nn import module
    from repro_torch.nn.module import tree_leaves

    t_phase = time.perf_counter()
    free_card(torch)
    bh, sq, d, kw = ED_FLASH
    gen = torch.Generator(device="cuda").manual_seed(60)
    q, k, v = (torch.randn(bh, sq, d, generator=gen, device="cuda")
               for _ in range(3))
    flash = kernel_call(
        torch, f"({bh}, {sq}, {d}) causal=False",
        lambda: flash_attention(q, k, v, **kw),
        lambda: flash_attention_ref(q, k, v, **kw),
        lambda: F.scaled_dot_product_attention(q, k, v),
        4 * 4 * bh * sq * d, 4 * bh * sq * sq * d,
        rtol=FLASH_RTOL, atol=FLASH_ATOL, plain_runs=20, runs=40)
    flash["launch_shape"] = launch_shape(bh, sq, sq, d)
    del q, k, v
    emit({"phase": "encdec", "step": "flash_attention", **flash})

    cfg = configs.get_config(ED_ARCH)
    specs = encdec.model_specs(cfg)
    n_params = module.param_count(specs)
    check(n_params == ED_PARAMS, f"{ED_ARCH}: {n_params} parameters, want "
                                 f"{ED_PARAMS}")
    params = module.init_tree(
        specs, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    emit({"phase": "encdec", "step": "model", "arch": ED_ARCH,
          "parameters": n_params, "param_bytes": module.param_bytes(specs),
          "encoder_layers": cfg.n_encoder_layers,
          "decoder_layers": cfg.n_layers,
          "activation_dtype": cfg.activation_dtype, "reduced": None})

    # encode: the stubbed frontend's frames, timed, counted, profiled
    frames = torch.randn(ED_B, cfg.encoder_len, cfg.d_model, generator=gen,
                         device="cuda")
    enc = encdec.encode(cfg, params, frames)
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    times = []
    for _ in range(ED_ENCODE_RUNS):
        t0 = time.perf_counter()
        enc = encdec.encode(cfg, params, frames)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    per_call = {k_: n / ED_ENCODE_RUNS
                for k_, n in registry.launch_counts().items() if n}
    check(per_call == {"flash_attention": cfg.n_encoder_layers},
          f"encode launched {per_call} per call, want flash_attention "
          f"{cfg.n_encoder_layers} and nothing else")
    check(tuple(enc.shape) == (ED_B, cfg.encoder_len, cfg.d_model)
          and bool(torch.isfinite(enc).all()), "encode: not finite")
    prof = device_profile(torch, lambda: encdec.encode(cfg, params, frames),
                          reps=3)
    k5_us = sum(k_["device_us_per_batch"] for k_ in prof["kernels"]
                if "flash_attention" in k_["name"])
    emit({"phase": "encdec", "step": "encode", "batch": ED_B,
          "frames": cfg.encoder_len, "ms_p50": statistics.median(times),
          "ms": times, "launches_per_call": per_call,
          "flash_attention_us_per_call": k5_us,
          "flash_attention_share_of_busy":
              k5_us / prof["device_busy_us_per_batch"]
              if prof["device_time_seen"] else None,
          **{k_: v_ for k_, v_ in prof.items() if k_ != "kernels"},
          "kernels_top": prof["kernels"][:10]})

    # decode_forward (teacher-forced) against replayed steps, and each
    # replayed step against the eager step on its own copy of the cache
    s = LM_DECODE_S
    toks = torch.randint(0, cfg.vocab_size, (ED_B, s), generator=gen,
                         device="cuda")
    registry.reset_launch_counts()
    full = encdec.decode_forward(cfg, params, toks, enc)
    fwd_launches = registry.launch_counts()["flash_attention"]
    caches = [encdec.init_cache(cfg, ED_B, s, enc=enc.clone())
              for _ in range(2)]

    def step_of(cache):
        def step(f):
            logits, _ = encdec.decode_step(cfg, params, f["tokens"], cache,
                                           f["pos"])
            return {"tokens": torch.argmax(logits, -1).to(torch.int32),
                    "logits": logits}
        return step

    run, eager = GraphRunner(step_of(caches[0]), torch.device("cuda")), \
        step_of(caches[1])
    differ = {"tokens": 0, "logits": 0}
    steps = []
    for t in range(s):
        feeds = {"tokens": toks[:, t:t + 1],
                 "pos": torch.full((ED_B,), t, device="cuda")}
        got, want = run(feeds), eager(feeds)
        for k_ in differ:
            differ[k_] += value_diff(torch, got[k_], want[k_])
        steps.append(got["logits"].clone())
    cache_differ = sum(value_diff(torch, a, b) for a, b in zip(
        tree_leaves(caches[0]), tree_leaves(caches[1])))
    check(differ == {"tokens": 0, "logits": 0} and cache_differ == 0,
          f"{ED_ARCH} step: a replay differs from the eager step in "
          f"{differ} values and the caches in {cache_differ}")
    check(len(run.replay_launches()) == 1, f"{ED_ARCH}: not one graph")
    dec = torch.stack(steps, 1)
    scale = float(full.abs().max())
    fvd = {"batch": ED_B, "seq": s, "logit_scale": scale,
           "max_abs_err": float((dec - full).abs().max()),
           "err_over_scale": float((dec - full).abs().max()) / scale,
           "greedy_agree_share": float(
               (dec.argmax(-1) == full.argmax(-1)).float().mean()),
           "flash_attention_launches": fwd_launches,
           "replays_checked": s - 1, "values_differing": differ,
           "cache_values_differing": cache_differ,
           "tolerance_over_scale": LM_DECODE_TOL}
    emit({"phase": "encdec", "step": "decode_forward vs steps", **fvd})
    check(fwd_launches == cfg.n_layers,
          f"decode_forward launched K5 {fwd_launches} times")
    check(fvd["err_over_scale"] <= LM_DECODE_TOL,
          f"{ED_ARCH} decode_forward against the steps: "
          f"{fvd['err_over_scale']:.4g} of the logit scale")
    run.release()
    del caches, run, eager, steps, dec, full

    # the card against the CPU at full width, the same numpy weights
    weights = module.map_tree(lambda a: a.cpu().numpy(), params)
    f_cpu, t_cpu = frames[:2].cpu(), toks[:2].cpu()
    card = encdec.decode_forward(cfg, params, toks[:2], encdec.encode(
        cfg, params, frames[:2])).cpu()
    p_cpu = module.params_from_numpy(weights)
    cpu = encdec.decode_forward(cfg, p_cpu, t_cpu,
                                encdec.encode(cfg, p_cpu, f_cpu))
    scale = float(cpu.abs().max())
    err = float((card - cpu).abs().max())
    emit({"phase": "encdec", "step": "card vs cpu", "batch": 2, "seq": s,
          "logit_scale": scale, "max_abs_err": err,
          "err_over_scale": err / scale,
          "greedy_agree_share": float(
              (card.argmax(-1) == cpu.argmax(-1)).float().mean()),
          "tolerance_over_scale": LM_BF16_TOL})
    check(bool(torch.isfinite(card).all()) and err <= LM_BF16_TOL * scale,
          f"{ED_ARCH} card against CPU: {err / scale:.4g} of the logit "
          f"scale, over {LM_BF16_TOL}")

    # greedy generation through the step's runner
    prompt = torch.randint(1, cfg.vocab_size, (ED_B, ED_PROMPT),
                           generator=gen, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = encdec.generate(cfg, params, frames, prompt, ED_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the same decoding step by step, each step timed
    cache = encdec.init_cache(cfg, ED_B, ED_PROMPT + ED_NEW, enc=enc)
    step = encdec.step_runner(cfg, params, cache)
    tok, again, step_ms = prompt[:, :1], [], []
    for t in range(ED_PROMPT + ED_NEW - 1):
        t1 = time.perf_counter()
        nxt = step({"tokens": tok,
                    "pos": torch.full((ED_B,), t, device="cuda")})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if t + 1 < ED_PROMPT:
            tok = prompt[:, t + 1:t + 2]
        else:
            again.append(nxt.clone())
            tok = again[-1][:, None].long()
    step.release()
    same = bool(torch.equal(torch.stack(again, 1), out))
    emit({"phase": "encdec", "step": "generate", "batch": ED_B,
          "prompt": ED_PROMPT, "new_tokens": ED_NEW,
          "wall_s": wall, "tokens_per_s": ED_B * ED_NEW / wall,
          "first_step_ms": step_ms[0],
          "step_ms_p50": statistics.median(step_ms[1:]),
          "step_ms_max": max(step_ms[1:]),
          "stepwise_equals_generate": same,
          "sample": out[0, :16].tolist()})
    check(tuple(out.shape) == (ED_B, ED_NEW) and same,
          f"generate: shape {tuple(out.shape)}, step by step equal {same}")
    del params, enc, frames
    free_card(torch)
    emit({"phase": "encdec", "step": "done",
          "seconds": time.perf_counter() - t_phase})
    return {"flash": flash,
            "launches": {k_: int(v) for k_, v in per_call.items()}}


# ---------------------------------------------------------------------------
# Qwen2-VL at qwen2-vl-2b's full width and depth
# ---------------------------------------------------------------------------

#: qwen2-vl-2b at its published width and depth, nothing cut (28 layers,
#: d_model 1,536, 12 heads over 2 KV heads of 128, d_ff 8,960, vocab
#: 151,936, M-RoPE sections (16, 24, 24), QKV bias, tied embeddings, bf16
#: activations; the vision frontend a stub, as in the reference: 1,024
#: precomputed patch embeddings a sequence)
VLM_ARCH, VLM_PARAMS = "qwen2-vl-2b", 1_543_715_840
#: its prefill: 4 x (1,024 patches + 1,024 tokens); timed calls
VLM_PREFILL_B, VLM_PREFILL_S, VLM_PREFILL_RUNS = 4, 1024, 5
#: K5 at that prefill: B*H 48, S 2,048, D 128, causal
VLM_FLASH = (48, 2048, 128, {"causal": True})
#: its engine: the LM's lanes, cache and prompts over 16 text requests
VLM_REQUESTS = 16


def phase_vlm(torch) -> dict:
    """Qwen2-VL's serving path at qwen2-vl-2b's full width and depth: K5 at
    the prefill's shape against its plain version, beside SDPA and the
    bound; the model drawn on the card; ``lm.prefill`` of 4 x (1,024
    patches + 1,024 tokens) timed, profiled and counted (28 K5 launches a
    call, nothing else of the port's); ``forward`` against 64 cached
    decode steps on text, B 2 (1%); the card against the CPU at two layers
    with the 1,024 patches in front of 256 tokens (2%); the engine at 8
    lanes over 16 text requests."""
    import torch.nn.functional as F
    from repro_torch.configs import registry as configs
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, launch_shape)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    t_phase = time.perf_counter()
    free_card(torch)
    bh, sq, d, kw = VLM_FLASH
    gen = torch.Generator(device="cuda").manual_seed(70)
    q, k, v = (torch.randn(bh, sq, d, generator=gen, device="cuda")
               for _ in range(3))
    flash = kernel_call(
        torch, f"({bh}, {sq}, {d}) causal=True",
        lambda: flash_attention(q, k, v, **kw),
        lambda: flash_attention_ref(q, k, v, **kw),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        4 * 4 * bh * sq * d, 4 * bh * causal_pairs(sq) * d,
        rtol=FLASH_RTOL, atol=FLASH_ATOL, plain_runs=10, runs=20)
    flash["launch_shape"] = launch_shape(bh, sq, sq, d)
    del q, k, v
    emit({"phase": "vlm", "step": "flash_attention", **flash})

    cfg = configs.get_config(VLM_ARCH)
    params, model = draw(torch, cfg, VLM_ARCH, VLM_PARAMS)
    emit({"phase": "vlm", "step": "model", **model, "reduced": None,
          "mrope_sections": list(cfg.mrope_sections),
          "n_patches": cfg.n_patches})

    # the prefill, patches in front of the tokens
    pre = prefill_run(torch, cfg, params, VLM_PREFILL_B, VLM_PREFILL_S,
                      VLM_PREFILL_RUNS, 71, patches=cfg.n_patches)
    emit({"phase": "vlm", "step": "prefill", **pre})

    registry.reset_launch_counts()
    fvd = lm_forward_vs_decode(torch, cfg, params, "cuda", LM_DECODE_B,
                               LM_DECODE_S)
    fvd["flash_attention_launches"] = registry.launch_counts()[
        "flash_attention"]
    emit({"phase": "vlm", "step": "forward vs decode", **fvd,
          "tolerance_over_scale": LM_DECODE_TOL})
    check(fvd["flash_attention_launches"] == cfg.n_layers,
          f"{VLM_ARCH} forward launched K5 "
          f"{fvd['flash_attention_launches']} times")
    check(fvd["err_over_scale"] <= LM_DECODE_TOL,
          f"{VLM_ARCH} forward against decode: {fvd['err_over_scale']:.4g} "
          f"of the logit scale, over {LM_DECODE_TOL}")

    registry.reset_launch_counts()
    # text only, as the reference's launcher serves it
    eng = lm_engine_run(torch, cfg, params, lanes=LM_LANES,
                        max_len=LM_MAX_LEN, requests=VLM_REQUESTS,
                        prompt=LM_PROMPT, new=LM_NEW)
    eng["port_kernel_launches"] = {
        k_: v_ for k_, v_ in registry.launch_counts().items() if v_}
    emit({"phase": "vlm", "step": "engine", **eng})
    del params
    free_card(torch)

    cpu_check = lm_card_vs_cpu(torch, cfg.replace(n_layers=LM_CPU_LAYERS),
                               patches=cfg.n_patches)
    emit({"phase": "vlm", "step": "card vs cpu", **cpu_check,
          "tolerance_over_scale": LM_BF16_TOL})
    emit({"phase": "vlm", "step": "done",
          "seconds": time.perf_counter() - t_phase})
    return {"flash": flash,
            "launches": {k_: int(v_) for k_, v_ in
                         pre["launches_per_call"].items()}}


# ---------------------------------------------------------------------------
# The LM's training at Qwen2.5-3B's full width
# ---------------------------------------------------------------------------

#: the card's published dense bf16 tensor-core peak (H100 SXM data sheet)
BF16_FLOPS_PER_S = 989e12
#: one attention layer at Qwen2.5-3B's microbatch of 1 x 1,024: 16 query
#: heads over 2 KV heads of 128, causal, fp32
TR_ATTN = (1, 1024, 16, 2, 128)
#: K5's gradients against autograd through full_attention, and its lse
#: against the plain version: fp32 sums in other orders
TR_GRAD_RTOL, TR_GRAD_ATOL = 1e-4, 1e-5
#: the training run: global batch x sequence (in cfg.microbatches = 4
#: microbatches of 1 x 1,024), replayed steps timed
TR_BATCH, TR_SEQ, TR_STEPS = 4, 1024, 5
#: the first batch's loss at full depth against the CPU: the card's at
#: the training shape with the targets past TR_FIRST_PREFIX masked (-1),
#: the CPU's on that prefix alone (causal: the same positions' losses),
#: relative (bf16 activations, other sum orders: 10x the 1.5e-5 read on
#: an H100, PERF.md)
TR_FIRST_PREFIX, TR_FIRST_RTOL = 64, 1.5e-4
#: replay against eager at full width but cut in depth: two copies of
#: the full state (2 x 49.4 GB) do not fit on the card
TR_EAGER_LAYERS, TR_EAGER_STEPS = 4, 2
#: the card against the CPU: layers, batch x sequence; loss and grad norm
#: (bf16 activations: cuBLAS's bf16 products and K5's fp32 sums against
#: the CPU's widened products move bf16 roundings; about 10x the reads on
#: an H100, 9.5e-6 and 2.3e-3)
TR_CPU_LAYERS, TR_CPU_S, TR_CPU_LOSS_RTOL, TR_CPU_GN_RTOL = 2, 256, 1e-4, \
    0.02
#: and each gradient leaf of ``lm.train_loss`` there: max |difference|
#: over the leaf's max |gradient| (the loss, dominated at this init by the
#: tied embedding's self term, barely sees the layers; their gradients
#: do; the worst read on an H100 6.7e-3)
TR_CPU_LEAF_TOL = 0.05
#: whisper-tiny's steps: global batch (its 8 microbatches of one), frames,
#: tokens
TR_ED_BATCH, TR_ED_TOKENS, TR_ED_STEPS = 8, 448, 3
#: xLSTM's training at xlstm-1.3b's full width and depth: global batch
#: (in cfg.microbatches = 8 microbatches of 1 x 1,024) and replayed steps
#: timed
TR_XL_BATCH, TR_XL_STEPS = 8, 3
#: one superblock (7 mLSTM + 1 sLSTM layers): replay against eager (two
#: copies of the full state, 2 x 56.0 GB, do not fit; at 2 microbatches of
#: 1 x 1,024, a quarter of the step's eager host time) and the card
#: against the CPU
TR_XL_LAYERS, TR_XL_EAGER_MICRO = 8, 2
#: xlstm-1.3b's trained depth: 2 of its 6 superblocks (16 of 48 layers),
#: so the script keeps its time with phases moe_mesh, tp and dryrun: the
#: step's first call at full depth took 75.4 s of host time, and at 24
#: layers the whole script took 1,169 s of its 1,200 on an H100 80GB HBM3
#: (700 W) whose host ran about 30% slower than others
TR_XL_TRAIN_LAYERS = 16
#: the sLSTM's backward kernel against its plain reverse loop: (B, S, H,
#: W) of xlstm-1.3b's training call, and a ragged one (W 36: the
#: cluster's last block part-filled); the forward kernel with and without
#: its saves at the first
TR_XL_SLSTM_CASES = ((1, 1024, 4, 512), (2, 37, 3, 36))
#: the card against the CPU at one superblock, in two steps.  In fp32
#: activations the bars above hold the kernels.  In the config's bf16
#: the mLSTM's exponential gating lets roundings move gradient leaves by
#: tenths of their scale between any two sound runs: the CPU's own, on
#: its pool and on one intra-op thread (other sum orders, nothing else),
#: differed by 0.140 of blocks/1/mixer/igate/bias's max and the card's
#: from the CPU's by 0.179 (an H100 host, PERF.md).  So the bf16
#: gradients are held beside that witness, made in the same run: each
#: reading within max(its fp32 bar, TR_XL_BF16_WITNESS x the witness's).
#: A leaf that is zero in exact arithmetic (the sLSTM's input-gate bias:
#: its stabiliser scales c and n alike) holds rounding noise on both
#: devices, so each leaf's scale is floored at this share of the model's
#: largest gradient, as tests/test_torch_lm_train.py floors it
TR_XL_LEAF_FLOOR = 1e-3
TR_XL_BF16_WITNESS = 2.0


def train_attention(torch) -> dict:
    """One attention layer's training at Qwen2.5-3B's microbatch shape: K5
    forward with the rows' lse and the torch backward against autograd
    through ``full_attention``; the lse against the plain version; the
    forward, the backward and SDPA's forward and forward + backward timed;
    K5 at the LM prefill's shape (64, 1,024, 128) with and without the lse
    store."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.nn import attention

    b, s, h, kv, d = TR_ATTN
    g = h // kv
    gen = torch.Generator(device="cuda").manual_seed(80)
    q = torch.randn(b, s, h, d, generator=gen, device="cuda")
    k, v = (torch.randn(b, s, kv, d, generator=gen, device="cuda")
            for _ in range(2))
    do = torch.randn(b, s, h, d, generator=gen, device="cuda")
    pos = torch.arange(s, device="cuda").expand(b, s)

    def grads(fn):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*ts).backward(do)
        return [t.grad for t in ts]
    got = grads(lambda a, b_, c: fa_ops.attention(a, b_, c, causal=True))
    want = grads(lambda a, b_, c: attention.full_attention(
        a, b_, c, q_pos=pos, k_pos=pos, causal=True))
    errs = {n: float((x - y).abs().max()) for n, x, y in zip(
        ("dq", "dk", "dv"), got, want)}
    check(all(torch.allclose(x, y, rtol=TR_GRAD_RTOL, atol=TR_GRAD_ATOL)
              for x, y in zip(got, want)),
          f"K5's training gradients differ from autograd through "
          f"full_attention by {errs}")

    # the kernel with lse, (B*H, S, D), and its plain version
    qh = q.transpose(1, 2).reshape(b * h, s, d).contiguous()
    kh, vh = (t.repeat_interleave(g, 2).transpose(1, 2).reshape(
        b * h, s, d).contiguous() for t in (k, v))
    lse = torch.empty(b * h, s, device="cuda")
    o = flash_attention(qh, kh, vh, causal=True, lse=lse)
    _, lse_ref = flash_attention_ref(qh, kh, vh, causal=True, with_lse=True)
    lse_err = float((lse - lse_ref).abs().max())
    check(torch.allclose(lse, lse_ref, rtol=TR_GRAD_RTOL,
                         atol=TR_GRAD_ATOL),
          f"K5's lse differs from its plain version by {lse_err}")
    pairs = causal_pairs(s)
    fwd = kernel_call(
        torch, f"({b * h}, {s}, {d}) causal=True, lse",
        lambda: flash_attention(qh, kh, vh, causal=True, lse=lse),
        lambda: flash_attention_ref(qh, kh, vh, causal=True,
                                    with_lse=True)[0],
        lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True),
        4 * (4 * b * h * s * d + b * h * s), 4 * b * h * pairs * d,
        rtol=FLASH_RTOL, atol=FLASH_ATOL, plain_runs=20, runs=40)

    # the torch backward on the kernel's output and lse, and SDPA forward
    # + backward
    out = o.view(b, h, s, d).transpose(1, 2).reshape(b, s, kv, g, d)
    m = lse.view(b, kv, g, s)

    def backward():
        return attention.blockwise_grads(
            q, k, v, pos, pos, out, m, None, do, causal=True, window=None,
            logit_cap=0.0, block_size=fa_ops.BACKWARD_BLOCK)
    # 5 products of 2 * pairs * D each, and q, k, v, out, lse, do read,
    # dq, dk, dv written
    bwd_bytes = 4 * (4 * b * s * h * d + 4 * b * s * kv * d + b * h * s)
    bwd_flops = 10 * b * h * pairs * d
    bwd_ms = device_ms(torch, backward, 20, chunk=10,
                       label="training attention backward")
    bwd_bound, bwd_by = bound(bwd_bytes, bwd_flops)
    qs, ks, vs = (t.transpose(1, 2).clone().requires_grad_()
                  for t in (q, k.repeat_interleave(g, 2),
                            v.repeat_interleave(g, 2)))
    dos = do.transpose(1, 2).contiguous()

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qs, ks, vs,
                                       is_causal=True).backward(dos)
    sdpa_ms = device_ms(torch, sdpa_fwd_bwd, 20, chunk=10,
                        label="sdpa forward + backward")
    # K5 at the LM prefill's shape: with the lse store, and without
    bh2 = LM_FLASH_CASES[0][0]
    q2, k2, v2 = (torch.randn(bh2, s, d, generator=gen, device="cuda")
                  for _ in range(3))
    lse2 = torch.empty(bh2, s, device="cuda")
    prefill_ms = {
        "without_lse": device_ms(torch, lambda: flash_attention(
            q2, k2, v2, causal=True), 20, chunk=10, label="k5 prefill"),
        "with_lse": device_ms(torch, lambda: flash_attention(
            q2, k2, v2, causal=True, lse=lse2), 20, chunk=10,
            label="k5 prefill lse")}
    del q2, k2, v2
    torch.cuda.empty_cache()
    return {"shape": {"batch": b, "seq": s, "heads": h, "kv_heads": kv,
                      "head_dim": d, "causal": True},
            "grad_max_abs_err": errs, "lse_max_abs_err": lse_err,
            "tolerance": {"rtol": TR_GRAD_RTOL, "atol": TR_GRAD_ATOL},
            "forward": fwd, "backward_torch_ms": bwd_ms,
            "backward_bound_ms": bwd_bound, "backward_bound_by": bwd_by,
            "backward_bytes": bwd_bytes, "backward_flops": bwd_flops,
            "sdpa_forward_ms": fwd["library_ms"],
            "sdpa_forward_backward_ms": sdpa_ms,
            "k5_forward_plus_torch_backward_ms": fwd["ms"] + bwd_ms,
            "k5_lm_prefill_shape_ms": prefill_ms}


def _sample(torch, tree) -> list:
    """A few values of each leaf, to see that a step moved them."""
    from repro_torch.nn.module import tree_leaves
    return [t.reshape(-1)[:4].clone() for t in tree_leaves(tree)]


def first_loss_vs_cpu(torch, cfg, params, batch: dict) -> dict:
    """The first microbatch's loss over its first TR_FIRST_PREFIX
    positions at full depth: on the card at the training shape, the
    targets after the prefix masked; on the CPU, from a host copy of the
    same weights, on the prefix alone.  Held within TR_FIRST_RTOL."""
    from repro_torch.models import lm
    from repro_torch.nn import module

    n = TR_FIRST_PREFIX
    tokens = torch.as_tensor(batch["tokens"][:1])
    targets = torch.as_tensor(batch["targets"][:1]).clone()
    targets[:, n:] = -1
    with torch.no_grad():
        card = float(lm.train_loss(cfg, params, {
            "tokens": tokens.cuda(), "targets": targets.cuda()})[1]["loss"])
        t0 = time.perf_counter()
        host = module.map_tree(lambda t: t.to("cpu"), params)
        cpu = float(lm.train_loss(cfg, host, {
            "tokens": tokens[:, :n], "targets": targets[:, :n]})[1]["loss"])
        seconds = time.perf_counter() - t0
    del host
    rel = abs(card - cpu) / abs(cpu)
    check(rel <= TR_FIRST_RTOL,
          f"{LM_ARCH} first microbatch's loss over {n} positions: card "
          f"{card}, CPU {cpu} ({rel:.3g} apart, over {TR_FIRST_RTOL})")
    return {"prefix": n, "cuda": card, "cpu": cpu, "rel_err": rel,
            "rtol": TR_FIRST_RTOL, "cpu_seconds": seconds}


def train_full(torch, arch: str, n_params: int, batch: int, n_steps: int,
               want_launches, cpu_prefix: bool,
               layers: "int | None" = None) -> dict:
    """``arch`` trained at full width and depth (``layers``: cut to that
    depth, the full config's ``n_params`` still checked), ``batch`` x
    TR_SEQ tokens in its config's microbatches: the first call (one eager step, then the
    capture) with its loss held to the no-grad forward's, ``n_steps``
    replayed steps timed, one profiled; memory; the launches per replayed
    step held to ``want_launches(cfg)`` (kernel -> launches) and nothing
    else of the port's.  ``cpu_prefix``: the first microbatch's loss
    prefix against the CPU's at full depth too."""
    import math

    from repro_torch.configs import registry as configs
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.kernels import registry
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.nn import module, transformer
    from repro_torch.optim import adamw

    cfg = configs.get_config(arch)
    reduced = None
    if layers is not None:
        full_n = module.param_count(transformer.model_specs(cfg))
        check(full_n == n_params, f"{arch}: {full_n} parameters, want "
                                  f"{n_params}")
        reduced = f"n_layers {layers} of {cfg.n_layers}"
        cfg = cfg.replace(n_layers=layers)
        n_params = module.param_count(transformer.model_specs(cfg))
    free_card(torch)
    params, model = draw(torch, cfg, arch, n_params)
    state = adamw.init_state(params)
    state_bytes = torch.cuda.memory_allocated()
    pipe = SyntheticTokenPipeline(DataConfig(
        seq_len=TR_SEQ, global_batch=batch, vocab_size=cfg.vocab_size))
    batches = [pipe.batch_at(i) for i in range(n_steps + 3)]
    # the first batch's loss with no gradient, in one call: the step's
    # first loss must be it (the mean of its microbatches' means, every
    # target counted; the forward's values do not depend on autograd or
    # remat); and its first microbatch's prefix against the CPU at full
    # depth
    t0 = time.perf_counter()
    with torch.no_grad():
        first = float(lm.train_loss(cfg, params, {
            k_: torch.as_tensor(v_).cuda()
            for k_, v_ in batches[0].items()})[1]["loss"])
    no_grad_s = time.perf_counter() - t0
    vs_cpu = first_loss_vs_cpu(torch, cfg, params, batches[0]) \
        if cpu_prefix else None
    step = steps.make_train_step(cfg)
    before = _sample(torch, params)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, _, m = step(params, state, batches[0])
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    losses = [float(m["loss"])]
    emit({"phase": "train_lm", "step": f"{arch} first call",
          "seconds": first_call_s, "loss": losses[0], "no_grad_loss": first,
          "ln_vocab": math.log(cfg.vocab_size), "prefix_vs_cpu": vs_cpu,
          "grad_norm": float(m["grad_norm"]),
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    check(math.isfinite(losses[0])
          and abs(losses[0] - first) <= 1e-4 * abs(first),
          f"{arch} first loss {losses[0]}, no-grad forward {first}")
    registry.reset_launch_counts()
    times = []
    for i in range(1, n_steps + 1):
        t0 = time.perf_counter()
        _, _, m = step(params, state, batches[i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    per_step = {k_: v_ / n_steps
                for k_, v_ in registry.launch_counts().items() if v_}
    after = _sample(torch, params)
    moved = sum(not torch.equal(a, b_) for a, b_ in zip(before, after))
    check(all(math.isfinite(x) for x in losses)
          and moved == len(before),
          f"{arch} training: losses {losses}, {moved} of "
          f"{len(before)} leaves moved")
    want = want_launches(cfg)
    check(per_step == want,
          f"{arch} replayed step launched {per_step}, want {want} "
          f"(per layer and microbatch, the forward twice under remat) and "
          f"nothing else")
    t0 = time.perf_counter()
    prof = device_profile(torch, lambda: step(params, state, batches[-1]),
                          reps=1, warm=False)
    profile_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    p50 = statistics.median(times)
    tokens = batch * TR_SEQ
    n = module.param_count(transformer.model_specs(cfg))
    out = {"arch": arch, **model, "reduced": reduced,
           "first_loss_vs_cpu": vs_cpu, "batch": batch, "seq": TR_SEQ,
           "microbatches": cfg.microbatches, "remat": cfg.remat,
           "state_bytes": state_bytes, "peak_device_bytes": peak,
           "reserved_bytes": torch.cuda.memory_reserved(),
           "first_call_s": first_call_s, "no_grad_loss": first,
           "no_grad_s": no_grad_s, "profile_s": profile_s,
           "losses": losses,
           "step_ms_p50": p50, "step_ms": times,
           "tokens_per_s": tokens / p50 * 1e3,
           "model_flops_per_step": 6 * n * tokens,
           "mfu_bf16_dense": 6 * n * tokens / (p50 / 1e3)
           / BF16_FLOPS_PER_S,
           "launches_per_step": per_step,
           **{k_: v_ for k_, v_ in prof.items() if k_ != "kernels"},
           "kernels_top": prof["kernels"][:14]}
    step.runner().release()
    del params, state, step
    free_card(torch)
    return out


def train_replay_vs_eager(torch, arch: str, layers: int,
                          microbatches: int = 0) -> dict:
    """TR_EAGER_STEPS replayed steps against as many eager ones on a copy
    of the state, at ``arch``'s width and ``layers`` layers (and
    ``microbatches`` of 1 x TR_SEQ where given, else the config's), under
    deterministic algorithms (the step made, and so captured, under them):
    losses, parameters and moments value for value."""
    from repro_torch.configs import registry as configs
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch import steps
    from repro_torch.nn import module, transformer
    from repro_torch.nn.module import tree_leaves
    from repro_torch.optim import adamw

    full = configs.get_config(arch)
    cfg = full.replace(n_layers=layers,
                       microbatches=microbatches or full.microbatches)
    specs = transformer.model_specs(cfg)
    # parameters, gradients and both moments, fp32
    state_gb = 16 * module.param_count(transformer.model_specs(full)) / 1e9
    pipe = SyntheticTokenPipeline(DataConfig(
        seq_len=TR_SEQ, global_batch=cfg.microbatches,
        vocab_size=cfg.vocab_size))
    saved = torch.are_deterministic_algorithms_enabled()
    try:
        torch.use_deterministic_algorithms(True)
        trees = []
        for _ in range(2):
            p = module.init_tree(specs, torch.Generator(
                device="cuda").manual_seed(0), device="cuda")
            trees.append((p, adamw.init_state(p)))
        step = steps.make_train_step(cfg)
        losses = {"replayed": [], "eager": []}
        for i in range(TR_EAGER_STEPS + 1):
            b = pipe.batch_at(i)
            for label, fn, (p, st) in (("replayed", step, trees[0]),
                                       ("eager", step.eager, trees[1])):
                losses[label].append(float(fn(p, st, b)[2]["loss"]))
        differ = sum(value_diff(torch, a, b_) for a, b_ in zip(
            tree_leaves(trees[0]), tree_leaves(trees[1])))
        step.runner().release()
    finally:
        torch.use_deterministic_algorithms(saved)
    check(losses["replayed"] == losses["eager"] and differ == 0,
          f"{arch} ({layers} layers): replayed losses "
          f"{losses['replayed']}, eager {losses['eager']}, {differ} state "
          f"values differing")
    del trees
    free_card(torch)
    return {"arch": arch, "layers": layers,
            "microbatches": cfg.microbatches,
            "reduced": f"n_layers {layers} of {full.n_layers}: two copies "
                       f"of the full state (2 x {state_gb:.1f} GB) do not "
                       f"fit",
            "steps": TR_EAGER_STEPS + 1, "replays_checked": TR_EAGER_STEPS,
            "losses": losses, "state_values_differing": differ,
            "deterministic": True}


def _named_leaves(tree, prefix: str = "") -> list:
    """(path, leaf) of a tree of dicts, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _leaf_errors(named: list, got: list, want: list,
                 leaf_floor: float) -> tuple:
    """Each leaf's max |got - want| over want's max |gradient|, floored at
    ``leaf_floor`` of the largest; and the names of the floored leaves."""
    err, floored = {}, []
    top = max(float(c.abs().max()) for c in want)
    for (name, _), a, c in zip(named, got, want):
        scale = float(c.abs().max())
        if scale < leaf_floor * top:
            scale = leaf_floor * top
            floored.append(name)
        err[name] = float((a - c).abs().max()) / scale if scale \
            else float(a.abs().max())
    return err, floored


def train_card_vs_cpu(torch) -> dict:
    """One step at TR_CPU_LAYERS layers of Qwen2.5-3B's width on the card
    and on the CPU, from the same weights and batch (1 x TR_CPU_S, one
    microbatch): the loss within TR_CPU_LOSS_RTOL, the grad norm within
    TR_CPU_GN_RTOL; and each gradient leaf of ``lm.train_loss`` within
    TR_CPU_LEAF_TOL of the leaf's max |gradient|."""
    from repro_torch.configs import registry as configs
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.nn import module, transformer
    from repro_torch.optim import adamw

    cfg = configs.get_config(LM_ARCH).replace(n_layers=TR_CPU_LAYERS,
                                              microbatches=1)
    w = module.init_tree(transformer.model_specs(cfg),
                         torch.Generator().manual_seed(81))
    b = SyntheticTokenPipeline(DataConfig(
        seq_len=TR_CPU_S, global_batch=1,
        vocab_size=cfg.vocab_size)).batch_at(0)
    out, grads = {}, {}
    for dev in ("cuda", "cpu"):
        p = module.map_tree(
            lambda t: t.to(dev, copy=True).requires_grad_(), w)
        named = _named_leaves(p)
        total, _ = lm.train_loss(cfg, p, {
            k_: torch.as_tensor(v_).to(dev) for k_, v_ in b.items()})
        grads[dev] = [g.cpu() for g in torch.autograd.grad(
            total, [t for _, t in named])]
        p = module.map_tree(lambda t: t.detach(), p)
        t0 = time.perf_counter()
        _, _, m = steps.make_train_step(cfg).eager(p, adamw.init_state(p),
                                                   b)
        out[dev] = {"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "seconds": time.perf_counter() - t0}
        del p
    free_card(torch)
    leaf_err, _ = _leaf_errors(named, grads["cuda"], grads["cpu"], 0.0)
    worst = max(leaf_err, key=leaf_err.get)
    dl = abs(out["cuda"]["loss"] - out["cpu"]["loss"]) / abs(
        out["cpu"]["loss"])
    dg = abs(out["cuda"]["grad_norm"] - out["cpu"]["grad_norm"]) / abs(
        out["cpu"]["grad_norm"])
    check(dl <= TR_CPU_LOSS_RTOL and dg <= TR_CPU_GN_RTOL
          and leaf_err[worst] <= TR_CPU_LEAF_TOL,
          f"{LM_ARCH} ({TR_CPU_LAYERS} layers) step on the card against "
          f"the CPU: loss {dl:.4g}, grad norm {dg:.4g} apart; gradient "
          f"leaf {worst} {leaf_err[worst]:.4g} of its max")
    return {"layers": TR_CPU_LAYERS, "seq": TR_CPU_S, **out,
            "loss_rel_err": dl, "grad_norm_rel_err": dg,
            "grad_leaf_err_over_max": leaf_err, "worst_leaf": worst,
            "tolerance": {"loss_rtol": TR_CPU_LOSS_RTOL,
                          "grad_norm_rtol": TR_CPU_GN_RTOL,
                          "grad_leaf_over_max": TR_CPU_LEAF_TOL}}


def train_grads_vs_cpu(torch, arch: str, layers: int,
                       leaf_floor: float) -> dict:
    """``lm.train_loss``'s loss and gradients at ``layers`` layers of
    ``arch`` (1 x TR_CPU_S, one microbatch) on the card and on the CPU,
    from the same weights and batch.  In fp32 activations the loss is
    held within TR_CPU_LOSS_RTOL, the gradient norm within TR_CPU_GN_RTOL
    and each leaf within TR_CPU_LEAF_TOL of its max |gradient| (floored as
    in :func:`_leaf_errors`).  In the config's bf16 the CPU's run is made
    again on one intra-op thread, which sums in other orders: that pair
    is the witness of bf16's own noise, and each of the card's readings
    is held within max(its fp32 bar, TR_XL_BF16_WITNESS x the
    witness's).  The witness, the longest run, runs in a thread of its
    own beside the others (intra-op threads are set per thread)."""
    import threading

    from repro_torch.configs import registry as configs
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.models import lm
    from repro_torch.nn import module, transformer

    base = configs.get_config(arch).replace(n_layers=layers, microbatches=1)
    w = module.init_tree(transformer.model_specs(base),
                         torch.Generator().manual_seed(81))
    b = SyntheticTokenPipeline(DataConfig(
        seq_len=TR_CPU_S, global_batch=1,
        vocab_size=base.vocab_size)).batch_at(0)
    pool = torch.get_num_threads()
    bars = {"loss_rel_err": TR_CPU_LOSS_RTOL,
            "grad_norm_rel_err": TR_CPU_GN_RTOL,
            "worst_leaf_err": TR_CPU_LEAF_TOL}

    def run(cfg, dev: str, threads: int = 0) -> dict:
        t0 = time.perf_counter()
        if threads:
            torch.set_num_threads(threads)
        try:
            p = module.map_tree(
                lambda t: t.to(dev, copy=True).requires_grad_(), w)
            total, _ = lm.train_loss(cfg, p, {
                k_: torch.as_tensor(v_).to(dev) for k_, v_ in b.items()})
            g = [x.float().cpu() for x in torch.autograd.grad(
                total, [t for _, t in _named_leaves(p)])]
            used = torch.get_num_threads()
        finally:
            if threads:
                torch.set_num_threads(pool)
        return {"loss": float(total.detach()), "grads": g,
                "grad_norm": float(torch.sqrt(sum(
                    (x.double() ** 2).sum() for x in g))),
                "intra_op_threads": used,
                "seconds": time.perf_counter() - t0}

    def readings(got: dict, want: dict) -> dict:
        leaf, floored = _leaf_errors(_named_leaves(w), got["grads"],
                                     want["grads"], leaf_floor)
        worst = max(leaf, key=leaf.get)
        return {"loss_rel_err": abs(got["loss"] - want["loss"])
                / abs(want["loss"]),
                "grad_norm_rel_err": abs(got["grad_norm"]
                                         - want["grad_norm"])
                / want["grad_norm"],
                "worst_leaf": worst, "worst_leaf_err": leaf[worst],
                "leaves_over_5pct": sum(v > TR_CPU_LEAF_TOL
                                        for v in leaf.values()),
                "floored_leaves": floored}

    bf16 = base.activation_dtype
    witness_box: dict = {}

    def witness() -> None:
        try:
            witness_box["run"] = run(base, "cpu", threads=1)
        except Exception as exc:        # raised again in the caller
            witness_box["error"] = exc
    side = threading.Thread(target=witness, name="bf16 witness")
    side.start()
    out = {"arch": arch, "layers": layers, "seq": TR_CPU_S,
           "threads": pool, "leaf_scale_floor": leaf_floor,
           "witness_factor": TR_XL_BF16_WITNESS}
    for dtype in ("float32", bf16):
        cfg = base.replace(activation_dtype=dtype)
        runs = {"cuda": run(cfg, "cuda"), "cpu": run(cfg, "cpu")}
        card = readings(runs["cuda"], runs["cpu"])
        rec = {"card_vs_cpu": card, "bars": dict(bars)}
        if dtype == bf16:
            side.join()
            if "error" in witness_box:
                raise witness_box["error"]
            runs["cpu, 1 thread"] = witness_box["run"]
            check(runs["cpu, 1 thread"]["intra_op_threads"] == 1
                  and runs["cpu"]["intra_op_threads"] == pool,
                  f"the bf16 witness ran on "
                  f"{runs['cpu, 1 thread']['intra_op_threads']} intra-op "
                  f"threads beside {runs['cpu']['intra_op_threads']}")
            witness = readings(runs["cpu, 1 thread"], runs["cpu"])
            rec["witness_cpu_1_thread_vs_cpu"] = witness
            rec["bars"] = {k: max(bar, TR_XL_BF16_WITNESS * witness[k])
                           for k, bar in bars.items()}
        free_card(torch)
        check(all(card[k] <= rec["bars"][k] for k in bars),
              f"{arch} ({layers} layers) {dtype} gradients on the card "
              f"against the CPU: {card}, bars {rec['bars']}")
        out[dtype] = {**rec, **{k: {k_: v_ for k_, v_ in r.items()
                                    if k_ != "grads"}
                                for k, r in runs.items()}}
    return out


def train_whisper(torch) -> dict:
    """whisper-tiny's ``encdec.train_loss`` through ``make_train_step`` on
    the card: TR_ED_STEPS steps (the first captures), losses finite, K5's
    launches per replayed step as counted."""
    import math

    import numpy as np
    from repro_torch.configs import registry as configs
    from repro_torch.kernels import registry
    from repro_torch.launch import steps
    from repro_torch.models import encdec
    from repro_torch.nn import module
    from repro_torch.optim import adamw

    cfg = configs.get_config(ED_ARCH)
    params = module.init_tree(encdec.model_specs(cfg), torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    state = adamw.init_state(params)
    step = steps.make_train_step(cfg)
    rng = np.random.default_rng(82)
    losses, times, launches = [], [], []
    for _ in range(TR_ED_STEPS):
        toks = rng.integers(1, cfg.vocab_size, (TR_ED_BATCH,
                                                TR_ED_TOKENS + 1))
        b = {"frames": rng.standard_normal((
            TR_ED_BATCH, cfg.encoder_len, cfg.d_model)).astype(np.float32),
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32)}
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        _, _, m = step(params, state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        launches.append({k_: v_ for k_, v_ in
                         registry.launch_counts().items() if v_})
    check(all(math.isfinite(x) for x in losses),
          f"{ED_ARCH} training losses {losses}")
    want = (cfg.n_encoder_layers + cfg.n_layers) * cfg.microbatches
    check(launches[-1] == {"flash_attention": want},
          f"{ED_ARCH} replayed step launched {launches[-1]}, want "
          f"flash_attention {want}")
    step.runner().release()
    del params, state
    free_card(torch)
    return {"arch": ED_ARCH, "batch": TR_ED_BATCH,
            "frames": cfg.encoder_len, "tokens": TR_ED_TOKENS,
            "microbatches": cfg.microbatches,
            "remat": "none (the reference's encdec has no remat)",
            "losses": losses, "step_ms": times,
            "launches_per_step": launches}


def slstm_backward_kernel(torch) -> dict:
    """The sLSTM's backward kernel against its plain reverse loop at
    TR_XL_SLSTM_CASES, both on the saves of the forward kernel (themselves
    held against the plain forward's); its device time beside the plain
    loop's and the bound (the products dpre_g @ R_g^T: 8 W^2 flops per
    (batch row, head, step); dhs, the seven saves, R and the start state
    read once, the four dx written once); the forward kernel with and
    without its saves at the training call."""
    from repro_torch.kernels.slstm_scan.ref import (slstm_scan_backward_ref,
                                                    slstm_scan_ref)
    from repro_torch.kernels.slstm_scan.slstm_scan import (
        SAVES, slstm_scan, slstm_scan_backward)
    gen = torch.Generator(device="cuda").manual_seed(84)
    calls = []
    for b, s, nh, w in TR_XL_SLSTM_CASES:
        x_pre = [torch.randn(b, s, nh, w, generator=gen, device="cuda")
                 for _ in range(4)]
        rec = [0.02 * torch.randn(nh, w, w, generator=gen, device="cuda")
               for _ in range(4)]       # the spec's scale
        state = [torch.zeros(b, nh, w, device="cuda") for _ in range(3)]
        state.append(torch.full((b, nh, w), -1e30, device="cuda"))
        dhs = torch.randn(b, s, nh, w, generator=gen, device="cuda")
        saves = [torch.empty_like(dhs) for _ in SAVES]
        plain = [torch.empty_like(dhs) for _ in SAVES]
        slstm_scan(x_pre, rec, *[t.clone() for t in state], saves=saves)
        slstm_scan_ref(x_pre, rec, *[t.clone() for t in state], saves=plain)
        got = slstm_scan_backward(dhs, rec, saves, *state[1:])
        want = slstm_scan_backward_ref(dhs, rec, saves, *state[1:])
        torch.cuda.synchronize()
        call = f"(B {b}, S {s}, H {nh}, W {w})"
        save_err = {n: float((a - b_).abs().max())
                    for n, a, b_ in zip(SAVES, saves, plain)}
        err = {f"d{g}": float((a - b_).abs().max())
               for g, a, b_ in zip("ifzo", got, want)}
        bad = [n for n, a, b_ in zip(SAVES, saves, plain)
               if not torch.allclose(a, b_, rtol=SLSTM_RTOL,
                                     atol=SLSTM_ATOL)]
        bad += [f"d{g}" for g, a, b_ in zip("ifzo", got, want)
                if not torch.allclose(a, b_, rtol=SLSTM_RTOL,
                                      atol=SLSTM_ATOL)]
        check(not bad, f"slstm_scan_backward {call}: {bad} differ from "
                       f"the plain version (saves {save_err}, dx {err})")
        nbytes = 4 * (12 * b * s * nh * w + 4 * nh * w * w + 3 * b * nh * w)
        flops = 8 * w * w * b * nh * s
        bound_ms, bound_by = bound(nbytes, flops)
        label = f"slstm_scan_backward {call}"
        runs = 20 if s > 64 else TIMED_RUNS
        kern = lambda: slstm_scan_backward(  # noqa: E731
            dhs, rec, saves, *state[1:])
        plain = lambda: slstm_scan_backward_ref(  # noqa: E731
            dhs, rec, saves, *state[1:])
        rec_ = {"call": call, "max_abs_err": max(err.values()),
                "max_abs_err_by_gate": err, "saves_max_abs_err": save_err,
                "tolerance": {"rtol": SLSTM_RTOL, "atol": SLSTM_ATOL},
                "ms": device_ms(torch, kern, runs, label=label),
                "plain_ms": _blocking_ms(torch, plain, 3, f"{label} plain"),
                "library_ms": None, "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": nbytes, "flops": flops}
        rec_["us_per_step"] = rec_["ms"] * 1e3 / s
        if (b, s, nh, w) == TR_XL_SLSTM_CASES[0]:
            work = [t.clone() for t in state]
            rec_["forward_ms"] = {
                "without_saves": device_ms(torch, lambda: slstm_scan(
                    x_pre, rec, *work), runs, label="slstm_scan train"),
                "with_saves": device_ms(torch, lambda: slstm_scan(
                    x_pre, rec, *work, saves=saves), runs,
                    label="slstm_scan train saves")}
            rec_["saves_bytes"] = 4 * len(SAVES) * b * s * nh * w
        calls.append(rec_)
        del x_pre, rec, state, dhs, saves, plain, got, want
    torch.cuda.empty_cache()
    return {"calls": calls}


def train_xlstm(torch) -> dict:
    """xLSTM's training on the card: the sLSTM's backward kernel against
    its plain reverse loop; xlstm-1.3b trained at full width, cut to
    TR_XL_TRAIN_LAYERS layers (32 forward and 16 backward sLSTM launches
    a replayed step at 16 layers, nothing else of the port's); replay
    against eager and the card against the CPU at one superblock, in fp32
    and in bf16 activations."""
    t0 = time.perf_counter()
    kern = slstm_backward_kernel(torch)
    emit({"phase": "train_lm", "step": "slstm backward", **kern,
          "timing": {k: v for k, v in TIMING_NOTES.items()
                     if k.startswith("slstm_scan_backward")},
          "seconds": time.perf_counter() - t0})

    def want(cfg):
        n = forward_launches(cfg)["slstm_scan"] * cfg.microbatches
        return {"slstm_scan": 2 * n, "slstm_scan_backward": n}
    t0 = time.perf_counter()
    full = train_full(torch, XL_ARCH, XL_PARAMS, TR_XL_BATCH, TR_XL_STEPS,
                      want, cpu_prefix=False, layers=TR_XL_TRAIN_LAYERS)
    emit({"phase": "train_lm", "step": XL_ARCH, **full,
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    eager = train_replay_vs_eager(torch, XL_ARCH, TR_XL_LAYERS,
                                  TR_XL_EAGER_MICRO)
    emit({"phase": "train_lm", "step": f"{XL_ARCH} replayed vs eager",
          **eager, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    cpu = train_grads_vs_cpu(torch, XL_ARCH, TR_XL_LAYERS, TR_XL_LEAF_FLOOR)
    emit({"phase": "train_lm", "step": f"{XL_ARCH} card vs cpu", **cpu,
          "seconds": time.perf_counter() - t0})
    return {"backward": kern,
            "launches": {k_: int(v_) for k_, v_ in
                         full["launches_per_step"].items()}}


def train_loss_cost(torch) -> dict:
    """The training loss at Qwen2.5-3B's microbatch (1 x TR_SEQ positions
    over its vocabulary, fp32 logits, the last target not counted):
    ``models.lm.next_token_loss``, whose vocabulary-parallel
    cross-entropy (``nn.tensor_parallel.cross_entropy``) every LM train
    step runs, against the fused ``log_softmax`` and ``nll_loss`` it
    replaced, on the same inputs.  Forward and backward: the device time
    of each, the peak memory each adds over its input, the loss within
    1e-5 and the gradient within 1e-6 of the other's."""
    import torch.nn.functional as F

    from repro_torch.configs import registry as configs
    from repro_torch.models import lm

    vocab = configs.get_config(LM_ARCH).vocab_size
    gen = torch.Generator(device="cuda").manual_seed(53)
    logits = 4.0 * torch.randn(1, TR_SEQ, vocab, device="cuda",
                               generator=gen)
    targets = torch.randint(0, vocab, (1, TR_SEQ), device="cuda",
                            generator=gen)
    targets[:, -1] = -1

    def port(x):
        return lm.next_token_loss(x, targets)[0]

    def fused(x):
        t = targets.long().reshape(-1)
        nll = F.nll_loss(F.log_softmax(x.reshape(-1, vocab), dim=-1),
                         t.clamp(min=0), reduction="none")
        mask = (t >= 0).to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)

    def run(f):
        x = logits.detach().requires_grad_()
        loss = f(x)
        loss.backward()
        return loss.detach(), x.grad

    out: dict = {"shape": [TR_SEQ, vocab], "ms": {}, "peak_added_bytes": {}}
    got = {}
    for name, f in (("port", port), ("fused", fused)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got[name] = run(f)
        torch.cuda.synchronize()
        out["peak_added_bytes"][name] = \
            torch.cuda.max_memory_allocated() - base
        out["ms"][name] = device_ms(torch, lambda f=f: run(f),
                                    label=f"loss {name}")
    loss_err = abs(float(got["port"][0]) - float(got["fused"][0]))
    grad_err = float((got["port"][1] - got["fused"][1]).abs().max())
    check(loss_err <= 1e-5 * abs(float(got["fused"][0]))
          and grad_err <= 1e-6,
          f"the training loss against log_softmax and nll_loss: loss "
          f"{loss_err}, gradient {grad_err}")
    out.update(loss_abs_err=loss_err, grad_max_abs_err=grad_err,
               ms_ratio=out["ms"]["port"] / out["ms"]["fused"])
    del logits, targets, got
    torch.cuda.empty_cache()
    return out


def phase_train_lm(torch) -> dict:
    """The LM's training on the card: one attention layer's gradients and
    the loss at Qwen2.5-3B's microbatch shape; Qwen2.5-3B trained at full width and
    depth (3,085,938,688 parameters, batch 4 x 1,024 in 4 microbatches,
    full remat, each step a replayed graph); replay against eager at four
    layers; the card against the CPU at two layers; whisper-tiny's
    training steps; xlstm-1.3b's: the sLSTM's backward kernel, the model
    trained at full width, 16 of 48 layers (batch 8 x 1,024 in 8
    microbatches),
    replay against eager and the card against the CPU at one
    superblock."""
    t_phase = time.perf_counter()
    att = train_attention(torch)
    emit({"phase": "train_lm", "step": "attention", **att})
    emit({"phase": "train_lm", "step": "loss", **train_loss_cost(torch)})
    full = train_full(torch, LM_ARCH, LM_PARAMS, TR_BATCH, TR_STEPS,
                      lambda cfg: {"flash_attention":
                                   2 * cfg.n_layers * cfg.microbatches},
                      cpu_prefix=True)
    emit({"phase": "train_lm", "step": "qwen2.5-3b", **full})
    eager = train_replay_vs_eager(torch, LM_ARCH, TR_EAGER_LAYERS)
    emit({"phase": "train_lm", "step": "replayed vs eager", **eager})
    cpu = train_card_vs_cpu(torch)
    emit({"phase": "train_lm", "step": "card vs cpu", **cpu})
    ed = train_whisper(torch)
    emit({"phase": "train_lm", "step": "whisper-tiny", **ed})
    t_xl = time.perf_counter()
    xl = train_xlstm(torch)
    emit({"phase": "train_lm", "step": "done",
          "seconds": time.perf_counter() - t_phase,
          "xlstm_seconds": time.perf_counter() - t_xl})
    return {"attention": att,
            "launches": {k_: int(v_) for k_, v_ in
                         full["launches_per_step"].items()},
            "whisper_launches": {k_: int(v_) for k_, v_ in
                                 ed["launches_per_step"][-1].items()},
            "xlstm": xl}


#: phase mesh: Qwen2.5-3B at full width cut to MESH_LAYERS layers (two
#: copies of the full-depth state, 2 x 49.4 GB, do not fit), batch
#: TR_BATCH x TR_SEQ in the config's 4 microbatches; the sharded and the
#: unsharded step's first calls, MESH_COMPARED replays each held value for
#: value, then MESH_TIMED replays each timed
MESH_LAYERS, MESH_COMPARED, MESH_TIMED = 4, 2, 5
#: the sharded step's peak device memory over the unsharded one's
MESH_PEAK_RATIO = 1.05


def _mesh_pair(torch, cfg, mesh, trees, batches, comp: bool) -> dict:
    """The sharded and the unsharded step (with compression where
    ``comp``) on ``trees`` ((sharded params, state), (params, state)),
    made and captured under deterministic algorithms: each step's first
    call, then MESH_COMPARED replays of each, metrics value for value; the
    K5 launches of one replayed sharded step; then MESH_TIMED replays of
    each timed (host clock, synchronised), with the peak device memory
    each step adds over the live states."""
    from repro_torch.configs import registry as configs
    from repro_torch.kernels import registry
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps
    from repro_torch.nn import module, transformer

    rules = sh.rules_for(cfg)
    axes = module.axes_tree(transformer.model_specs(cfg))
    abstract, _ = sh.model_param_shardings(cfg, mesh)
    o_sh = sh.state_shardings(abstract, axes, mesh, rules)
    per = TR_BATCH // cfg.microbatches
    train = configs.input_axes(cfg, configs.get_shape("train_4k"))
    micro_sh = {k: sh.sharding_for((cfg.microbatches, per, TR_SEQ),
                                   (None,) + ax, mesh, rules)
                for k, ax in train.items()}
    made = {"sharded": steps.make_train_step(
        cfg, grad_compression=comp, microbatch_shardings=micro_sh,
        grad_shardings=o_sh["mu"]),
        "unsharded": steps.make_train_step(cfg, grad_compression=comp)}
    tree = dict(zip(("sharded", "unsharded"), trees))
    out: dict = {"metrics": {}, "first_call_s": {}, "step_ms": {},
                 "peak_extra_bytes": {}}
    for label, step in made.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ms = [step(*tree[label], batches[0])[2]]
        torch.cuda.synchronize()
        out["first_call_s"][label] = time.perf_counter() - t0
        for i in range(MESH_COMPARED):
            if label == "sharded" and i == 0:
                registry.reset_launch_counts()
            ms.append(step(*tree[label], batches[1 + i])[2])
            if label == "sharded" and i == 0:
                torch.cuda.synchronize()
                out["launches_per_step"] = {
                    k: v for k, v in registry.launch_counts().items() if v}
        times = []
        for i in range(MESH_TIMED):
            t0 = time.perf_counter()
            step(*tree[label], batches[1 + MESH_COMPARED + i])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["peak_extra_bytes"][label] = torch.cuda.max_memory_allocated() \
            - base
        out["metrics"][label] = [{k: float(v) for k, v in m.items()}
                                 for m in ms]
        out["step_ms"][label] = times
    check(out["metrics"]["sharded"] == out["metrics"]["unsharded"],
          f"sharded step's metrics {out['metrics']['sharded']} against "
          f"the unsharded step's {out['metrics']['unsharded']}")
    differ = 0
    (ps, ss), (pu, su) = trees
    for a, b in zip(module.tree_leaves((ps, ss)),
                    module.tree_leaves((pu, su))):
        differ += value_diff(torch, sh.local(a), b)
    out["state_values_differing"] = differ
    check(differ == 0, f"sharded step's state differs from the unsharded "
                       f"step's in {differ} values")
    for step in made.values():
        step.runner().release()
    return out


def mesh_psum(torch, mesh, x) -> dict:
    """``compressed_psum`` over ``data`` on the card (NCCL, int32 payload)
    of ``x``, against its one-rank value, the dequantised int8 of ``x``
    (bit for bit); timed."""
    from repro_torch.optim import compress
    fn = compress.compressed_psum("data", mesh)
    got = fn(x)
    want = compress.dequantize_int8(*compress.quantize_int8(x))
    differ = value_diff(torch, got, want)
    check(differ == 0, f"compressed_psum on the 1 x 1 mesh differs from "
                       f"the dequantised int8 in {differ} values")
    ms = device_ms(torch, lambda: fn(x), 10, chunk=5,
                   label="compressed_psum")
    return {"elements": x.numel(), "values_differing": differ, "ms": ms,
            "payload_bytes": 4 * x.numel()}


def mesh_reshard(torch, mesh) -> dict:
    """``reshard_checkpoint`` onto the 1 x 1 NCCL mesh of a checkpoint of
    tiny Qwen2.5-3B's parameters and AdamW state: every leaf bit for bit
    what was saved, on the card."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import registry as configs
    from repro_torch.nn import module, transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime.elastic import reshard_checkpoint

    cfg = configs.get_tiny(LM_ARCH)
    p = module.init_tree(transformer.model_specs(cfg),
                         torch.Generator().manual_seed(3))
    saved = {"params": p, "opt": adamw.init_state(p)}
    for t in module.tree_leaves(saved["opt"]["mu"]):
        t.normal_(generator=torch.Generator().manual_seed(4))
    tmp = Path(tempfile.mkdtemp(prefix=".smoke_mesh_", dir=ROOT))
    try:
        CheckpointManager(str(tmp)).save(7, saved)
        t0 = time.perf_counter()
        tree, step = reshard_checkpoint(CheckpointManager(str(tmp)), cfg,
                                        mesh)
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got, want = module.tree_leaves(tree), module.tree_leaves(saved)
    differ = sum(value_diff(torch, g.to_local().cpu(), w)
                 for g, w in zip(got, want))
    on_card = all(g.to_local().is_cuda for g in got)
    check(step == 7 and len(got) == len(want) and differ == 0 and on_card,
          f"reshard_checkpoint onto the card's mesh: step {step}, "
          f"{len(got)} of {len(want)} leaves, {differ} values differing, "
          f"on the card {on_card}")
    return {"arch": cfg.name, "leaves": len(got), "values_differing": differ,
            "seconds": seconds}


def mesh_states(torch, cfg, mesh, sharded_only: bool = False) -> list:
    """[(sharded params, state), (params, state)]: ``cfg``'s parameters
    drawn on the card from seed 0 twice, and each one's AdamW state; the
    first pair sharded by ``model_param_shardings`` and ``state_axes``
    (no leaf copied on the 1 x 1 mesh).  ``sharded_only``: that pair
    alone."""
    from repro_torch.launch import shardings as sh
    from repro_torch.nn import module, transformer
    from repro_torch.optim import adamw

    specs = transformer.model_specs(cfg)
    abstract, p_sh = sh.model_param_shardings(cfg, mesh)
    o_sh = sh.state_shardings(abstract, module.axes_tree(specs), mesh,
                              sh.rules_for(cfg))
    trees = []
    for sharded in (True,) if sharded_only else (True, False):
        p = module.init_tree(specs, torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        st = adamw.init_state(p)
        if sharded:
            ptrs = [t.data_ptr() for t in module.tree_leaves(p)]
            p, st = sh.shard_tree(p, p_sh), sh.shard_tree(st, o_sh)
            copied = sum(sh.local(t).data_ptr() != q for t, q in zip(
                module.tree_leaves(p), ptrs))
            check(copied == 0, f"shard_tree copied {copied} parameters "
                               f"on the 1 x 1 mesh")
        trees.append((p, st))
    return trees


def phase_mesh(torch) -> dict:
    """The sharded pieces on the card: a 1 x 1 (data, model) NCCL mesh;
    Qwen2.5-3B at full width, 4 layers, through the split plan over its
    head width (asserted, with its axes; on one rank the attention's
    exchanges are identities), its parameters and AdamW state
    sharded by ``model_param_shardings`` and ``state_axes``
    (``shard_tree``: no copy on this mesh), the batch by ``input_axes``;
    the sharded step replayed against the unsharded one from the same
    seed, value for value, without and then with ``grad_compression``;
    K5 launches per sharded step; step times and peak memory side by
    side; ``compressed_psum`` over ``data``; ``reshard_checkpoint`` onto
    the mesh."""
    import torch.distributed

    from repro_torch.launch.mesh import single_device_mesh

    t_phase = time.perf_counter()
    free_card(torch)
    mesh = single_device_mesh()
    try:
        return _mesh_phase(torch, mesh, t_phase)
    finally:
        torch.distributed.destroy_process_group()


def _mesh_phase(torch, mesh, t_phase: float) -> dict:
    """:func:`phase_mesh` on its mesh."""
    from repro_torch.configs import registry as configs
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch import shardings as sh
    from repro_torch.nn import module, transformer
    from repro_torch.optim import adamw, compress

    full = configs.get_config(LM_ARCH)
    cfg = full.replace(n_layers=MESH_LAYERS)
    split = check_plan(sh, cfg, mesh)
    specs = transformer.model_specs(cfg)
    o_sh = sh.state_shardings(sh.model_param_shardings(cfg, mesh)[0],
                              module.axes_tree(specs), mesh,
                              sh.rules_for(cfg))
    pipe = SyntheticTokenPipeline(DataConfig(
        seq_len=TR_SEQ, global_batch=TR_BATCH, vocab_size=cfg.vocab_size))
    n_batches = 1 + MESH_COMPARED + MESH_TIMED
    trees = mesh_states(torch, cfg, mesh)
    state_bytes = torch.cuda.memory_allocated() // 2
    saved = torch.are_deterministic_algorithms_enabled()
    pairs = {}
    try:
        torch.use_deterministic_algorithms(True)
        pairs["plain"] = _mesh_pair(
            torch, cfg, mesh, trees,
            [pipe.batch_at(i) for i in range(n_batches)], False)
        (_, ss), (pu, su) = trees
        su["err"] = compress.init_error_state(pu)
        ss["err"] = sh.shard_tree(compress.init_error_state(pu), o_sh["mu"])
        pairs["compressed"] = _mesh_pair(
            torch, cfg, mesh, trees,
            [pipe.batch_at(n_batches + i) for i in range(n_batches)], True)
    finally:
        torch.use_deterministic_algorithms(saved)
    want = {"flash_attention": 2 * cfg.n_layers * cfg.microbatches}
    for label, pair in pairs.items():
        check(pair["launches_per_step"] == want,
              f"mesh {label}: a replayed sharded step launched "
              f"{pair['launches_per_step']}, want {want} (per layer and "
              f"microbatch, the forward twice under remat) and nothing "
              f"else")
    plain = pairs["plain"]
    peak = {k: state_bytes + v for k, v in plain["peak_extra_bytes"].items()}
    ratio = peak["sharded"] / peak["unsharded"]
    check(ratio <= MESH_PEAK_RATIO,
          f"the sharded step's peak {peak['sharded']} B is {ratio:.4f} of "
          f"the unsharded step's {peak['unsharded']} B")
    p50 = {k: statistics.median(v) for k, v in plain["step_ms"].items()}
    psum = mesh_psum(torch, mesh, sh.local(
        trees[0][1]["err"]["embed"]["table"]))
    trees.clear()
    free_card(torch)
    reshard = mesh_reshard(torch, mesh)
    n = module.param_count(specs)
    out = {"arch": LM_ARCH, "layers": MESH_LAYERS, "split_axes": split,
           "reduced": f"n_layers {MESH_LAYERS} of {full.n_layers}: the "
                      f"sharded and the unsharded state side by side (2 x "
                      f"{16 * module.param_count(transformer.model_specs(full)) / 1e9:.1f}"
                      f" GB at full depth) do not fit",
           "parameters": n, "mesh": dict(mesh.shape), "backend": "nccl",
           "batch": TR_BATCH, "seq": TR_SEQ,
           "microbatches": cfg.microbatches, "deterministic": True,
           "state_bytes_each": state_bytes,
           "pairs": {k: {kk: vv for kk, vv in v.items()
                         if kk != "peak_extra_bytes"}
                     for k, v in pairs.items()},
           "step_ms_p50": p50,
           "tokens_per_s": {k: TR_BATCH * TR_SEQ / v * 1e3
                            for k, v in p50.items()},
           "peak_device_bytes": peak, "peak_ratio": ratio,
           "compressed_psum": psum, "reshard": reshard,
           "seconds": time.perf_counter() - t_phase}
    emit({"phase": "mesh", **out})
    return {"launches": {k: int(v) for k, v in
                         plain["launches_per_step"].items()},
            "step_ms_p50": p50["sharded"]}


#: the logical axes the split plan splits over ``model``, by config: the
#: plan each takes on the 1 x 1 mesh, as on the 16 x 16 one
SPLIT_AXES = {"gemma2-27b": ["heads", "kv_heads", "mlp", "vocab"],
              "recurrentgemma-9b": ["heads", "mlp", "vocab"],
              "qwen2-moe-a2.7b": ["experts", "heads", "kv_heads", "mlp",
                                  "vocab"],
              "qwen2.5-3b": ["head_dim", "mlp", "vocab"],
              "qwen2-vl-2b": ["head_dim", "mlp", "vocab"]}


def check_plan(sh, cfg, mesh) -> list:
    """The axes of the split plan ``cfg`` takes on ``mesh``
    (``launch.shardings.model_split``), which must be SPLIT_AXES'."""
    split = sh.model_split(cfg, mesh)
    got = None if split is None else sorted(split)
    check(got == SPLIT_AXES[cfg.name],
          f"{cfg.name} on the mesh {dict(mesh.shape)} takes the plan {got}, "
          f"want the split plan over {SPLIT_AXES[cfg.name]}")
    return got


#: phase moe_mesh: qwen2-moe-a2.7b at full width cut to MOE_MESH_LAYERS
#: layers (1,832,675,328 parameters; two states side by side, 2 x 29 GB),
#: phase mesh's batch, microbatches and numbers of calls
MOE_MESH_LAYERS = 2


def phase_moe_mesh(torch) -> dict:
    """Expert routing over a sharded batch (ROADMAP.md item 8.6b) and the
    experts split over ``model`` (item 8.9c-i) on the card: a 1 x 1 (data,
    model) NCCL mesh, where ``model`` keeps extent 1 and qwen2-moe-a2.7b
    takes the split plan (asserted, with its axes); at full width,
    MOE_MESH_LAYERS layers, its state sharded; under deterministic
    algorithms the sharded step, whose MoE layers route each microbatch's
    rows through ``nn.moe.batch_shard`` (the per-(chunk, expert) counts
    summed over the data axis, the aux loss's probabilities through an
    all-reduce with a gradient) and combine their experts' outputs through
    the model-axis all-reduce, against the unsharded step from the same
    seed: 3 calls each, metrics and every parameter and moment value for
    value; K5 launches per replayed sharded step; p50 and peak memory side
    by side."""
    import torch.distributed

    from repro_torch.configs import registry as configs
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.nn import module, transformer

    t_phase = time.perf_counter()
    free_card(torch)
    full = configs.get_config(MOE_ARCH)
    cfg = full.replace(n_layers=MOE_MESH_LAYERS)
    mesh = single_device_mesh()
    split = check_plan(sh, cfg, mesh)
    trees: list = []
    saved = torch.are_deterministic_algorithms_enabled()
    try:
        trees += mesh_states(torch, cfg, mesh)
        state_bytes = torch.cuda.memory_allocated() // 2
        pipe = SyntheticTokenPipeline(DataConfig(
            seq_len=TR_SEQ, global_batch=TR_BATCH,
            vocab_size=cfg.vocab_size))
        torch.use_deterministic_algorithms(True)
        pair = _mesh_pair(torch, cfg, mesh, trees, [
            pipe.batch_at(i) for i in range(1 + MESH_COMPARED + MESH_TIMED)],
            False)
    finally:
        torch.use_deterministic_algorithms(saved)
        trees.clear()
        torch.distributed.destroy_process_group()
    want = {"flash_attention": 2 * cfg.n_layers * cfg.microbatches}
    check(pair["launches_per_step"] == want,
          f"moe_mesh: a replayed sharded step launched "
          f"{pair['launches_per_step']}, want {want} (per layer and "
          f"microbatch, the forward twice under remat) and nothing else")
    p50 = {k: statistics.median(v) for k, v in pair["step_ms"].items()}
    peak = {k: state_bytes + v for k, v in pair["peak_extra_bytes"].items()}
    free_card(torch)
    out = {"arch": MOE_ARCH, "layers": MOE_MESH_LAYERS,
           "split_axes": split,
           "reduced": f"n_layers {MOE_MESH_LAYERS} of {full.n_layers}: the "
                      f"sharded and the unsharded state side by side",
           "parameters": module.param_count(transformer.model_specs(cfg)),
           "mesh": {"data": 1, "model": 1},
           "backend": "nccl", "batch": TR_BATCH, "seq": TR_SEQ,
           "microbatches": cfg.microbatches,
           "token_chunks": cfg.moe_token_chunks, "deterministic": True,
           "state_bytes_each": state_bytes,
           **{k: v for k, v in pair.items() if k != "peak_extra_bytes"},
           "step_ms_p50": p50, "peak_device_bytes": peak,
           "seconds": time.perf_counter() - t_phase}
    emit({"phase": "moe_mesh", **out})
    return {"launches": {k: int(v) for k, v in
                         pair["launches_per_step"].items()}}


#: phase serve_mesh: the sharded prefill's first call, then SERVE_RUNS
#: replays beside as many unsharded calls; SERVE_TICKS replayed ticks of
#: each path from one zero cache; whisper-tiny's tick cache length;
#: qwen2-vl-2b's layers (its split prefill with patches)
SERVE_RUNS, SERVE_TICKS, SERVE_ED_LEN, SERVE_VLM_LAYERS = 5, 16, 64, 4


def _shard_params(torch, cfg, params, mesh):
    """``params`` as DTensors under ``model_param_shardings``, each local
    block the tensor itself on the 1 x 1 mesh (checked)."""
    from repro_torch.launch import shardings as sh
    from repro_torch.nn import module
    _, p_sh = sh.model_param_shardings(cfg, mesh)
    out = sh.shard_tree(params, p_sh)
    copied = sum(sh.local(a).data_ptr() != b.data_ptr() for a, b in zip(
        module.tree_leaves(out), module.tree_leaves(params)))
    check(copied == 0, f"shard_tree copied {copied} of {cfg.name}'s "
                       f"parameters on the 1 x 1 mesh")
    return out


def serve_prefill_pair(torch, cfg, params, sharded, batch: dict) -> dict:
    """The sharded prefill (``make_prefill`` on DTensor parameters: its
    first call, then SERVE_RUNS replays of its captured graph) against the
    unsharded one on the same tensors, logits value for value each call;
    the port's launches per replayed sharded call; p50 of each."""
    from repro_torch.kernels import registry
    from repro_torch.launch import steps
    from repro_torch.launch.shardings import local

    pre = steps.make_prefill(cfg)
    differ, ms = 0, {"sharded": [], "unsharded": []}
    for i in range(1 + SERVE_RUNS):
        if i == 1:
            registry.reset_launch_counts()
        t0 = time.perf_counter()
        got = pre(sharded, batch)
        torch.cuda.synchronize()
        if i:
            ms["sharded"].append((time.perf_counter() - t0) * 1e3)
        if i == 1:
            launches = {k: v for k, v in registry.launch_counts().items()
                        if v}
        t0 = time.perf_counter()
        want = pre(params, batch)
        torch.cuda.synchronize()
        if i:
            ms["unsharded"].append((time.perf_counter() - t0) * 1e3)
        differ += value_diff(torch, local(got), want)
        check(tuple(got.shape) == tuple(want.shape)
              and bool(torch.isfinite(want).all()),
              f"{cfg.name} sharded prefill: {tuple(got.shape)} against "
              f"{tuple(want.shape)}, or not finite")
    check(differ == 0, f"{cfg.name} sharded prefill differs from the "
                       f"unsharded one in {differ} logits")
    graphs = len(pre.runner().replay_launches())
    check(graphs == 1, f"{cfg.name} sharded prefill: {graphs} graphs")
    pre.runner().release()
    return {"batch": list(batch["tokens"].shape), "calls_compared":
            1 + SERVE_RUNS, "values_differing": differ,
            "launches_per_replay": launches,
            "ms_p50": {k: statistics.median(v) for k, v in ms.items()},
            "ms": ms, "unsharded_route": "eager (make_prefill unsharded)"}


def split_rows_pair(torch, cfg, sharded, b: int, s: int, seed: int) -> dict:
    """The attention's path where the split plan splits the head width
    (``nn.attention._attend_rows``) on the card, which the 1 x 1 mesh's
    layers do not take (one rank attends unsplit): inside the sharded
    prefill's own model shard, which splits ``head_dim`` one way, so its
    two exchanges are all-to-alls over the NCCL group of one.  q, k and v
    at ``cfg``'s prefill shape (``b`` x ``s`` positions, ``arange``; the
    activation dtype) drawn from ``seed``; the rows' RoPE or M-RoPE, K5 on
    (B x H, S, 1, D) with each query row's own KV row, the exchange back,
    against the unsplit path (``apply_rope``, then K5 on (B, S, H, D)
    over the KV heads) on the same tensors, value for value; its K5
    launches in one call."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import steps
    from repro_torch.nn import attention
    from repro_torch.nn import tensor_parallel as tp
    from repro_torch.nn.rope import apply_rope

    plan = steps.make_prefill(cfg).prepare(sharded)
    shard = plan.model
    check(shard is not None and shard.ways == 1
          and "head_dim" in shard.split,
          f"{cfg.name}: the prefill's model shard {shard} does not split "
          f"head_dim one way")
    h, n_kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = getattr(torch, cfg.activation_dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda").to(dt)
               for n in (h, n_kv, n_kv))
    pos = torch.arange(s, device="cuda").expand(b, s)
    rope_kw = dict(theta=cfg.rope_theta, fraction=cfg.rope_fraction,
                   mrope_sections=cfg.mrope_sections or None)
    kw = dict(causal=True, window=None, logit_cap=cfg.attn_softcap)
    with torch.no_grad():
        registry.reset_launch_counts()
        with tp.model_shard(shard):
            got = attention._attend_rows(q, k, v, pos, False, rope_kw, kw,
                                         None)
        torch.cuda.synchronize()
        launches = {n: c for n, c in registry.launch_counts().items() if c}
        qr, kr = apply_rope(q, k, pos, **rope_kw)
        want = flash_ops.attention(qr, kr, v, **kw)
    differ = value_diff(torch, got, want)
    err = float((got.float() - want.float()).abs().max())
    check(tuple(got.shape) == tuple(want.shape) and differ == 0
          and bool(torch.isfinite(got).all()),
          f"{cfg.name} attention over the head width's rows: "
          f"{tuple(got.shape)} against {tuple(want.shape)}, {differ} values "
          f"differing, max abs err {err}")
    check(launches == {"flash_attention": 1},
          f"{cfg.name} attention over the head width's rows launched "
          f"{launches}, want one K5 and nothing else")
    plan.release()
    return {"call": f"q ({b}, {s}, {h}, {d}), k/v ({b}, {s}, {n_kv}, {d}) "
                    f"{cfg.activation_dtype}, as ({b * h}, {s}, 1, {d}) rows",
            "model_shard": {"ways": shard.ways, "split": sorted(shard.split)},
            "values_differing": differ, "max_abs_err": err,
            "launches": launches}


def serve_tick_pair(torch, cfg, params, sharded, mesh, lanes: int,
                    max_len: int, seed: int, enc=None, kept=False) -> dict:
    """SERVE_TICKS ticks of the sharded serve step (DTensor parameters,
    its cache under ``cache_shardings``; the first call captures, the
    rest replay) and of the unsharded tick (``decode_step`` and the
    greedy token, replayed from a ``GraphRunner``) from two zero caches
    (``enc``, whisper's encoder output, in both): tokens and logits value
    for value each tick, then every cache leaf; the port's launches per
    replayed sharded tick; p50 of each.  ``kept``: the MoE's kept share of
    one eager tick of each on scratch caches, which must be equal."""
    from repro_torch.core.graphs import GraphRunner
    from repro_torch.kernels import registry
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps
    from repro_torch.models import encdec
    from repro_torch.nn import module, transformer

    mod = encdec if cfg.is_encoder_decoder else transformer

    def zero_cache():
        if enc is None:
            return mod.init_cache(cfg, lanes, max_len, device="cuda")
        return mod.init_cache(cfg, lanes, max_len, enc=enc.clone())
    c_sh = sh.cache_shardings(cfg, lanes, max_len, mesh)
    caches = [sh.shard_tree(zero_cache(), c_sh), zero_cache()]
    step = steps.make_serve_step(cfg)

    def tick_of(cache):
        def tick(f):
            logits, _ = mod.decode_step(cfg, params, f["tokens"], cache,
                                        f["pos"])
            return {"tokens": torch.argmax(logits, dim=-1).to(torch.int32),
                    "logits": logits}
        return tick
    run = GraphRunner(tick_of(caches[1]), torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    differ = {"tokens": 0, "logits": 0}
    ms: dict = {"sharded": [], "unsharded": []}
    stride = (max_len - SERVE_TICKS) // lanes
    for t in range(SERVE_TICKS):
        feeds = {"tokens": torch.randint(1, cfg.vocab_size, (lanes, 1),
                                         generator=gen, device="cuda"),
                 "pos": torch.arange(lanes, device="cuda") * stride + t}
        if t == SERVE_TICKS - 1:
            registry.reset_launch_counts()
        t0 = time.perf_counter()
        tok, _ = step(sharded, caches[0], feeds)
        torch.cuda.synchronize()
        ms["sharded"].append((time.perf_counter() - t0) * 1e3)
        if t == SERVE_TICKS - 1:
            launches = {k: v for k, v in registry.launch_counts().items()
                        if v}
        t0 = time.perf_counter()
        want = run(feeds)
        torch.cuda.synchronize()
        ms["unsharded"].append((time.perf_counter() - t0) * 1e3)
        differ["tokens"] += value_diff(torch, sh.local(tok), want["tokens"])
        differ["logits"] += value_diff(torch, sh.local(step.logits()),
                                       want["logits"])
    names = [n for n, _ in _named_leaves(caches[1])]
    cache_differ = {n: value_diff(torch, sh.local(a), b) for (n, a), (_, b)
                    in zip(_named_leaves(caches[0]), _named_leaves(caches[1]))}
    check(differ == {"tokens": 0, "logits": 0}
          and not any(cache_differ.values()),
          f"{cfg.name} sharded ticks differ from the unsharded ones in "
          f"{differ} values and the cache leaves in {cache_differ}")
    graphs = len(step.runner().replay_launches())
    check(graphs == 1, f"{cfg.name} sharded tick: {graphs} graphs")
    step.runner().release()
    run.release()
    out = {"lanes": lanes, "max_len": max_len, "ticks": SERVE_TICKS,
           "values_differing": differ, "cache_leaves": names,
           "cache_values_differing": sum(cache_differ.values()),
           "launches_per_replay": launches,
           "ms_p50": {k: statistics.median(v[1:]) for k, v in ms.items()},
           "unsharded_route": "decode_step replayed from a GraphRunner"}
    if kept:
        shares = {}
        for label, p in (("sharded", sharded), ("unsharded", params)):
            scratch = zero_cache()
            if label == "sharded":
                scratch = sh.shard_tree(scratch, c_sh)
            with KeptShare() as share:
                step.eager(p, scratch, feeds)
            shares[label] = share.share()
        check(shares["sharded"] == shares["unsharded"],
              f"{cfg.name} tick kept {shares} of its assignments")
        out["routed_kept_share"] = shares
    del caches
    return out


def serve_eager_peaks(torch, cfg, sharded, mesh, lanes: int,
                      max_len: int, batch: dict) -> dict:
    """One eager call each of the sharded prefill and serve step (a fresh
    zero cache), the peak device memory of each after
    ``reset_peak_memory_stats`` with nothing else of this phase live, and
    the port's launches: what phase dryrun's trace predicts."""
    from repro_torch.kernels import registry
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps
    from repro_torch.nn import transformer

    out = {}
    for kind in ("prefill", "decode"):
        free_card(torch)
        if kind == "prefill":
            args = (sharded, batch)
            call = steps.make_prefill(cfg).eager
        else:
            cache = sh.shard_tree(transformer.init_cache(
                cfg, lanes, max_len, device="cuda"), sh.cache_shardings(
                cfg, lanes, max_len, mesh))
            args = (sharded, cache, {
                "tokens": torch.ones(lanes, 1, dtype=torch.int64,
                                     device="cuda"),
                "pos": torch.arange(lanes, device="cuda")})
            call = steps.make_serve_step(cfg).eager
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        registry.reset_launch_counts()
        call(*args)
        torch.cuda.synchronize()
        out[kind] = {"peak_bytes": torch.cuda.max_memory_allocated(),
                     "launches": {k: v for k, v in
                                  registry.launch_counts().items() if v}}
        del args
    return out


def phase_serve_mesh(torch) -> dict:
    """Data-parallel prefill and decode on a mesh (ROADMAP.md item 8.8) on
    the card: a 1 x 1 (data, model) NCCL mesh, under deterministic
    algorithms, the sharded tensors the unsharded ones (``shard_tree``
    copies nothing).  Qwen2.5-3B at full width and depth: the sharded
    prefill at LM_PREFILL_B x LM_PREFILL_S against ``lm.prefill``, 36 K5
    launches per replay and nothing else; LM_LANES-lane ticks of the
    sharded serve step against the unsharded tick; then one eager call of
    each, their peaks for phase dryrun; all of it through the split plan
    over the head width (asserted, with its axes).  qwen2-vl-2b cut to
    SERVE_VLM_LAYERS layers: its split prefill of VLM_PREFILL_B x (1,024
    patches + VLM_PREFILL_S tokens) against ``lm.prefill``, one K5
    launch a layer.  For both Qwen models the attention's path over the
    head width's rows, which one rank does not take, called alone in the
    prefill's model shard at their prefill shapes (:func:`split_rows_pair`).  qwen2-moe-a2.7b cut to
    MOE_MESH_LAYERS layers: its tick through the split plan (asserted, with
    its axes: the experts' combine summed over ``model``), the counts
    exchange inside the graph, its kept share the unsharded tick's.
    recurrentgemma-9b cut to one superblock: its tick through the split
    plan (asserted: the RG-LRU's channels and heads split; the ``h``,
    ``conv``, ``k``, ``v`` and ``kpos`` leaves).  whisper-tiny: the prefill
    (encode and decode) and its tick."""
    import torch.distributed

    from repro_torch.configs import registry as configs
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.models import encdec
    from repro_torch.nn import module, transformer

    t_phase = time.perf_counter()
    free_card(torch)
    mesh = single_device_mesh()
    saved = torch.are_deterministic_algorithms_enabled()
    out: dict = {"mesh": dict(mesh.shape), "backend": "nccl",
                 "deterministic": True}
    try:
        torch.use_deterministic_algorithms(True)
        cfg = configs.get_config(LM_ARCH)
        lm_split = check_plan(sh, cfg, mesh)
        params, line = draw(torch, cfg, LM_ARCH, LM_PARAMS)
        sharded = _shard_params(torch, cfg, params, mesh)
        gen = torch.Generator(device="cuda").manual_seed(41)
        batch = {"tokens": torch.randint(
            0, cfg.vocab_size, (LM_PREFILL_B, LM_PREFILL_S), generator=gen,
            device="cuda")}
        pre = serve_prefill_pair(torch, cfg, params, sharded, batch)
        want = {"flash_attention": cfg.n_layers}
        check(pre["launches_per_replay"] == want,
              f"sharded Qwen2.5-3B prefill launched "
              f"{pre['launches_per_replay']} per replay, want {want} and "
              f"nothing else")
        rows = split_rows_pair(torch, cfg, sharded, LM_PREFILL_B,
                               LM_PREFILL_S, 48)
        tick = serve_tick_pair(torch, cfg, params, sharded, mesh, LM_LANES,
                               LM_MAX_LEN, 42)
        peaks = serve_eager_peaks(torch, cfg, sharded, mesh, LM_LANES,
                                  LM_MAX_LEN, batch)
        out["lm"] = {**line, "split_axes": lm_split, "prefill": pre,
                     "split_rows": rows, "tick": tick, "eager": peaks}
        del params, sharded, batch
        free_card(torch)

        t_vlm = time.perf_counter()
        cfg = configs.get_config(VLM_ARCH).replace(n_layers=SERVE_VLM_LAYERS)
        params, line = draw(torch, cfg, VLM_ARCH, module.param_count(
            transformer.model_specs(cfg)))
        sharded = _shard_params(torch, cfg, params, mesh)
        gen = torch.Generator(device="cuda").manual_seed(47)
        batch = {"tokens": torch.randint(
            0, cfg.vocab_size, (VLM_PREFILL_B, VLM_PREFILL_S), generator=gen,
            device="cuda"), "patches": torch.randn(
            VLM_PREFILL_B, cfg.n_patches, cfg.d_model, generator=gen,
            device="cuda")}
        pre = serve_prefill_pair(torch, cfg, params, sharded, batch)
        want = {"flash_attention": cfg.n_layers}
        check(pre["launches_per_replay"] == want,
              f"sharded qwen2-vl-2b prefill launched "
              f"{pre['launches_per_replay']} per replay, want {want}")
        rows = split_rows_pair(torch, cfg, sharded, VLM_PREFILL_B,
                               cfg.n_patches + VLM_PREFILL_S, 49)
        out["vlm"] = {**line, "split_axes": check_plan(sh, cfg, mesh),
                      "reduced": f"n_layers {SERVE_VLM_LAYERS} of 28",
                      "n_patches": cfg.n_patches, "prefill": pre,
                      "split_rows": rows,
                      "seconds": time.perf_counter() - t_vlm}
        del params, sharded, batch
        free_card(torch)

        cfg = configs.get_config(MOE_ARCH).replace(n_layers=MOE_MESH_LAYERS)
        params, line = draw(torch, cfg, MOE_ARCH, module.param_count(
            transformer.model_specs(cfg)))
        sharded = _shard_params(torch, cfg, params, mesh)
        out["moe"] = {**line, "split_axes": check_plan(sh, cfg, mesh),
                      "tick": serve_tick_pair(
                          torch, cfg, params, sharded, mesh, LM_LANES,
                          LM_MAX_LEN, 43, kept=True)}
        del params, sharded
        free_card(torch)

        full = configs.get_config(RG_ARCH)
        cfg = full.replace(n_layers=len(full.attn_pattern))
        params, line = draw(torch, cfg, RG_ARCH, module.param_count(
            transformer.model_specs(cfg)))
        sharded = _shard_params(torch, cfg, params, mesh)
        out["recurrent"] = {**line, "split_axes": check_plan(sh, cfg, mesh),
                            "tick": serve_tick_pair(
                                torch, cfg, params, sharded, mesh, LM_LANES,
                                LM_MAX_LEN, 44)}
        del params, sharded
        free_card(torch)

        cfg = configs.get_config(ED_ARCH)
        params = module.init_tree(encdec.model_specs(cfg), torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        sharded = _shard_params(torch, cfg, params, mesh)
        gen = torch.Generator(device="cuda").manual_seed(45)
        frames = torch.randn(ED_B, cfg.encoder_len, cfg.d_model,
                             generator=gen, device="cuda")
        batch = {"frames": frames, "tokens": torch.randint(
            0, cfg.vocab_size, (ED_B, ED_PROMPT), generator=gen,
            device="cuda")}
        pre = serve_prefill_pair(torch, cfg, params, sharded, batch)
        want = {"flash_attention": cfg.n_encoder_layers + cfg.n_layers}
        check(pre["launches_per_replay"] == want,
              f"sharded whisper-tiny prefill launched "
              f"{pre['launches_per_replay']} per replay, want {want}")
        enc = encdec.encode(cfg, params, frames)
        out["encdec"] = {"arch": ED_ARCH, "prefill": pre,
                         "tick": serve_tick_pair(
                             torch, cfg, params, sharded, mesh, ED_B,
                             SERVE_ED_LEN, 46, enc=enc)}
        del params, sharded, batch, frames, enc
    finally:
        torch.use_deterministic_algorithms(saved)
        torch.distributed.destroy_process_group()
    free_card(torch)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "serve_mesh", **out})
    return {"lm_prefill_launches": out["lm"]["prefill"]["launches_per_replay"],
            "lm_tick_launches": out["lm"]["tick"]["launches_per_replay"],
            "whisper_prefill_launches":
                out["encdec"]["prefill"]["launches_per_replay"],
            "vlm_prefill_launches":
                out["vlm"]["prefill"]["launches_per_replay"],
            "split_rows_launches": out["lm"]["split_rows"]["launches"],
            "vlm_split_rows_launches": out["vlm"]["split_rows"]["launches"],
            "lm_prefill_ms_p50": out["lm"]["prefill"]["ms_p50"],
            "eager": out["lm"]["eager"]}


#: phase tp: gemma2-27b at full width, whose default binding rules split
#: its compute over model (the split plan); the train step cut to one
#: superblock (a local and a global layer) in 4 microbatches, the prefill
#: to two superblocks; calls of each train step (the first eager, then
#: replays).  recurrentgemma-9b's train step cut to one superblock (two
#: RG-LRU layers and a local one) in as many microbatches
TP_ARCH, TP_TRAIN_LAYERS, TP_PREFILL_LAYERS, TP_CALLS = "gemma2-27b", 2, 4, 3
TP_MICRO = 4


def _tp_train(torch, cfg, mesh, batches, sharded: bool) -> dict:
    """TP_CALLS steps of ``cfg`` from seed 0, its parameters and state
    sharded on ``mesh`` where ``sharded`` (``shard_tree`` copies nothing
    on the 1 x 1 mesh): the metrics, the replays' times, the K5 launches
    of the first replay, the peak device memory above what lay on the
    card when it started, and the final parameters and moments leaf by
    leaf, the live tensors on the card but, where ``sharded``, the second
    moments copied to the host (the other run's peak leaves room for the
    rest: 51.3 + 18.5 GB at gemma2-27b's 2 layers)."""
    from repro_torch.configs import registry as configs
    from repro_torch.kernels import registry
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps
    from repro_torch.nn import module, transformer
    from repro_torch.optim import adamw

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    p = module.init_tree(transformer.model_specs(cfg), torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    st = adamw.init_state(p)
    if sharded:
        rules = sh.rules_for(cfg)
        per = TR_BATCH // cfg.microbatches
        train = configs.input_axes(cfg, configs.get_shape("train_4k"))
        micro_sh = {k: sh.sharding_for((cfg.microbatches, per, TR_SEQ),
                                       (None,) + ax, mesh, rules)
                    for k, ax in train.items()}
        abstract, p_sh = sh.model_param_shardings(cfg, mesh)
        o_sh = sh.state_shardings(
            abstract, module.axes_tree(transformer.model_specs(cfg)), mesh,
            rules)
        p, st = sh.shard_tree(p, p_sh), sh.shard_tree(st, o_sh)
        step = steps.make_train_step(cfg, microbatch_shardings=micro_sh,
                                     grad_shardings=o_sh["mu"])
    else:
        step = steps.make_train_step(cfg)
    out: dict = {"metrics": [], "step_ms": []}
    for i, b in enumerate(batches):
        if i == 1:
            registry.reset_launch_counts()
        t0 = time.perf_counter()
        _, _, m = step(p, st, b)
        torch.cuda.synchronize()
        if i:
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if i == 1:
            out["launches"] = {k: v for k, v in
                               registry.launch_counts().items() if v}
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    out["replayed"] = step.runner() is not None
    leaves = [sh.local(t) for t in module.tree_leaves((p, st["mu"],
                                                       st["nu"]))]
    kept = 2 * len(leaves) // 3 if sharded else len(leaves)
    out["leaves"] = leaves[:kept] + [t.cpu() for t in leaves[kept:]]
    step.runner().release()
    del p, st, step, leaves
    free_card(torch)
    return out


def tp_train_pair(torch, arch: str, layers: int, mesh) -> dict:
    """``arch``'s split-plan train step (its plan asserted) against its
    unsharded step, ``layers`` layers at full width, TR_BATCH x TR_SEQ in
    TP_MICRO microbatches, one run after the other from one seed (two
    states do not fit): metrics and every parameter and moment value for
    value; K5 launches per replayed step, twice per attending layer and
    microbatch (the forward and its recompute under remat); peaks within
    MESH_PEAK_RATIO of each other; the p50 of each, printed."""
    from repro_torch.configs import registry as configs
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch import shardings as sh
    from repro_torch.nn import module, transformer

    t0 = time.perf_counter()
    full = configs.get_config(arch)
    cfg = full.replace(n_layers=layers, microbatches=TP_MICRO)
    split = check_plan(sh, full, mesh)
    pipe = SyntheticTokenPipeline(DataConfig(
        seq_len=TR_SEQ, global_batch=TR_BATCH, vocab_size=cfg.vocab_size))
    batches = [pipe.batch_at(i) for i in range(TP_CALLS)]
    runs = {label: _tp_train(torch, cfg, mesh, batches, label == "sharded")
            for label in ("sharded", "unsharded")}
    differ = 0
    for a, b in zip(runs["sharded"].pop("leaves"),
                    runs["unsharded"].pop("leaves")):
        a = a.to(b.device)
        differ += 0 if torch.equal(a, b) else value_diff(torch, a, b)
        del a, b
    free_card(torch)
    check(runs["sharded"]["metrics"] == runs["unsharded"]["metrics"],
          f"tp {arch}: the sharded step's metrics "
          f"{runs['sharded']['metrics']} against the unsharded step's "
          f"{runs['unsharded']['metrics']}")
    check(differ == 0, f"tp {arch}: the sharded step's parameters and "
                       f"moments differ from the unsharded step's in "
                       f"{differ} values")
    want = {"flash_attention": 2 * attention_layers(cfg) * cfg.microbatches}
    for label, r in runs.items():
        check(r["replayed"] and r["launches"] == want,
              f"tp {arch} {label}: a replayed step launched "
              f"{r['launches']}, want {want} (per attending layer and "
              f"microbatch, the forward twice under remat)")
    ratio = runs["sharded"]["peak_bytes"] / runs["unsharded"]["peak_bytes"]
    check(ratio <= MESH_PEAK_RATIO,
          f"tp {arch}: the sharded step's peak is {ratio:.4f} of the "
          f"unsharded step's")
    p50 = {k: statistics.median(v["step_ms"]) for k, v in runs.items()}
    print(f"tp {arch}: p50 split {p50['sharded']:.2f} ms, unsharded "
          f"{p50['unsharded']:.2f} ms, peak ratio {ratio:.4f}", flush=True)
    n = module.param_count(transformer.model_specs(cfg))
    return {"arch": arch, "split_axes": split, "layers": cfg.n_layers,
            "batch": TR_BATCH, "seq": TR_SEQ,
            "microbatches": cfg.microbatches, "calls": TP_CALLS,
            "parameters": n,
            "reduced": f"n_layers {cfg.n_layers} of {full.n_layers}: one "
                       f"state of {cfg.n_layers} layers at full width is "
                       f"{16 * n / 1e9:.1f} GB",
            "values_differing": differ, "runs": runs, "step_ms_p50": p50,
            "p50_ratio": p50["sharded"] / p50["unsharded"],
            "peak_ratio": ratio, "seconds": time.perf_counter() - t0}


def phase_tp(torch) -> dict:
    """Tensor parallelism over ``model`` (ROADMAP.md items 8.9a, 8.9d) on
    the card: a 1 x 1 (data, model) NCCL mesh, where ``prune_spec`` keeps
    ``model`` at extent 1 and a config takes the split plan it takes on
    16 x 16, under deterministic algorithms.  The train step
    (:func:`tp_train_pair`: the first call, then replays of its captured
    graph, the model-group all-reduces inside) of gemma2-27b at
    TP_TRAIN_LAYERS layers and of recurrentgemma-9b at one superblock
    (its RG-LRU layers' channels and heads split, its local layer's one KV
    head whole), each against the unsharded step, value for value.  Then
    gemma2-27b's sharded prefill at TP_PREFILL_LAYERS layers, LM_PREFILL_B
    x LM_PREFILL_S, against the unsharded one, and SERVE_TICKS replayed
    LM_LANES-lane ticks against the unsharded ticks: tokens, logits and
    every cache leaf value for value."""
    import torch.distributed

    from repro_torch.configs import registry as configs
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.nn import module, transformer

    t_phase = time.perf_counter()
    free_card(torch)
    full = configs.get_config(TP_ARCH)
    mesh = single_device_mesh()
    saved = torch.are_deterministic_algorithms_enabled()
    out: dict = {"arch": TP_ARCH, "mesh": dict(mesh.shape),
                 "backend": "nccl", "deterministic": True}
    try:
        torch.use_deterministic_algorithms(True)
        out["train"] = tp_train_pair(torch, TP_ARCH, TP_TRAIN_LAYERS, mesh)
        out["split_axes"] = out["train"]["split_axes"]
        rg = configs.get_config(RG_ARCH)
        out["recurrent_train"] = tp_train_pair(
            torch, RG_ARCH, len(rg.attn_pattern), mesh)

        t0 = time.perf_counter()
        cfg = full.replace(n_layers=TP_PREFILL_LAYERS)
        params, line = draw(torch, cfg, TP_ARCH, module.param_count(
            transformer.model_specs(cfg)))
        sharded = _shard_params(torch, cfg, params, mesh)
        gen = torch.Generator(device="cuda").manual_seed(47)
        batch = {"tokens": torch.randint(
            0, cfg.vocab_size, (LM_PREFILL_B, LM_PREFILL_S), generator=gen,
            device="cuda")}
        pre = serve_prefill_pair(torch, cfg, params, sharded, batch)
        want = {"flash_attention": cfg.n_layers}
        check(pre["launches_per_replay"] == want,
              f"tp: the sharded prefill launched "
              f"{pre['launches_per_replay']} per replay, want {want}")
        tick = serve_tick_pair(torch, cfg, params, sharded, mesh, LM_LANES,
                               LM_MAX_LEN, 48)
        out["serve"] = {**line, "prefill": pre, "tick": tick,
                        "seconds": time.perf_counter() - t0}
        del params, sharded, batch
    finally:
        torch.use_deterministic_algorithms(saved)
        torch.distributed.destroy_process_group()
    free_card(torch)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "tp", **out})
    return {"train_launches": out["train"]["runs"]["sharded"]["launches"],
            "recurrent_train_launches":
                out["recurrent_train"]["runs"]["sharded"]["launches"],
            "prefill_launches": pre["launches_per_replay"]}


#: phase dryrun: the predicted peak's bar against the card's eager step
DRY_PEAK_RTOL = 0.15
#: the reference test's tiny cell: tiny gemma2-27b in 2 microbatches,
#: batch 8 x 32, on a (pod 2, data 2, model 2) fake world
DRY_TINY = ("gemma2-27b", {"pod": 2, "data": 2, "model": 2}, 8, 32)
#: the split plan's serving cells on the 16 x 16 fake world, which must
#: fit in 80 GB with nothing gathered
DRY_TP_CELLS = (("gemma2-27b", "prefill_32k"), ("gemma2-27b", "decode_32k"),
                ("stablelm-3b", "prefill_32k"), ("stablelm-3b", "decode_32k"),
                ("recurrentgemma-9b", "decode_32k"),
                ("qwen2-moe-a2.7b", "decode_32k"),
                ("qwen2-7b", "prefill_32k"), ("qwen2-7b", "decode_32k"),
                ("qwen2.5-3b", "decode_32k"), ("qwen2-vl-2b", "decode_32k"))
#: gemma2-27b's prefill_32k FLOPs per device under the gather plan, where
#: every rank of a model group of 16 repeated the group's compute (the
#: dry-run's record on an H100 80GB HBM3 at 700 W, PERF.md section 6); the
#: split plan's are held within 10% of a 16th
DRY_GEMMA_PREFILL_GATHER_FLOPS = 5032.5e12
#: qwen2-7b's prefill_32k FLOPs per device where the split plan splits its
#: head width, reckoned from the gather plan's 1,717.3e12 (the same
#: record): K5's formula counts 4 B H S^2 D a layer, 862.0e12 over 28
#: layers at B 2, H 28, S 32,768, D 128; the linear rest, 855.3e12, split
#: 16 ways; the attention on the heaviest rank's 4 of the 56 (batch x
#: head) rows (rank 0, the one traced).  Held to at most 1.1 x
DRY_QWEN7_PREFILL_ROWS_FLOPS = (1717.3e12 - 862.0e12) / 16 + 862.0e12 * 4 / 56
#: the longest wait for one 16 x 16 cell's CLI process (each traced in
#: 3-7 s alone on the card's host)
DRY_CELL_TIMEOUT_S = 300


def phase_dryrun(torch, mesh_out: dict, serve_out: dict) -> dict:
    """The dry-run (ROADMAP.md item 8.7) on the card's machine: phase
    mesh's own step (Qwen2.5-3B at full width, MESH_LAYERS layers, TR_BATCH
    x TR_SEQ in 4 microbatches) traced on fake CUDA tensors over a 1 x 1
    fake world (the kernels reached as their custom ops' fake
    implementations), its predicted peak, FLOPs and K5 launches beside the
    card's eager step run once on a 1 x 1 NCCL mesh (peak memory after
    ``reset_peak_memory_stats``, launches) and phase mesh's launches per
    step; the rate the predicted FLOPs imply at phase mesh's p50; the
    reference test's tiny 2 x 2 x 2 cell; Qwen2.5-3B's sharded prefill and
    serve step at full depth (phase serve_mesh's shapes) traced on the
    1 x 1 fake world, their predicted peaks and launches beside phase
    serve_mesh's eager calls, all three through the split plan over the
    head width (asserted); the split plan's serving cells on 16 x 16
    (DRY_TP_CELLS), each fitting with nothing gathered, gemma2-27b's
    prefill FLOPs within 10% of a 16th of the gather plan's and qwen2-7b's
    at most 1.1 x the split by rows (DRY_QWEN7_PREFILL_ROWS_FLOPS), its
    exchanges among the model axis's collectives."""
    import shutil
    import tempfile

    import torch.distributed

    from repro_torch.configs import registry as configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.kernels import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.launch.roofline import PEAK_BF16
    from repro_torch.nn import module, transformer

    t_phase = time.perf_counter()
    free_card(torch)
    cfg = configs.get_config(LM_ARCH).replace(n_layers=MESH_LAYERS)
    out_dir = Path(tempfile.mkdtemp(prefix=".smoke_dryrun_", dir=ROOT))
    # the 16 x 16 cells, one CLI process each, beside the rest
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
         "--shape", shp, "--mesh", "single", "--out", str(out_dir)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, PYTHONPATH=str(SRC),
                            OMP_NUM_THREADS="1"))
        for a, shp in DRY_TP_CELLS]
    try:
        launches0 = registry.launch_counts()
        rec = dryrun.run_cell(
            LM_ARCH, "smoke_train", {"data": 1, "model": 1}, out_dir,
            cfg=cfg, shape=ShapeConfig("smoke_train", TR_SEQ, TR_BATCH,
                                       "train"))
        serve = {kind: dryrun.run_cell(
            LM_ARCH, f"smoke_{kind}", {"data": 1, "model": 1}, out_dir,
            cfg=configs.get_config(LM_ARCH), shape=ShapeConfig(
                f"smoke_{kind}", s, b, kind))
            for kind, b, s in (("prefill", LM_PREFILL_B, LM_PREFILL_S),
                               ("decode", LM_LANES, LM_MAX_LEN))}
        arch, world, b, s = DRY_TINY
        tiny = dryrun.run_cell(
            arch, "tiny_train", world, out_dir,
            cfg=configs.get_tiny(arch).replace(microbatches=2),
            shape=ShapeConfig("tiny_train", s, b, "train"))
        fake_launched = registry.launch_counts() != launches0
        tp_cells = []
        for (a, shp), proc in zip(DRY_TP_CELLS, procs):
            log, _ = proc.communicate(timeout=DRY_CELL_TIMEOUT_S)
            path = out_dir / f"{a}__{shp}__single.json"
            check(path.exists(), f"dry-run CLI of {a} {shp} exited "
                                 f"{proc.returncode} with no record: "
                                 f"{log[-3000:]}")
            tp_cells.append(json.loads(path.read_text()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    for r in (rec, tiny, *serve.values(), *tp_cells):
        check(r.get("status") == "ok",
              f"dry-run of {r['arch']} on {r['mesh']}: "
              f"{r.get('error')}\n{r.get('traceback', '')[-3000:]}")
    check(not fake_launched, "the dry-run's fake kernels moved the launch "
                             "counters")
    plans = [r["model_split"] for r in (rec, *serve.values())]
    check(plans == ["compute"] * 3, f"{LM_ARCH}'s traced step, prefill and "
                                    f"tick took the plans {plans}, want the "
                                    f"split plan (compute)")
    for r in tp_cells:
        check(r["model_split"] == "compute" and r["fits"]
              and r["gather_bytes_per_device"] == 0,
              f"dry-run of {r['arch']} {r['shape']} on 16 x 16: plan "
              f"{r['model_split']}, peak {r['memory']['peak_bytes']} B, "
              f"gather {r['gather_bytes_per_device']} B")
    want_flops = DRY_GEMMA_PREFILL_GATHER_FLOPS / 16
    got_flops = tp_cells[0]["flops_per_device"]
    check(abs(got_flops - want_flops) <= 0.1 * want_flops,
          f"gemma2-27b prefill_32k traced {got_flops} FLOP per device, want "
          f"{want_flops} within 10%")
    qwen7 = next(r for r in tp_cells
                 if (r["arch"], r["shape"]) == ("qwen2-7b", "prefill_32k"))
    check(qwen7["flops_per_device"] <= 1.1 * DRY_QWEN7_PREFILL_ROWS_FLOPS
          and qwen7["collectives_by_axis"]["model"].get("all-to-all", 0) > 0,
          f"qwen2-7b prefill_32k traced {qwen7['flops_per_device']} FLOP "
          f"per device (want at most 1.1 x {DRY_QWEN7_PREFILL_ROWS_FLOPS}) "
          f"and {qwen7['collectives_by_axis']} over the axes")
    # the card's eager step: the same step on the state it traced
    mesh = single_device_mesh()
    try:
        (p, st), = mesh_states(torch, cfg, mesh, sharded_only=True)
        rules = sh.rules_for(cfg)
        train = configs.input_axes(cfg, configs.get_shape("train_4k"))
        micro_sh = {k: sh.sharding_for(
            (cfg.microbatches, TR_BATCH // cfg.microbatches, TR_SEQ),
            (None,) + ax, mesh, rules) for k, ax in train.items()}
        o_sh = sh.state_shardings(
            sh.model_param_shardings(cfg, mesh)[0],
            module.axes_tree(transformer.model_specs(cfg)), mesh, rules)
        step = steps.make_train_step(cfg, microbatch_shardings=micro_sh,
                                     grad_shardings=o_sh["mu"])
        batch = SyntheticTokenPipeline(DataConfig(
            seq_len=TR_SEQ, global_batch=TR_BATCH,
            vocab_size=cfg.vocab_size)).batch_at(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        _, _, m = step.eager(p, st, batch)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        eager_launches = {k: v for k, v in registry.launch_counts().items()
                          if v}
        del p, st, step
    finally:
        torch.distributed.destroy_process_group()
    free_card(torch)
    predicted = rec["memory"]["peak_bytes"]
    peak_err = abs(predicted - peak) / peak
    check(peak_err <= DRY_PEAK_RTOL,
          f"dry-run peak {predicted} B against the card's eager step's "
          f"{peak} B: {peak_err:.3f} > {DRY_PEAK_RTOL}")
    k5 = rec["kernel_launches"].get("flash_attention", 0)
    check(k5 == mesh_out["launches"].get("flash_attention") == eager_launches
          .get("flash_attention") and rec["kernel_launches"] == eager_launches,
          f"dry-run launches {rec['kernel_launches']}, the eager step's "
          f"{eager_launches}, phase mesh's {mesh_out['launches']}")
    served = {}
    for kind, r in serve.items():
        eager = serve_out["eager"][kind]
        err = abs(r["memory"]["peak_bytes"] - eager["peak_bytes"]) / \
            eager["peak_bytes"]
        check(err <= DRY_PEAK_RTOL,
              f"dry-run {kind} peak {r['memory']['peak_bytes']} B against "
              f"the card's eager call's {eager['peak_bytes']} B: {err:.3f} "
              f"> {DRY_PEAK_RTOL}")
        check(r["kernel_launches"] == eager["launches"],
              f"dry-run {kind} launches {r['kernel_launches']}, the eager "
              f"call's {eager['launches']}")
        served[kind] = {
            "trace_s": r["trace_s"], "n_ops": r["n_ops"],
            "predicted_peak_bytes": r["memory"]["peak_bytes"],
            "eager_peak_bytes": eager["peak_bytes"], "peak_rel_err": err,
            "flops": r["flops_per_device"],
            "kernel_launches": r["kernel_launches"],
            "eager_launches": eager["launches"],
            "cache_bytes_per_device": r["cache_bytes_per_device"],
            "gather_bytes_per_device": r["gather_bytes_per_device"]}
    p50 = mesh_out["step_ms_p50"]
    rate = rec["flops_per_device"] / (p50 / 1e3)
    out = {"arch": LM_ARCH, "layers": MESH_LAYERS, "batch": TR_BATCH,
           "seq": TR_SEQ, "microbatches": rec["microbatches"],
           "fake_world": rec["mesh"], "trace_s": rec["trace_s"],
           "n_ops": rec["n_ops"],
           "predicted": {"peak_bytes": predicted,
                         "flops_per_step": rec["flops_per_device"],
                         "kernel_launches": rec["kernel_launches"],
                         "argument_bytes": rec["memory"]["argument_bytes"]},
           "card": {"eager_peak_bytes": peak, "eager_s": eager_s,
                    "eager_loss": float(m["loss"]),
                    "eager_launches": eager_launches,
                    "mesh_launches_per_step": mesh_out["launches"],
                    "mesh_step_ms_p50": p50},
           "peak_rel_err": peak_err, "peak_rtol": DRY_PEAK_RTOL,
           "implied_tflops_at_p50": rate / 1e12,
           "implied_share_of_bf16_peak": rate / PEAK_BF16,
           "tiny_cell": {k: tiny[k] for k in (
               "arch", "mesh", "status", "trace_s", "flops_per_device",
               "params_bytes_per_device", "collectives_by_kind",
               "n_collective_ops", "kernel_launches", "memory")},
           "serve": {"arch": LM_ARCH, "layers": configs.get_config(
               LM_ARCH).n_layers, **served},
           "split_plan_cells": [{k: r.get(k) for k in (
               "arch", "shape", "mesh", "model_split", "trace_s", "fits",
               "flops_per_device", "params_bytes_per_device",
               "cache_bytes_per_device", "cache_bytes_per_device_rules",
               "gather_bytes_per_device", "collectives_by_kind",
               "collectives_by_axis", "collective_bytes_by_link",
               "traced_rank", "kernel_launches", "memory")}
               for r in tp_cells],
           "qwen2_7b_prefill_rows_flops": DRY_QWEN7_PREFILL_ROWS_FLOPS,
           "seconds": time.perf_counter() - t_phase}
    emit({"phase": "dryrun", **out})
    return out


KERNEL_META = {
    "conv2d_vmem": ("src/repro_torch/csrc/conv2d_vmem.cu",
                    "src/repro/kernels/conv2d_vmem/conv2d_vmem.py:82"),
    "dfg_segment": ("src/repro_torch/csrc/dfg_segment.cu",
                    "src/repro/core/emit_pallas.py:269"),
    "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:93"),
    "fused_softmax": ("src/repro_torch/csrc/fused_softmax.cu",
                      "src/repro/kernels/fused_softmax/fused_softmax.py:52"),
    "smallfloat_matmul": (
        "src/repro_torch/csrc/smallfloat_matmul.cu",
        "src/repro/kernels/smallfloat_matmul/smallfloat_matmul.py:111"),
}


#: how each kernel is held against its plain version, where not at
#: KERNEL_RTOL / KERNEL_ATOL
TOLERANCE = {"dfg_segment": "value for value",
             "flash_attention": {"rtol": FLASH_RTOL, "atol": FLASH_ATOL}}
#: why a kernel's row has no library time
NO_LIBRARY = {"dfg_segment": "no single PyTorch call computes a DFG "
                             "segment (a levelised gather/compute/scatter "
                             "over an index table)"}


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: FAIL: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # deterministic cuBLAS for phase train's restart check: the workspace
    # is sized when cuBLAS is first used (32 MiB, Hopper's default size)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        dev = phase_device(torch)
        phase_build()
        phase_quantizer(torch)
        design = phase_compile(torch)
        kern = phase_kernels(torch, design)
        sl = phase_slice(torch, design)
        phase_graphs(torch, design)
        phase_engine(torch, design)
        phase_trigger(torch, design)
        blk = phase_transformer(torch)
        tn = phase_tune(torch, design)
        tr = phase_train(torch)
        lmp = phase_lm(torch)
        moe = phase_moe(torch)
        rgr = phase_recurrent(torch)
        xl = phase_xlstm(torch)
        ed = phase_encdec(torch)
        vlm = phase_vlm(torch)
        trl = phase_train_lm(torch)
        msh = phase_mesh(torch)
        mmsh = phase_moe_mesh(torch)
        smsh = phase_serve_mesh(torch)
        tpr = phase_tp(torch)
        phase_dryrun(torch, msh, smsh)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    # each kernel's launches on every path that runs it: BraggNN's serve
    # phase (the main path), the block's paths, the tuner's measure mode
    by_path = {"braggnn": sl["launches"]}
    by_path.update({f"transformer {k}": v
                    for k, v in blk["launches"].items()})
    by_path["tune measure"] = tn["measure"]
    by_path["train"] = tr["launches"]
    by_path["lm_prefill"] = lmp["launches"]
    by_path["moe_prefill"] = moe["launches"]
    by_path["mixtral_prefill"] = moe["mixtral_launches"]
    by_path["recurrentgemma_prefill"] = rgr["launches"]
    by_path["xlstm_prefill"] = xl["launches"]
    by_path["xlstm_tick"] = xl["tick_launches"]
    by_path["whisper_encode"] = ed["launches"]
    by_path["vlm_prefill"] = vlm["launches"]
    by_path["train_lm_step"] = trl["launches"]
    by_path["whisper_train_step"] = trl["whisper_launches"]
    by_path["xlstm_train_step"] = trl["xlstm"]["launches"]
    by_path["mesh_train_step"] = msh["launches"]
    by_path["moe_mesh_train_step"] = mmsh["launches"]
    by_path["serve_mesh_prefill"] = smsh["lm_prefill_launches"]
    by_path["serve_mesh_tick"] = smsh["lm_tick_launches"]
    by_path["serve_mesh_whisper_prefill"] = smsh["whisper_prefill_launches"]
    by_path["serve_mesh_vlm_prefill"] = smsh["vlm_prefill_launches"]
    by_path["serve_mesh_split_rows"] = smsh["split_rows_launches"]
    by_path["serve_mesh_vlm_split_rows"] = smsh["vlm_split_rows_launches"]
    by_path["tp_train_step"] = tpr["train_launches"]
    by_path["tp_recurrent_train_step"] = tpr["recurrent_train_launches"]
    by_path["tp_prefill"] = tpr["prefill_launches"]
    rows = []
    for name, (source, replaces) in KERNEL_META.items():
        rec = kern[name]
        bound_ms, bound_by = bound(rec["bytes"], rec["flops"])
        n = sl["launches"].get(name, 0)
        paths = {p: c[name] for p, c in by_path.items() if c.get(name)}
        if n == 0:
            print(f"chip_smoke: FAIL: {name} was not launched on the main "
                  f"path", file=sys.stderr)
            return 1
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": n,
                     "max_abs_err": rec["max_abs_err"],
                     "tolerance": TOLERANCE.get(name, {
                         "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL}),
                     "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": rec["library_ms"],
                     "per": f"one batch of {BATCH}: the sum over the "
                            f"kernel's {len(rec['calls'])} calls",
                     "launches_by_path": paths})
        if name in blk["kernels"]:
            # the same numbers at the transformer block's calls
            b = blk["kernels"][name]
            per = BLOCK_DFG_BATCH if name == "dfg_segment" else BATCH
            n_calls = sum(" at " not in c["call"] for c in b["calls"])
            rows[-1]["transformer_block"] = {
                **{k: b[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms",
                                     "max_abs_err")},
                "per": f"one batch of {per}: the sum over {n_calls} calls"}
        if name == "flash_attention":
            # the same numbers at the LM's shapes, per call
            rows[-1]["lm"] = {
                "per": "one call; launches_by_path['lm_prefill'] counts "
                       "one Qwen2.5-3B prefill",
                "calls": [{k: c[k] for k in (
                    "call", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "max_abs_err", "sdpa_window_mask_no_cap_ms")
                    if k in c} for c in lmp["flash"]["calls"]]}
            # and at Mixtral's prefill shape
            rows[-1]["moe"] = {
                "per": "one call; launches_by_path['moe_prefill'] counts "
                       "one qwen2-moe-a2.7b prefill (its calls have the "
                       "lm row's first shape), ['mixtral_prefill'] one of "
                       "Mixtral cut to 4 layers",
                **{k: moe["flash"][k] for k in (
                    "call", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "max_abs_err")}}
            # and at RecurrentGemma-9b's prefill shape (head dim 256)
            rows[-1]["recurrent"] = {
                "per": "one call; launches_by_path['recurrentgemma_"
                       "prefill'] counts one recurrentgemma-9b prefill at "
                       "2 x 4,096 (its calls: B 2, 16 query heads over one "
                       "KV head)",
                "library": rgr["flash"]["library"],
                **{k: rgr["flash"][k] for k in (
                    "call", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "max_abs_err")}}
            # and at whisper-tiny's encoder (non-causal, S 1,500)
            rows[-1]["encdec"] = {
                "per": "one call; launches_by_path['whisper_encode'] counts "
                       "one encode of 8 x 1,500 frames (its calls: B 8, 6 "
                       "heads)",
                **{k: ed["flash"][k] for k in (
                    "call", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "max_abs_err")}}
            # and at qwen2-vl-2b's prefill (1,024 patches + 1,024 tokens)
            rows[-1]["vlm"] = {
                "per": "one call; launches_by_path['vlm_prefill'] counts "
                       "one qwen2-vl-2b prefill at 4 x 2,048 positions "
                       "(its calls: B 4, 12 query heads over 2 KV heads)",
                **{k: vlm["flash"][k] for k in (
                    "call", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "max_abs_err")}}
            # and in training, with the rows' lse, beside the torch
            # backward (no TPU kernel has a backward) and SDPA's
            att = trl["attention"]
            rows[-1]["train"] = {
                "per": "one call at Qwen2.5-3B's microbatch (B 1, S 1,024, "
                       "16 query heads over 2 KV heads, D 128, causal, "
                       "fp32); launches_by_path['train_lm_step'] counts "
                       "one replayed Qwen2.5-3B step (4 microbatches, "
                       "forward and remat recompute), "
                       "['whisper_train_step'] one whisper-tiny step",
                **{k: att["forward"][k] for k in (
                    "call", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "max_abs_err")},
                "library": "F.scaled_dot_product_attention, forward",
                "backward_route": "torch (nn/attention.blockwise_grads)",
                **{k: att[k] for k in (
                    "backward_torch_ms", "backward_bound_ms",
                    "backward_bound_by", "sdpa_forward_backward_ms",
                    "k5_forward_plus_torch_backward_ms",
                    "grad_max_abs_err", "lse_max_abs_err",
                    "k5_lm_prefill_shape_ms")}}
            # and on a mesh: the sharded Qwen2.5-3B prefill (its calls have
            # the lm row's first shape)
            rows[-1]["serve_mesh"] = {
                "per": "launches_by_path['serve_mesh_prefill'] counts one "
                       "replayed sharded Qwen2.5-3B prefill at 4 x 1,024 "
                       "on a 1 x 1 NCCL mesh, ['serve_mesh_whisper_"
                       "prefill'] one whisper-tiny prefill (encode and "
                       "decode), ['serve_mesh_vlm_prefill'] one "
                       "qwen2-vl-2b prefill at 4 layers with patches; "
                       "the Qwen models' through the split plan over "
                       "the head width; ['serve_mesh_split_rows'] and "
                       "['serve_mesh_vlm_split_rows'] one call of the "
                       "attention's path over the head width's rows "
                       "(nn.attention._attend_rows) at Qwen2.5-3B's and "
                       "qwen2-vl-2b's prefill shapes in a model shard "
                       "that splits head_dim one way",
                "prefill_ms_p50": smsh["lm_prefill_ms_p50"]}
        if name in NO_LIBRARY:
            rows[-1]["library_ms_null_because"] = NO_LIBRARY[name]
    # the sLSTM's time loop, which replaces no TPU kernel: its main path
    # is xLSTM's prefill (phase xlstm), the tick's call beside it
    pre, tick = xl["slstm"]["calls"]
    n = xl["launches"].get("slstm_scan", 0)
    if n == 0:
        print("chip_smoke: FAIL: slstm_scan was not launched on the xLSTM "
              "prefill", file=sys.stderr)
        return 1
    rows.append({"name": "slstm_scan", "route": "cuda",
                 "source": "src/repro_torch/csrc/slstm_scan.cu",
                 "replaces": "src/repro/nn/xlstm.py:275",
                 "replaces_note": "no TPU kernel: the reference's "
                                  "_slstm_scan step loop under lax.scan",
                 "launches": n, "max_abs_err": pre["max_abs_err"],
                 "tolerance": pre["tolerance"], "ms": pre["ms"],
                 "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
                 "bound_by": pre["bound_by"], "library_ms": None,
                 "library_ms_null_because": "no single PyTorch call runs a "
                                            "recurrence with exponential "
                                            "gating over time",
                 "per": f"one call {pre['call']}, an xlstm-1.3b prefill "
                        f"layer's; launches: one prefill",
                 "launches_by_path": {p: c["slstm_scan"] for p, c in
                                      by_path.items()
                                      if c.get("slstm_scan")},
                 "tick": {k: tick[k] for k in (
                     "call", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "max_abs_err")}})
    # its backward, which replaces no TPU kernel either: its main path is
    # xlstm-1.3b's training step (phase train_lm)
    bwd, ragged = trl["xlstm"]["backward"]["calls"]
    n = trl["xlstm"]["launches"].get("slstm_scan_backward", 0)
    if n == 0:
        print("chip_smoke: FAIL: slstm_scan_backward was not launched on "
              "the xLSTM training step", file=sys.stderr)
        return 1
    rows.append({"name": "slstm_scan_backward", "route": "cuda",
                 "source": "src/repro_torch/csrc/slstm_scan_backward.cu",
                 "replaces": "src/repro/nn/xlstm.py:275",
                 "replaces_note": "no TPU kernel: jax.grad through the "
                                  "reference's _slstm_scan under lax.scan",
                 "launches": n, "max_abs_err": bwd["max_abs_err"],
                 "tolerance": bwd["tolerance"], "ms": bwd["ms"],
                 "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
                 "bound_by": bwd["bound_by"], "library_ms": None,
                 "library_ms_null_because": "no single PyTorch call runs "
                                            "the gated recurrence's "
                                            "gradient",
                 "per": f"one call {bwd['call']}, an xlstm-1.3b training "
                        f"microbatch's layer; launches: one replayed "
                        f"training step",
                 "launches_by_path": {p: c["slstm_scan_backward"]
                                      for p, c in by_path.items()
                                      if c.get("slstm_scan_backward")},
                 "forward_ms_at_this_call": bwd["forward_ms"],
                 "ragged": {k: ragged[k] for k in (
                     "call", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "max_abs_err")}})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(dev["nvidia_smi"])
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
