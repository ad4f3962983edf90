#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py                 # ogbn-mag at scale 0.1, the LM configs
    python3 chip_smoke.py --scale 1.0 --out results/smoke.json

Phases, run in the order 1-6, 9, 9b, 7, 8 (any failure ends the run with a
non-zero exit and no result line):

  1. environment — torch/CUDA versions, the card's name and power limit;
  2. build — every ``csrc/*.cu`` kernel compiled with nvcc for sm_90a, one
     process per source, all at once; the ptxas registers and spills of every
     instantiation of the kernels redesigned for Hopper (flash_attention's
     wgmma kernel; stacked_mean_linear and relation_agg, both the template of
     ``csrc/mean_linear.cuh``, stacked_mean_linear_dh, stacked_attn_dh and
     stacked_attn_epilogue on the fp32 register-tiled core
     ``csrc/fp32_tile.cuh``; gather_rows; stacked_softmax_combine), none of
     which may spill, and
     ``cuobjdump -sass`` of the flash attention library, which must hold
     HGMMA and UTMALDG instructions;
  3. kernels vs plain — each kernel's wrapper on the card at ragged shapes
     and the training path's shapes against its plain PyTorch version
     (atol/rtol 1e-5: the kernels sum in their own order; gather_rows
     exact).  The attention kernels (stacked_attn_epilogue and its backward
     stacked_attn_dh) in both operand variants — R-GAT's (eb, slope 0.2,
     values shared with the logits projection, a per-slot qv) and HGT's
     (separate values, pe/pv transforms) — with and without residuals, at
     f in {1, 3, 16, 64, 100}, ragged n and d_in (789), H from 16 to 72,
     fully masked rows and shared stack rows, and the epilogue at the fanout
     limits it promises (HGT f = 392, R-GAT f = 792 at H = 64, nh = 4);
     gather_rows exactly at d in {1, 3, 4, 63, 64, 65, 128, 200} x n in {1,
     7, 874, 100000} with int32 and int64 indices, each also into an output
     4 bytes off the 16-byte grid; relation_agg (the dict-form R-GCN
     aggregation) at the reference's AGG_SHAPES and the raf path's shapes,
     each also with h's base 4 bytes off the 16-byte grid, and an all-masked
     case; stacked_softmax_combine (the unfused attention epilogue) at the
     reference's cases, f in {16, 64, 100, 1000}, ragged n, dh = 5 and 6, H
     beyond 256 and beyond 1024, each with v contiguous, v's base off the
     16-byte grid, and e and v as HGT's head-major views;
     stacked_mean_linear and stacked_mean_linear_dh also at 108 ragged shapes
     each (n in {1, 1000, 4097}, d_in in {33, 100, 128, 789}, d_out in {1,
     65, 100}, f in {1, 3, 16}, five slots on two stack rows, every 7th row
     fully masked); stacked_attn_dh also at 96 (n * f in {1, 3000, 12291},
     d_in in {33, 100, 128, 789}, H in {15, 64, 72, 130}, with and without
     dv, slots sharing stack rows);
  4. training — a port ``Heta`` session on the GPU at each model's full
     width (hidden 64, 4 heads, learnable_dim 64, 2 layers, fanouts 4,3,
     learnable tables through the default 4 MiB cache) on ogbn-mag capped
     at in-degree 16, batch 1024: build_graph -> partition ->
     profile_and_cache -> compile -> fit (20 steps, saving a checkpoint at
     step 10) -> evaluate; R-GCN (4), then R-GAT and HGT (4b).  Launch
     counts are reset just before each fit and read just after: R-GCN must
     launch stacked_mean_linear, stacked_mean_linear_dh and gather_rows;
     R-GAT and HGT must launch stacked_attn_epilogue and stacked_attn_dh,
     and their query-side projections stacked_mean_linear (f = 1) and its
     backward.  The losses must be finite and the step-0 batch must score
     lower after the fit;
  4c. dict-form executors — R-GCN at the same width on the same graph
     through vanilla (the oracle, which by the reference's design launches no
     aggregation kernel) and raf (relation_agg once per metatree branch and
     step), 20 steps each with learnable tables in the bundle; their first 3
     losses within 1e-5 (Prop 1), step 0's batch re-scored lower; a fresh raf
     session resumes from raf's step-10 checkpoint (bit for bit, or within
     1e-6); comm_report at this scale;
  4d. unfused attention — R-GAT and HGT through raf_spmd with
     fuse_epilogue=False, 20 steps: stacked_softmax_combine launched, the
     fused kernels not; first 3 losses within 1e-5 of phase 4b's fused runs;
     then infer_all fused and unfused on the trained state (kernel 3 at
     f = 16), the stores within atol/rtol 1e-5; for the fit and the unfused
     infer_all, whether e and v reach kernel 3 contiguous, and the order of
     their dimensions in memory;
  4e. the asynchronous host pipeline — R-GCN raf_spmd on phase 4's graph,
     20 steps a fit, from reset launch counts each: a producer thread and a
     pool of 2 spawned sampler processes over the shared-memory graph store
     and batch arena, each under snapshot "fresh" (losses bit-equal to phase
     4's serial ones; the pooled session's evaluate equal to phase 4's) and
     "stale" (within 5e-2 of them, step 0's batch re-scored lower; pooled
     workers stage against the tables republished after each step, queue
     items under 1 KiB); frozen tables serial, threaded, pooled with and
     without the arena (all bit-equal); a pooled frozen fit whose worker
     owning item 5 is killed (respawned once, losses bit-equal); two pooled
     fit(10) calls on one pool (equal to one fit(20)); HGT pooled "fresh"
     (bit-equal to phase 4b's); the serial loop runs again beside them.
     Each run prints step/host/update time, samples/s, overlap fraction,
     queue bytes, wall ms a step (the fit's, which holds a pool's start,
     and the steady rate over steps 2..19), the first step's latency, the
     republish ms a step under "stale", and its launches (kernels 1, 2 and
     7 wherever tables train; frozen tables have no sparse update, so no
     gather_rows: 1 and 2).  Then infer_all(shm=True) on
     the pooled "fresh" state equals the in-process store bit for bit, a
     server over it answers 512 requests, and one with a scheduled
     fail_flush retries once with no degraded answer; no segment named with
     this process's pid is left;
  4f. the data-parallel tier — phase 4's graph, full width, batch 1024,
     frozen tables (the tier refuses trained ones), 20 steps a fit in 2
     trainer processes on the one card (this process is rank 0, rank 1 is
     spawned with its own CUDA context), each from reset launch counts:
     R-GCN "global" over the shm store and over the on-disk mmap store
     (losses bit-equal to phase 4e's frozen serial fit), R-GCN "local"
     (the fit's own cross-rank check of losses and state hash; finite
     losses; rank 0's step-0 sub-batch re-scored lower), HGT "global"
     (bit-equal to a frozen HGT serial fit run here).  Both ranks must
     launch the model's kernels (R-GCN 1 and 2; HGT 4, 5 and 1: with
     frozen tables no gradient reaches the gathered features, and HGT's
     q side reads only those, so its kernel 2 has nothing to compute),
     rank 1 counting its own, and neither gather_rows; under "global" both
     the same number of times.  Each run prints the fit's wall and steady ms a
     step, rank 1's start, each rank's wall / host / device seconds and
     the exchange's bytes a publication; then evaluate on each DP session,
     and no segment or mmap store named with this process's pid is left;
  5. resume — a fresh session restores the step-10 checkpoint and trains
     to step 20; its losses must equal the uninterrupted run's bit for bit
     (every reduction on the path runs in a fixed order): R-GCN (5), HGT (5b);
  6. serving — on each trained state, from reset launch counts: infer_all,
     then an embedding server whose cache holds the whole target table (every
     flush an all-hit fetch through the gather kernel), answering 512
     requests of 4 ids from 8 client threads; R-GCN (6) also serves from a
     second server at the default 4 MiB (the mixed hit/miss path); R-GAT and
     HGT (6b) must launch stacked_attn_epilogue with no residuals only.
     Every answer is held against the store's rows and a plain
     relu(e) @ w + b; the servers must answer with no retry, no breaker
     trip and no degraded answer, and after each run the cache's
     consistency_check (paper §6's non-replicative invariant: unique slots,
     the mod-hash shard rule) must hold;
  7. kernels at the main paths' shapes — each kernel against its plain
     version at every shape any path launched it with (gather_rows at the
     rows of the table each fetch read); at the two most launched shapes of
     each path, the error against the plain version, kernel time (CUDA
     events over raw launches, inputs rotated through more than the 50 MB
     L2), the plain version's time, the library call's time where one
     PyTorch call computes the same function (every kernel but 8's decode
     shape also as one CUDA graph of the same calls, which leaves out the host's
     launch cost: ``graph_ms``, ``plain_graph_ms``, ``library_graph_ms``;
     stacked_attn_epilogue, which no one call computes, also its
     ``projection_library_ms``: its projections alone as one torch.bmm
     against the slot-gathered weights, a yardstick that computes less than
     the kernel), and the least
     time the card could take (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s fp32
     without tensor cores); relation_agg and stacked_softmax_combine at every
     shape their paths launched, eager and as a graph (no one PyTorch call
     computes either), kernel 3 also on HGT's head-major views through their
     strides beside the contiguous copies of them that the kernel spares
     (``strided_ms``, ``copy_ms``); at f = 1 the library call of stacked_mean_linear
     (torch.baddbmm) and of its dh (torch.bmm), the slot gather outside the
     timed call; plus the whole backward of the R-GCN autograd Function (dh
     + dw + db) at the leaf shape; flash_attention at each LM prefill's
     shape (llama3.2-3b's and phase 9b's: granite 4,16,8,2048,2048,64
     causal, qwen3-moe 4,32,4,...,128, hubert 4,16,16,...,80 non-causal,
     llava 4,56,8,...,128, jamba reduced fp32; bf16 bound by operations at
     989 TFLOP/s, library call scaled_dot_product_attention) and at one sq
     = 1 decode shape; the redesigned kernels' ptxas registers and spills
     again;
  8. card vs CPU — the same training session at a small scale on the GPU
     (kernels) and on the CPU (plain PyTorch), for R-GCN, R-GAT and HGT, the
     raf executor's R-GCN and the unfused R-GAT and HGT: 3-step losses within 1e-5,
     then (raf_spmd) every type's infer_all embeddings within atol/rtol
     1e-5; the LM workbench's configurations reduced (fp32: llama3.2-3b,
     granite-moe, qwen3-moe, mamba2, jamba, llava, hubert), each from the
     same weights: prefill logits of 4 x 64 and 8 decode steps (hubert: its
     prefill logits), the card's prefill launching flash_attention once per
     attention layer and decode none; block by block (every block call of
     the CPU's run again on the card from the CPU's inputs) within 1e-4, and
     the whole model within 1e-4 where no Mamba-2 state carries rounding
     (mamba2's and jamba's whole-model gaps printed: LM_REFERENCE);
  9. LM workbench — llama3.2-3b at full width (28 layers, d_model 3072, 24
     heads over 8 kv heads of 128, bf16) with weights drawn on the card from
     ``--seed``: from reset launch counts, make_prefill_step on a 4 x 2048
     prompt drawn with numpy (flash_attention launched exactly once per
     layer), then 32 greedy decode steps against the cache padded to 2080;
     prefill ms, decode ms/token and tokens/s.  Then the bf16 prefill
     logits with the kernel and with the einsum path, each against the fp32
     answer for the same weights: the kernel's within relative Frobenius
     error 2e-2 of it and no farther from it than the einsum path's (the
     two bf16 paths' own gap is printed: at 28 random layers it sits at
     bf16's noise floor, 0.02); at full width, 2 layers, fp32: prefill
     logits with the kernel
     within 1e-4 of the einsum path, prefill(2048) then decode(token 2048)
     within 1e-3 of forward(2049), and a 32-slot sliding-window ring buffer
     fed 48 tokens through decode within 1e-3 of the windowed forward;
  9b. the rest of the LM workbench — weights drawn on the card from
     ``--seed``, prompts, frames and patches with numpy; each run from reset
     launch counts: a warm-up, then make_prefill_step on 4 x 2048 and 32
     greedy decode steps, printing prefill ms, prompt tokens/s, decode
     ms/token, tokens/s, peak device memory and the run's seconds; prefill
     launches flash_attention exactly once per attention layer, decode and
     every other kernel never.  (a) granite-moe-1b-a400m, full size, bf16:
     param_count, 24 launches, cache [24, 1, 4, 2080, 8, 64], router_stats
     and the picks dropped by the first MoE layer at capacity_factor 1.25,
     bf16 against fp32 logits (printed: routing is discontinuous); then at
     full width, 2 layers, fp32: kernel 8's prefill logits within 1e-4 of the
     einsum path's, at capacity_factor 64 prefill(2048) then decode(token
     2048) within 1e-3 of forward(2049) on one row (cut from 4: capacity 64
     makes the expert batches 51 times larger), and a 32-slot ring buffer fed
     48 tokens within 1e-3 of the windowed forward.  (b) qwen3-moe-30b-a3b at
     full depth (48 layers, 61.1 GB of bf16 weights, drawn slice by slice):
     as (a), bf16 against fp32 on 2 layers.  (c) mamba2-1.3b, full size:
     no launch at all, conv [48, 1, 4, 3, 4096] and ssm [48, 1, 4, 64, 64,
     128] float32, bf16 against fp32 logits (printed); 2 layers fp32:
     prefill(1920) then 128 decode steps within 1e-3 of forward(2048) at
     every decoded position.  (d) hubert-xlarge, full size: the encoder over
     4 x 2048 frames of width 512, 48 launches (non-causal, d 80: the
     mma.sync route), logits [4, 2048, 504], make_serve_step refused; 2
     layers fp32: kernel within 1e-4 of einsum.  (e) llava-next-34b at full
     width, 16 of 60 layers (cut: 68.8 GB at full depth): 576 patches + 1472
     tokens a row, 16 launches, decode from position 2048; 2 layers fp32:
     kernel within 1e-4 of einsum, prefill then one decode step within 1e-3
     of the forward.  (f) jamba-1.5-large-398b at reduced() size (cut: one
     full-width period is 90 GB; fp32, 2 periods, d_model 256): prefill of 4
     x 256, 2 launches, 32 decode steps; at capacity_factor 64 prefill(128)
     then 128 decode steps within 1e-3 of forward(256).

Phase 3 also holds flash_attention against attention_ref at the reference's
ATTN_CASES, rows with no visible key, ragged non-causal, sq = 1 with
q_offset and s = 2048 with d = 128 and GQA 24:8, and at every (sq, sk) in
{1, 129, 1000, 2047}^2 at every head dim (GQA 24:8 or 4:1, causal or not,
windows, offsets, rows that see no key), in fp32 (atol/rtol 2e-5) and bf16
(3e-2, against attention_ref and against fp32 attention of the same
inputs).

The last three lines are the card's name and power limit, one JSON object
describing every kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
L2_BYTES = 50 << 20
TOL = dict(atol=1e-5, rtol=1e-5)
DEVICE = "cuda"  # where phases 3 and 7 put the kernels' inputs


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# the kernels redesigned for Hopper, by the kernel op whose library holds them
# (kernels 1 and 6 both hold mean_linear.cuh's template)
REDESIGNED = {"stacked_mean_linear": "mean_linear_kernel",
              "stacked_mean_linear_dh": "stacked_mean_linear_dh_kernel",
              "stacked_attn_dh": "stacked_attn_dh_kernel",
              "stacked_attn_epilogue": "stacked_attn_epilogue_kernel",
              "gather_rows": "gather_rows_kernel",
              "flash_attention": "flash_attention_wgmma_kernel",
              "relation_agg": "mean_linear_kernel",
              "stacked_softmax_combine": "stacked_softmax_combine_kernel"}


def ptxas_entries(log: str):
    """[(kernel, registers, spill store bytes, spill load bytes)] of every
    entry function in one ``ptxas -v`` report, by its mangled name."""
    import re

    out, entry, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.append((entry, int(m.group(1)), *spills))
            entry = None
    return out


def sass_counts(lib: Path, ops=("HGMMA", "UTMALDG")) -> dict:
    """How often each SASS opcode appears in ``cuobjdump -sass`` of ``lib``."""
    import os
    import re
    import shutil

    tool = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "cuobjdump"
    tool = str(tool) if tool.is_file() else shutil.which("cuobjdump")
    check(tool is not None, "cuobjdump not found: cannot show the SASS of the Hopper kernels")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", text)) for op in ops}


def redesigned_report(build) -> dict:
    """ptxas registers and spills of the redesigned kernels, and the Hopper
    instructions in the flash attention library's SASS."""
    rep = {name: [dict(kernel=k, registers=r, spill_stores=ss, spill_loads=sl)
                  for k, r, ss, sl in ptxas_entries(build.build_log(name)) if fn in k]
           for name, fn in REDESIGNED.items()}
    rep["flash_attention_sass"] = sass_counts(build.library_path("flash_attention"))
    return rep


def log_redesigned(rep: dict) -> None:
    for name in REDESIGNED:
        for e in rep[name]:
            log(f"  {name}: {e['kernel']} {e['registers']} registers, spill stores "
                f"{e['spill_stores']} B, spill loads {e['spill_loads']} B (ptxas)")
    log(f"  flash_attention SASS: {rep['flash_attention_sass']}")


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------


def time_ms(fn, arg_sets, iters: int = 50, graph: bool = False) -> float:
    """Mean ms per call of ``fn(*args)`` over ``iters`` calls cycling
    through ``arg_sets`` (rotated so the working set exceeds L2), timed
    with CUDA events after a warm-up pass.  ``graph``: the calls are
    captured once into a CUDA graph and the replay is timed, which leaves
    out the host's launch cost (5-20 us for a raw launch through ctypes,
    more than a small kernel takes on the card)."""
    import torch

    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def copies_to_exceed_l2(nbytes: int) -> int:
    return max(2, min(8, math.ceil(2 * L2_BYTES / max(1, nbytes))))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# the two kernels: inputs, plain versions, timing
# --------------------------------------------------------------------------


def mean_linear_inputs(shape, seed, device, masked_rows=False):
    """h, mask, w, b, slot_u of a mean-linear shape; ``masked_rows`` also
    masks every 7th row fully, puts the slots on the stack rows in turn
    (rb > U: rows shared) and draws h on the device from the seed (the
    ragged sweep's h reaches 1 GB)."""
    import numpy as np
    import torch

    rb, n, f, di, do, U = shape
    r = np.random.default_rng(seed)
    if masked_rows:
        gen = torch.Generator(device=device).manual_seed(seed)
        h = torch.randn((rb, n, f, di), generator=gen, device=device)
    else:
        h = torch.from_numpy(r.standard_normal((rb, n, f, di)).astype(np.float32)).to(device)
    mask = r.random((rb, n, f)) > 0.3
    slot_u = r.integers(0, U, rb)
    if masked_rows:
        mask[:, ::7, :] = False
        slot_u = np.arange(rb) % U
    mask = torch.from_numpy(mask).to(device)
    w = torch.from_numpy((r.standard_normal((U, di, do)) * 0.1).astype(np.float32)).to(device)
    b = torch.from_numpy((r.standard_normal((U, do)) * 0.1).astype(np.float32)).to(device)
    return h, mask, w, b, slot_u


def check_mean_linear(shape, seed, device, masked_rows=False) -> float:
    from repro_torch.kernels.stacked_relation_agg import (
        stacked_mean_linear, stacked_mean_linear_ref, stage_slot_u)
    import torch

    h, mask, w, b, slot_u = mean_linear_inputs(shape, seed, device, masked_rows)
    got = stacked_mean_linear(h, mask, w, b, slot_u)
    staged = stacked_mean_linear(h, mask, w, b, stage_slot_u(slot_u, w.shape[0], device))
    ref = stacked_mean_linear_ref(h, mask, w, b, slot_u)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"stacked_mean_linear {shape}: non-finite output")
    check(bool(torch.equal(got, staged)),
          f"stacked_mean_linear {shape}: staged slot_u gives another answer")
    err = (got - ref).abs()
    lim = TOL["atol"] + TOL["rtol"] * ref.abs()
    check(bool((err <= lim).all()),
          f"stacked_mean_linear {shape}: max abs err {float(err.max()):.3g} over tolerance")
    return float(err.max()) if err.numel() else 0.0


def check_gather(shape, seed, device, idx_dtype="int64", misaligned=False) -> float:
    """gather_rows against table[idx], exactly; ``misaligned`` also launches
    it raw into an output whose base is 4 bytes off the 16-byte grid (the
    kernel's 4-byte path)."""
    import numpy as np
    import torch

    from repro_torch.kernels.gather_rows.ops import gather_rows, gather_rows_ref, launch_kernel

    rows, d, n = shape
    r = np.random.default_rng(seed)
    table = torch.from_numpy(r.standard_normal((rows, d)).astype(np.float32)).to(device)
    idx = r.integers(0, rows, n).astype(idx_dtype)
    got = gather_rows(table, idx)
    ref = gather_rows_ref(table, torch.from_numpy(idx))
    if misaligned:
        off = torch.empty(n * d + 1, dtype=torch.float32, device=device)[1:].view(n, d)
        launch_kernel(table, torch.from_numpy(idx).to(device), off)
    torch.cuda.synchronize()
    check(bool(torch.equal(got, ref)), f"gather_rows {shape}: differs from table[idx]")
    check(not misaligned or bool(torch.equal(off, ref)),
          f"gather_rows {shape}: the unaligned output differs from table[idx]")
    return 0.0


def time_mean_linear(shape, device):
    import numpy as np
    import torch

    from repro_torch.kernels.stacked_relation_agg import ops as sml

    rb, n, f, di, do, U = shape
    h_bytes = rb * n * f * di * 4
    sets = [mean_linear_inputs(shape, 100 + i, device)
            for i in range(copies_to_exceed_l2(h_bytes))]
    raw, plain = [], []
    for h, mask, w, b, slot_u in sets:
        out = torch.empty((rb, n, do), dtype=torch.float32, device=device)
        u_dev = torch.from_numpy(np.asarray(slot_u, np.int32)).to(device)
        raw.append((h, mask.view(torch.uint8), w, b, u_dev, out))
        plain.append((h, mask, w, b, u_dev))
    # at f = 1 (the attention models' q side) the function is one
    # torch.baddbmm after the slot gather, which stays outside the call
    lib = [(b[u.long()][:, None, :].contiguous(), h[:, :, 0, :].contiguous(), w[u.long()])
           for h, _, w, b, u in plain] if f == 1 else None
    ms = time_ms(sml.launch_kernel, raw)
    plain_ms = time_ms(sml.stacked_mean_linear_ref, plain)
    library_ms = time_ms(torch.baddbmm, lib) if lib else None
    graph = dict(graph_ms=time_ms(sml.launch_kernel, raw, graph=True),
                 plain_graph_ms=time_ms(sml.stacked_mean_linear_ref, plain, graph=True),
                 library_graph_ms=time_ms(torch.baddbmm, lib, graph=True) if lib else None)
    nbytes = h_bytes + rb * n * f + U * di * do * 4 + U * do * 4 + rb * 4 + rb * n * do * 4
    flops = 2 * rb * n * f * di + 2 * rb * n * di * do + rb * n * do
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, bytes=nbytes, flops=flops, **graph)


def time_gather(shape, device):
    import numpy as np
    import torch

    from repro_torch.kernels.gather_rows import ops as gr

    rows, d, n = shape
    r = np.random.default_rng(7)
    sets, raw, lib = [], [], []
    for i in range(copies_to_exceed_l2(rows * d * 4)):
        table = torch.from_numpy(r.standard_normal((rows, d)).astype(np.float32)).to(device)
        idx_dev = torch.from_numpy(r.integers(0, rows, n).astype(np.int64)).to(device)
        out = torch.empty((n, d), dtype=torch.float32, device=device)
        # the plain version on the same device indices (a host index would
        # add its copy, and cannot be captured)
        sets.append((table, idx_dev))
        raw.append((table, idx_dev, out))
        lib.append((table, 0, idx_dev))
    ms = time_ms(gr.launch_kernel, raw)
    plain_ms = time_ms(gr.gather_rows_ref, sets)
    library_ms = time_ms(torch.index_select, lib)
    graph = dict(graph_ms=time_ms(gr.launch_kernel, raw, graph=True),
                 plain_graph_ms=time_ms(gr.gather_rows_ref, sets, graph=True),
                 library_graph_ms=time_ms(torch.index_select, lib, graph=True))
    nbytes = 2 * n * d * 4 + n * 8
    bound_ms, bound_by = bound(nbytes, 0)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, bytes=nbytes, flops=0, **graph)


def dh_inputs(shape, seed, device, masked_rows=False):
    """g, mask, w, slot_u of a dh shape; ``masked_rows`` also masks every 7th
    row fully and puts the slots on the stack rows in turn (rb > U: rows
    shared)."""
    import numpy as np
    import torch

    rb, n, f, di, do, U = shape
    r = np.random.default_rng(seed)
    g = torch.from_numpy(r.standard_normal((rb, n, do)).astype(np.float32)).to(device)
    mask = r.random((rb, n, f)) > 0.3
    slot_u = r.integers(0, U, rb)
    if masked_rows:
        mask[:, ::7, :] = False
        slot_u = np.arange(rb) % U
    mask = torch.from_numpy(mask).to(device)
    w = torch.from_numpy((r.standard_normal((U, di, do)) * 0.1).astype(np.float32)).to(device)
    return g, mask, w, slot_u


def check_dh(shape, seed, device, masked_rows=False) -> float:
    import torch

    from repro_torch.kernels.stacked_relation_agg import (
        stacked_mean_linear_dh, stacked_mean_linear_dh_ref, stage_slot_u)

    g, mask, w, slot_u = dh_inputs(shape, seed, device, masked_rows)
    got = stacked_mean_linear_dh(g, mask, w, slot_u)
    staged = stacked_mean_linear_dh(g, mask, w, stage_slot_u(slot_u, w.shape[0], device))
    ref = stacked_mean_linear_dh_ref(g, mask, w, slot_u)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"stacked_mean_linear_dh {shape}: non-finite output")
    check(bool(torch.equal(got, staged)),
          f"stacked_mean_linear_dh {shape}: staged slot_u gives another answer")
    err = (got - ref).abs()
    lim = TOL["atol"] + TOL["rtol"] * ref.abs()
    check(bool((err <= lim).all()),
          f"stacked_mean_linear_dh {shape}: max abs err {float(err.max()):.3g} over tolerance")
    return float(err.max()) if err.numel() else 0.0


def time_dh(shape, device):
    import numpy as np
    import torch

    from repro_torch.kernels.stacked_relation_agg import ops as sml

    rb, n, f, di, do, U = shape
    out_bytes = rb * n * f * di * 4
    sets = [dh_inputs(shape, 200 + i, device) for i in range(copies_to_exceed_l2(out_bytes))]
    raw, plain = [], []
    for g, mask, w, slot_u in sets:
        dh = torch.empty((rb, n, f, di), dtype=torch.float32, device=device)
        u_dev = torch.from_numpy(np.asarray(slot_u, np.int32)).to(device)
        raw.append((g, mask.view(torch.uint8), w, u_dev, dh))
        plain.append((g, mask, w, u_dev))
    # at f = 1 the function is one torch.bmm against the slot-gathered,
    # transposed weights; the gather stays outside the timed call
    lib = [(g, w[u.long()].transpose(1, 2)) for g, _, w, u in plain] if f == 1 else None
    ms = time_ms(sml.launch_dh_kernel, raw)
    plain_ms = time_ms(sml.stacked_mean_linear_dh_ref, plain)
    library_ms = time_ms(torch.bmm, lib) if lib else None
    graph = dict(graph_ms=time_ms(sml.launch_dh_kernel, raw, graph=True),
                 plain_graph_ms=time_ms(sml.stacked_mean_linear_dh_ref, plain, graph=True),
                 library_graph_ms=time_ms(torch.bmm, lib, graph=True) if lib else None)
    nbytes = out_bytes + rb * n * do * 4 + rb * n * f + U * di * do * 4 + rb * 4
    flops = 2 * rb * n * di * do + rb * n * di + rb * n * f * di
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, bytes=nbytes, flops=flops, **graph)


def time_backward(shape, device):
    """ms of the autograd Function's whole backward (dh kernel + stack-form
    dw/db) at one shape, graph kept and replayed."""
    import torch

    from repro_torch.kernels.stacked_relation_agg import stacked_mean_linear

    h, mask, w, b, slot_u = mean_linear_inputs(shape, 300, device)
    h, w, b = (t.requires_grad_(True) for t in (h, w, b))
    out = stacked_mean_linear(h, mask, w, b, slot_u)
    g = torch.randn_like(out)
    back = lambda: torch.autograd.grad(out, (h, w, b), g, retain_graph=True)  # noqa: E731
    return time_ms(back, [()], iters=20)


# --------------------------------------------------------------------------
# the attention kernels: inputs, plain versions, timing
# --------------------------------------------------------------------------

# a recorded stacked_attn_epilogue shape: (rb, n, f, d_in, nh, dh, Ue, Uv,
# Ua, has_eb, has_slope, qv_bcast, with_res); Uv = 0 shares the values with
# the logits projection, Ua = 0 has no pe/pv transforms


def attn_shape(rb, n, f, di, nh, dh, U, variant, with_res):
    """The recorded form of an R-GAT or HGT epilogue launch."""
    if variant == "rgat":
        return (rb, n, f, di, nh, dh, U, 0, 0, 1, 1, 1, int(with_res))
    return (rb, n, f, di, nh, dh, U, U, U, 0, 0, 0, int(with_res))


def attn_inputs(shape, seed, device):
    """Operands of one epilogue launch at a recorded shape, with shared
    stack rows (slots 0 and 1 on row 0) and fully masked rows."""
    import numpy as np
    import torch

    from repro_torch.kernels.stacked_relation_agg import attn_slots

    rb, n, f, di, nh, dh, Ue, Uv, Ua, has_eb, has_slope, bcast, with_res = shape
    H = nh * dh
    r = np.random.default_rng(seed)

    def t(*s, sc=1.0):
        return torch.from_numpy((r.standard_normal(s) * sc).astype(np.float32)).to(device)

    h = t(rb, n, f, di)
    mask = r.random((rb, n, f)) > 0.3
    mask[0, 0] = False
    mask[-1, n // 2] = False
    qv = t(rb, 1, H, sc=0.1).expand(rb, n, H) if bcast else t(rb, n, H, sc=0.3)
    ops = dict(qv=qv, eb=t(rb, n, nh) if has_eb else None, we=t(Ue, di, H, sc=0.1),
               wv=t(Uv, di, H, sc=0.1) if Uv else None,
               pe=t(Ua, nh, dh, dh, sc=0.3) if Ua else None,
               pv=t(Ua, nh, dh, dh, sc=0.3) if Ua else None)
    slots = [r.integers(0, U, rb) for U in (Ue, Uv or Ue, Ua or 1)]
    slots[0][: min(rb, 2)] = 0
    us = attn_slots(*slots, (Ue, Uv or Ue, Ua or 1), rb, device)
    kw = dict(num_heads=nh, head_dim=dh, scale=float(1 / math.sqrt(dh)) if Ua else 1.0,
              slope=0.2 if has_slope else None, with_residuals=bool(with_res))
    return h, torch.from_numpy(mask).to(device), ops, us, kw


def check_attn(shape, seed, device) -> float:
    import torch

    from repro_torch.kernels.stacked_relation_agg import (
        attn_epilogue_forward, stacked_attn_epilogue_ref)

    h, mask, ops, us, kw = attn_inputs(shape, seed, device)
    got = attn_epilogue_forward(h, mask, **ops, us=us, **kw)
    ref = stacked_attn_epilogue_ref(h, mask, **ops, us=us, **kw)
    torch.cuda.synchronize()
    got, ref = (got, ref) if kw["with_residuals"] else ((got,), (ref,))
    worst = 0.0
    for name, a, b in zip(("out", "z0", "v0"), got, ref):
        check(bool(torch.isfinite(a).all()), f"stacked_attn_epilogue {shape}: non-finite {name}")
        err = (a - b).abs()
        check(bool((err <= TOL["atol"] + TOL["rtol"] * b.abs()).all()),
              f"stacked_attn_epilogue {shape}: {name} max abs err {float(err.max()):.3g} "
              "over tolerance")
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    return worst


def attn_dh_inputs(shape, seed, device):
    """(dz, dv, we, wv, us) of a recorded stacked_attn_dh shape (rb, n, f,
    d_in, H, Ue, Uv); Uv = 0 is the shared (one-product) form.  Slots 0 and
    1 share stack row 0."""
    import numpy as np
    import torch

    from repro_torch.kernels.stacked_relation_agg import attn_slots

    rb, n, f, di, H, Ue, Uv = shape
    r = np.random.default_rng(seed)

    def t(*s, sc=1.0):
        return torch.from_numpy((r.standard_normal(s) * sc).astype(np.float32)).to(device)

    dz = t(rb, n, f, H)
    dv = t(rb, n, f, H) if Uv else None
    we, wv = t(Ue, di, H, sc=0.1), (t(Uv, di, H, sc=0.1) if Uv else None)
    slots = [r.integers(0, Ue, rb), r.integers(0, Uv or Ue, rb), np.zeros(rb, np.int64)]
    slots[0][: min(rb, 2)] = 0
    return dz, dv, we, wv, attn_slots(*slots, (Ue, Uv or Ue, 1), rb, device)


def check_attn_dh(shape, seed, device) -> float:
    import torch

    from repro_torch.kernels.stacked_relation_agg import stacked_attn_dh, stacked_attn_dh_ref

    args = attn_dh_inputs(shape, seed, device)
    got = stacked_attn_dh(*args)
    ref = stacked_attn_dh_ref(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"stacked_attn_dh {shape}: non-finite output")
    err = (got - ref).abs()
    check(bool((err <= TOL["atol"] + TOL["rtol"] * ref.abs()).all()),
          f"stacked_attn_dh {shape}: max abs err {float(err.max()):.3g} over tolerance")
    return float(err.max()) if err.numel() else 0.0


def attn_work(shape):
    """(bytes, FLOPs) of one epilogue launch: each input read once (the
    stacks whole, qv once per slot when broadcast), each output written
    once; FLOPs as the kernel computes the function (HGT's transforms once
    per row: q' = pe.qv and (sum_j a_j v0_j).pv)."""
    rb, n, f, di, nh, dh, Ue, Uv, Ua, has_eb, _, bcast, with_res = shape
    H = nh * dh
    pairs = rb * n * f
    nbytes = 4 * (pairs * di + (rb * H if bcast else rb * n * H) + has_eb * rb * n * nh
                  + (Ue + Uv) * di * H + 2 * Ua * nh * dh * dh + rb * n * H
                  + with_res * pairs * H * (2 if Uv else 1)) + pairs + 3 * rb * 4
    flops = (2 * pairs * di * H * (2 if Uv else 1) + 2 * pairs * H + 6 * pairs * nh
             + 2 * pairs * H + (4 * rb * n * H * dh if Ua else 0))
    return nbytes, flops


def time_attn(shape, device):
    import torch

    from repro_torch.kernels.stacked_relation_agg import ops as sra

    rb, n, f, di, nh, dh = shape[:6]
    H = nh * dh
    two = bool(shape[7])
    sets = [attn_inputs(shape, 400 + i, device)
            for i in range(copies_to_exceed_l2(rb * n * f * di * 4))]
    raw, plain, proj = [], [], []
    for h, mask, ops, us, kw in sets:
        out = torch.empty((rb, n, H), dtype=torch.float32, device=device)
        z0 = v0 = None
        if kw["with_residuals"]:
            z0 = torch.empty((rb, n, f, H), dtype=torch.float32, device=device)
            v0 = torch.empty_like(z0) if two else None
        raw.append((h, mask.view(torch.uint8), ops["qv"], ops["eb"], ops["we"], ops["wv"],
                    ops["pe"], ops["pv"], us, out, z0, v0, nh, dh, kw["scale"], kw["slope"]))
        plain.append((h, mask, ops["qv"], ops["eb"], ops["we"], ops["wv"], ops["pe"],
                      ops["pv"], us, nh, dh, kw["scale"], kw["slope"], kw["with_residuals"]))
        # the projection yardstick: z0 (and v0 beside it along H) as one
        # torch.bmm against the slot-gathered weights, gathered beforehand
        u = us.long()
        w = ops["we"][u[0]] if not two else torch.cat([ops["we"][u[0]], ops["wv"][u[1]]], 2)
        proj.append((h.reshape(rb, n * f, di), w.contiguous()))
    ms = time_ms(sra.launch_attn_epilogue, raw)
    plain_ms = time_ms(sra.stacked_attn_epilogue_ref, plain)
    graph = dict(graph_ms=time_ms(sra.launch_attn_epilogue, raw, graph=True),
                 plain_graph_ms=time_ms(sra.stacked_attn_epilogue_ref, plain, graph=True),
                 library_graph_ms=None)
    nbytes, flops = attn_work(shape)
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, bytes=nbytes, flops=flops, **graph,
                projection_library_ms=time_ms(torch.bmm, proj),
                projection_library_graph_ms=time_ms(torch.bmm, proj, graph=True))


def time_attn_dh(shape, device):
    """Kernel, plain and library times of stacked_attn_dh.  The library call
    is one ``torch.bmm`` of dz (with dv beside it along H when the values
    are not shared) against the slot-gathered, transposed weights; the
    gather and the concatenation happen before the timed calls."""
    import torch

    from repro_torch.kernels.stacked_relation_agg import ops as sra

    rb, n, f, di, H, Ue, Uv = shape
    sets = [attn_dh_inputs(shape, 500 + i, device)
            for i in range(copies_to_exceed_l2(rb * n * f * di * 4))]
    raw, lib = [], []
    for dz, dv, we, wv, us in sets:
        raw.append((dz, dv, we, wv, us, torch.empty((rb, n, f, di), dtype=torch.float32,
                                                     device=device)))
        u = us.long()
        wt = we[u[0]].transpose(1, 2)
        a = dz.reshape(rb, n * f, H)
        if dv is not None:
            wt = torch.cat([wt, wv[u[1]].transpose(1, 2)], dim=1)
            a = torch.cat([a, dv.reshape(rb, n * f, H)], dim=2)
        lib.append((a.contiguous(), wt.contiguous()))
    ms = time_ms(sra.launch_attn_dh, raw)
    plain_ms = time_ms(sra.stacked_attn_dh_ref, sets)
    library_ms = time_ms(torch.bmm, lib)
    graph = dict(graph_ms=time_ms(sra.launch_attn_dh, raw, graph=True),
                 plain_graph_ms=time_ms(sra.stacked_attn_dh_ref, sets, graph=True),
                 library_graph_ms=time_ms(torch.bmm, lib, graph=True))
    k = 2 if Uv else 1
    nbytes = 4 * (k * rb * n * f * H + (Ue + Uv) * di * H + rb * n * f * di) + 3 * rb * 4
    flops = 2 * k * rb * n * f * di * H
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, bytes=nbytes, flops=flops, **graph)


# --------------------------------------------------------------------------
# the dict-form executors' kernel (relation_agg) and the unfused attention
# epilogue (stacked_softmax_combine): inputs, plain versions, timing
# --------------------------------------------------------------------------


def offset_view(a, device):
    """``a`` on the device as a contiguous view at storage offset 1 of a
    larger buffer: its base 4 bytes off the 16-byte grid."""
    import torch

    buf = torch.empty(a.size + 1, dtype=torch.float32, device=device)
    out = buf[1:].view(a.shape)
    out.copy_(torch.from_numpy(a))
    return out


def relation_agg_inputs(shape, seed, device, all_masked=False, misaligned=False):
    """(h, mask, w, b) of a recorded relation_agg shape (n, f, d_in, d_out),
    row 0 fully masked; ``misaligned``: h's base off the 16-byte grid."""
    import numpy as np
    import torch

    n, f, di, do = shape
    r = np.random.default_rng(seed)
    ha = r.standard_normal((n, f, di)).astype(np.float32)
    h = offset_view(ha, device) if misaligned else torch.from_numpy(ha).to(device)
    m = np.zeros((n, f), bool) if all_masked else r.random((n, f)) > 0.3
    m[0] = False
    w = torch.from_numpy((r.standard_normal((di, do)) * 0.1).astype(np.float32)).to(device)
    b = torch.from_numpy((r.standard_normal(do) * 0.1).astype(np.float32)).to(device)
    return h, torch.from_numpy(m).to(device), w, b


def close(name, shape, got, ref) -> float:
    """Hold ``got`` to ``ref`` at TOL; returns the max abs error."""
    import torch

    check(bool(torch.isfinite(got).all()), f"{name} {shape}: non-finite output")
    err = (got - ref).abs()
    check(bool((err <= TOL["atol"] + TOL["rtol"] * ref.abs()).all()),
          f"{name} {shape}: max abs err {float(err.max()):.3g} over tolerance")
    return float(err.max()) if err.numel() else 0.0


def check_relation_agg(shape, seed, device, all_masked=False, misaligned=False) -> float:
    import torch

    from repro_torch.kernels.relation_agg import ops as ra

    h, mask, w, b = relation_agg_inputs(shape, seed, device, all_masked, misaligned)
    got = ra.relation_agg(h, mask, w, b)
    ref = ra.relation_agg_ref(h, mask, w, b)
    torch.cuda.synchronize()
    check(bool(((got[0] - b).abs() <= TOL["atol"] + TOL["rtol"] * b.abs()).all()),
          f"relation_agg {shape}: the all-masked row is not b")
    return close("relation_agg", shape, got, ref)


def time_relation_agg(shape, device):
    import torch

    from repro_torch.kernels.relation_agg import ops as ra

    n, f, di, do = shape
    h_bytes = n * f * di * 4
    sets = [relation_agg_inputs(shape, 600 + i, device)
            for i in range(copies_to_exceed_l2(h_bytes))]
    raw = [(h, mask.view(torch.uint8), w, b,
            torch.empty((n, do), dtype=torch.float32, device=device))
           for h, mask, w, b in sets]
    ms = time_ms(ra.launch_kernel, raw)
    plain_ms = time_ms(ra.relation_agg_ref, sets)
    graph = dict(graph_ms=time_ms(ra.launch_kernel, raw, graph=True),
                 plain_graph_ms=time_ms(ra.relation_agg_ref, sets, graph=True),
                 library_graph_ms=None)
    nbytes = h_bytes + n * f + di * do * 4 + do * 4 + n * do * 4
    flops = 2 * n * f * di + n * di + 2 * n * di * do + n * do
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, bytes=nbytes, flops=flops, **graph)


# kernel 3's operand layouts: as the einsums of R-GAT's attn_parts return
# them (v contiguous), a v whose base is 4 bytes off the 16-byte grid, and
# HGT's (e and v head-major views, [rb, nh, n, f] and [rb, nh, n, f, dh] in
# memory)
SC_LAYOUTS = ("contiguous", "misaligned", "head-major")


def softmax_combine_inputs(shape, seed, device, layout="contiguous"):
    """(e, mask, v) of a recorded stacked_softmax_combine shape (rb, n, f,
    nh, dh) in one of SC_LAYOUTS, row 0 of slot 0 fully masked."""
    import numpy as np
    import torch

    rb, n, f, nh, dh = shape
    r = np.random.default_rng(seed)
    e = r.standard_normal((rb, n, f, nh)).astype(np.float32)
    v = r.standard_normal((rb, n, f, nh, dh)).astype(np.float32)
    m = r.random((rb, n, f)) > 0.3
    m[0, 0] = False
    if layout == "head-major":
        te = torch.from_numpy(np.ascontiguousarray(e.transpose(0, 3, 1, 2))).to(device)
        tv = torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2, 4))).to(device)
        te, tv = te.permute(0, 2, 3, 1), tv.permute(0, 2, 3, 1, 4)
    else:
        te = torch.from_numpy(e).to(device)
        tv = offset_view(v, device) if layout == "misaligned" else torch.from_numpy(v).to(device)
    return te, torch.from_numpy(m).to(device), tv


def check_softmax_combine(shape, seed, device, layout="contiguous") -> float:
    import torch

    from repro_torch.kernels.stacked_relation_agg import ops as sra

    e, mask, v = softmax_combine_inputs(shape, seed, device, layout)
    got = sra.stacked_softmax_combine(e, mask, v)
    ref = sra.stacked_softmax_combine_ref(e, mask, v)
    torch.cuda.synchronize()
    check(not bool(got[0, 0].any()), f"stacked_softmax_combine {shape}: masked row is not 0")
    return close(f"stacked_softmax_combine ({layout})", shape, got, ref)


def time_softmax_combine(shape, device):
    """Kernel 3 on R-GAT's layout (v contiguous): eager and graph, against
    the plain version; on HGT's head-major views, read through their strides
    (``strided_ms``), beside the contiguous copies of e and v a wrapper would
    otherwise make in front of the launch (``copy_ms``, graph times too)."""
    import torch

    from repro_torch.kernels.stacked_relation_agg import ops as sra

    rb, n, f, nh, dh = shape
    H = nh * dh
    v_bytes = rb * n * f * H * 4
    raw, plain, strided, copies = [], [], [], []
    for i in range(copies_to_exceed_l2(v_bytes)):
        e, mask, v = softmax_combine_inputs(shape, 700 + i, device)
        out = torch.empty((rb, n, H), dtype=torch.float32, device=device)
        raw.append((e, mask.view(torch.uint8), v, out))
        plain.append((e, mask, v))
        pe, _, pv = softmax_combine_inputs(shape, 700 + i, device, "head-major")
        strided.append((pe, mask.view(torch.uint8), pv, out))
        copies.append((pe, pv))

    def copy(pe, pv):
        pe.contiguous(), pv.contiguous()

    ms = time_ms(sra.launch_softmax_combine, raw)
    plain_ms = time_ms(sra.stacked_softmax_combine_ref, plain)
    graph = dict(graph_ms=time_ms(sra.launch_softmax_combine, raw, graph=True),
                 plain_graph_ms=time_ms(sra.stacked_softmax_combine_ref, plain, graph=True),
                 library_graph_ms=None)
    layout = dict(strided_ms=time_ms(sra.launch_softmax_combine, strided),
                  strided_graph_ms=time_ms(sra.launch_softmax_combine, strided, graph=True),
                  copy_ms=time_ms(copy, copies), copy_graph_ms=time_ms(copy, copies, graph=True))
    nbytes = rb * n * f * nh * 4 + rb * n * f + v_bytes + rb * n * H * 4
    # per (row, head): max, exp of the difference, sum, divide over f; per
    # (row, column): a multiply-add over f
    flops = 4 * rb * n * nh * f + 2 * rb * n * H * f
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, bytes=nbytes, flops=flops, **graph, **layout)


# --------------------------------------------------------------------------
# kernel 8 (flash_attention): inputs, plain version, timing
# --------------------------------------------------------------------------

# a recorded flash_attention shape: (b, h, hk, sq, sk, d, causal, window (-1:
# none), q_offset, dtype code (0 fp32, 1 bf16))
FLASH_TOL = {0: dict(atol=2e-5, rtol=2e-5), 1: dict(atol=3e-2, rtol=3e-2)}
# bf16 checks: the kernel's Frobenius error against fp32 attention over the
# plain bf16 path's, per case
FLASH_FROBENIUS = []


def flash_args(shape):
    b, h, hk, sq, sk, d, causal, window, off, code = shape
    return dict(causal=bool(causal), window=None if window < 0 else window, q_offset=off)


def flash_inputs(shape, seed, device):
    """q, k, v of a recorded shape in the model's [b, s, h, d] layout."""
    import numpy as np
    import torch

    b, h, hk, sq, sk, d, _, _, _, code = shape
    dtype = (torch.float32, torch.bfloat16)[code]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return tuple(torch.randn(shp, generator=g, device=device).to(dtype)
                 for shp in ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d)))


def check_flash(shape, seed, device) -> float:
    """Kernel 8 through its wrapper (on transposed views, as the model calls
    it) against attention_ref on the same inputs; bf16 also against fp32
    attention of the same inputs.  Returns the max abs error."""
    import torch

    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    kw = flash_args(shape)
    q, k, v = (t.transpose(1, 2) for t in flash_inputs(shape, seed, device))
    got = flash_attention(q, k, v, **kw)
    ref = attention_ref(q, k, v, kw["causal"], kw["window"], kw["q_offset"])
    refs = [ref]
    if shape[-1] == 1:
        refs.append(attention_ref(q.float(), k.float(), v.float(), kw["causal"], kw["window"],
                                  kw["q_offset"]))
    torch.cuda.synchronize()
    tol = FLASH_TOL[shape[-1]]
    check(bool(torch.isfinite(got).all()), f"flash_attention {shape}: non-finite output")
    worst = 0.0
    for want in refs:
        err = (got.float() - want.float()).abs()
        check(bool((err <= tol["atol"] + tol["rtol"] * want.float().abs()).all()),
              f"flash_attention {shape}: max abs err {float(err.max()):.3g} over tolerance")
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    if shape[-1] == 1:
        # a check that scales with the output (|out| is about sqrt(e / keys),
        # near the 3e-2 above at long rows): the kernel's Frobenius error
        # against fp32 attention within 1.5x the plain bf16 path's own
        exact = refs[1].float()
        k_err = float((got.float() - exact).norm())
        p_err = float((ref.float() - exact).norm())
        check(k_err <= 1.5 * p_err + 1e-6 * float(exact.norm()),
              f"flash_attention {shape}: Frobenius error {k_err:.4g} against fp32 attention, "
              f"over 1.5x the plain bf16 path's {p_err:.4g}")
        FLASH_FROBENIUS.append(k_err / p_err if p_err > 0 else 0.0)
    return worst


def flash_pairs(sq, sk, causal, window, off) -> int:
    """(query, key) pairs inside the mask: the work this input needs."""
    import numpy as np

    qp = np.arange(sq, dtype=np.int64) + off
    hi = np.minimum(qp, sk - 1) if causal else np.full(sq, sk - 1, np.int64)
    lo = np.maximum(qp - window + 1, 0) if window >= 0 else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def time_flash(shape, device):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import ops as fa

    b, h, hk, sq, sk, d, causal, window, off, code = shape
    kw = flash_args(shape)
    esize = 4 if code == 0 else 2
    in_bytes = (b * sq * h * d + 2 * b * sk * hk * d) * esize
    sets = [flash_inputs(shape, 800 + i, device) for i in range(copies_to_exceed_l2(in_bytes))]
    raw = [(q, k, v, torch.empty_like(q), kw["causal"], kw["window"], kw["q_offset"])
           for q, k, v in sets]
    ms = time_ms(fa.launch_kernel, raw, iters=20)
    graph_ms = time_ms(fa.launch_kernel, raw, iters=20, graph=True)
    views = [tuple(t.transpose(1, 2) for t in qkv) for qkv in sets]
    plain_ms = time_ms(attention_ref, [(*qkv, kw["causal"], kw["window"], kw["q_offset"])
                                       for qkv in views], iters=10)
    # the library yardstick where one call computes the same function: no
    # window, and either every key visible or causal from position 0
    library_ms = library_graph_ms = None
    if window < 0 and (not causal or off >= sk - 1 or off == 0):
        is_causal = bool(causal) and off < sk - 1

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=is_causal, enable_gqa=True)

        library_ms = time_ms(sdpa, views, iters=20)
        library_graph_ms = time_ms(sdpa, views, iters=20, graph=True)
    pairs = flash_pairs(sq, sk, causal, window, off)
    nbytes = in_bytes + b * sq * h * d * esize
    flops = 4 * d * pairs * b * h  # q k^T and p v over the visible pairs
    peak = FP32_FLOP_PER_S if code == 0 else BF16_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    # attention_ref copies its mask from the host, which a CUDA graph cannot
    # capture: its graph time is not measured
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, bytes=nbytes, flops=flops, graph_ms=graph_ms,
                plain_graph_ms=None, library_graph_ms=library_graph_ms)


# phase 3's cases of kernel 8: the reference's ATTN_CASES, the rows with no
# visible key (ROADMAP.md §3 R3), ragged non-causal, sq = 1 with q_offset,
# and llama3.2-3b's heads (24:8, d = 128) at s = 2048; each in fp32 and bf16
FLASH_CASES = [
    (2, 4, 2, 256, 256, 64, 1, -1, 0), (1, 8, 8, 300, 300, 64, 1, -1, 0),
    (1, 4, 4, 256, 256, 128, 1, 64, 0), (2, 4, 2, 1, 512, 64, 1, -1, 511),
    (1, 2, 2, 1, 1024, 64, 1, 256, 1023), (1, 2, 2, 128, 128, 64, 0, -1, 0),
    (1, 16, 16, 160, 160, 80, 0, -1, 0), (1, 2, 2, 16, 16, 32, 0, 4, 10),
    (2, 6, 3, 77, 131, 64, 0, -1, 0), (1, 6, 2, 100, 37, 32, 0, 9, 0),
    (4, 24, 8, 1, 2049, 128, 1, -1, 2048), (1, 24, 8, 2048, 2048, 128, 1, -1, 0),
]
# phase 7's decode shape (not on the path: decode attention is plain torch
# ops): one token of llama3.2-3b's batch 4 against a 2048-token cache
FLASH_DECODE_SHAPE = (4, 24, 8, 1, 2049, 128, 1, -1, 2048, 1)


# --------------------------------------------------------------------------
# the LM workbench (phases 9 and 8)
# --------------------------------------------------------------------------


def rel_frobenius(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def run_lm(report: dict, seed: int, batch: int = 4, prompt: int = 2048, new_tokens: int = 32):
    """Phase 9: llama3.2-3b at full width (28 layers, d_model 3072, bf16,
    weights from ``seed``) through prefill and greedy decode on the card,
    from reset launch counts; then the checks at full width.  Returns the
    shapes each kernel was launched at by prefill + decode."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.ops import reset_launch_counts
    from repro_torch.launch.serve import pad_kv_cache
    from repro_torch.models import (forward, init_decode_cache, init_params,
                                    make_prefill_step, make_serve_step)

    t_phase = time.perf_counter()
    cfg = get_arch("llama3.2-3b")
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.dtype)
          == (28, 3072, 24, 8, 128, "bfloat16"), f"unexpected llama3.2-3b config {cfg}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed, DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for blk in params["blocks"].values() for t in blk.values())
    n_params += sum(params[k].numel() for k in ("final_norm", "embed", "head"))
    check(n_params == cfg.param_count(), f"{n_params} parameters, config says "
          f"{cfg.param_count()}")
    log(f"  llama3.2-3b: {n_params:,} parameters ({n_params * 2 / 1e9:.2f} GB bf16) "
        f"initialized on the card from seed {seed} in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt + 1)), device=DEVICE)
    prompts = tokens[:, :prompt]
    prefill = make_prefill_step(cfg)
    serve = make_serve_step(cfg)

    prefill(params, {"tokens": prompts})  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches, _ = launch_counts()
    cache = pad_kv_cache(cache, new_tokens)
    token = logits[:, -1:].argmax(dim=-1)
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pos in range(prompt, prompt + new_tokens):
        step_logits, cache = serve(params, cache, token, pos)
        token = step_logits.argmax(dim=-1)
        out.append(token)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches, shapes = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(prefill_launches["flash_attention"] == cfg.num_layers,
          f"prefill launched flash_attention {prefill_launches['flash_attention']} times, "
          f"want {cfg.num_layers}")
    check(launches["flash_attention"] == cfg.num_layers,
          "decode launched flash_attention (its attention is plain torch ops)")
    check(all(v == 0 for k, v in launches.items() if k != "flash_attention"),
          f"the LM path launched other kernels: {launches}")
    check(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step_logits).all()),
          "non-finite logits")
    check(tuple(cache["k"].shape) == (cfg.n_periods, 1, batch, prompt + new_tokens,
                                      cfg.num_kv_heads, cfg.hd),
          f"cache shape {tuple(cache['k'].shape)}")
    gen = torch.cat(out, dim=1).cpu().numpy()
    tok_s = batch * new_tokens / decode_s
    log(f"  prefill {batch}x{prompt}: {prefill_s * 1e3:.2f} ms "
        f"({batch * prompt / prefill_s:,.0f} prompt tokens/s), flash_attention launched "
        f"{prefill_launches['flash_attention']} times at {dict(shapes['flash_attention'])}")
    log(f"  decode {new_tokens} steps x batch {batch} (cache {prompt + new_tokens}): "
        f"{decode_s * 1e3:.2f} ms, {decode_s / new_tokens * 1e3:.3f} ms/token, "
        f"{tok_s:,.1f} tokens/s; peak device memory {peak_gb:.2f} GB; "
        f"generated tokens of row 0: {gen[0][:8].tolist()}...")
    res = dict(prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_s / new_tokens * 1e3,
               decode_tokens_per_s=tok_s, peak_gb=peak_gb, launches=launches,
               shapes=shape_dict(shapes), batch=batch, prompt=prompt, new_tokens=new_tokens)

    # bf16 at full depth: the kernel and the einsum path, each against the
    # exact answer for the same weights (upcast to fp32, einsum path in fp32)
    plain_logits, _ = make_prefill_step(cfg, use_kernel=False)(params, {"tokens": prompts})
    del cache
    cfg32 = dataclasses.replace(cfg, name="llama3.2-3b-fp32", dtype="float32")
    params = {k: ({kind: {leaf: t.float() for leaf, t in blk.items()}
                   for kind, blk in v.items()} if k == "blocks" else v.float())
              for k, v in params.items()}
    exact, _ = make_prefill_step(cfg32, use_kernel=False)(params, {"tokens": prompts})
    res["bf16_rel_frobenius"] = rel_frobenius(logits, plain_logits)
    res["bf16_kernel_vs_exact"] = rel_frobenius(logits, exact)
    res["bf16_einsum_vs_exact"] = rel_frobenius(plain_logits, exact)
    log(f"  bf16, {cfg.num_layers} layers, prefill logits, relative Frobenius error: kernel "
        f"path vs einsum path {res['bf16_rel_frobenius']:.4g}; against the fp32 answer for "
        f"the same weights: kernel path {res['bf16_kernel_vs_exact']:.4g}, einsum path "
        f"{res['bf16_einsum_vs_exact']:.4g} (gate: the kernel path within 2e-2 of the fp32 "
        f"answer and no farther from it than the einsum path)")
    check(res["bf16_kernel_vs_exact"] <= 2e-2, "bf16 prefill logits with kernel 8 are more "
          "than 2e-2 from the fp32 answer")
    check(res["bf16_kernel_vs_exact"] <= res["bf16_einsum_vs_exact"],
          "bf16 prefill logits with kernel 8 are farther from the fp32 answer than the "
          "einsum path's")
    del logits, plain_logits, exact
    torch.cuda.empty_cache()

    # fp32 at full width, 2 layers: the first two layers of the same weights
    cfg32 = dataclasses.replace(cfg32, name="llama3.2-3b-2l-fp32", num_layers=2)
    params["blocks"] = {kind: {leaf: t[:2] for leaf, t in blk.items()}
                        for kind, blk in params["blocks"].items()}
    lk, cache = make_prefill_step(cfg32)(params, {"tokens": prompts})
    le, _ = make_prefill_step(cfg32, use_kernel=False)(params, {"tokens": prompts})
    res["fp32_kernel_vs_einsum"] = max_abs(lk, le)
    log(f"  fp32, 2 layers: prefill logits with kernel 8 vs the einsum path, max abs "
        f"{res['fp32_kernel_vs_einsum']:.3g} (limit 1e-4)")
    check(res["fp32_kernel_vs_einsum"] <= 1e-4, "fp32 prefill logits: kernel and einsum "
          "path disagree")
    cache = pad_kv_cache(cache, 1)
    ld, _ = make_serve_step(cfg32)(params, cache, tokens[:, prompt:prompt + 1], prompt)
    full = forward(cfg32, params, {"tokens": tokens})
    res["fp32_decode_vs_forward"] = max_abs(ld[:, 0], full[:, prompt])
    res["fp32_prefill_vs_forward"] = max_abs(lk[:, 0], full[:, prompt - 1])
    log(f"  fp32, 2 layers: prefill({prompt}) then decode(token {prompt}) vs "
        f"forward({prompt + 1}), max abs {res['fp32_decode_vs_forward']:.3g}; prefill vs "
        f"forward {res['fp32_prefill_vs_forward']:.3g} (limit 1e-3)")
    check(res["fp32_decode_vs_forward"] <= 1e-3 and res["fp32_prefill_vs_forward"] <= 1e-3,
          "fp32 decode disagrees with the forward")
    del full
    window, steps = 32, 48
    ring = init_decode_cache(cfg32, batch, window, device=DEVICE)
    step_w = make_serve_step(cfg32, window=window)
    for pos in range(steps):
        lw, ring = step_w(params, ring, tokens[:, pos:pos + 1], pos)
    fw = forward(cfg32, params, {"tokens": tokens[:, :steps]}, window=window)
    res["fp32_window_decode_vs_forward"] = max_abs(lw[:, 0], fw[:, -1])
    log(f"  fp32, 2 layers: window {window} ring buffer fed {steps} tokens through decode "
        f"vs the windowed forward (kernel 8 with a window), max abs "
        f"{res['fp32_window_decode_vs_forward']:.3g} (limit 1e-3)")
    check(res["fp32_window_decode_vs_forward"] <= 1e-3, "windowed decode disagrees with the "
          "windowed forward")
    del params, ring, fw, lk, le
    torch.cuda.empty_cache()
    log(f"  ({time.perf_counter() - t_phase:.1f} s phase)")
    report["lm"] = res
    return shapes


# phase 8's LM configurations, reduced and fp32: llama3.2-3b and phase 9b's
# six, each held block by block (every block call of its CPU run again on the
# card, from the CPU's inputs: tests/_lm_blocks.py) and whole.  The whole
# model is not held where Mamba-2 blocks carry a state: jamba's 16 layers
# amplify fp32 rounding past 1e-4 (the reference's own jitted and eager
# forwards differ by 3.2e-4: test_jamba_is_beyond_whole_model_parity_in_fp32
# in tests/test_torch_lm_families.py), and mamba2's state left one decode
# step 2.9e-4 off the CPU while no block on the same inputs differed by more
# than 1.7e-5 (PERF.md §6); their whole-model gaps are printed
LM_REFERENCE = ("llama3.2-3b", "granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "mamba2-1.3b",
                "jamba-1.5-large-398b", "llava-next-34b", "hubert-xlarge")


def lm_inputs(cfg, rng, batch: int, prompt: int, extra: int = 0):
    """numpy inputs of a ``batch`` x ``prompt`` prefill (frames for the audio
    model; the vision model's patches, drawn after the tokens, before the
    text) and the ``extra`` tokens after the prompt: ``(tokens [batch,
    prompt + extra], prefill batch)``."""
    import numpy as np

    tokens = rng.integers(0, cfg.vocab, (batch, prompt + extra))
    if cfg.frontend == "audio":
        frames = rng.standard_normal((batch, prompt, cfg.frontend_dim)).astype(np.float32)
        return tokens, {"frames": frames}
    inputs = {"tokens": tokens[:, :prompt]}
    if cfg.frontend == "vision":
        inputs["patch_embeds"] = rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return tokens, inputs


def lm_to(params: dict, device) -> dict:
    return {k: lm_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}


def attention_layers(cfg) -> int:
    return cfg.n_periods * len(cfg.attn_slots)


def run_lm_reference(name: str, seed: int, steps: int = 8) -> dict:
    """Phase 8 for the LM: one reduced configuration (fp32) on the card and
    on the CPU from the same weights: prefill logits of a 4 x 64 prompt and
    ``steps`` decode steps (the encoder: its prefill logits), block by block
    and whole within 1e-4 (see LM_REFERENCE); the card's prefill launches
    flash_attention once per attention layer, its decode none."""
    import numpy as np
    import torch

    import repro_torch.models.transformer as transformer
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ops import reset_launch_counts
    from repro_torch.launch.serve import pad_kv_cache
    from repro_torch.models import init_params, make_prefill_step, make_serve_step

    sys.path.insert(0, str(REPO / "tests"))
    from _lm_blocks import recorded, replay

    cfg = get_arch(name).reduced()
    cpu = init_params(cfg, seed, "cpu")
    gpu = lm_to(cpu, DEVICE)
    tokens, batch = lm_inputs(cfg, np.random.default_rng(seed), 4, 64, steps)
    start = 64 + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)

    def run(params):
        reset_launch_counts()
        logits, cache = make_prefill_step(cfg)(params, batch)
        prefill = launch_counts()[0]
        seq = [logits]
        if cfg.is_decoder:
            cache, step = pad_kv_cache(cache, steps), make_serve_step(cfg)
            for i in range(steps):
                logits, cache = step(params, cache, tokens[:, 64 + i:65 + i], start + i)
                seq.append(logits)
        return torch.cat(seq, dim=1).cpu(), prefill, launch_counts()[0]

    with recorded(transformer) as calls:
        cpu_out, cpu_launches, _ = run(cpu)
    gpu_out, prefill, launches = run(gpu)
    diff = max_abs(gpu_out, cpu_out)
    want = attention_layers(cfg)
    what = f"prefill 4x64 + {steps} decode steps" if cfg.is_decoder else "encoder prefill 4x64"
    check(not any(cpu_launches.values()), f"{name}: the CPU run launched a kernel")
    check(prefill["flash_attention"] == want, f"{name}: the card's prefill launched "
          f"flash_attention {prefill['flash_attention']} times, want {want}")
    check(launches == prefill and not any(v for k, v in launches.items()
                                          if k != "flash_attention"),
          f"{name}: decode launched a kernel, or prefill another kernel: {launches}")
    try:
        worst = replay(calls, cfg, DEVICE, 1e-4)
    except AssertionError as exc:
        raise SmokeFailure(f"{name} reduced, block by block: {exc}") from None
    held = not cfg.mamba_slots
    log(f"  [{name} reduced, fp32] {what}, card vs CPU: each of {len(calls)} block calls on "
        f"the card from the CPU's inputs, max abs diff {worst:.3g} (limit 1e-4); the whole "
        f"model {diff:.3g} ({'limit 1e-4' if held else 'not held: Mamba state, LM_REFERENCE'})"
        f"; card launches of flash_attention {prefill['flash_attention']}")
    check(not held or diff <= 1e-4, f"{name} reduced: card and CPU differ by {diff:.3g}")
    return dict(max_diff=diff, block_max_diff=worst, launches=prefill["flash_attention"])


def fp32_copy(params: dict, layers: int = None) -> dict:
    """float32 copies of ``params`` (of their first ``layers`` stack rows)."""
    def cast(t):
        t = t if layers is None else t[:layers]
        return t.float() if t.is_floating_point() else t.clone()

    return {k: ({kind: {leaf: cast(t) for leaf, t in blk.items()} for kind, blk in v.items()}
                if k == "blocks" else v.float())
            for k, v in params.items()}


def lm_param_count(params: dict) -> int:
    return (sum(t.numel() for blk in params["blocks"].values() for t in blk.values())
            + sum(t.numel() for k, t in params.items() if k != "blocks"))


def device_profile(label: str, what: str, fn, rows: int = 5) -> dict:
    """One call of ``fn`` under torch.profiler: the card's busy time (the sum
    of its kernels' device time) against the call's wall time, and the
    ``rows`` kernels that took the most device time.  The profiler slows the
    host, so the busy share it gives is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = [(e.key[:60], round(e.self_device_time_total / 1e3, 3), e.count)
           for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:rows]]
    log(f"  [{label}] {what} under the profiler: device busy {busy_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall; most device time (kernel, ms, launches): {top}")
    return dict(busy_ms=busy_ms, wall_ms=wall_ms, top=top)


def serve_lm_run(label: str, cfg, params, batch, new_tokens: int) -> tuple:
    """One phase-9b run: a warm-up prefill, then from reset launch counts
    ``make_prefill_step`` on ``batch`` and ``new_tokens`` greedy decode steps
    (none for an encoder), timed.  Checks launches (flash_attention once per
    attention layer in prefill, no kernel in decode, no other kernel) and
    finite logits.  Returns ``(result dict, prefill logits, cache, launch
    shapes)``."""
    import torch

    from repro_torch.kernels.ops import reset_launch_counts
    from repro_torch.launch.serve import pad_kv_cache
    from repro_torch.models import make_prefill_step, make_serve_step

    prefill = make_prefill_step(cfg)
    prefill(params, batch)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches, _ = launch_counts()
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite prefill logits")
    sq = int(next(iter(batch.values())).shape[1]) + (
        cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    b = int(next(iter(batch.values())).shape[0])
    res = dict(prefill_ms=prefill_s * 1e3, prompt_tokens_per_s=b * sq / prefill_s,
               batch=b, prompt=sq, new_tokens=new_tokens if cfg.is_decoder else 0)
    decode_s = 0.0
    if cfg.is_decoder:
        cache = pad_kv_cache(cache, new_tokens)
        serve = make_serve_step(cfg)
        token = logits[:, -1:].argmax(dim=-1)
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(sq, sq + new_tokens):
            step_logits, cache = serve(params, cache, token, pos)
            token = step_logits.argmax(dim=-1)
            out.append(token)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        check(bool(torch.isfinite(step_logits).all()), f"{label}: non-finite decode logits")
        res["decode_profile"] = device_profile(
            label, "one decode step", lambda: serve(params, cache, token, sq + new_tokens - 1))
        res.update(decode_ms_per_token=decode_s / new_tokens * 1e3,
                   decode_tokens_per_s=b * new_tokens / decode_s,
                   generated_row0=torch.cat(out, dim=1)[0, :8].tolist())
    launches, shapes = launch_counts()
    res["prefill_profile"] = device_profile(label, "one prefill", lambda: prefill(params, batch))
    want = attention_layers(cfg)
    check(prefill_launches["flash_attention"] == want,
          f"{label}: prefill launched flash_attention {prefill_launches['flash_attention']} "
          f"times, want {want} (one per attention layer)")
    check(launches["flash_attention"] == want, f"{label}: decode launched flash_attention")
    check(not any(v for k, v in launches.items() if k != "flash_attention"),
          f"{label}: the LM path launched other kernels: {launches}")
    res.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
               shapes=shape_dict(shapes))
    log(f"  [{label}] prefill {b}x{sq}: {prefill_s * 1e3:.2f} ms ({res['prompt_tokens_per_s']:,.0f}"
        f" prompt tokens/s), flash_attention launched {prefill_launches['flash_attention']} "
        f"times at {dict(shapes['flash_attention'])}"
        + (f"; decode {new_tokens} steps x batch {b}: {decode_s * 1e3:.2f} ms, "
           f"{res['decode_ms_per_token']:.3f} ms/token, {res['decode_tokens_per_s']:,.1f} "
           f"tokens/s; generated tokens of row 0: {res['generated_row0']}..."
           if cfg.is_decoder else "; encoder-only: no decode")
        + f"; peak device memory {res['peak_gb']:.2f} GB")
    return res, logits, cache, shapes


# relative margin between two experts' router probabilities under which two
# fp32 runs of one model may pick differently (module note of RouteBook)
NEAR_TIE = 1e-4


class RouteBook:
    """Routing for phase 9b's fp32 MoE comparisons of two runs of one model
    (decode against the forward, the einsum path against the kernel's).
    Top-k routing is discontinuous: two experts whose probabilities differ by
    less than fp32 rounding can swap between two runs that round their
    inputs differently, and one swapped token moves every later position's
    logits through attention (qwen3-moe-30b-a3b, 2 layers, seed 0: token
    586's 8th and 9th probabilities 0.027098043 and 0.027098008 moved the
    prefill-vs-forward logits at position 2047 by 7.3e-3).  So the run
    compared takes the reference run's experts wherever the two pick
    differently on a near tie (relative margin at most NEAR_TIE), and the
    check fails where they differ by more.  ``record`` keeps the reference
    run's choices, ``follow(start)`` makes the next entry-point call, whose
    rows cover positions ``start..`` of the reference's, take them."""

    def __init__(self, rows: int):
        self.rows, self.ref, self.start, self.layer = rows, [], None, 0
        self.margins = []

    def record(self):
        self.start = None

    def follow(self, start: int):
        self.start, self.layer = start, 0

    def route(self, orig, cfg, h, router):
        import torch

        idx, w, probs = orig(cfg, h, router)
        if self.start is None:
            self.ref.append(idx.clone())
            return idx, w, probs
        ref = self.ref[self.layer]
        self.layer += 1
        K = idx.shape[1]
        seq = idx.shape[0] // self.rows
        want = ref.reshape(self.rows, -1, K)[:, self.start:self.start + seq].reshape(-1, K)
        differ = (idx.sort(-1).values != want.sort(-1).values).any(-1)
        for r in differ.nonzero().flatten().tolist():
            own, theirs = set(idx[r].tolist()), set(want[r].tolist())
            low = float(probs[r, sorted(own - theirs)].min())
            high = float(probs[r, sorted(theirs - own)].max())
            self.margins.append((low - high) / low)
            check(self.margins[-1] <= NEAR_TIE, f"routing differs beyond a near tie: token "
                  f"{r}, probabilities {low:.9g} against {high:.9g}")
        if not bool(differ.any()):
            return idx, w, probs
        idx = torch.where(differ[:, None], want, idx)
        w = probs.gather(1, idx)
        return idx, w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), probs

    def note(self) -> str:
        if not self.margins:
            return "routing identical"
        return (f"{len(self.margins)} near-tie routing swap(s) followed, largest relative "
                f"margin {max(self.margins):.3g}")


@contextlib.contextmanager
def routed(book: RouteBook):
    """Within the ``with``, every MoE routing goes through ``book``."""
    import repro_torch.models.moe as moe

    orig = moe._route
    moe._route = lambda cfg, h, router: book.route(orig, cfg, h, router)
    try:
        yield book
    finally:
        moe._route = orig


def fp32_lm_checks(label: str, cfg32, params32, tokens, batch, res: dict, prompt: int,
                   moe_batch: int = 4, kernel_vs_einsum: bool = True) -> None:
    """Phase 9b's fp32 checks (full width, 2 layers; jamba reduced): prefill
    logits with kernel 8 within 1e-4 of the einsum path; prefill then decode
    within 1e-3 of the forward (every decoder; at capacity_factor 64, so
    that no pick drops, on ``moe_batch`` rows; with Mamba blocks over the
    last 128 positions, the SSD chunk refusing a forward over 2049); for the
    MoE decoders the 32-slot ring buffer fed 48 tokens within 1e-3 of the
    windowed forward."""
    import dataclasses

    import torch

    from repro_torch.launch.serve import pad_kv_cache
    from repro_torch.models import forward, init_decode_cache, make_prefill_step, make_serve_step

    if cfg32.attn_slots and kernel_vs_einsum:
        book = RouteBook(tokens.shape[0])
        with routed(book):
            lk, _ = make_prefill_step(cfg32)(params32, batch)
            book.follow(0)
            le, _ = make_prefill_step(cfg32, use_kernel=False)(params32, batch)
        res["fp32_kernel_vs_einsum"] = max_abs(lk, le)
        log(f"  [{label}] fp32, 2 layers: prefill logits with kernel 8 vs the einsum path, "
            f"max abs {res['fp32_kernel_vs_einsum']:.3g} (limit 1e-4)"
            + (f"; {book.note()}" if cfg32.moe_slots else ""))
        check(res["fp32_kernel_vs_einsum"] <= 1e-4, f"{label}: fp32 prefill logits, kernel and "
              "einsum path disagree")
        del lk, le
    if not cfg32.is_decoder:
        return
    cfg64 = dataclasses.replace(cfg32, capacity_factor=64.0)
    P = cfg32.frontend_tokens if cfg32.frontend == "vision" else 0
    if cfg32.mamba_slots:  # forward over prompt, prefill over prompt - 128, 128 steps
        pre, steps, rows = prompt - 128, 128, slice(None)
    else:  # forward over prompt + 1, prefill over prompt, one step
        pre, steps, rows = prompt, 1, slice(0, moe_batch if cfg32.moe_slots else None)
    full_batch = dict(batch, tokens=tokens[rows, :pre + steps])
    if "patch_embeds" in batch:
        full_batch["patch_embeds"] = batch["patch_embeds"][rows]
    b = full_batch["tokens"].shape[0]
    book = RouteBook(b)
    with routed(book):
        full = forward(cfg64, params32, full_batch)
        pre_batch = dict(full_batch, tokens=full_batch["tokens"][:, :pre])
        book.follow(0)
        lp, cache = make_prefill_step(cfg64)(params32, pre_batch)
        gaps = [max_abs(lp[:, 0], full[:, P + pre - 1])]
        cache, step = pad_kv_cache(cache, steps), make_serve_step(cfg64)
        for i in range(steps):
            book.follow(P + pre + i)
            ld, cache = step(params32, cache, full_batch["tokens"][:, pre + i:pre + i + 1],
                             P + pre + i)
            gaps.append(max_abs(ld[:, 0], full[:, P + pre + i]))
    res["fp32_decode_vs_forward"] = max(gaps)
    log(f"  [{label}] fp32, 2 layers{', capacity_factor 64' if cfg32.moe_slots else ''}: "
        f"prefill({P + pre}) then {steps} decode step{'s' if steps > 1 else ''} vs "
        f"forward({P + pre + steps}), batch {b}, max abs over every decoded position "
        f"{res['fp32_decode_vs_forward']:.3g} (prefill vs forward {gaps[0]:.3g}; limit 1e-3)"
        + (f"; {book.note()}" if cfg32.moe_slots else ""))
    check(res["fp32_decode_vs_forward"] <= 1e-3, f"{label}: fp32 decode disagrees with the "
          "forward")
    del full, cache
    if cfg32.attn_slots and not cfg32.mamba_slots and cfg32.frontend is None:
        window, n = 32, 48
        book = RouteBook(tokens.shape[0])
        with routed(book):
            fw = forward(cfg64, params32, {"tokens": tokens[:, :n]}, window=window)
            ring = init_decode_cache(cfg64, tokens.shape[0], window, device=DEVICE)
            step_w = make_serve_step(cfg64, window=window)
            for pos in range(n):
                book.follow(pos)
                lw, ring = step_w(params32, ring, tokens[:, pos:pos + 1], pos)
        res["fp32_window_decode_vs_forward"] = max_abs(lw[:, 0], fw[:, -1])
        log(f"  [{label}] fp32, 2 layers, capacity_factor 64: window {window} ring buffer fed "
            f"{n} tokens through decode vs the windowed forward, max abs "
            f"{res['fp32_window_decode_vs_forward']:.3g} (limit 1e-3); {book.note()}")
        check(res["fp32_window_decode_vs_forward"] <= 1e-3, f"{label}: windowed decode "
              "disagrees with the windowed forward")
    torch.cuda.empty_cache()


# phase 9b: each configuration and what it runs at.  llava-next-34b's depth
# is cut to 16 of 60 layers (68.8 GB of bf16 weights at full depth leave no
# room for the rest of the phase); jamba-1.5-large-398b runs at reduced()
# size (one period of 8 layers at full width is 45.1B parameters, 90 GB)
LLAVA_LAYERS = 16
LM_FAMILIES = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "mamba2-1.3b", "hubert-xlarge",
               "llava-next-34b", "jamba-1.5-large-398b")


def param_gap(cfg) -> int:
    """The tree ``init_params`` draws, less ``param_count`` (ROADMAP.md §C,
    R7): the count is one ``d_inner`` vector a Mamba block short
    (``conv_b`` and ``gnorm`` are both that long), counts an MLP norm where
    ``d_ff`` is 0 and there is no MLP, and an embedding the audio model
    lacks."""
    gap = cfg.n_periods * len(cfg.mamba_slots) * cfg.d_inner
    if cfg.d_ff == 0:
        gap -= cfg.n_periods * (cfg.period - len(cfg.moe_slots)) * cfg.d_model
    return gap - (cfg.vocab * cfg.d_model if cfg.frontend == "audio" else 0)


def first_moe_input(cfg, params, batch):
    """The hidden state that enters the first MoE block of period 0."""
    import torch

    import repro_torch.models.transformer as tt

    with torch.inference_mode():
        x = tt._embed_inputs(cfg, params, batch)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        for mixer, m, ffn, f in tt._slot_rows(cfg):
            p = tt._take(params["blocks"], mixer, 0, m)
            x = (tt.attention_block(p, cfg, x, positions) if mixer == "attn"
                 else tt.mamba_block(p, cfg, x))
            if ffn == "moe":
                return x, tt._take(params["blocks"], "moe", 0, f)
            if ffn == "mlp":
                x = tt.mlp_block(tt._take(params["blocks"], "mlp", 0, f), cfg, x)
    raise ValueError(f"{cfg.name} has no MoE slot")


def run_lm_family(name: str, report: dict, seed: int):
    """Phase 9b, one configuration: weights from ``seed`` on the card, a 4 x
    2048 prompt (jamba reduced: 4 x 256) drawn with numpy, prefill and 32
    greedy decode steps from reset launch counts (serve_lm_run), the cache's
    shapes, then the configuration's own checks.  Returns the shapes each
    kernel was launched at."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, make_prefill_step, make_serve_step
    from repro_torch.models.moe import _capacity, moe_block, router_stats

    t_phase = time.perf_counter()
    full = get_arch(name)
    if name == "jamba-1.5-large-398b":
        cfg, label, prompt = full.reduced(), f"{name} reduced", 256
    elif name == "llava-next-34b":
        cfg = dataclasses.replace(full, name=f"{name}-{LLAVA_LAYERS}l", num_layers=LLAVA_LAYERS)
        label, prompt = f"{name}, {LLAVA_LAYERS} of {full.num_layers} layers", 2048
    else:
        cfg, label, prompt = full, name, 2048
    P = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed, DEVICE)
    torch.cuda.synchronize()
    n = lm_param_count(params)
    check(n == cfg.param_count() + param_gap(cfg), f"{label}: {n} parameters, config says "
          f"{cfg.param_count()} (+ {param_gap(cfg)})")
    log(f"  [{label}] {n:,} parameters ({n * (2 if cfg.dtype == 'bfloat16' else 4) / 1e9:.2f} "
        f"GB {cfg.dtype}; param_count {cfg.param_count():,}, the full config's "
        f"{full.param_count():,}) initialized on the card from seed {seed} in "
        f"{time.perf_counter() - t0:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    tokens, batch = lm_inputs(cfg, np.random.default_rng(seed), 4, prompt - P, 1)
    res, logits, cache, shapes = serve_lm_run(label, cfg, params, batch, 32)
    res.update(params=n, layers=cfg.num_layers, d_model=cfg.d_model, dtype=cfg.dtype)
    check(res["peak_gb"] * 1e9 < torch.cuda.get_device_properties(0).total_memory,
          f"{label}: peak memory over the card's")
    if not cfg.is_decoder:
        check(tuple(logits.shape) == (4, prompt, cfg.vocab) and cache == {},
              f"{label}: encoder prefill gave {tuple(logits.shape)} and a cache {list(cache)}")
        try:
            make_serve_step(cfg)
        except ValueError:
            pass
        else:
            raise SmokeFailure(f"{label}: make_serve_step did not refuse an encoder")
    if cfg.attn_slots and cfg.is_decoder:
        want = (cfg.n_periods, len(cfg.attn_slots), 4, prompt + 32, cfg.num_kv_heads, cfg.hd)
        check(tuple(cache["k"].shape) == want, f"{label}: k cache {tuple(cache['k'].shape)}")
    if cfg.mamba_slots:
        nm = len(cfg.mamba_slots)
        check(tuple(cache["conv"].shape) == (cfg.n_periods, nm, 4, cfg.ssm_conv - 1, cfg.d_inner)
              and tuple(cache["ssm"].shape) == (cfg.n_periods, nm, 4, cfg.ssm_heads,
                                                cfg.ssm_head_dim, cfg.ssm_state)
              and cache["ssm"].dtype == torch.float32,
              f"{label}: conv {tuple(cache['conv'].shape)}, ssm {tuple(cache['ssm'].shape)} "
              f"{cache['ssm'].dtype}")
    log(f"  [{label}] cache " + ", ".join(f"{k} {list(c.shape)} {c.dtype}"
                                          for k, c in cache.items()))
    del cache
    if cfg.moe_slots:
        x, pm = first_moe_input(cfg, params, batch)
        with torch.inference_mode():
            _, aux = moe_block(pm, cfg, x, return_aux=True)
            st = router_stats(cfg, pm, x)
        T, E, K = x.shape[0] * x.shape[1], cfg.moe_experts, cfg.moe_topk
        C = _capacity(cfg, T)
        kept = round((1 - float(aux["dropped"])) * E * C)
        load = st["expert_load"]
        res.update(dropped_slots=float(aux["dropped"]), kept_picks=kept / (T * K),
                   expert_load_max=float(load.max()), expert_load_min=float(load.min()),
                   router_entropy=float(st["entropy"]))
        log(f"  [{label}] first MoE layer at capacity_factor {cfg.capacity_factor}: {T} tokens "
            f"x top-{K} over {E} experts, capacity {C}; picks kept {kept} of {T * K} "
            f"({kept / (T * K):.4f}); empty capacity slots (\"dropped\") "
            f"{float(aux['dropped']):.4f}; expert load min / max {float(load.min()):.4f} / "
            f"{float(load.max()):.4f} (uniform {1 / E:.4f}); router entropy "
            f"{float(st['entropy']):.4f} (ln E = {math.log(E):.4f})")
        del x, pm  # pm's rows are views that hold every MoE leaf
    # the fp32 checks run at full width on the first 2 layers of the same
    # weights (jamba reduced: as it is, fp32 already)
    if cfg.dtype == "bfloat16":
        cfg32 = dataclasses.replace(cfg, name=f"{cfg.name}-2l-fp32", num_layers=2,
                                    dtype="float32")
        params32 = fp32_copy(params, 2)
    else:
        cfg32, params32 = cfg, params
    if name in ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "mamba2-1.3b"):
        # bf16 against the fp32 answer for the same weights: printed, not
        # held (routing is discontinuous: bf16 sends tokens to other experts);
        # qwen3-moe on 2 layers (122 GB in fp32 at full depth)
        if name == "qwen3-moe-30b-a3b":
            cfg_b = dataclasses.replace(cfg, num_layers=2)
            part = {k: ({kind: {leaf: t[:2] for leaf, t in blk.items()}
                         for kind, blk in v.items()} if k == "blocks" else v)
                    for k, v in params.items()}
            lk = make_prefill_step(cfg_b)(part, batch)[0]
            le = make_prefill_step(cfg_b, use_kernel=False)(part, batch)[0]
            exact_params, cfg_e = params32, cfg32
            del part
        else:
            cfg_b, lk = cfg, logits
            le = (make_prefill_step(cfg, use_kernel=False)(params, batch)[0]
                  if cfg.attn_slots else None)
            exact_params, cfg_e = fp32_copy(params), dataclasses.replace(cfg, dtype="float32")
        exact = make_prefill_step(cfg_e, use_kernel=False)(exact_params, batch)[0]
        res["bf16_layers"] = cfg_b.num_layers
        res["bf16_kernel_vs_exact"] = rel_frobenius(lk, exact)
        if le is not None:
            res["bf16_einsum_vs_exact"] = rel_frobenius(le, exact)
        log(f"  [{label}] bf16, {cfg_b.num_layers} layers, prefill logits against the fp32 "
            f"answer for the same weights, relative Frobenius: "
            + (f"kernel path {res['bf16_kernel_vs_exact']:.4g}, einsum path "
               f"{res['bf16_einsum_vs_exact']:.4g}" if le is not None
               else f"{res['bf16_kernel_vs_exact']:.4g} (no attention)")
            + " (printed, not held)")
        del lk, le, exact, exact_params
    del params, logits
    torch.cuda.empty_cache()
    # jamba: no kernel-vs-einsum comparison of its 16 layers (LM_REFERENCE)
    fp32_lm_checks(label, cfg32, params32, tokens, batch, res, prompt - P, moe_batch=1,
                   kernel_vs_einsum=name != "jamba-1.5-large-398b")
    del params32
    torch.cuda.empty_cache()
    report.setdefault("lm_families", {})[name] = res
    log(f"  ({time.perf_counter() - t_phase:.1f} s phase)")
    return shapes


# --------------------------------------------------------------------------
# the slice
# --------------------------------------------------------------------------


def session_config(scale: float, batch_size: int = 1024, model: str = "rgcn",
                   executor: str = "raf_spmd", fuse_epilogue: bool = True,
                   pipeline=None, learnable: bool = True, dp=None):
    from repro_torch.api import DataConfig, HetaConfig, ModelConfig

    cfg = HetaConfig(
        data=DataConfig(dataset="ogbn-mag", scale=scale, fanouts=(4, 3),
                        batch_size=batch_size),
        model=ModelConfig(model=model, train_learnable=learnable),
    ).updated(run=dict(executor=executor), kernels=dict(fuse_epilogue=fuse_epilogue))
    if dp is not None:
        cfg = cfg.updated(scale=dp)
    return cfg if pipeline is None else cfg.updated(pipeline=dict(enabled=True, **pipeline))


def build_session(scale: float, device, max_degree: int = 16, batch_size: int = 1024,
                  model: str = "rgcn", executor: str = "raf_spmd", fuse_epilogue: bool = True,
                  graph=None, pipeline=None, learnable: bool = True, dp=None):
    """A compiled session; ``graph`` reuses a graph built (and bounded)
    before; ``pipeline`` (a dict of ``PipelineConfig`` fields) turns the
    host pipeline on; ``dp`` (a dict of ``ScaleConfig`` fields) the
    data-parallel tier."""
    from repro_torch.api import Heta
    from repro_torch.serve import bounded_graph

    sess = Heta(session_config(scale, batch_size, model, executor, fuse_epilogue, pipeline,
                               learnable, dp),
                device=device)
    g = graph if graph is not None else bounded_graph(sess.build_graph(), max_degree)
    sess.build_graph(g)
    sess.partition()
    sess.profile_and_cache()
    sess.compile()
    return sess, g


def count_all_hit_fetches(cache) -> dict:
    """Per node type, how many of the cache's fetches were all hits (the
    fetches that go through the gather kernel).  Wraps ``cache.fetch`` on
    this one instance."""
    import collections

    counts = collections.Counter()
    fetch = cache.fetch

    def counted(ntype, nids):
        c = cache.caches.get(ntype)
        if c is not None and len(nids) and bool((c.slot_of[nids] >= 0).all()):
            counts[ntype] += 1
        return fetch(ntype, nids)

    cache.fetch = counted
    return counts


def drive_server(name, server, store, n_target, seed, requests=512, retries=0):
    import numpy as np
    import torch

    from repro_torch.launch.serve import run_clients

    answers, wall = run_clients(server, n_target, requests, 8, 4, seed)
    stats = server.stats()
    check(len(answers) == requests, f"{name}: {len(answers)} answers for {requests} requests")
    w = torch.from_numpy(store.head["w"]).double()
    b = torch.from_numpy(store.head["b"]).double()
    emb = store.embeddings[store.target_type]
    for nids, res in answers:
        check(np.array_equal(res.embeddings, emb[nids]),
              f"{name}: answer rows differ from the store's")
        plain = (torch.relu(torch.from_numpy(emb[nids]).double()) @ w + b).numpy()
        check(res.scores is not None and res.scores.shape == plain.shape,
              f"{name}: missing or misshapen scores")
        check(bool(np.allclose(res.scores, plain, **TOL)),
              f"{name}: scores differ from relu(e) @ w + b "
              f"(max abs err {np.abs(res.scores - plain).max():.3g})")
    check(stats.degraded == 0 and stats.retries == retries and stats.breaker_trips == 0,
          f"{name}: degraded={stats.degraded} retries={stats.retries} (expected {retries}) "
          f"breaker_trips={stats.breaker_trips}")
    check(server.cache.consistency_check(),
          f"{name}: the cache broke the non-replicative invariant (duplicate slots or a "
          "shard off the mod-hash rule)")
    log(f"  {name}: {stats.count} requests in {wall:.3f} s wall, "
        f"{stats.flushes} flushes, p50={stats.p50_ms:.3f} ms p99={stats.p99_ms:.3f} ms "
        f"qps={stats.qps:.1f}; hit rates "
        + ", ".join(f"{t}={r:.4f}" for t, r in sorted(stats.hit_rates.items())))
    return dict(count=stats.count, flushes=stats.flushes, wall_s=wall,
                p50_ms=stats.p50_ms, p99_ms=stats.p99_ms, qps=stats.qps,
                hit_rates=stats.hit_rates, consistency_check=True)


def launch_counts():
    from repro_torch.kernels.ops import KERNELS

    return ({name: info.launches for name, info in KERNELS.items()},
            {name: info.shapes.copy() for name, info in KERNELS.items()})


# the kernels each model's training fit must launch
TRAIN_KERNELS = {
    "rgcn": ("stacked_mean_linear", "stacked_mean_linear_dh", "gather_rows"),
    # the attention models' q side runs stacked_mean_linear at f = 1
    "rgat": ("stacked_attn_epilogue", "stacked_attn_dh", "stacked_mean_linear",
             "stacked_mean_linear_dh"),
    "hgt": ("stacked_attn_epilogue", "stacked_attn_dh", "stacked_mean_linear",
            "stacked_mean_linear_dh"),
}


# and with frozen tables: no gradient flows into the gathered features, so
# the backward kernels run only where the input is a hidden state (R-GCN's
# kernel 2 and HGT's kernel 5 at the top level); the attention models' q
# side reads gathered features at every level, so its kernel 2 never runs
FROZEN_KERNELS = {
    "rgcn": ("stacked_mean_linear", "stacked_mean_linear_dh"),
    "rgat": ("stacked_attn_epilogue", "stacked_attn_dh", "stacked_mean_linear"),
    "hgt": ("stacked_attn_epilogue", "stacked_attn_dh", "stacked_mean_linear"),
}


def shape_dict(shapes):
    return {k: {str(x): c for x, c in v.items()} for k, v in shapes.items()}


def run_training(scale: float, report: dict, ckpt_dir, model: str = "rgcn"):
    """Phase 4/4b: one model's training path, from reset launch counts.
    Saves a checkpoint at step 10 into ``ckpt_dir`` (if given).  Returns the
    trained session, its graph and the shapes each kernel was launched at."""
    import numpy as np

    from repro_torch.kernels.ops import reset_launch_counts

    t0 = time.perf_counter()
    sess, g = build_session(scale, None, model=model)
    check(sess.device.type == "cuda", f"session landed on {sess.device}")
    check(sess.plan.learn_feats, "learnable tables are not training")
    log(f"  [{model}] graph {g.name}: {g.total_nodes:,} nodes, {g.total_edges:,} edges, "
        f"paper features {g.features['paper'].nbytes / 2**20:.1f} MiB; learnable "
        f"{sorted(sess.engine.learnable_types)}; cache {sess.config.cache.cache_mb} MiB "
        f"{dict(sess.engine.allocation.rows)}")
    steps = sess.config.run.steps
    all_hit = count_all_hit_fetches(sess.engine.cache)
    reset_launch_counts()
    t1 = time.perf_counter()
    sess.fit(steps // 2)
    if ckpt_dir is not None:
        sess.save(ckpt_dir)
    res = sess.fit(steps - steps // 2)
    launches, shapes = launch_counts()
    t_fit = time.perf_counter() - t1
    losses = res["losses"]
    check(len(losses) == steps, f"{len(losses)} losses for {steps} steps")
    check(bool(np.isfinite(losses).all()), f"non-finite losses {losses}")
    for name in TRAIN_KERNELS[model]:
        check(launches[name] > 0, f"kernel {name} was not launched by the {model} fit")
    # the synthetic labels are uniform random, so the loss of a fresh batch
    # stays near ln(classes) whatever the model learns; what training must
    # lower is the loss of a batch it has trained on: step 0's, re-scored
    first_after, _ = sess.executor.loss_and_metrics(sess, sess.plan, sess.state,
                                                    sess._batch_for_step(0))
    check(first_after < losses[0],
          f"{model}: step 0's batch scores {first_after} after the fit, {losses[0]} before")
    ev = sess.evaluate(num_batches=2)
    check(bool(np.isfinite(ev["loss"])), f"{model}: evaluate gave {ev['loss']}")
    n = len(sess.step_times)
    log(f"  [{model}] fit: {steps} steps in {t_fit:.3f} s wall; losses {losses[0]:.6f} -> "
        f"{losses[-1]:.6f} (ln {g.num_classes} = {math.log(g.num_classes):.6f}); step 0's "
        f"batch re-scored after the fit {first_after:.6f}; evaluate loss {ev['loss']:.6f}")
    log(f"  [{model}] median of steps 2..{n - 1}: step {res['step_time_s'] * 1e3:.3f} ms "
        f"(sparse update {res['update_time_s'] * 1e3:.3f} ms), host sample+stage "
        f"{res['host_time_s'] * 1e3:.3f} ms; samples/s {res['samples_per_s']:.1f}")
    log(f"  [{model}] per step (ms) step/update/host: " + "; ".join(
        f"{a * 1e3:.1f}/{b * 1e3:.1f}/{c * 1e3:.1f}" for a, b, c in
        zip(sess.step_times, sess.update_times, sess.host_times)))
    log(f"  [{model}] hit rates "
        + ", ".join(f"{t}={r:.4f}" for t, r in sorted(res["hit_rates"].items()))
        + f"; engine steps {sess.engine.steps}")
    log(f"  [{model}] kernel launches by fit: {launches}; all-hit fetches (gather_rows) by "
        f"type: {dict(all_hit)}")
    if model != "rgcn":
        log(f"  [{model}] the q side (stacked_mean_linear at f = 1 and its backward) added "
            f"{launches['stacked_mean_linear']} and {launches['stacked_mean_linear_dh']} "
            f"launches; shapes {dict(shapes['stacked_mean_linear'])}")
    log(f"  [{model}] stage seconds: "
        + ", ".join(f"{k}={v:.3f}" for k, v in sess.stage_times.items())
        + f" ({time.perf_counter() - t0:.1f} s phase)")
    report.setdefault("training", {})[model] = dict(
        scale=scale, nodes=g.total_nodes, edges=g.total_edges, steps=steps,
        batch_size=sess.config.data.batch_size, losses=losses, eval_loss=ev["loss"],
        first_batch_after=first_after,
        fit_wall_s=t_fit, step_time_s=res["step_time_s"], host_time_s=res["host_time_s"],
        update_time_s=res["update_time_s"], samples_per_s=res["samples_per_s"],
        overlap_fraction=res["overlap_fraction"], step_times=list(sess.step_times),
        host_times=list(sess.host_times), update_times=list(sess.update_times),
        hit_rates=res["hit_rates"], engine_steps=dict(sess.engine.steps),
        all_hit_fetches=dict(all_hit), launches=launches, shapes=shape_dict(shapes),
        stage_times=dict(sess.stage_times))
    return sess, g, shapes


def run_resume(scale: float, report: dict, ckpt_dir: str, losses, model: str = "rgcn"):
    """Phase 5/5b: a fresh session restores the mid-run checkpoint and
    trains to the end; its losses must be the uninterrupted run's, bit for
    bit."""
    sess, _ = build_session(scale, None, model=model)
    step = sess.restore(ckpt_dir)
    sess.fit(len(losses) - step)
    tail, want = sess.losses, list(losses[step:])
    diff = max(abs(a - b) for a, b in zip(tail, want))
    log(f"  [{model}] restored step {step}, trained to {step + len(tail)}: max |loss diff| "
        f"{diff:.3g} against the uninterrupted run")
    check(tail == want, f"{model}: resumed losses {tail} differ from {want}")
    report.setdefault("resume", {})[model] = dict(step=step, losses=tail, max_diff=diff)


def run_serving(sess, g, report: dict, model: str = "rgcn"):
    """Phase 6/6b: infer_all and the servers on one trained state, from
    reset launch counts.  Returns the shapes each kernel was launched at."""
    import numpy as np
    import torch

    from repro_torch.kernels.ops import reset_launch_counts
    from repro_torch.serve.server import EmbeddingServer

    reset_launch_counts()
    t0 = time.perf_counter()
    store = sess.infer_all()
    torch.cuda.synchronize()
    t_infer = time.perf_counter() - t0
    n_emb = sum(a.shape[0] for a in store.embeddings.values())
    for t, a in store.embeddings.items():
        check(a.shape == (g.num_nodes[t], sess.hgnn_cfg.hidden),
              f"{model}: store[{t}] has shape {a.shape}")
        check(bool(np.isfinite(a).all()), f"{model}: store[{t}] holds non-finite values")
    check(store.target_type in store.embeddings, f"{model}: no target-type embeddings")
    tm = store.timings
    log(f"  [{model}] infer_all: {n_emb:,} embeddings of {len(store.embeddings)} types in "
        f"{t_infer:.3f} s ({t_infer / n_emb * 1e6:.3f} us/node); "
        f"{int(tm['blocks'])} blocks: host gather {tm['host_gather_s']:.3f} s, "
        f"h2d {tm['h2d_s']:.3f} s, compute {tm['compute_s']:.3f} s, "
        f"d2h {tm['d2h_s']:.3f} s")
    full = sess.evaluate(num_batches=2, use_full_graph=True)
    check(bool(np.isfinite(full["loss"])), f"{model}: full-graph evaluate gave {full['loss']}")

    n_target = g.num_nodes[g.target_type]
    full_mb = math.ceil(len(store.embeddings) * n_target * store.hidden * 4 / 2**20) + 1
    with EmbeddingServer(store, cache_mb=full_mb, kernels=sess.config.kernels) as srv:
        check(srv.cache.caches[store.target_type].ids.shape[0] == n_target,
              f"{model}: the all-hit server does not cache the whole target table")
        all_hit = drive_server(f"[{model}] server cache_mb={full_mb} (all hits)", srv, store,
                               n_target, seed=1)
    check(all_hit["hit_rates"][store.target_type] == 1.0, f"{model}: all-hit server missed")
    mixed = None
    if model == "rgcn":
        mixed = drive_server(f"[{model}] server cache_mb={sess.config.serve.cache_mb} (mixed)",
                             sess.serve(), store, n_target, seed=2)
        sess.close_serving()
    launches, shapes = launch_counts()
    log(f"  [{model}] kernel launches by serving: {launches} "
        f"({time.perf_counter() - t0:.1f} s)")
    agg = "stacked_mean_linear" if model == "rgcn" else "stacked_attn_epilogue"
    for name in (agg, "gather_rows"):
        check(launches[name] > 0, f"kernel {name} was not launched by {model} serving")
    if model != "rgcn":
        res = [x for x in shapes["stacked_attn_epilogue"] if x[-1]]
        check(not res, f"{model} serving asked the epilogue for residuals at {res}")
        check(launches["stacked_attn_dh"] == 0, f"{model} serving ran a backward")
    report.setdefault("serving", {})[model] = dict(
        target_rows=n_target, embeddings=n_emb, infer_all_s=t_infer,
        infer_us_per_node=t_infer / n_emb * 1e6, timings=dict(tm),
        full_graph_eval_loss=full["loss"], server_all_hit=all_hit, server_mixed=mixed,
        launches=launches, shapes=shape_dict(shapes))
    return shapes


def dense_breakdown(sess, batch, reps: int = 10) -> dict:
    """Median ms of the parts of one dense-bundle step on ``batch``, each
    ended by a device synchronize: host staging (index arrays to the
    device), forward, backward, Adam over the whole bundle.  The results
    are dropped: the session's state does not change."""
    import numpy as np
    import torch

    from repro_torch.api.executors import _bundle_grads, _trainable
    from repro_torch.optim.adam import adam_update, tree_leaves

    parts = {"stage": [], "forward": [], "backward": [], "adam": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arrs = sess.executor.stage(sess, sess.plan, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bundle = _trainable(sess.state["bundle"])
        loss = sess.plan.loss(bundle, arrs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        grads = _bundle_grads(bundle, loss)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        with torch.no_grad():
            adam_update(sess.adam_cfg, bundle, grads, sess.state["opt"])
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, a, b in (("stage", t0, t1), ("forward", t1, t2), ("backward", t2, t3),
                        ("adam", t3, t4)):
            parts[k].append((b - a) * 1e3)
    out = {k: float(np.median(v)) for k, v in parts.items()}
    out["leaves"] = len(tree_leaves(sess.state["bundle"]))
    out["bundle_mb"] = sum(t.numel() * t.element_size()
                           for t in tree_leaves(sess.state["bundle"])) / 1e6
    return out


def run_dense(scale: float, report: dict, graph) -> dict:
    """Phase 4c: R-GCN at full width through the dict-form executors on the
    card, from reset launch counts: vanilla (the oracle, which by the
    reference's design launches no aggregation kernel), then raf (kernel 6
    once per metatree branch and step), saving at the half way step; then a
    fresh raf session resumes from it.  Returns the shapes the raf fit
    launched each kernel at."""
    import numpy as np
    import torch

    from repro_torch.kernels.ops import reset_launch_counts

    runs, shapes_raf = {}, None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        for executor in ("vanilla", "raf"):
            t0 = time.perf_counter()
            sess, _ = build_session(scale, None, executor=executor, graph=graph)
            check(sess.device.type == "cuda", f"{executor} session landed on {sess.device}")
            check(set(sess.state["bundle"]["embed"]) == set(sess.engine.learnable_types),
                  f"{executor}: the learnable tables are not training in the bundle")
            steps = sess.config.run.steps
            reset_launch_counts()
            t1 = time.perf_counter()
            sess.fit(steps // 2)
            if executor == "raf":
                sess.save(ckpt_dir)
            res = sess.fit(steps - steps // 2)
            torch.cuda.synchronize()
            launches, shapes = launch_counts()
            t_fit = time.perf_counter() - t1
            losses = res["losses"]
            check(len(losses) == steps and bool(np.isfinite(losses).all()),
                  f"{executor}: losses {losses}")
            branches = sum(len(lv) for lv in sess.spec.levels)
            if executor == "raf":
                check(launches["relation_agg"] == steps * branches,
                      f"raf launched relation_agg {launches['relation_agg']} times in {steps} "
                      f"steps of {branches} branches")
                check(not any(v for k, v in launches.items() if k != "relation_agg"),
                      f"raf launched other kernels: {launches}")
                shapes_raf = shapes
            else:
                check(not any(launches.values()), f"vanilla launched kernels: {launches}")
            first_after, _ = sess.executor.loss_and_metrics(sess, sess.plan, sess.state,
                                                            sess._batch_for_step(0))
            check(first_after < losses[0],
                  f"{executor}: step 0's batch scores {first_after} after the fit, "
                  f"{losses[0]} before")
            n = len(sess.step_times)
            log(f"  [rgcn {executor}] fit: {steps} steps in {t_fit:.3f} s wall; losses "
                f"{losses[0]:.6f} -> {losses[-1]:.6f}; step 0's batch re-scored after the fit "
                f"{first_after:.6f}; {branches} branches a step")
            log(f"  [rgcn {executor}] median of steps 2..{n - 1}: step "
                f"{res['step_time_s'] * 1e3:.3f} ms, host sample+stage "
                f"{res['host_time_s'] * 1e3:.3f} ms; samples/s {res['samples_per_s']:.1f}; "
                f"launches {dict((k, v) for k, v in launches.items() if v)}; shapes "
                f"{dict(shapes['relation_agg'])} ({time.perf_counter() - t0:.1f} s phase)")
            log(f"  [rgcn {executor}] per step (ms) step/host: " + "; ".join(
                f"{a * 1e3:.1f}/{b * 1e3:.1f}" for a, b in zip(sess.step_times, sess.host_times)))
            parts = dense_breakdown(sess, sess._batch_for_step(0))
            log(f"  [rgcn {executor}] one step's parts, median ms of 10: stage "
                f"{parts['stage']:.3f}, forward {parts['forward']:.3f}, backward "
                f"{parts['backward']:.3f}, Adam {parts['adam']:.3f} over {parts['leaves']} "
                f"leaves ({parts['bundle_mb']:.1f} MB of parameters)")
            runs[executor] = dict(
                losses=losses, first_batch_after=first_after, fit_wall_s=t_fit,
                step_time_s=res["step_time_s"], host_time_s=res["host_time_s"],
                step_times=list(sess.step_times), host_times=list(sess.host_times),
                launches=launches, shapes=shape_dict(shapes), branches=branches,
                breakdown_ms=parts)
            if executor == "raf":
                comm = sess.comm_report()
                log("  [rgcn] comm_report (bytes per batch of "
                    f"{sess.config.data.batch_size}): " + ", ".join(
                        f"{k}={v}" for k, v in comm.items()))
                runs["comm_report"] = comm
            del sess
        lv, lr = runs["vanilla"]["losses"], runs["raf"]["losses"]
        gap3 = max(abs(a - b) for a, b in zip(lv[:3], lr[:3]))
        gap = max(abs(a - b) for a, b in zip(lv, lr))
        log(f"  [rgcn] Prop 1: vanilla and raf first 3 losses within {gap3:.3g}, all "
            f"{len(lv)} within {gap:.3g}")
        check(gap3 <= TOL["atol"], f"vanilla and raf first 3 losses differ by {gap3:.3g}")
        resumed, _ = build_session(scale, None, executor="raf", graph=graph)
        step = resumed.restore(ckpt_dir)
        resumed.fit(len(lr) - step)
        tail, want = resumed.losses, list(lr[step:])
        diff = max(abs(a - b) for a, b in zip(tail, want))
        bitwise = tail == want
        log(f"  [rgcn raf] restored step {step}, trained to {step + len(tail)}: "
            f"{'bit for bit' if bitwise else 'not bit for bit'}, max |loss diff| {diff:.3g}")
        check(bitwise or diff <= 1e-6, f"raf resume: losses {tail} differ from {want}")
    report["dense"] = dict(runs, prop1_gap3=gap3, prop1_gap=gap,
                           resume=dict(step=step, losses=tail, bitwise=bitwise, max_diff=diff))
    return shapes_raf


class OperandLayouts:
    """While open, records the layout in which e and v reach kernel 3's
    forward: per operand, whether it is contiguous and the order of its
    dimensions in memory (outermost first)."""

    def __init__(self):
        self.seen = collections.Counter()

    def __enter__(self):
        from repro_torch.kernels.stacked_relation_agg import ops as sra

        inner = self._inner = sra.softmax_combine_forward

        def spy(e, mask, v):
            for name, t in (("e", e), ("v", v)):
                order = tuple(sorted(range(t.dim()), key=lambda d: (-t.stride(d), d)))
                self.seen[(name, t.is_contiguous(), order)] += 1
            return inner(e, mask, v)

        sra.softmax_combine_forward = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.stacked_relation_agg import ops as sra

        sra.softmax_combine_forward = self._inner

    def summary(self) -> dict:
        return {f"{name} {'contiguous' if c else 'permuted'} {list(o)}": k
                for (name, c, o), k in sorted(self.seen.items())}


def run_unfused(scale: float, report: dict, graph, model: str, fused_losses):
    """Phase 4d: R-GAT or HGT through raf_spmd with fuse_epilogue=False
    (the attn_parts projections, then kernel 3) from reset launch counts;
    then infer_all, fused and unfused, on the trained state.  Returns the
    shapes the fit and the unfused infer_all launched each kernel at."""
    import numpy as np
    import torch

    from repro_torch.kernels.ops import reset_launch_counts

    t0 = time.perf_counter()
    sess, _ = build_session(scale, None, model=model, fuse_epilogue=False, graph=graph)
    steps = sess.config.run.steps
    reset_launch_counts()
    with OperandLayouts() as fit_layouts:
        res = sess.fit(steps)
        torch.cuda.synchronize()
    launches, shapes = launch_counts()
    losses = res["losses"]
    check(len(losses) == steps and bool(np.isfinite(losses).all()), f"{model}: {losses}")
    check(launches["stacked_softmax_combine"] > 0, f"{model} unfused: kernel 3 not launched")
    check(launches["stacked_attn_epilogue"] == 0 and launches["stacked_attn_dh"] == 0,
          f"{model} unfused launched the fused kernels: {launches}")
    gap3 = max(abs(a - b) for a, b in zip(losses[:3], fused_losses[:3]))
    gap = max(abs(a - b) for a, b in zip(losses, fused_losses))
    log(f"  [{model} unfused] fit: {steps} steps, losses {losses[0]:.6f} -> {losses[-1]:.6f}; "
        f"against the fused run: first 3 within {gap3:.3g}, all within {gap:.3g}")
    log(f"  [{model} unfused] median of steps 2..{steps - 1}: step "
        f"{res['step_time_s'] * 1e3:.3f} ms (sparse update {res['update_time_s'] * 1e3:.3f} "
        f"ms), host {res['host_time_s'] * 1e3:.3f} ms; launches "
        f"{dict((k, v) for k, v in launches.items() if v)}; kernel 3 shapes "
        f"{dict(shapes['stacked_softmax_combine'])}")
    check(gap3 <= TOL["atol"], f"{model}: unfused and fused first 3 losses differ by {gap3:.3g}")
    sess.config = sess.config.updated(kernels=dict(fuse_epilogue=True))
    fused = sess.infer_all()
    sess.config = sess.config.updated(kernels=dict(fuse_epilogue=False))
    reset_launch_counts()
    with OperandLayouts() as infer_layouts:
        t1 = time.perf_counter()
        store = sess.infer_all()
        torch.cuda.synchronize()
        t_infer = time.perf_counter() - t1
    s_launches, s_shapes = launch_counts()
    layouts = dict(training=fit_layouts.summary(), infer_all=infer_layouts.summary())
    log(f"  [{model} unfused] e and v as they reach kernel 3 (memory order of [rb, n, f, "
        f"nh(, dh)], launches): training {layouts['training']}; infer_all "
        f"{layouts['infer_all']}")
    check(any(x[2] == 16 for x in s_shapes["stacked_softmax_combine"]),
          f"{model} unfused infer_all: no kernel 3 launch at f = 16 "
          f"({dict(s_shapes['stacked_softmax_combine'])})")
    check(s_launches["stacked_attn_epilogue"] == 0, f"{model} unfused infer_all ran kernel 4")
    worst = 0.0
    for t, a in fused.embeddings.items():
        b = store.embeddings[t]
        check(bool(np.allclose(b, a, **TOL)), f"{model}: unfused infer_all of {t} differs")
        worst = max(worst, float(np.abs(a - b).max()))
    tm = store.timings
    log(f"  [{model} unfused] infer_all {t_infer:.3f} s (host gather {tm['host_gather_s']:.3f}, "
        f"h2d {tm['h2d_s']:.3f}, compute {tm['compute_s']:.3f}, d2h {tm['d2h_s']:.3f}); "
        f"against the fused store on this state: max abs diff {worst:.3g}; launches "
        f"{dict((k, v) for k, v in s_launches.items() if v)} ({time.perf_counter() - t0:.1f} s "
        "phase)")
    sess.close_serving()
    report.setdefault("unfused", {})[model] = dict(
        losses=losses, gap3=gap3, gap=gap, step_time_s=res["step_time_s"],
        host_time_s=res["host_time_s"], update_time_s=res["update_time_s"],
        launches=launches, shapes=shape_dict(shapes), infer_all_s=t_infer,
        infer_timings=dict(tm), infer_max_diff=worst, infer_launches=s_launches,
        infer_shapes=shape_dict(s_shapes), operand_layouts=layouts)
    return shapes, s_shapes


PIPE_WORKERS = 2  # phase 4e's sampler processes


def own_segments() -> list:
    """This process's shared-memory segments (the port's prefix and pid)."""
    import os

    from repro_torch.graph.shm import live_segments

    return live_segments(f"heta-tshm-{os.getpid():x}-")


def pipelined_fit(label: str, scale: float, graph, report: dict, pipeline=None,
                  learnable: bool = True, model: str = "rgcn", fits=(20,),
                  fault_plan=None, shapes_acc=None):
    """One phase-4e fit: a session on the card with the host pipeline as
    ``pipeline`` says (None: the serial loop), trained ``fits`` (one fit
    per entry, from reset launch counts, read after the last), its metrics
    printed.  Besides the fit's wall time (which holds a pool's start: the
    shm export and the spawn of its workers) it times the steady rate, the
    wall time from the end of step 1 to the end of the last step over the
    steps between, and the first step's latency.  Returns the session, its
    result dict and the pool each fit drew from; the caller closes the
    session's pipeline."""
    import numpy as np
    import torch

    from repro_torch.kernels.ops import reset_launch_counts

    t0 = time.perf_counter()
    sess, _ = build_session(scale, None, model=model, graph=graph, pipeline=pipeline,
                            learnable=learnable)
    check(sess.device.type == "cuda", f"{label}: session landed on {sess.device}")
    check(sess.plan.learn_feats == learnable, f"{label}: learn_feats {sess.plan.learn_feats}")
    sess.fault_plan = fault_plan
    stamps = []  # the wall clock at the end of each consumed step
    record = sess._record

    def stamped(*args):
        loss = record(*args)
        stamps.append(time.perf_counter())
        return loss

    sess._record = stamped
    reset_launch_counts()
    t1 = time.perf_counter()
    pools = []
    for n in fits:
        res = sess.fit(n)
        if sess._pool_cache is not None:
            pools.append(sess._pool_cache[2])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches, shapes = launch_counts()
    if shapes_acc is not None:
        for name, c in shapes.items():
            shapes_acc.setdefault(name, collections.Counter()).update(c)
    losses = res["losses"]
    steps = sum(fits)
    check(len(losses) == steps and bool(np.isfinite(losses).all()),
          f"{label}: losses {losses}")
    need = TRAIN_KERNELS[model] if learnable else FROZEN_KERNELS[model]
    for name in need:
        check(launches[name] > 0, f"kernel {name} was not launched by {label}")
    rep = np.median(sess.republish_times) * 1e3 if sess.republish_times else None
    restarts = list(pools[-1].restarts) if pools else []
    steady = (stamps[-1] - stamps[1]) / (len(stamps) - 2) * 1e3
    first = (stamps[0] - t1) * 1e3
    m = dict(losses=losses, steps=steps, fit_wall_s=wall, wall_ms_per_step=wall / steps * 1e3,
             steady_ms_per_step=steady, first_step_ms=first,
             steady_samples_per_s=sess.config.data.batch_size / steady * 1e3,
             step_time_s=res["step_time_s"], host_time_s=res["host_time_s"],
             update_time_s=res["update_time_s"], samples_per_s=res["samples_per_s"],
             overlap_fraction=res["overlap_fraction"],
             queue_bytes_per_step=res["queue_bytes_per_step"],
             republish_ms=rep, republish_times=list(sess.republish_times),
             sampler_workers=res["sampler_workers"], restarts=restarts,
             launches=launches, step_times=list(sess.step_times),
             host_times=list(sess.host_times), update_times=list(sess.update_times))
    log(f"  [{label}] {steps} steps in {wall:.3f} s wall ({m['wall_ms_per_step']:.3f} ms a "
        f"step; steady {steady:.3f} ms a step over steps 2..{steps - 1}, "
        f"{m['steady_samples_per_s']:.1f} samples/s; first step {first:.1f} ms); step_time_s {res['step_time_s']:.6f} host_time_s {res['host_time_s']:.6f} "
        f"update_time_s {res['update_time_s']:.6f} samples_per_s {res['samples_per_s']:.1f} "
        f"overlap_fraction {res['overlap_fraction']:.4f} queue_bytes_per_step "
        f"{res['queue_bytes_per_step']:.1f}"
        + ("" if rep is None else f"; republish {rep:.3f} ms a step (median)")
        + f"; launches {dict((k, v) for k, v in launches.items() if v)}"
        + (f"; restarts {restarts}" if restarts else "")
        + f" ({time.perf_counter() - t0:.1f} s)")
    report.setdefault("pipeline", {})[label] = m
    return sess, res, pools


def run_pipeline(scale: float, report: dict, graph) -> dict:
    """Phase 4e: R-GCN raf_spmd at full width on phase 4's graph through the
    asynchronous host pipeline — a producer thread, and a pool of
    ``PIPE_WORKERS`` spawned sampler processes over the shared-memory
    graph store and batch arena — against the serial loop; a worker killed
    mid-fit; one pool over two fits; pooled evaluate; HGT pooled; then
    the shm-backed embedding store, served, with one scheduled flush
    fault.  Returns the shapes the R-GCN and HGT pipelined fits launched
    each kernel at."""
    import os

    import numpy as np

    from repro_torch.data.faults import KILL_EXIT_CODE, FaultPlan, FaultSpec
    from repro_torch.serve.server import EmbeddingServer

    t_phase = time.perf_counter()
    W = PIPE_WORKERS
    serial = report["training"]["rgcn"]
    want = serial["losses"]
    log(f"  os.cpu_count() {os.cpu_count()}; {W} sampler workers; the serial loop (phase 4): "
        f"step_time_s {serial['step_time_s']:.6f} host_time_s {serial['host_time_s']:.6f} "
        f"update_time_s {serial['update_time_s']:.6f} samples_per_s "
        f"{serial['samples_per_s']:.1f} overlap_fraction {serial['overlap_fraction']:.4f}")
    rgcn_shapes, hgt_shapes = {}, {}

    def fit(label, **kw):
        return pipelined_fit(label, scale, graph, report, shapes_acc=rgcn_shapes, **kw)

    def close(sess):
        sess.close_pipeline()
        sess.close_serving()

    # the serial loop again, timed as the pipelined runs are
    sess, res, _ = fit("serial")
    check(res["losses"] == want, "the serial fit differs from phase 4's")
    close(sess)
    # learnable tables: "fresh" bit for bit, "stale" within the reference's bound
    for mode, pipeline in (("thread", {}), ("pool", dict(num_workers=W))):
        sess, res, _ = fit(f"{mode} fresh", pipeline=dict(snapshot="fresh", **pipeline))
        check(res["losses"] == want, f"{mode} fresh: losses {res['losses']} differ from the "
              f"serial {want}")
        if mode == "pool":
            check(0 < res["queue_bytes_per_step"] < 1024,
                  f"pool fresh: {res['queue_bytes_per_step']} bytes a queue item")
            ev = sess.evaluate(num_batches=2)
            check(ev["loss"] == serial["eval_loss"],
                  f"pooled evaluate {ev['loss']} differs from the serial {serial['eval_loss']}")
            log(f"  [pool fresh] pooled evaluate {ev['loss']:.9f} = serial "
                f"{serial['eval_loss']:.9f}")
            report["pipeline"]["pool fresh"]["eval_loss"] = ev["loss"]
            fresh_pool = sess
        else:
            close(sess)
        sess, res, _ = fit(f"{mode} stale", pipeline=dict(snapshot="stale", **pipeline))
        gap = float(np.abs(np.asarray(res["losses"]) - want).max())
        first_after, _ = sess.executor.loss_and_metrics(sess, sess.plan, sess.state,
                                                        sess._batch_for_step(0))
        log(f"  [{mode} stale] max |loss - serial| {gap:.3g} (bound 5e-2); step 0's batch "
            f"re-scored {first_after:.6f} after the fit, {res['losses'][0]:.6f} before")
        check(gap <= 5e-2, f"{mode} stale: losses {gap:.3g} from the serial ones")
        check(first_after < res["losses"][0], f"{mode} stale: step 0's batch not lowered")
        if mode == "pool":
            check(0 < res["queue_bytes_per_step"] < 1024,
                  f"pool stale: {res['queue_bytes_per_step']} bytes a queue item")
            check(len(sess.republish_times) == len(res["losses"]),
                  f"pool stale: {len(sess.republish_times)} republishes")
            check(sess._pool_cache[1].handle.tables_mutable,
                  "pool stale: the workers do not stage against republished tables")
        report["pipeline"][f"{mode} stale"]["max_gap"] = gap
        close(sess)

    # frozen tables: serial, thread, pool with and without the arena
    frozen = {}
    for label, pipeline in (("frozen serial", None), ("frozen thread", {}),
                            ("frozen pool", dict(num_workers=W)),
                            ("frozen pool no arena", dict(num_workers=W, arena=False))):
        sess, res, _ = fit(label, pipeline=pipeline, learnable=False)
        frozen[label] = res["losses"]
        close(sess)
    for label, losses in frozen.items():
        check(losses == frozen["frozen serial"], f"{label}: losses differ from the serial")
    check(report["pipeline"]["frozen pool"]["queue_bytes_per_step"] < 1024
          < report["pipeline"]["frozen pool no arena"]["queue_bytes_per_step"],
          "frozen pools: queue item sizes out of order")

    # a worker killed mid-fit: respawned, its stripe replayed, losses unchanged
    plan = FaultPlan((FaultSpec("kill_worker", step=5),))
    sess, res, pools = fit("frozen pool, worker of item 5 killed",
                           pipeline=dict(num_workers=W), learnable=False, fault_plan=plan)
    restarts = pools[-1].restarts
    check(res["losses"] == frozen["frozen serial"], "fault drill: losses differ")
    check(len(restarts) == 1 and restarts[0]["exitcode"] == KILL_EXIT_CODE,
          f"fault drill: restarts {restarts}")
    log(f"  [fault drill] worker {restarts[0]['wid']} (owner of item 5) killed, respawned at "
        f"item {restarts[0]['item']} after {restarts[0]['downtime_s'] * 1e3:.1f} ms; losses "
        "bit-equal to the serial frozen fit")
    close(sess)

    # one pool over two fits
    sess, res, pools = fit("pool fresh, fit(10) twice",
                           pipeline=dict(snapshot="fresh", num_workers=W), fits=(10, 10))
    check(pools[0] is pools[1] and not pools[1]._closed, "the second fit spawned a new pool")
    check(res["losses"] == want, "two pooled fits differ from one serial fit of 20")
    close(sess)

    # HGT, pooled, "fresh"
    sess, res, _ = pipelined_fit("hgt pool fresh", scale, graph, report, model="hgt",
                                 pipeline=dict(snapshot="fresh", num_workers=W),
                                 shapes_acc=hgt_shapes)
    check(res["losses"] == report["training"]["hgt"]["losses"],
          "hgt pool fresh: losses differ from phase 4b's")
    close(sess)

    # the shm-backed store on the pooled "fresh" state (phase 4's, bit for bit)
    sess = fresh_pool
    sess.close_pipeline()
    plain = sess.infer_all()
    shared = sess.infer_all(shm=True)
    seg = shared.handle.segment
    for t, a in plain.embeddings.items():
        check(np.array_equal(shared.embeddings[t], a), f"shm store: {t} differs")
    for k in ("w", "b"):
        check(np.array_equal(shared.head[k], plain.head[k]), f"shm store: head {k} differs")
    check(seg in own_segments(), f"shm store: segment {seg} is not this process's")
    n_target = graph.num_nodes[graph.target_type]
    with EmbeddingServer(shared, cache_mb=sess.config.serve.cache_mb,
                         kernels=sess.config.kernels) as srv:
        served = drive_server("[shm store] server", srv, shared, n_target, seed=3)
    with EmbeddingServer(shared, cache_mb=sess.config.serve.cache_mb,
                         kernels=sess.config.kernels,
                         faults=FaultPlan((FaultSpec("fail_flush", step=0, count=1),))) as srv:
        faulted = drive_server("[shm store] server, one fail_flush", srv, shared, n_target,
                               seed=4, retries=1)
    sess.close_serving()
    check(not own_segments(), f"segments left: {own_segments()}")
    report["pipeline"]["shm store"] = dict(segment=seg, served=served, fail_flush=faulted)
    log(f"  shm store equal to the in-process one; served 512 + 512 requests (one retry "
        f"with the fault); no segment of pid {os.getpid()} left "
        f"({time.perf_counter() - t_phase:.1f} s phase)")
    return rgcn_shapes, hgt_shapes


DP_RANKS = 2  # phase 4f's trainer processes, time-sharing the one card


def own_stores() -> list:
    """This process's on-disk mmap stores (the port's prefix and pid)."""
    import os

    from repro_torch.graph.mmap_store import live_stores

    return live_stores(prefix=f"heta-tmmap-{os.getpid():x}-")


def dp_fit(label: str, scale: float, graph, report: dict, model: str = "rgcn",
           steps: int = 20, shapes_acc=None, **dp):
    """One phase-4f fit: a frozen-table session on the card whose fit runs
    in ``DP_RANKS`` trainer processes (this one is rank 0; ``dp`` holds the
    other ``ScaleConfig`` fields), from reset launch counts.  Checks that
    both ranks launched the model's kernels (rank 1 reports its own
    counts, launch counters being per process) and no gather_rows, and
    prints the fit's wall and steady ms a step, the ranks' start, each
    rank's wall / host / device seconds and the exchange's bytes.  Rank 0
    stamps the end of each step where it releases the step's exchange
    slot (``DPExchange.ack``: its own steps after publishing, the others
    after adopting).  Returns the session and its result dict."""
    import numpy as np
    import torch

    from repro_torch.data import dp_trainer
    from repro_torch.kernels.ops import reset_launch_counts

    t0 = time.perf_counter()
    mode = dp.get("mode", "global")
    sess, _ = build_session(scale, None, model=model, graph=graph, learnable=False,
                            dp=dict(num_trainers=DP_RANKS, **dp))
    check(sess.device.type == "cuda", f"{label}: session landed on {sess.device}")
    check(not sess.plan.learn_feats, f"{label}: learnable tables train")
    payload = sum(a.nbytes for a in dp_trainer._payload_template(sess, mode))
    stamps = []
    ack = dp_trainer.DPExchange.ack

    def stamped(self, k):
        ack(self, k)
        stamps.append(time.perf_counter())

    dp_trainer.DPExchange.ack = stamped
    try:
        reset_launch_counts()
        t1 = time.perf_counter()
        res = sess.fit(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    finally:
        dp_trainer.DPExchange.ack = ack
    launches, shapes = launch_counts()
    sc = res["scale"]
    rank1 = sc["trainer_reports"][1]
    launches1 = {k: v["launches"] for k, v in rank1["kernel_launches"].items()}
    if shapes_acc is not None:
        for name, c in shapes.items():
            shapes_acc.setdefault(name, collections.Counter()).update(c)
        for name, v in rank1["kernel_launches"].items():
            shapes_acc.setdefault(name, collections.Counter()).update(
                {tuple(x): n for x, n in v["shapes"]})
    losses = res["losses"]
    check(len(losses) == steps and bool(np.isfinite(losses).all()),
          f"{label}: losses {losses}")
    check(len(stamps) == steps, f"{label}: rank 0 released {len(stamps)} of {steps} steps")
    for name in FROZEN_KERNELS[model]:
        check(launches[name] > 0, f"kernel {name} was not launched by {label}'s rank 0")
        check(launches1.get(name, 0) > 0, f"kernel {name} was not launched by {label}'s rank 1")
    check(launches.get("gather_rows", 0) == 0 and launches1.get("gather_rows", 0) == 0,
          f"{label}: gather_rows launched with frozen tables")
    if mode == "global":  # each rank owns half the steps
        check(launches["stacked_mean_linear"] == launches1["stacked_mean_linear"],
              f"{label}: ranks 0 and 1 launched stacked_mean_linear "
              f"{launches['stacked_mean_linear']} and {launches1['stacked_mean_linear']} times")
    steady = (stamps[-1] - stamps[1]) / (steps - 2) * 1e3
    ranks = {0: dict(wall_s=stamps[-1] - t1, host_s=float(sum(sess.host_times)),
                     device_s=float(sum(sess.step_times)), steps=len(sess.step_times)),
             1: dict(wall_s=rank1["wall_s"], host_s=rank1["host_s"],
                     device_s=rank1["device_s"])}
    m = dict(losses=losses, steps=steps, mode=mode, store=sc["store"], fit_wall_s=wall,
             wall_ms_per_step=wall / steps * 1e3, steady_ms_per_step=steady,
             steady_samples_per_s=sess.config.data.batch_size / steady * 1e3,
             startup_s=sc["startup_s"][1], ranks=ranks, payload_bytes=payload,
             launches={0: launches, 1: launches1}, state_sha=sc["state_sha"],
             step_times=list(sess.step_times), host_times=list(sess.host_times))
    log(f"  [{label}] {steps} steps in {wall:.3f} s wall ({m['wall_ms_per_step']:.3f} ms a "
        f"step; steady {steady:.3f} ms a step over steps 2..{steps - 1}, "
        f"{m['steady_samples_per_s']:.1f} samples/s); rank 1 started its loop "
        f"{m['startup_s']:.3f} s after its spawn; exchange payload {payload} bytes a "
        f"publication ({'the state' if mode == 'global' else 'each rank the gradients'})")
    owned = {0: len(sess.host_times), 1: steps - len(sess.host_times) if mode == "global"
             else steps}
    for r, v in ranks.items():
        log(f"  [{label}] rank {r}: wall_s {v['wall_s']:.3f} host_s {v['host_s']:.3f} "
            f"device_s {v['device_s']:.3f} ({owned[r]} steps staged, "
            f"{v['host_s'] / owned[r] * 1e3:.1f} ms host a step); launches "
            f"{dict((k, n) for k, n in m['launches'][r].items() if n)}")
    log(f"  [{label}] losses {losses[0]:.6f} -> {losses[-1]:.6f}; state "
        f"{sc['state_sha'][:12]} on both ranks ({time.perf_counter() - t0:.1f} s)")
    report.setdefault("dp", {})[label] = m
    return sess, res


def local_first_batch(sess, rank: int = 0):
    """Rank ``rank``'s step-0 sub-batch of a ``"local"`` fit, drawn as
    ``dp_trainer._dp_loop_local`` draws it."""
    import dataclasses

    from repro_torch.data import dp_trainer
    from repro_torch.data.worker_pool import EpochSchedule
    from repro_torch.graph.sampler import NeighborSampler

    cfg = sess.config
    owned = dp_trainer._hierarchy(sess).trainer_train_nodes(sess.graph, rank)
    sampler = NeighborSampler(dataclasses.replace(sess.graph, train_nodes=owned), sess.spec,
                              max(1, cfg.data.batch_size // DP_RANKS), seed=cfg.run.seed + 1)
    es, idx = EpochSchedule(cfg.run.seed + 2 + 7919 * (rank + 1),
                            sampler.steps_per_epoch()).seed_and_index(0)
    return sampler.batch_at(idx, epoch_seed=es)


def run_dp(scale: float, report: dict, graph, steps: int = 20) -> tuple:
    """Phase 4f: the data-parallel tier, ``DP_RANKS`` trainer processes on
    the one card over phase 4's graph with frozen tables: R-GCN "global"
    over the shm and the mmap store (bit-equal to phase 4e's frozen serial
    fit), R-GCN "local" (ranks agree; step 0's sub-batch re-scored lower),
    HGT "global" (bit-equal to a frozen HGT serial fit run here); then
    evaluate on each DP session, and no segment or store of this process
    left.  Returns the shapes the R-GCN and HGT DP fits launched each
    kernel at, both ranks summed."""
    import os

    import numpy as np

    t_phase = time.perf_counter()
    serial = report["pipeline"]["frozen serial"]
    log(f"  {DP_RANKS} ranks; the frozen serial loop (phase 4e): "
        f"{serial['wall_ms_per_step']:.3f} ms a step wall, steady "
        f"{serial['steady_ms_per_step']:.3f}; step_time_s {serial['step_time_s']:.6f} "
        f"host_time_s {serial['host_time_s']:.6f}")
    rgcn_shapes, hgt_shapes = {}, {}
    sessions = []
    for label, store in (("rgcn global shm", "shm"), ("rgcn global mmap", "mmap")):
        sess, res = dp_fit(label, scale, graph, report, steps=steps, shapes_acc=rgcn_shapes,
                           mode="global", store=store)
        check(res["losses"] == serial["losses"],
              f"{label}: losses differ from the frozen serial fit's")
        sessions.append((label, sess))
    sess, _ = build_session(scale, None, graph=graph, learnable=False,
                            dp=dict(num_trainers=DP_RANKS, mode="local"))
    b0 = local_first_batch(sess)
    before, _ = sess.executor.loss_and_metrics(sess, sess.plan, sess.state, b0)
    del sess
    sess, res = dp_fit("rgcn local shm", scale, graph, report, steps=steps,
                       shapes_acc=rgcn_shapes, mode="local", store="shm")
    after, _ = sess.executor.loss_and_metrics(sess, sess.plan, sess.state, b0)
    log(f"  [rgcn local shm] rank 0's step-0 sub-batch ({len(b0.seeds)} seeds) scores "
        f"{before:.6f} before the fit, {after:.6f} after; ranks bit-identical (losses and "
        f"state, run_dp_fit's own check)")
    check(after < before, f"rgcn local: step 0's sub-batch scores {after} after, {before} before")
    report["dp"]["rgcn local shm"].update(first_batch_before=before, first_batch_after=after)
    sessions.append(("rgcn local shm", sess))
    hsess, hres, _ = pipelined_fit("hgt frozen serial", scale, graph, report, model="hgt",
                                   learnable=False, fits=(steps,))
    del hsess
    sess, res = dp_fit("hgt global shm", scale, graph, report, model="hgt", steps=steps,
                       shapes_acc=hgt_shapes, mode="global", store="shm")
    check(res["losses"] == hres["losses"], "hgt global: losses differ from the frozen serial fit's")
    log(f"  [hgt global shm] beside the frozen HGT serial fit: "
        f"{report['pipeline']['hgt frozen serial']['wall_ms_per_step']:.3f} ms a step wall, "
        f"steady {report['pipeline']['hgt frozen serial']['steady_ms_per_step']:.3f}")
    sessions.append(("hgt global shm", sess))
    for label, sess in sessions:
        ev = sess.evaluate(num_batches=2)
        check(bool(np.isfinite(ev["loss"])), f"{label}: evaluate gave {ev['loss']}")
        report["dp"][label]["eval_loss"] = ev["loss"]
        log(f"  [{label}] evaluate loss {ev['loss']:.6f}")
    check(not own_segments(), f"segments left: {own_segments()}")
    check(not own_stores(), f"stores left: {own_stores()}")
    log(f"  no segment or store of pid {os.getpid()} left "
        f"({time.perf_counter() - t_phase:.1f} s phase)")
    return rgcn_shapes, hgt_shapes


def run_reference(scale: float, model: str = "rgcn", steps: int = 3,
                  executor: str = "raf_spmd", fuse_epilogue: bool = True) -> dict:
    """Phase 8: the port on the card against the port on the CPU: 3-step
    losses, and for the stacked executor the trained infer_all store."""
    import numpy as np

    from repro_torch.kernels.ops import reset_launch_counts

    kw = dict(max_degree=8, batch_size=32, model=model, executor=executor,
              fuse_epilogue=fuse_epilogue)
    gpu, _ = build_session(scale, None, **kw)
    cpu, _ = build_session(scale, "cpu", **kw)
    reset_launch_counts()
    lg = gpu.fit(steps)["losses"]
    launches, _ = launch_counts()
    lc = cpu.fit(steps)["losses"]
    diff = max(abs(a - b) for a, b in zip(lg, lc))
    name = f"{model} {executor}" + ("" if fuse_epilogue else " unfused")
    log(f"  [{name}] scale {scale}, batch 32: {steps}-step losses GPU {lg} CPU {lc}, "
        f"max diff {diff:.3g}; GPU launches "
        + ", ".join(f"{k}={v}" for k, v in launches.items() if v))
    check(diff <= TOL["atol"], f"{name}: GPU and CPU losses differ by {diff:.3g}")
    want = ("relation_agg" if executor == "raf" else "stacked_softmax_combine"
            if not fuse_epilogue else None)
    check(want is None or launches[want] > 0, f"{name}: {want} was not launched on the GPU")
    out = dict(losses_gpu=lg, losses_cpu=lc, max_diff=diff, launches=launches)
    if executor != "raf_spmd":
        return out
    a, b = gpu.infer_all(), cpu.infer_all()
    check(set(a.embeddings) == set(b.embeddings), f"{model}: types differ between GPU and CPU")
    worst = 0.0
    for t in a.embeddings:
        check(bool(np.allclose(a.embeddings[t], b.embeddings[t], **TOL)),
              f"{model}: GPU and CPU embeddings of {t} differ beyond tolerance")
        worst = max(worst, float(np.abs(a.embeddings[t] - b.embeddings[t]).max()))
    ids = np.arange(min(64, a.embeddings[a.target_type].shape[0]))
    check(bool(np.allclose(a.scores(ids), b.scores(ids), **TOL)),
          f"{model}: GPU and CPU scores differ")
    log(f"  [{name}] trained infer_all: {sum(x.shape[0] for x in a.embeddings.values()):,} "
        f"embeddings, max abs diff GPU kernels vs CPU plain {worst:.3g}")
    out["infer_all_max_diff"] = worst
    return out


TIMERS = {"stacked_mean_linear": (time_mean_linear, check_mean_linear),
          "stacked_mean_linear_dh": (time_dh, check_dh),
          "gather_rows": (time_gather, check_gather),
          "stacked_attn_epilogue": (time_attn, check_attn),
          "stacked_attn_dh": (time_attn_dh, check_attn_dh),
          "relation_agg": (time_relation_agg, check_relation_agg),
          "stacked_softmax_combine": (time_softmax_combine, check_softmax_combine),
          "flash_attention": (time_flash, check_flash)}
# kernels timed at every shape a path launched them with (not only its two
# most launched)
TIME_ALL = ("relation_agg", "stacked_softmax_combine")


def kernel_table(paths: dict, errs: dict, device):
    """Phase 7: every kernel against its plain version at every shape any
    path launched it with, and timed at each path's two most launched
    shapes.  ``paths`` maps a path's name to the shapes its run launched
    each kernel at.  Returns the entries of the ``kernels`` line: the main
    keys hold the first path that launched the kernel (training first) at
    its most launched shape, ``launches`` the sum over every path's run,
    and ``paths`` each path's launches and timings."""
    from repro_torch.kernels.ops import KERNELS

    entries = []
    for name, info in KERNELS.items():
        timer, checker = TIMERS[name]
        union = collections.Counter()
        for shapes in paths.values():
            union.update(shapes[name])
        for i, shape in enumerate(sorted(union)):
            errs[name] = max(errs[name], checker(shape, 1000 + i, device))
        log(f"  {name}: max abs err {errs[name]:.3g} over {len(union)} shapes")
        timed = {}
        for path, shapes in paths.items():
            launched = sum(shapes[name].values())
            # the two most launched shapes of the path; among those, the most work first
            cases = sorted(shapes[name].items(), key=lambda sc: (-sc[1], -math.prod(sc[0])))
            cases = cases if name in TIME_ALL else cases[:2]
            timed[path] = dict(launches=launched, timed=[])
            for shape, count in cases:
                t = timer(shape, device)
                timed[path]["timed"].append(dict(shape=list(shape), count=count, **t))
                log(f"    {path} {shape} ({count} of {launched} launches): "
                    f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
                    f"{t['library_ms'] if t['library_ms'] is None else round(t['library_ms'], 4)}"
                    f" ms, bound {t['bound_ms']:.3g} ms ({t['bound_by']}), "
                    f"{t['bytes'] / t['ms'] / 1e6:.1f} GB/s, "
                    f"{t['flops'] / t['ms'] / 1e9:.1f} TFLOP/s")
                if "graph_ms" in t:
                    log("      as one CUDA graph (no host launch cost): " + ", ".join(
                        f"{k} {'none' if t[k] is None else f'{t[k]:.4f} ms'}"
                        for k in ("graph_ms", "plain_graph_ms", "library_graph_ms")))
                if "copy_ms" in t:
                    log(f"      on HGT's head-major views through their strides "
                        f"{t['strided_ms']:.4f} ms (graph {t['strided_graph_ms']:.4f}); "
                        f"their contiguous copies alone {t['copy_ms']:.4f} ms (graph "
                        f"{t['copy_graph_ms']:.4f})")
                if "projection_library_ms" in t:
                    log(f"      yardstick computing less than the kernel (its projections "
                        f"alone, one torch.bmm): {t['projection_library_ms']:.4f} ms, as a "
                        f"graph {t['projection_library_graph_ms']:.4f} ms")
        main = next(timed[p]["timed"][0] for p in paths if timed[p]["timed"])
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "graph_ms",
                "plain_graph_ms", "library_graph_ms", "projection_library_ms")
        entries.append({
            "name": name, "route": info.route, "source": info.source,
            "replaces": info.replaces,
            "launches": sum(t["launches"] for t in timed.values()),
            "max_abs_err": errs[name], "shapes_checked": len(union),
            "shape": main["shape"], **{k: main[k] for k in keys if k in main},
            "paths": timed,
        })
    return entries


# --------------------------------------------------------------------------


# phase 3's ragged shapes: (rb, n, f, d_in, d_out, U) of the mean-linear pair
RAGGED = [(5, 17, 4, 37, 24, 3), (1, 1, 1, 1, 1, 1), (8, 130, 3, 129, 65, 8),
          (12, 64, 25, 128, 64, 6), (3, 200, 7, 789, 349, 2)]
# and (rb, n, f, d_in, nh, dh, U) of the attention pair: f in {1, 3, 16, 64,
# 100}, ragged n and d_in, H = 72 (two column passes), the training leaf and
# the serving block
ATTN_RAGGED = [(5, 19, 4, 23, 4, 8, 3), (4, 33, 1, 789, 4, 16, 3), (3, 130, 3, 129, 4, 16, 2),
               (2, 7, 16, 37, 2, 8, 2), (3, 45, 64, 100, 4, 16, 2), (2, 9, 100, 33, 4, 16, 2),
               (3, 50, 5, 70, 3, 24, 2), (6, 4096, 3, 128, 4, 16, 6),
               (2, 1024, 16, 128, 4, 16, 2)]


# the attention epilogue at the fanout limits it promises (H = 64, nh = 4):
# one row of 392 neighbours for HGT, of 792 for R-GAT (the lean layout)
ATTN_LIMITS = [(2, 5, 392, 128, 4, 16, 2, "hgt"), (2, 5, 792, 128, 4, 16, 2, "rgat")]
# kernel 7's sweep ((rows, d, n), index type): d in {1, 3, 4, 63, 64, 65,
# 128, 200} x n in {1, 7, 874, 100000}, int32 and int64 indices in turn;
# each also into an output 4 bytes off the 16-byte grid
GATHER_SWEEP = [((5000, d, n), ("int32", "int64")[(i + j) % 2])
                for i, d in enumerate((1, 3, 4, 63, 64, 65, 128, 200))
                for j, n in enumerate((1, 7, 874, 100000))]
GATHER_SWEEP += [(shape, "int64" if dt == "int32" else "int32") for shape, dt in GATHER_SWEEP]


# kernel 2's ragged shapes (rb, n, f, d_in, d_out, U): n in {1, 1000, 4097},
# d_in in {33, 100, 128, 789}, d_out in {1, 65, 100}, f in {1, 3, 16}; five
# slots on two stack rows, every 7th row fully masked
DH_RAGGED = [(5, n, f, di, do, 2) for n in (1, 1000, 4097) for di in (33, 100, 128, 789)
             for do in (1, 65, 100) for f in (1, 3, 16)]
# kernel 1's ragged shapes: the same sweep (every 7th row fully masked, five
# slots on two stack rows)
ML_RAGGED = DH_RAGGED
# kernel 5's (rb, n, f, d_in, H, Ue, Uv): n * f in {1, 3000, 12291}, d_in in
# {33, 100, 128, 789}, H in {15, 64, 72, 130}, with (Uv = 3) and without
# (Uv = 0) dv; five slots on two or three stack rows, slots 0 and 1 on row 0
ADH_RAGGED = [(5, n, f, di, H, 2, uv) for n, f in ((1, 1), (1000, 3), (4097, 3))
              for di in (33, 100, 128, 789) for H in (15, 64, 72, 130) for uv in (0, 3)]
# kernel 8's ragged cases (b, h, hk, sq, sk, d, causal, window, q_offset):
# every (sq, sk) in {1, 129, 1000, 2047}^2 at every head dim, each with one of
# six settings in turn (GQA 24:8 or 4:1, causal or not, a window, a q_offset,
# rows that see no key)
FLASH_SETTINGS = [(24, 8, 1, -1, 0), (4, 1, 0, -1, 0), (24, 8, 1, 100, 0), (4, 1, 1, -1, 37),
                  (4, 1, 0, 64, 0), (4, 1, 0, 4, 3000)]
FLASH_RAGGED = [(1 + i % 2, *FLASH_SETTINGS[i % 6][:2], sq, sk, d, *FLASH_SETTINGS[i % 6][2:])
                for i, (sq, sk, d) in enumerate((a, b, d) for a in (1, 129, 1000, 2047)
                                                for b in (1, 129, 1000, 2047)
                                                for d in (32, 64, 80, 128))]


# (n, f, d_in, d_out) of kernel 6: tests/test_kernels.py's AGG_SHAPES, one
# row, and the raf R-GCN step's three shapes at batch 1024
RA_SHAPES = [(200, 25, 128, 64), (64, 20, 64, 64), (64, 4, 789, 64), (128, 20, 64, 349),
             (5, 3, 7, 16), (256, 10, 1024, 64), (1, 1, 1, 1), (1024, 4, 64, 64),
             (4096, 3, 128, 64), (4096, 3, 64, 64)]
# (rb, n, f, nh, dh) of kernel 3: tests/test_stacked_kernels.py's cases,
# f in {16, 64, 100, 1000} at ragged n, dh = 5 and 6 (4-column chunks that
# straddle heads), H = 72 and H = 320 (> 256 threads), H = 1040 (a row over
# two blocks), the training leaf and top and the serving block; each in
# every layout of SC_LAYOUTS
SC_SHAPES = [(3, 21, 4, 2, 5), (1, 1, 1, 1, 1), (5, 130, 3, 4, 16), (2, 7, 16, 4, 16),
             (3, 45, 64, 4, 16), (2, 9, 100, 4, 16), (3, 50, 5, 3, 24), (2, 33, 3, 8, 40),
             (2, 9, 1000, 4, 16), (3, 21, 4, 2, 6), (2, 5, 20, 13, 80),
             (6, 4096, 3, 4, 16), (3, 1024, 4, 4, 16), (2, 1024, 16, 4, 16)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.1,
                    help="ogbn-mag scale of the slice (default 0.1; 1.0 = full size)")
    ap.add_argument("--ref-scale", type=float, default=0.005,
                    help="scale of the GPU-vs-CPU reference check (default 0.005)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the LM workbench's weights and prompts (default 0)")
    ap.add_argument("--out", default=None, help="also write the detailed results as JSON here")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is not next to this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on the GPU",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: dict = {}
    t_start = time.perf_counter()
    from repro_torch.kernels import build

    log("== 1 environment")
    card = card_line()
    import numpy

    log(f"  python {sys.version.split()[0]}, numpy {numpy.__version__}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    log(f"  {card}")
    report["card"] = card

    log("== 2 build")
    t0 = time.perf_counter()
    secs = build.build()
    wall = time.perf_counter() - t0
    log(f"  built {sorted(secs)} in {wall:.2f} s wall ({secs})")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")
    report["build_s"] = wall
    report["redesigned"] = redesigned_report(build)
    log_redesigned(report["redesigned"])
    check(all(report["redesigned"][name] for name in REDESIGNED),
          "a redesigned kernel is missing from its ptxas report")
    check(not any(e["spill_stores"] or e["spill_loads"]
                  for name in REDESIGNED for e in report["redesigned"][name]),
          "a redesigned kernel spills registers")
    check(all(report["redesigned"]["flash_attention_sass"].values()),
          "the flash attention library holds no HGMMA or no UTMALDG: the Hopper kernel "
          "was not built")

    log("== 3 kernels vs plain (ragged shapes and the training paths')")
    errs = {name: 0.0 for name in TIMERS}
    for i, shape in enumerate(RAGGED):
        errs["stacked_mean_linear"] = max(errs["stacked_mean_linear"],
                                          check_mean_linear(shape, i, DEVICE))
    # + the two levels of the training path at batch 1024 (leaf: d_in = d_pad)
    for i, shape in enumerate(RAGGED + [(3, 1024, 4, 64, 64, 3), (6, 4096, 3, 128, 64, 6)]):
        errs["stacked_mean_linear_dh"] = max(errs["stacked_mean_linear_dh"],
                                             check_dh(shape, i, DEVICE))
    for i, shape in enumerate(DH_RAGGED):
        errs["stacked_mean_linear_dh"] = max(errs["stacked_mean_linear_dh"],
                                             check_dh(shape, 500 + i, DEVICE, masked_rows=True))
    for i, shape in enumerate(ML_RAGGED):
        errs["stacked_mean_linear"] = max(errs["stacked_mean_linear"],
                                          check_mean_linear(shape, 700 + i, DEVICE,
                                                            masked_rows=True))
    for i, shape in enumerate(ADH_RAGGED):
        errs["stacked_attn_dh"] = max(errs["stacked_attn_dh"], check_attn_dh(shape, 900 + i, DEVICE))
    for i, (shape, dt) in enumerate(GATHER_SWEEP):
        check_gather(shape, i, DEVICE, dt, misaligned=True)
    for i, (rb, n, f, di, nh, dh, U) in enumerate(ATTN_RAGGED):
        for variant in ("rgat", "hgt"):
            for with_res in (False, True):
                shape = attn_shape(rb, n, f, di, nh, dh, U, variant, with_res)
                errs["stacked_attn_epilogue"] = max(errs["stacked_attn_epilogue"],
                                                    check_attn(shape, i, DEVICE))
            dshape = (rb, n, f, di, nh * dh, U, 0 if variant == "rgat" else U)
            errs["stacked_attn_dh"] = max(errs["stacked_attn_dh"],
                                          check_attn_dh(dshape, i, DEVICE))
    for i, (rb, n, f, di, nh, dh, U, variant) in enumerate(ATTN_LIMITS):
        for with_res in (False, True):
            errs["stacked_attn_epilogue"] = max(
                errs["stacked_attn_epilogue"],
                check_attn(attn_shape(rb, n, f, di, nh, dh, U, variant, with_res), 50 + i,
                           DEVICE))
    # kernel 6 at the reference's AGG_SHAPES, the raf path's shapes and an
    # all-masked case; kernel 3 at the reference's cases, f in {16, 64, 100},
    # ragged n and the training and serving paths' shapes
    for i, shape in enumerate(RA_SHAPES):
        for misaligned in (False, True):
            errs["relation_agg"] = max(errs["relation_agg"],
                                       check_relation_agg(shape, i, DEVICE, misaligned=misaligned))
    errs["relation_agg"] = max(errs["relation_agg"],
                               check_relation_agg((16, 5, 32, 8), 99, DEVICE, all_masked=True))
    for i, shape in enumerate(SC_SHAPES):
        for layout in SC_LAYOUTS:
            errs["stacked_softmax_combine"] = max(errs["stacked_softmax_combine"],
                                                  check_softmax_combine(shape, i, DEVICE, layout))
    # kernel 8 at the reference's ATTN_CASES and the LM's shapes, fp32 and bf16
    flash_errs = [0.0, 0.0]
    for i, case in enumerate(FLASH_CASES + FLASH_RAGGED):
        for code in (0, 1):
            flash_errs[code] = max(flash_errs[code], check_flash(case + (code,), i, DEVICE))
    errs["flash_attention"] = max(flash_errs)
    log(f"  ok; max abs err {errs}; flash_attention fp32 {flash_errs[0]:.3g}, bf16 "
        f"{flash_errs[1]:.3g}; bf16 Frobenius error against fp32 attention at most "
        f"{max(FLASH_FROBENIUS):.3f}x the plain bf16 path's (limit 1.5x)")
    report["flash_bf16_frobenius_ratio"] = max(FLASH_FROBENIUS)

    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        log(f"== 4 R-GCN training (ogbn-mag scale {args.scale}, batch 1024)")
        sess, g, paths["rgcn training"] = run_training(args.scale, report, ckpt_dir)
        log("== 5 R-GCN resume from the step-10 checkpoint")
        run_resume(args.scale, report, ckpt_dir, report["training"]["rgcn"]["losses"])
    log("== 6 R-GCN serving the trained state")
    paths["rgcn serving"] = run_serving(sess, g, report)
    del sess
    log(f"== 4c R-GCN through the dict-form executors vanilla and raf (scale {args.scale}, "
        "batch 1024), raf resumed from its step-10 checkpoint")
    paths["rgcn raf training"] = run_dense(args.scale, report, g)

    for model in ("rgat", "hgt"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
            log(f"== 4b {model} training (ogbn-mag scale {args.scale}, batch 1024)")
            sess, g, paths[f"{model} training"] = run_training(
                args.scale, report, ckpt_dir if model == "hgt" else None, model)
            if model == "hgt":
                log("== 5b hgt resume from the step-10 checkpoint")
                run_resume(args.scale, report, ckpt_dir, report["training"]["hgt"]["losses"],
                           model)
        log(f"== 6b {model} serving the trained state")
        paths[f"{model} serving"] = run_serving(sess, g, report, model)
        del sess
    for model in ("rgat", "hgt"):
        log(f"== 4d {model} training with the epilogue unfused (kernel 3), then infer_all")
        paths[f"{model} unfused training"], paths[f"{model} unfused serving"] = run_unfused(
            args.scale, report, g, model, report["training"][model]["losses"])
    log(f"== 4e the asynchronous host pipeline: R-GCN (and HGT) through a producer thread "
        f"and {PIPE_WORKERS} sampler processes against the serial loop; the shm store served")
    paths["rgcn pipeline training"], paths["hgt pipeline training"] = run_pipeline(
        args.scale, report, g)
    log(f"== 4f the data-parallel tier: {DP_RANKS} trainer processes on the one card, "
        "R-GCN global (shm, mmap) and local, HGT global, against the serial loop")
    paths["rgcn dp training"], paths["hgt dp training"] = run_dp(args.scale, report, g)
    log(f"== 9 LM workbench: llama3.2-3b at full width (bf16, seed {args.seed}), prefill "
        "4 x 2048 then 32 greedy decode steps")
    paths["lm prefill + decode"] = run_lm(report, args.seed)
    for name in LM_FAMILIES:
        log(f"== 9b LM workbench: {name} (seed {args.seed}), prefill then 32 greedy decode "
            "steps, then its fp32 checks")
        paths[f"{name} prefill + decode"] = run_lm_family(name, report, args.seed)
    order = [f"{m} {p}" for p in ("training", "serving") for m in ("rgcn", "rgat", "hgt")]
    order += ["rgcn raf training"] + [f"{m} unfused {p}" for p in ("training", "serving")
                                      for m in ("rgat", "hgt")]
    order += ["rgcn pipeline training", "hgt pipeline training"]
    order += ["rgcn dp training", "hgt dp training"]
    order += ["lm prefill + decode"] + [f"{name} prefill + decode" for name in LM_FAMILIES]
    paths = {p: paths[p] for p in order}

    log("== 7 kernels at the shapes the training and serving paths launched them with")
    report["kernels"] = kernel_table(paths, errs, DEVICE)
    leaf = max(paths["rgcn training"]["stacked_mean_linear_dh"],
               key=lambda x: x[0] * x[1] * x[2] * x[3])
    back_ms = time_backward(leaf, DEVICE)
    log(f"  autograd backward of stacked_mean_linear (dh + dw + db) at {leaf}: "
        f"{back_ms:.4f} ms")
    report["backward_ms"] = dict(shape=list(leaf), ms=back_ms)
    log_redesigned(report["redesigned"])
    err = check_flash(FLASH_DECODE_SHAPE, 77, DEVICE)
    t = time_flash(FLASH_DECODE_SHAPE, DEVICE)
    log(f"  flash_attention at the decode shape {FLASH_DECODE_SHAPE} (not on the path: "
        f"decode attention is plain torch ops): kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.3g} ms ({t['bound_by']}), max abs err {err:.3g}")
    report["flash_decode_shape"] = dict(shape=list(FLASH_DECODE_SHAPE), max_abs_err=err, **t)

    log(f"== 8 card vs CPU (scale {args.ref_scale}, batch 32; the LM workbench's "
        "configurations, reduced)")
    report["reference"] = {}
    for model, executor, fuse in (("rgcn", "raf_spmd", True), ("rgat", "raf_spmd", True),
                                  ("hgt", "raf_spmd", True), ("rgcn", "raf", True),
                                  ("rgat", "raf_spmd", False), ("hgt", "raf_spmd", False)):
        report["reference"][f"{model} {executor}{'' if fuse else ' unfused'}"] = run_reference(
            args.ref_scale, model, executor=executor, fuse_epilogue=fuse)
    for name in LM_REFERENCE:
        report["reference"][f"{name} reduced"] = run_lm_reference(name, args.seed)
    report["wall_s"] = time.perf_counter() - t_start
    log(f"  whole run {report['wall_s']:.1f} s")

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1, default=str))
    log(card_line())
    log(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "paths"}
                                for e in report["kernels"]]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
