"""Launch-layout tuner for kernels 1, 3 and 4 on the H100: the port's
counterpart of the reference's ``repro/kernels/autotune.py`` (a TPU
block-size search under a VMEM budget).

Each of the three kernels the reference tunes takes one layout at launch
(``repro_torch.kernels.stacked_relation_agg.ops``, module docstring), named
by the reference's ``(block_n, block_out, block_in)``:

  * ``stacked_mean_linear`` (kernel 1): ``block_n`` 16 or 64, the rows of
    its fp32 tile (RM = 1 or 4); ``block_out`` 64 and ``block_in`` 32 fixed;
  * ``stacked_attn_epilogue`` (kernel 4): ``block_n`` 64, the 64-pair tile,
    or 16, the lean layout (one row a block); the same fixed fields;
  * ``stacked_softmax_combine`` (kernel 3): ``block_n`` rows per block,
    ``block_in`` neighbours a chunk of logits; ``block_out`` 1024 fixed.

This pass sweeps, per shape class (the reference's key,
``repro_torch.kernels.ops.shape_class``), the layouts the kernel can launch
there within one block's 227 KB of opt-in shared memory, and writes the
winners to a JSON table that ``repro_torch.kernels.ops.resolve_blocks``
reads when ``kernels.autotune`` is on.  A shape class can stand for several
launches (two slot counts at one n; R-GAT's and HGT's operand variants): a
layout's cost there is the sum over them, and it must launch for each.

Two scoring modes:

  * ``mode="measured"`` — each layout's launches on the card, captured as
    one CUDA graph per layout and replayed on one stream between CUDA
    events, after a warm-up, the layouts taking turns; the median of the
    repeats.  It needs a CUDA device (it raises without one: no plain
    version is ever timed in the kernel's place).  A winner is kept only
    when it beats the shape rule's layout by more than the spread (max -
    min) of its own repeats; otherwise the entry records the rule's layout,
    so that the table never encodes noise.  The committed table is this
    mode's, from an H100.
  * ``mode="analytic"`` — a deterministic Hopper-shaped model (waves of
    blocks over 132 SMs, blocks an SM bounded by shared memory and threads;
    bytes at 3.35 TB/s; fp32 operations at 67 TFLOP/s; a fixed cost a
    block): pure arithmetic of the shape and the layout, so repeat runs give
    bit-identical tables on any host.

The layout arithmetic below (:func:`mean_linear_smem`, :func:`attn_choose`,
:func:`softmax_combine_choose`) restates the C entry points' so that the
analytic mode and :func:`candidates` run without the card;
``chip_smoke.py`` holds it against the entry points' own layout queries.

Table schema (version 1)::

    {"version": 1, "mode": "measured", "backend": "cuda",
     "card": "<nvidia-smi name, power.limit>", "smem_bytes": 232448,
     "entries": {"<op>/<dtype>/n<2^k>/f<f>/di<d>/do<d>":
                 {"block_n": int, "block_out": int, "block_in": int,
                  "source": "analytic" | "measured", "cost_us": float}}}

Regenerate on the card with ``python -m repro_torch.kernels.autotune --mode
measured --out src/repro_torch/kernels/tuning_table.json`` (``--mode
analytic`` anywhere).
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kernels.ops import TUNING_TABLE_PATH, load_tuning_table, shape_class

__all__ = [
    "OPS",
    "candidates",
    "rule_blocks",
    "operands",
    "launch",
    "analytic_cost_us",
    "measured_cost_us",
    "autotune_op",
    "build_table",
    "save_table",
    "validate_table",
    "DEFAULT_SHAPES",
]

OPS = ("stacked_mean_linear", "stacked_attn_epilogue", "stacked_softmax_combine")
# launch variants a shape class stands for: kernel 4's R-GAT operands (values
# shared with the logits projection, eb, leaky_relu, a per-slot query) and
# HGT's (own values, pe/pv transforms); kernel 3's e and v contiguous
# (R-GAT) and as HGT's head-major einsum views
VARIANTS = {"stacked_mean_linear": ("plain",), "stacked_attn_epilogue": ("rgat", "hgt"),
            "stacked_softmax_combine": ("rgat", "hgt")}
HEAD_DIM = 16  # the head split of d_out, as the reference's _heads_of

SMEM_BYTES = 232448  # opt-in shared memory of one block on sm_90
SM_SMEM = 233472  # shared memory of one SM (228 KB)
SM_THREADS = 2048
SM_BLOCKS = 32
SMS = 132
# the analytic model's rates (H100 SXM: HBM3, fp32 on the CUDA cores) and
# the fixed cost of a block (prologue, barriers, epilogue)
BYTES_PER_US = 3.35e6
FLOPS_PER_US = 67e6
BLOCK_US = 1.0
# the measured mode: each layout's CUDA graph holds ITERS launches and is
# timed REPEATS times
REPEATS, ITERS = 5, 10

# csrc/fp32_tile.cuh
_BN, _KC, _AP, _MAX_KW = 64, 32, 36, 128
# csrc/stacked_softmax_combine.cu
_SC_THREADS, _SC_DEPTH = 256, 16

Blocks = Tuple[int, int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _heads_of(d_out: int) -> Tuple[int, int]:
    dh = min(HEAD_DIM, d_out)
    return max(1, d_out // dh), dh


# --------------------------------------------------------------------------
# the entry points' layout arithmetic
# --------------------------------------------------------------------------


def _slice_depth(d_in: int) -> int:
    return min(_cdiv(max(d_in, 1), _KC) * _KC, _MAX_KW)


def mean_linear_rm_rule(rb: int, n: int, d_out: int) -> int:
    """``csrc/fp32_tile.cuh`` ``rows_per_thread`` at kernel 1's cap of 4."""
    return 4 if rb * _cdiv(n, 64) * _cdiv(d_out, _BN) >= SMS else 1


def mean_linear_smem(rm: int, f: int, d_in: int) -> int:
    """Shared bytes of a kernel 1 block (``csrc/mean_linear.cuh`` ``launch``)."""
    stages = 0 if f == 1 else (2 if rm >= 4 else 4)
    extra = 4 * (0 if f == 1 else stages * 4096 - 16 * rm * _AP) + 2 * 16 * rm * 4
    return 4 * (_slice_depth(d_in) * _BN + 2 * 16 * rm * _AP) + extra


def attn_choose(f: int, d_in: int, nh: int, dh: int, two: bool, post: bool,
                rm: int) -> Optional[Tuple[int, int, int]]:
    """``(rm, rows per block, shared bytes)`` of a kernel 4 launch
    (``csrc/stacked_attn_epilogue.cu`` ``choose``), or ``None`` refused."""
    if rm not in (0, 1, 4) or f < 1:
        return None
    H, k = nh * dh, 2 if two else 1
    q = 2 if post else 1

    def main(st, ep, alias):
        return _cdiv(max(st, ep) if alias else st + ep, 4) * 4

    def stage(r, kw):
        return k * kw * _BN + 2 * 16 * r * _AP

    def epi(rows, zp):
        return rows * f * zp * k + rows * f * nh + rows * H * q

    def inputs(rows):
        return rows * H + rows * nh + (rows * f + 7) // 4

    lean = 4 * (main(stage(1, _KC), epi(1, H), False) + inputs(1))
    if 4 * (f * (H * k + nh) + H * q + 64 * 33 + 32 * 64 * k) > SMEM_BYTES or lean > SMEM_BYTES:
        return None
    rows = 1 if f >= 64 else 64 // f
    kw = _slice_depth(d_in)
    one = rows * f <= 64 and H <= _BN and d_in <= kw
    smem = 4 * (main(stage(4, kw), epi(rows, H + 1), one) + inputs(rows))
    if rm == 4 or (rm == 0 and smem <= SMEM_BYTES):
        return (4, rows, smem) if smem <= SMEM_BYTES else None
    return 1, 1, lean


def _sc_smem(rows: int, nh: int, depth: int) -> int:
    return 4 * (rows * (depth + 1) * nh + 2 * rows * nh) + rows * depth


def softmax_combine_choose(nh: int, dh: int, rows: int,
                           depth: int) -> Optional[Tuple[int, int, int]]:
    """``(rows per block, chunk depth, shared bytes)`` of a kernel 3 launch
    (``csrc/stacked_softmax_combine.cu`` ``choose``), or ``None`` refused."""
    chunks = _cdiv(nh * dh, 4)
    most = 1 if chunks >= _SC_THREADS else _SC_THREADS // chunks
    if not (0 <= rows <= most and 0 <= depth <= _SC_DEPTH):
        return None
    rows = rows or most
    if depth == 0:
        depth = _SC_DEPTH
        while depth > 1 and _sc_smem(rows, nh, depth) > 48 * 1024:
            depth //= 2
    smem = _sc_smem(rows, nh, depth)
    return None if smem > SMEM_BYTES else (rows, depth, smem)


def _attn_variant(variant: str) -> Tuple[bool, bool]:
    return (False, False) if variant == "rgat" else (True, True)


def _layout_ok(op: str, f: int, d_in: int, d_out: int, blocks: Blocks) -> bool:
    """Whether ``blocks`` launches for every variant of the shape class."""
    bn, bo, bc = blocks
    nh, dh = _heads_of(d_out)
    if op == "stacked_mean_linear":
        return bn in (16, 64) and (bo, bc) == (_BN, _KC)
    if op == "stacked_attn_epilogue":
        return bn in (16, 64) and (bo, bc) == (_BN, _KC) and all(
            attn_choose(f, d_in, nh, dh, *_attn_variant(v), bn // 16) is not None
            for v in VARIANTS[op])
    if op == "stacked_softmax_combine":
        return bo == 4 * _SC_THREADS and softmax_combine_choose(nh, dh, bn, bc) is not None
    raise ValueError(f"unknown autotune op {op!r}; ops: {OPS}")


def rule_blocks(op: str, rb: int, n: int, f: int, d_in: int, d_out: int,
                variant: str = "rgat") -> Optional[Blocks]:
    """The layout the entry point's shape rule takes for one launch, or
    ``None`` where the rule refuses it."""
    nh, dh = _heads_of(d_out)
    if op == "stacked_mean_linear":
        return 16 * mean_linear_rm_rule(rb, n, d_out), _BN, _KC
    if op == "stacked_attn_epilogue":
        lay = attn_choose(f, d_in, nh, dh, *_attn_variant(variant), 0)
        return None if lay is None else (16 * lay[0], _BN, _KC)
    if op == "stacked_softmax_combine":
        lay = softmax_combine_choose(nh, dh, 0, 0)
        return None if lay is None else (lay[0], 4 * _SC_THREADS, lay[1])
    raise ValueError(f"unknown autotune op {op!r}; ops: {OPS}")


def candidates(op: str, n: int, f: int, d_in: int, d_out: int) -> List[Blocks]:
    """The layouts the kernel launches at this shape class, for every
    variant it stands for, within one block's shared memory: kernel 1 both
    tiles; kernel 4 the tile and the lean layout where each fits; kernel 3
    rows per block at the powers of two up to the most a block holds (and
    that most), each at the rule's chunk depth for those rows."""
    if op in ("stacked_mean_linear", "stacked_attn_epilogue"):
        cands = [(bn, _BN, _KC) for bn in (16, 64)]
    elif op == "stacked_softmax_combine":
        nh, dh = _heads_of(d_out)
        most = softmax_combine_choose(nh, dh, 0, 0)
        if most is None:
            return []
        rows = sorted({1 << i for i in range(most[0].bit_length()) if 1 << i <= most[0]}
                      | {most[0]})
        cands = []
        for r in rows:
            lay = softmax_combine_choose(nh, dh, r, 0)
            if lay is not None:
                cands.append((r, 4 * _SC_THREADS, lay[1]))
    else:
        raise ValueError(f"unknown autotune op {op!r}; ops: {OPS}")
    return sorted(c for c in cands if _layout_ok(op, f, d_in, d_out, c))


# --------------------------------------------------------------------------
# the analytic model
# --------------------------------------------------------------------------


def _work(op: str, rb: int, n: int, f: int, d_in: int, d_out: int, blocks: Blocks,
          variant: str):
    """(blocks, threads, shared bytes, share of the launched rows in use,
    bytes, operations) of one launch in a layout."""
    bn, _, bc = blocks
    nh, dh = _heads_of(d_out)
    H = nh * dh
    if op == "stacked_mean_linear":
        rm = bn // 16
        tiles = _cdiv(n, 16 * rm)
        nblocks = rb * tiles * _cdiv(d_out, _BN)
        nbytes = (4 * rb * n * f * d_in + rb * n * f + 4 * rb * n * d_out
                  + nblocks * 4 * d_in * _BN)  # each block stages its weight slice
        flops = 2 * rb * n * (f * d_in + d_in * d_out)
        return nblocks, 128, mean_linear_smem(rm, f, d_in), n / (tiles * 16 * rm), nbytes, flops
    if op == "stacked_attn_epilogue":
        two, post = _attn_variant(variant)
        rm, rows, smem = attn_choose(f, d_in, nh, dh, two, post, bn // 16)
        k = 2 if two else 1
        tiles = _cdiv(n, rows)
        nblocks = rb * tiles
        passes = _cdiv(rows * f, 16 * rm)
        fill = (n / (tiles * rows)) * (rows * f / (passes * 16 * rm))
        nbytes = (4 * rb * n * f * d_in + rb * n * f + 8 * rb * n * H
                  + nblocks * 4 * k * d_in * H)
        flops = 2 * k * rb * n * f * d_in * H + 6 * rb * n * f * H
        return nblocks, 128 * k, smem, fill, nbytes, flops
    if op == "stacked_softmax_combine":
        rows, depth, smem = softmax_combine_choose(nh, dh, bn, bc)
        chunks = _cdiv(H, 4)
        tiles = _cdiv(n, rows)
        nblocks = rb * tiles * _cdiv(chunks, _SC_THREADS)
        fill = (n / (tiles * rows)) * rows * min(chunks, _SC_THREADS) / _SC_THREADS
        nbytes = 4 * rb * n * f * nh + rb * n * f + 4 * rb * n * f * H + 4 * rb * n * H
        flops = 4 * rb * n * nh * f + 2 * rb * n * H * f
        return nblocks, _SC_THREADS, smem, fill, nbytes, flops
    raise ValueError(f"unknown autotune op {op!r}; ops: {OPS}")


def analytic_cost_us(op: str, n: int, f: int, d_in: int, d_out: int,
                     bn: int, bo: int, bc: int, rb: int = 4,
                     variant: Optional[str] = None) -> float:
    """Deterministic cost of one launch (all variants of the shape class
    summed when ``variant`` is None): the roofline time (bytes at 3.35
    TB/s or fp32 operations at 67 TFLOP/s, the larger), stretched by the
    share of the card's block slots and of each block's rows the launch
    leaves idle, plus a fixed cost a block for each wave."""
    if variant is None:
        return sum(analytic_cost_us(op, n, f, d_in, d_out, bn, bo, bc, rb, v)
                   for v in VARIANTS[op])
    nblocks, threads, smem, fill, nbytes, flops = _work(op, rb, n, f, d_in, d_out,
                                                         (bn, bo, bc), variant)
    per_sm = max(1, min(SM_THREADS // threads, SM_SMEM // smem, SM_BLOCKS))
    waves = _cdiv(nblocks, SMS * per_sm)
    slots = nblocks / (waves * SMS * per_sm)
    return max(nbytes / BYTES_PER_US, flops / FLOPS_PER_US) / (slots * fill) + waves * BLOCK_US


# --------------------------------------------------------------------------
# the measured mode (on the card)
# --------------------------------------------------------------------------


def _require_card():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("autotune mode 'measured' times the CUDA kernels and needs a CUDA "
                           "device; mode 'analytic' runs anywhere")
    return torch


def operands(op: str, rb: int, n: int, f: int, d_in: int, d_out: int, variant: str,
             seed: int) -> dict:
    """Operands of one launch on the card, drawn from ``seed`` (row 0 of
    slot 0 fully masked): the keywords of :func:`launch` and, but for
    ``out``, of the op's plain version."""
    torch = _require_card()
    from repro_torch.kernels.stacked_relation_agg import ops as sra

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    mask = (torch.rand((rb, n, f), generator=gen, device=dev) > 0.3).to(torch.uint8)
    mask[0, 0] = 0
    nh, dh = _heads_of(d_out)
    H = nh * dh
    if op == "stacked_mean_linear":
        U = max(1, rb // 2)  # slots share stack rows
        return dict(h=randn(rb, n, f, d_in), mask=mask, w=randn(U, d_in, d_out, scale=0.1),
                    b=randn(U, d_out, scale=0.1),
                    slot_u=torch.arange(rb, dtype=torch.int32, device=dev) % U,
                    out=torch.empty((rb, n, d_out), device=dev))
    if op == "stacked_attn_epilogue":
        two, post = _attn_variant(variant)
        U = max(1, rb // 2)
        return dict(
            h=randn(rb, n, f, d_in), mask=mask,
            qv=randn(rb, n, H, scale=0.3) if two else randn(rb, 1, H, scale=0.1).expand(rb, n, H),
            eb=None if two else randn(rb, n, nh), we=randn(U, d_in, H, scale=0.1),
            wv=randn(U, d_in, H, scale=0.1) if two else None,
            pe=randn(U, nh, dh, dh, scale=0.3) if post else None,
            pv=randn(U, nh, dh, dh, scale=0.3) if post else None,
            us=sra.attn_slots(*(r.integers(0, U, rb) for _ in range(3)), (U, U, U), rb, dev),
            num_heads=nh, head_dim=dh, scale=1 / math.sqrt(dh) if post else 1.0,
            slope=None if two else 0.2, out=torch.empty((rb, n, H), device=dev))
    if op == "stacked_softmax_combine":
        if variant == "hgt":  # the head-major views HGT's einsums return
            e = randn(rb, nh, n, f).permute(0, 2, 3, 1)
            v = randn(rb, nh, n, f, dh).permute(0, 2, 3, 1, 4)
        else:
            e, v = randn(rb, n, f, nh), randn(rb, n, f, nh, dh)
        return dict(e=e, mask=mask, v=v, out=torch.empty((rb, n, H), device=dev))
    raise ValueError(f"unknown autotune op {op!r}; ops: {OPS}")


def launch(op: str, ops: dict, blocks: Optional[Blocks]) -> None:
    """One raw, uncounted launch of ``op`` on :func:`operands` in the layout
    ``blocks`` (None: the entry point's shape rule) into ``ops["out"]``."""
    from repro_torch.kernels.stacked_relation_agg import ops as sra

    if op == "stacked_mean_linear":
        sra.launch_kernel(ops["h"], ops["mask"], ops["w"], ops["b"], ops["slot_u"], ops["out"],
                          0 if blocks is None else blocks[0] // 16)
    elif op == "stacked_attn_epilogue":
        sra.launch_attn_epilogue(
            ops["h"], ops["mask"], ops["qv"], ops["eb"], ops["we"], ops["wv"], ops["pe"],
            ops["pv"], ops["us"], ops["out"], None, None, ops["num_heads"], ops["head_dim"],
            ops["scale"], ops["slope"], 0 if blocks is None else blocks[0] // 16)
    elif op == "stacked_softmax_combine":
        sra.launch_softmax_combine(ops["e"], ops["mask"], ops["v"], ops["out"],
                                   *((0, 0) if blocks is None else (blocks[0], blocks[2])))
    else:
        raise ValueError(f"unknown autotune op {op!r}; ops: {OPS}")


def _sample_us(op: str, instances, layouts):
    """``{layout: [us of the summed instances, one per repeat]}``: each
    (instance, layout) as one CUDA graph of ITERS launches, warmed up,
    then replayed between CUDA events REPEATS times, the layouts taking
    turns in each repeat."""
    torch = _require_card()
    graphs, held = {}, []
    for i, (rb, n, f, d_in, d_out, variant) in enumerate(instances):
        # a graph holds its operands' addresses, not the tensors: they stay
        # alive here until the last replay (each capture empties the cache)
        ops = operands(op, rb, n, f, d_in, d_out, variant, seed=i)
        held.append(ops)
        for lay in layouts:
            launch(op, ops, lay)  # builds the library, sets the shared memory attribute
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(ITERS):
                    launch(op, ops, lay)
            g.replay()
            graphs[(i, lay)] = g
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    samples = {lay: [0.0] * REPEATS for lay in layouts}
    for rep in range(REPEATS):
        turn = layouts[rep % len(layouts):] + layouts[:rep % len(layouts)]
        for i in range(len(instances)):
            for lay in turn:
                start.record()
                graphs[(i, lay)].replay()
                stop.record()
                stop.synchronize()
                samples[lay][rep] += start.elapsed_time(stop) * 1e3 / ITERS
    return samples


def measured_cost_us(op: str, n: int, f: int, d_in: int, d_out: int,
                     bn: int, bo: int, bc: int, rb: int = 4,
                     variant: Optional[str] = None) -> float:
    """Median µs of one launch in the layout ``(bn, bo, bc)`` on the card
    (all variants of the shape class summed when ``variant`` is None);
    raises without a CUDA device."""
    _require_card()
    variants = VARIANTS[op] if variant is None else (variant,)
    lay = (bn, bo, bc)
    instances = [(rb, n, f, d_in, d_out, v) for v in variants]
    return float(np.median(_sample_us(op, instances, [lay])[lay]))


# --------------------------------------------------------------------------
# the sweep and the table
# --------------------------------------------------------------------------


def autotune_op(op: str, n: int, f: int, d_in: int, d_out: int,
                dtype: str = "float32", mode: str = "analytic", rbs: Sequence[int] = (4,),
                details: Optional[dict] = None) -> Tuple[str, Optional[Dict]]:
    """Sweep one shape class over its launches (each slot count of ``rbs``
    times each variant); returns ``(key, winning entry)``, the entry None
    where a measured winner does not beat the rule and the launches' rules
    disagree (the key then stays out of the table: a miss keeps each rule).
    ``details``, when given, gets the sweep's numbers under the key."""
    if mode not in ("analytic", "measured"):
        raise ValueError(f"mode must be analytic|measured, got {mode!r}")
    cands = candidates(op, n, f, d_in, d_out)
    if not cands:
        raise ValueError(f"{op} at n={n}, f={f}, d_in={d_in}, d_out={d_out}: no layout "
                         f"launches for every variant")
    key = shape_class(op, n, f, d_in, d_out, dtype)
    instances = [(rb, n, f, d_in, d_out, v) for rb in rbs for v in VARIANTS[op]]
    rules = {rule_blocks(op, *inst) for inst in instances}
    rule = rules.pop() if len(rules) == 1 else None
    info = dict(candidates=[list(c) for c in cands], rule=None if rule is None else list(rule))
    if mode == "analytic":
        costs = {c: sum(analytic_cost_us(op, n, f, d_in, d_out, *c, rb=rb, variant=v)
                        for rb, *_, v in instances) for c in cands}
        # ties go to the rule's layout, then to the smaller one
        best = min(cands, key=lambda c: (costs[c], c != rule, c))
        info.update(costs_us={str(list(c)): costs[c] for c in cands})
        entry = dict(zip(("block_n", "block_out", "block_in"), best),
                     source="analytic", cost_us=round(costs[best], 3))
    else:
        samples = _sample_us(op, instances, [None] + cands)
        med = {c: float(np.median(s)) for c, s in samples.items()}
        best = min(cands, key=lambda c: (med[c], c))
        spread = max(samples[best]) - min(samples[best])
        kept = med[None] - med[best] > spread
        info.update(rule_us=med[None],
                    rule_spread_us=max(samples[None]) - min(samples[None]),
                    winner=list(best), winner_us=med[best], spread_us=spread, kept=kept,
                    costs_us={str(list(c)): med[c] for c in cands})
        pick = best if kept else rule
        entry = None if pick is None else dict(
            zip(("block_n", "block_out", "block_in"), pick), source="measured",
            cost_us=round(med[best] if kept else med[None], 3))
    if details is not None:
        details[key] = info
    return key, entry


# (op, rb, n, f, d_in, d_out): the shapes the port's paths launch (ogbn-mag,
# batch 1024, fanouts (4, 3), hidden 64, 4 heads of 16; PERF.md section 6),
# then the reference's DEFAULT_SHAPES (mag-shaped and paper-scale widths) at
# its measured slot count, 4
DEFAULT_SHAPES: Tuple[Tuple[str, int, int, int, int, int], ...] = (
    ("stacked_mean_linear", 6, 4096, 3, 128, 64),    # R-GCN training leaf
    ("stacked_mean_linear", 3, 1024, 4, 64, 64),     # R-GCN training top
    ("stacked_mean_linear", 6, 4096, 1, 128, 64),    # attention q side, leaf
    ("stacked_mean_linear", 3, 1024, 1, 128, 64),    # q side, top and serving
    ("stacked_mean_linear", 2, 1024, 16, 128, 64),   # R-GCN serving blocks
    ("stacked_mean_linear", 3, 1024, 16, 128, 64),
    ("stacked_attn_epilogue", 6, 4096, 3, 128, 64),  # R-GAT / HGT training leaf
    ("stacked_attn_epilogue", 3, 1024, 4, 64, 64),   # training top
    ("stacked_attn_epilogue", 2, 1024, 16, 128, 64),  # serving blocks
    ("stacked_attn_epilogue", 3, 1024, 16, 128, 64),
    ("stacked_softmax_combine", 6, 4096, 3, 128, 64),  # unfused training leaf
    ("stacked_softmax_combine", 3, 1024, 4, 64, 64),   # unfused training top
    ("stacked_softmax_combine", 2, 1024, 16, 128, 64),  # unfused infer_all
    ("stacked_softmax_combine", 3, 1024, 16, 128, 64),
    ("stacked_mean_linear", 4, 1024, 25, 128, 64),    # the reference's mag_l1
    ("stacked_mean_linear", 4, 2048, 20, 64, 64),     # mag_l2_shared
    ("stacked_mean_linear", 4, 4096, 25, 789, 349),   # donor-wide features
    ("stacked_mean_linear", 4, 25600, 25, 1024, 64),  # IGB-HET scale
    ("stacked_attn_epilogue", 4, 1024, 25, 128, 64),
    ("stacked_attn_epilogue", 4, 2048, 20, 64, 64),
    ("stacked_attn_epilogue", 4, 25600, 25, 1024, 64),
    ("stacked_softmax_combine", 4, 1024, 25, 4, 64),
    ("stacked_softmax_combine", 4, 2048, 20, 4, 64),
)


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def build_table(shapes=DEFAULT_SHAPES, mode: str = "analytic",
                details: Optional[dict] = None) -> Dict:
    """Sweep every shape class of ``shapes`` (launches sharing a key, at
    several slot counts, are swept together) into a table."""
    groups: Dict[Tuple[str, str], List[Tuple[int, ...]]] = collections.OrderedDict()
    for op, rb, n, f, d_in, d_out in shapes:
        groups.setdefault((op, shape_class(op, n, f, d_in, d_out)), []).append((rb, n, f, d_in,
                                                                              d_out))
    table = {"version": 1, "mode": mode, "smem_bytes": SMEM_BYTES,
             "backend": "cuda" if mode == "measured" else "any"}
    if mode == "measured":
        _require_card()
        table["card"] = _card()
    entries = {}
    for (op, _), launches in groups.items():
        _, n, f, d_in, d_out = launches[0]
        key, entry = autotune_op(op, n, f, d_in, d_out, mode=mode,
                                 rbs=sorted({rb for rb, *_ in launches}), details=details)
        if entry is not None:
            entries[key] = entry
    table["entries"] = dict(sorted(entries.items()))
    return table


def save_table(table: Dict, path=None) -> Path:
    p = Path(path) if path else TUNING_TABLE_PATH
    with open(p, "w") as fh:
        json.dump(table, fh, indent=1, sort_keys=True)
        fh.write("\n")
    load_tuning_table.cache_clear()  # launches re-read the new winners
    return p


def validate_table(table: Dict) -> None:
    """Schema check: every entry's key parses, names a tuned op, and holds
    a layout among :func:`candidates` of its shape class (so every entry
    launches); a measured table names its card."""
    if table.get("version") != 1:
        raise ValueError(f"bad tuning-table version: {table.get('version')!r}")
    entries = table.get("entries")
    if not isinstance(entries, dict):
        raise ValueError("tuning table has no 'entries' dict")
    if table.get("mode") == "measured" and (table.get("backend") != "cuda"
                                            or not table.get("card")):
        raise ValueError("a measured tuning table names backend 'cuda' and its card")
    for key, e in entries.items():
        try:
            op, _, nb, fb, dib, dob = key.split("/")
            n, f = int(nb[1:]), int(fb[1:])
            d_in, d_out = int(dib[2:]), int(dob[2:])
        except ValueError:
            raise ValueError(f"malformed tuning-table key {key!r}") from None
        if op not in OPS:
            raise ValueError(f"entry {key!r}: unknown op {op!r}")
        for field in ("block_n", "block_out", "block_in"):
            v = e.get(field)
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                raise ValueError(f"entry {key!r}: {field} must be a positive int, got {v!r}")
        if e.get("source") not in ("analytic", "measured"):
            raise ValueError(f"entry {key!r}: bad source {e.get('source')!r}")
        lay = (e["block_n"], e["block_out"], e["block_in"])
        if lay not in candidates(op, n, f, d_in, d_out):
            raise ValueError(f"entry {key!r}: layout {lay} is not one the kernel launches "
                             f"there: {candidates(op, n, f, d_in, d_out)}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help=f"tuning-table path to write (the committed one: {TUNING_TABLE_PATH})")
    ap.add_argument("--mode", choices=("analytic", "measured"), default="analytic")
    args = ap.parse_args(argv)
    table = build_table(mode=args.mode)
    p = save_table(table, args.out)
    print(f"wrote {len(table['entries'])} entries -> {p}")


if __name__ == "__main__":
    main()
