#!/usr/bin/env python3
"""Time kernel 8 (``src/repro_torch/kernels/csrc/flash_attention.cu``) on the
card against a parent version of its source and against modified copies of
itself, each taking one part of the wgmma kernel's tile loop out.

Run from the repository root on a machine with one NVIDIA GPU:

    git show HEAD~1:src/repro_torch/kernels/csrc/flash_attention.cu \\
        > build/parent_flash_attention.cu
    python3 tools/flash_variants.py --parent build/parent_flash_attention.cu

Every source is compiled with the port's nvcc flags
(``repro_torch.kernels.build.NVCC_FLAGS``), one nvcc each, all at once, into
``build/flash_variants/``, and every library is called through the same bare
ctypes closure (the port's wrapper adds host time of its own).  Times are
``chip_smoke.time_ms`` (CUDA events over 40 launches, inputs rotated through
more than the 50 MB L2), taken in turns: every source once in order, then
once in reverse.  The copies:

  no_exp      exp2f(x) is x: the softmax without its exponentials;
  no_pv       no o += p v product;
  no_qk       no s = q k^T product (the scores stay 0);
  loads_only  none of the three: what the TMA ring and the rest of the
              softmax take alone;
  stages3     a three-stage K/V ring in place of two.

A copy's answers are wrong by design; only its time is read.  The parent
and the change are also compared on one input (bit-equal, or the max abs
difference).  Prints the card's name and power limit, one line a shape and
one JSON line with every time.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "flash_variants"
# (b, h, hk, sq, sk, d, causal, window, q_offset, dtype code): hubert-xlarge's
# prefill, the same at d 32 and d 64 and d 128, granite's and llama's prefills
SHAPES = [(4, 16, 16, 2048, 2048, 80, 0, -1, 0, 1), (4, 16, 16, 2048, 2048, 32, 0, -1, 0, 1),
          (4, 16, 16, 2048, 2048, 64, 0, -1, 0, 1), (4, 16, 16, 2048, 2048, 128, 0, -1, 0, 1),
          (4, 16, 8, 2048, 2048, 64, 1, -1, 0, 1), (4, 24, 8, 2048, 2048, 128, 1, -1, 0, 1)]
EXP = "#include <stdint.h>\n"
QK = "wgmma_ss_n128(sc, sw128_desc(q_s + off, 1, 64), sw128_desc(k_s + off, 1, 64), kk > 0);"
PV = "wgmma_pv<D>(o, pa[kk], sw128_desc(v_s + kk * 16 * kAtom * 2, L::kBlock / 16, 64));"
STAGES = "constexpr int kStages = 2;"


def variants(src: str) -> dict:
    """The modified copies of the kernel's source, by name."""
    for anchor in (EXP, QK, PV, STAGES):
        if anchor not in src:
            raise SystemExit(f"flash_variants: the source no longer holds {anchor!r}")
    no_exp = src.replace(EXP, EXP + "#define exp2f(x) (x)\n")
    return {"no_exp": no_exp, "no_pv": src.replace(PV, ";"),
            "no_qk": src.replace(QK, "(void)off;"),
            "loads_only": no_exp.replace(QK, "(void)off;").replace(PV, ";"),
            "stages3": src.replace(STAGES, "constexpr int kStages = 3;")}


def compile_all(sources: dict, build) -> dict:
    """{name: library path}, one nvcc per source, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"flash_variants: {name} failed to compile:\n{log[-4000:]}")
        libs[name] = lib
    return libs


def closure(path: Path, torch, fa):
    """A bare launch of the library's entry point, as ``ops.launch_kernel``
    makes it."""
    fn = ctypes.CDLL(str(path)).flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_longlong] * 6
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(q, k, v, out, causal, window, q_offset):
        b, sq, h, d = q.shape
        strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, out)
                                              for i in range(3)))
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    fa.dtype_code(q.dtype), b, h, k.shape[2], sq, k.shape[1], d, strides,
                    int(causal), -1 if window is None else window, q_offset,
                    1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"flash_variants: launch returned {status}")
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a parent version of csrc/flash_attention.cu, timed beside it")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa

    print(cs.card_line(), flush=True)
    src = (build.CSRC / "flash_attention.cu").read_text()
    sources = {"change": src}
    if args.parent:
        sources["parent"] = Path(args.parent).read_text()
    sources.update(variants(src))
    runs = {name: closure(lib, torch, fa) for name, lib in compile_all(sources, build).items()}
    order = list(runs)
    report = []
    for shape in SHAPES:
        kw = cs.flash_args(shape)
        sets = [cs.flash_inputs(shape, 800 + i, "cuda") for i in range(4)]
        raw = [(q, k, v, torch.empty_like(q), kw["causal"], kw["window"], kw["q_offset"])
               for q, k, v in sets]
        row = dict(shape=list(shape), ms={name: [] for name in order})
        for name in order + order[::-1]:
            row["ms"][name].append(cs.time_ms(runs[name], raw, iters=40))
        if "parent" in runs:
            outs = {}
            for name in ("change", "parent"):
                runs[name](*raw[0])
                outs[name] = raw[0][3].clone()
            torch.cuda.synchronize()
            row["parent_equal"] = bool(torch.equal(outs["change"], outs["parent"]))
            row["parent_max_abs"] = float((outs["change"].float() - outs["parent"].float())
                                          .abs().max())
        b, h, hk, sq, sk, d, causal, window, off, code = shape
        flops = 4 * d * cs.flash_pairs(sq, sk, causal, window, off) * b * h
        row["bound_ms"] = flops / cs.BF16_FLOP_PER_S * 1e3
        report.append(row)
        print(f"{tuple(shape)} bound {row['bound_ms']:.4f} ms; " + ", ".join(
            f"{n} {' / '.join(f'{t:.4f}' for t in row['ms'][n])}" for n in order)
            + (f"; parent bit-equal {row['parent_equal']}, max abs {row['parent_max_abs']:.3g}"
               if "parent" in runs else ""), flush=True)
    print(cs.card_line())
    print(json.dumps({"flash_variants": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
