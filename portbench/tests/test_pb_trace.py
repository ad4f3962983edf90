"""The idle-share, p95 and roofline arithmetic on synthetic event lists,
and a stall inside the window that moves each end-to-end statistic."""

from __future__ import annotations

import json
import time

import pytest
from conftest import ROOT

from portbench import core, window
from portbench.trace import Trace, gap_owners, gaps, merge

MS = 1_000_000  # ns


def test_merge_and_idle():
    ev = [("a", 0, 10 * MS), ("b", 5 * MS, 12 * MS), ("c", 20 * MS, 30 * MS),
          ("d", 25 * MS, 26 * MS), ("e", 90 * MS, 120 * MS)]
    busy = merge(ev, 0, 100 * MS)
    assert busy == [(0, 12 * MS), (20 * MS, 30 * MS), (90 * MS, 100 * MS)]
    assert gaps(busy, 0, 100 * MS) == [(12 * MS, 20 * MS), (30 * MS, 90 * MS)]
    host = [("portbench.step", 0, 100 * MS), ("aten::mm", 11 * MS, 13 * MS),
            ("cudaLaunchKernel", 29 * MS, 31 * MS)]
    own = dict(gap_owners(gaps(busy, 0, 100 * MS), host))
    assert own == {"aten::mm": pytest.approx(0.008), "cudaLaunchKernel": pytest.approx(0.060)}


def trace(kind, device, units, spans=(), cfg="hubert-xlarge", traffic="prefill"):
    c = json.loads((ROOT / "portbench" / "configs" / f"{cfg}.json").read_text())
    t = json.loads((ROOT / "portbench" / "traffic" / f"{traffic}.json").read_text())
    return Trace(kind, units, list(spans), device, [], units[0][0], units[-1][1], c, t,
                 {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12})


def reader(name):
    return core.load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


def test_idle_share_reader():
    units = [(0, 50 * MS), (50 * MS, 100 * MS)]
    dev = [("gemm", 0, 40 * MS), ("gemm", 50 * MS, 90 * MS), ("memcpy", 85 * MS, 95 * MS)]
    t = trace("prefill", dev, units)
    assert t.busy_s() == pytest.approx(0.085)
    assert reader("device_idle_share.prefill").read(t) == pytest.approx(15.0)
    assert reader("device_idle_share.train").read(t) is None


def test_roofline_reader():
    # hubert's prefill: 48 layers of 86.86 us least time; kernel 8 at 0.3239 ms a layer
    least = 4 * 4 * 16 * 2048 ** 2 * 80 / 989e12
    k = int(0.3239e-3 * 1e9)
    dev = [(f"void flash_attention_wgmma_kernel<80>(...)", i * MS, i * MS + k) for i in range(48)]
    dev.append(("ampere_bf16_s16816gemm", 0, 5 * MS))
    t = trace("prefill", dev, [(0, 100 * MS)])
    share = reader("attn_roofline").read(t)
    assert share == pytest.approx(100 * least / 0.3239e-3, rel=1e-4)
    assert 26 < share < 28
    assert reader("attn_roofline").read(trace("prefill", dev[-1:], [(0, 100 * MS)])) is None


def test_mfu_and_wait_readers():
    spans = [("next_batch", 1, 0, 2 * MS), ("step", 1, 2 * MS, 2000 * MS)]
    t = trace("train", [("k", 0, MS)], [(0, 2000 * MS)], spans, "granite-moe-1b-a400m", "train")
    assert reader("batch_wait_ms.train").read(t) == pytest.approx(2.0)
    # 26.0 TFLOP in 2 s of a 989 TFLOP/s card
    assert reader("train_mfu").read(t) == pytest.approx(100 * 26.0e12 / 2 / 989e12, rel=0.01)
    assert reader("prefill_mfu").read(t) is None


def test_p95_reader_reads_the_untraced_units():
    traced_units = [(0, 500 * MS)]  # slowed by the profiler
    free = [(i * 100 * MS, i * 100 * MS + (90 if i % 20 else 150) * MS) for i in range(40)]
    t = trace("prefill", [("k", 0, MS)], traced_units)
    t.free_units = free
    assert reader("prefill_p95_ms").read(t) == pytest.approx(90.0)
    t.free_units = free[:19] + [(0, 150 * MS)] * 2  # 2 of 21 slow: past the 95th rank
    assert reader("prefill_p95_ms").read(t) == pytest.approx(150.0)


def test_nearest_rank():
    v = list(range(1, 101))
    assert core.nearest_rank(v, 0.95) == 95
    assert core.nearest_rank(v[:20], 0.95) == 19
    assert core.nearest_rank([3.0], 0.95) == 3.0


def stats(delays):
    """The drivers' end-to-end statistics over a window of sleeping units."""
    lat = []

    def unit(i):
        t0 = time.perf_counter()
        time.sleep(delays(i))
        lat.append(time.perf_counter() - t0)

    win = window.run(unit, 0.4)
    n = len(win.units)
    return {"step_ms": win.seconds * 1e3 / n, "per_s": n / win.seconds,
            "p95_ms": core.nearest_rank(lat, 0.95) * 1e3}


def test_a_stall_moves_every_statistic():
    base = stats(lambda i: 0.002)
    stall = stats(lambda i: 0.002 if i % 5 else 0.060)  # one unit in five stalls
    assert stall["step_ms"] > 1.5 * base["step_ms"]
    assert stall["per_s"] < base["per_s"] / 1.5
    assert stall["p95_ms"] > 3 * base["p95_ms"]
