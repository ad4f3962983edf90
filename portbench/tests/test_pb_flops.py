"""The operation counts against hand-worked values for the four cells."""

from __future__ import annotations

import json

import pytest
from conftest import ROOT

from portbench import flops
from portbench.flops import attention


def cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def test_granite_train_step():
    # a layer, T = 8192: projections 2 T D (H + 2 KV) hd + 2 T H hd D = 51.54e9; attention's
    # products 4 b H s^2 hd / 2 = 68.72e9; MoE 2 T D E + 2 T K 3 D F = 206.70e9; head 2 T D V
    c, T = cfg("granite-moe-1b-a400m"), 2 * 4096
    proj = 2 * T * 1024 * 32 * 64 + 2 * T * 1024 * 1024
    core = 4 * 2 * 16 * 4096 ** 2 * 64 / 2
    moe = 2 * T * 1024 * 32 + 2 * T * 8 * 3 * 1024 * 512
    head = 2 * T * 1024 * 49155
    want = 3 * (24 * (proj + core + moe) + head)
    assert flops.count(c, 2, 4096, "train") == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(26.0e12, rel=0.01)


def test_granite_prefill_call():
    c, T = cfg("granite-moe-1b-a400m"), 4 * 2048
    proj = 2 * T * 1024 * 32 * 64 + 2 * T * 1024 * 1024
    core = 4 * 4 * 16 * 2048 ** 2 * 64 / 2
    moe = 2 * T * 1024 * 32 + 2 * T * 8 * 3 * 1024 * 512
    head = 2 * 4 * 1024 * 49155  # the last position only
    want = 24 * (proj + core + moe) + head
    assert flops.count(c, 4, 2048, "prefill") == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(7.02e12, rel=0.01)
    # attention's least time a layer: 34.4e9 operations at 989 TFLOP/s, 34.7 us
    assert attention.core(c, 4, 2048) / 24 == pytest.approx(34.36e9, rel=1e-3)
    assert attention.core_bytes(c, 4, 2048) / 24 == 4 * 2048 * (32 + 16) * 64 * 2


def test_hubert_train_step():
    c, T = cfg("hubert-xlarge"), 2 * 4096
    proj = 2 * T * 1280 * 48 * 80 + 2 * T * 1280 * 1280
    core = 4 * 2 * 16 * 4096 ** 2 * 80  # not causal
    mlp = 2 * T * 3 * 1280 * 5120
    head = 2 * T * 1280 * 504
    front = 2 * T * 512 * 1280
    want = 3 * (48 * (proj + core + mlp) + head) + 2 * front
    assert flops.count(c, 2, 4096, "train") == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(86.7e12, rel=0.01)


def test_hubert_prefill_call():
    c, T = cfg("hubert-xlarge"), 4 * 2048
    proj = 2 * T * 1280 * 48 * 80 + 2 * T * 1280 * 1280
    core = 4 * 4 * 16 * 2048 ** 2 * 80
    mlp = 2 * T * 3 * 1280 * 5120
    want = 48 * (proj + core + mlp) + 2 * T * 1280 * 504 + 2 * T * 512 * 1280
    assert flops.count(c, 4, 2048, "prefill") == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(24.74e12, rel=0.01)
    # the kernel-8 bound of a layer, 0.0869 ms at 989 TFLOP/s
    assert attention.core(c, 4, 2048) / 48 / 989e12 == pytest.approx(86.9e-6, rel=1e-3)
