"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, over
PyTorch's fake process group.

  * ``CollectiveCounter`` on a fake 4-rank (2, 2) mesh over DTensor ops
    whose collectives are known: a gather of a batch-sharded tensor, the
    all-reduce of a product's partial sums, an all-to-all over the model
    axis; the bytes are each collective's result on rank 0, the FLOPs the
    local products' (DTensor's shape propagation on the global shapes is
    not counted).
  * ``_analyze`` of reduced llama3.2-3b (train, prefill, decode) and of
    reduced qwen3-moe-30b-a3b (train, ``variant="ep"``) on a fake (2, 2)
    mesh: each step runs, with FLOPs and collectives counted and the
    argument bytes those of the local shards.
  * A failing combination is recorded with status ``error`` (experts that
    do not split over the model axis), and a process with a real default
    group is refused.
"""

import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

import repro_torch.configs.all_archs  # noqa: F401
from repro_torch.configs import get_arch
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh


@pytest.fixture(scope="module")
def mesh22():
    if dist.is_initialized():
        pytest.fail("a default process group is already open in this worker")
    dryrun.fake_world(4)
    yield make_test_mesh(2, 2, device_type="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_collective_counter_on_known_ops(mesh22):
    from torch.distributed._functional_collectives import all_to_all_single_autograd

    a = distribute_tensor(_meta(8, 6), mesh22, [Shard(0), Replicate()])
    x = distribute_tensor(_meta(8, 16, 32), mesh22, [Shard(0), Replicate()])
    w = distribute_tensor(_meta(32, 64), mesh22, [Replicate(), Shard(1)])
    y = x @ w  # [8, 16, 64], the product's columns sharded over model: no collective
    with dryrun.CollectiveCounter() as c:
        a.redistribute(mesh22, [Replicate(), Replicate()])  # gathers [8, 6] fp32
        z = y @ w.t()  # local [4, 16, 32] sums over model: partial
        z.redistribute(mesh22, [Shard(0), Replicate()])  # all-reduce of [4, 16, 32]
        all_to_all_single_autograd(_meta(12, 5), None, None, mesh22.get_group("model"))
    assert c.collectives == {
        "all-gather": 8 * 6 * 4, "count_all-gather": 1,
        "all-reduce": 4 * 16 * 32 * 4, "count_all-reduce": 1,
        "all-to-all": 12 * 5 * 4, "count_all-to-all": 1,
        "total": 8 * 6 * 4 + 4 * 16 * 32 * 4 + 12 * 5 * 4,
    }
    assert c.flops == 2 * (4 * 16) * 32 * 32  # the local product only


def _small(name, **replace):
    return dataclasses.replace(get_arch(name).reduced(), **replace)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_analyze_reduced_llama(kind, mesh22):
    cfg = _small("llama3.2-3b")
    shape = InputShape(f"small_{kind}", 64, 4, kind)
    rec = dryrun._analyze(cfg, shape, mesh22)
    assert rec["plan"].kind == kind
    assert rec["flops"] > 0 and rec["collectives"]["total"] > 0
    assert rec["memory"]["argument_bytes"] > 0


def test_analyze_reduced_qwen3_moe_expert_parallel(mesh22):
    cfg = _small("qwen3-moe-30b-a3b")
    shape = InputShape("small_train", 64, 4, "train")
    rec = dryrun._analyze(cfg, shape, mesh22, variant="ep")
    # two a MoE layer forward, two more backward
    assert rec["collectives"].get("count_all-to-all", 0) >= 4 * cfg.num_layers
    assert rec["flops"] > 0


def test_failure_is_recorded_and_real_groups_are_refused(mesh22, monkeypatch):
    # qwen3-moe's 128 experts do not split over a model axis of 3
    dryrun.fake_world(3)
    try:
        mesh13 = make_test_mesh(1, 3, device_type="cpu")
        rec = dryrun.run_one("qwen3-moe-30b-a3b", "train_4k", mesh=mesh13, variant="ep")
        assert rec["status"] == "error" and "do not split" in rec["error"]
        assert rec["mesh"] == "1x3+ep"
    finally:
        dryrun.fake_world(4)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    with pytest.raises(RuntimeError, match="real default group"):
        dryrun.fake_world(256)
