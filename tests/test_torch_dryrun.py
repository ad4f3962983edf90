"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, over
PyTorch's fake process group.

  * ``CollectiveCounter`` on a fake 4-rank (2, 2) mesh over DTensor ops
    whose collectives are known: a gather of a batch-sharded tensor, the
    all-reduce of a product's partial sums, an all-to-all over the model
    axis; the bytes are each collective's result on rank 0, the FLOPs the
    local products' (DTensor's shape propagation on the global shapes is
    not counted).
  * ``_analyze`` of reduced llama3.2-3b (train, prefill, decode), of
    reduced qwen3-moe-30b-a3b (train, ``variant="ep"``) and of reduced
    jamba-1.5-large-398b (train, prefill; 256 tokens, two SSD chunks, a
    Mamba block after a MoE block) on a fake (2, 2) mesh: each step runs,
    with FLOPs and collectives counted and the argument bytes those of the
    local shards.
  * With ``by_line`` the record names the model lines whose ops moved the
    most collective bytes and did the most FLOPs: reduced granite-moe's
    train step, each amount within the record's totals, the MoE block's
    lines among them.
  * The MoE block returns the residual stream in the placements it came in
    (batch-sharded, no pending sum); the SSD of DTensor operands runs on
    rank 0's own shard (batch over data, heads over model) and gives that
    shard of the plain SSD.
  * A failing combination is recorded with status ``error`` (experts that
    do not split over the model axis), and a process with a real default
    group is refused.
"""

import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

import repro_torch.configs.all_archs  # noqa: F401
from repro_torch.configs import get_arch
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.sharding import param_pspecs
from repro_torch.launch.specs import abstract_params
from repro_torch.models.mamba2 import _ssd_chunked
from repro_torch.models.moe import moe_block


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


def test_analyze_by_line_names_the_model_lines(mesh22):
    cfg = _small("granite-moe-1b-a400m")
    rec = dryrun._analyze(cfg, InputShape("small_train", 64, 4, "train"), mesh22, by_line=5)
    coll, flops = rec["collectives_by_line"], rec["flops_by_line"]
    assert 0 < len(coll) <= 5 and 0 < len(flops) <= 5
    assert sum(n for _, _, n in coll) <= rec["collectives"]["total"]
    assert sum(n for _, _, n in flops) <= rec["flops"]
    assert [n for _, _, n in coll] == sorted((n for _, _, n in coll), reverse=True)
    assert any(line.startswith("moe.py:") for line, _, _ in coll + flops)
    assert "collectives_by_line" not in dryrun._analyze(
        cfg, InputShape("small_prefill", 64, 4, "prefill"), mesh22)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_analyze_reduced_jamba(kind, mesh22):
    # the MoE block's output reaches the next Mamba block with its partial
    # sums reduced; left pending, the SSD's chunk-state einsum got x with its
    # batch split over the model axis too, and its local view failed
    cfg = _small("jamba-1.5-large-398b")
    rec = dryrun._analyze(cfg, InputShape(f"small_{kind}", 256, 4, kind), mesh22)
    assert rec["plan"].kind == kind
    assert rec["flops"] > 0 and rec["collectives"]["total"] > 0
    assert rec["memory"]["argument_bytes"] > 0


def test_moe_block_keeps_the_residual_placements(mesh22):
    # left pending, the block's sums (or the experts' model-axis split) rode
    # the residual stream into every later block
    cfg = _small("granite-moe-1b-a400m")
    params = abstract_params(cfg)
    params = dryrun.place(mesh22, params, param_pspecs(cfg, params, mesh22))
    p = {k: v[0, 0] for k, v in params["blocks"]["moe"].items()}
    x = distribute_tensor(_meta(4, 64, cfg.d_model), mesh22, [Shard(0), Replicate()])
    y = moe_block(p, cfg, x)
    assert y.placements == x.placements and y.shape == x.shape


def test_sharded_ssd_is_the_plain_ssd_on_the_local_shard(mesh22):
    gen = torch.Generator().manual_seed(0)
    b, s, nh, hp, N = 4, 256, 8, 16, 32
    x = torch.randn(b, s, nh, hp, generator=gen)
    dt = torch.rand(b, s, nh, generator=gen) * 0.1
    A = -torch.rand(nh, generator=gen)
    B_ = torch.randn(b, s, N, generator=gen)
    C_ = torch.randn(b, s, N, generator=gen)
    want_y, want_H = _ssd_chunked(x, dt, A, B_, C_, chunk=128, return_state=True)

    def on(local, placements, full):
        return DTensor.from_local(local, mesh22, placements, run_check=False,
                                  shape=full.shape, stride=full.stride())

    # rank 0 holds batch rows 0-1 (data 0) and heads 0-3 (model 0)
    y, H = _ssd_chunked(on(x[:2, :, :4], [Shard(0), Shard(2)], x),
                        on(dt[:2, :, :4], [Shard(0), Shard(2)], dt),
                        on(A[:4], [Replicate(), Shard(0)], A),
                        on(B_[:2], [Shard(0), Replicate()], B_),
                        on(C_[:2], [Shard(0), Replicate()], C_), chunk=128, return_state=True)
    assert y.placements == (Shard(0), Shard(2)) and H.placements == (Shard(0), Shard(1))
    torch.testing.assert_close(y.to_local(), want_y[:2, :, :4], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(H.to_local(), want_H[:2, :4], atol=1e-6, rtol=1e-6)


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
