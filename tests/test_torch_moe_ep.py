"""Expert-parallel MoE (``repro_torch.models.moe.moe_block_ep``) against the
reference's ``moe_block_ep``, on the CPU over gloo.

  * One rank (a gloo group of one, mesh (1, 1)): bit-equal to the port's
    ``moe_block`` (at world 1 the exchange is the identity and the routing
    global), from plain tensors and from DTensors, and through a whole
    prefill under ``inference_mode``; the gradients of every
    parameter and of x within 1e-4 of the reference's ``moe_block_ep`` on a
    (1, 1) jax mesh.
  * Four ranks on a (2, 2) mesh: four processes (``tests/_moe_ep_rank.py``)
    against the reference's ``moe_block_ep`` on a (2, 2) jax mesh (a
    process with ``--xla_force_host_platform_device_count=4``), at ample
    capacity (capacity factor 64) and at the configuration's default
    (1.25: each shard routes its own tokens at its own capacity, so picks
    drop by the shard, as in the reference): within 1e-5.
  * Four ranks on a (2, 2) mesh run ``moe_block`` on DTensors placed as the
    sharding rules place them (x's batch over data, the experts over
    model), whose combine sums each rank's own experts
    (``_combine_sharded``): the output within 1e-5 of the plain
    ``moe_block`` on the same inputs, the gradients of x and of every
    parameter within 1e-4 (through a fixed random projection of the output).

NCCL takes one rank per GPU, so the multi-rank exchange is held here; the
card runs the one-rank mesh (``chip_smoke.py`` phase 9d).  Every group
meets through ``file://`` in a temporary directory, never a fixed port.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs.all_archs  # noqa: F401
from repro.configs.base import ARCHS as REF_ARCHS
from repro.models.moe import moe_block_ep as ref_moe_block_ep
from repro.models.moe import moe_params as ref_moe_params
import repro_torch.configs.all_archs  # noqa: F401
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.moe import moe_block, moe_block_ep

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WAIT_S = 240


def _case(name, capacity_factor, seed, b=2, s=16):
    ref_cfg = dataclasses.replace(REF_ARCHS[name].reduced(), capacity_factor=capacity_factor)
    cfg = dataclasses.replace(get_arch(name).reduced(), capacity_factor=capacity_factor)
    p = jax.tree.map(np.asarray, ref_moe_params(jax.random.PRNGKey(seed), ref_cfg, jnp.float32))
    r = np.random.default_rng(seed)
    p["norm"] = (1.0 + 0.1 * r.standard_normal(p["norm"].shape)).astype(np.float32)
    x = r.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, p, x


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo group of one rank and its (1, 1) mesh."""
    if dist.is_initialized():
        pytest.fail("a default process group is already open in this worker")
    where = tmp_path_factory.mktemp("gloo1")
    dist.init_process_group("gloo", init_method=f"file://{where}/rendezvous", rank=0,
                            world_size=1)
    yield make_test_mesh(1, 1, device_type="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "granite-moe-1b-a400m"])
def test_one_rank_is_moe_block_bit_for_bit(name, one_rank):
    from torch.distributed.tensor import Replicate, distribute_tensor

    _, cfg, p_np, x_np = _case(name, 1.25, 1)
    p = {k: torch.from_numpy(v) for k, v in p_np.items()}
    x = torch.from_numpy(x_np)
    want = moe_block(p, cfg, x)
    got = moe_block_ep(p, cfg, x, one_rank, ("data",))
    assert torch.equal(got, want)
    rep = [Replicate(), Replicate()]
    pd = {k: distribute_tensor(v, one_rank, rep) for k, v in p.items()}
    got_d = moe_block_ep(pd, cfg, distribute_tensor(x, one_rank, rep), one_rank, ("data",))
    assert type(got_d).__name__ == "DTensor"
    assert torch.equal(got_d.full_tensor(), want)


def test_one_rank_prefill_under_pctx_is_the_plain_prefill(one_rank):
    """The serving path (``inference_mode``) through a real one-rank group:
    granite's prefill under expert parallelism, sequence-parallel attention
    and pinned activations, bit for bit the prefill with no context."""
    from repro_torch.models import init_params, make_prefill_step
    from repro_torch.models.transformer import ParallelCtx

    cfg = get_arch("granite-moe-1b-a400m").reduced()
    params = init_params(cfg, 0, "cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 32))
    pctx = ParallelCtx(mesh=one_rank, dp_axes=("data",), moe="expert_parallel",
                       sp_attention=True, constrain_activations=True)
    logits, cache = make_prefill_step(cfg, pctx=pctx)(params, {"tokens": tokens})
    want, want_cache = make_prefill_step(cfg)(params, {"tokens": tokens})
    assert torch.equal(logits, want)
    assert sorted(cache) == sorted(want_cache)
    assert all(torch.equal(cache[k], want_cache[k]) for k in cache)


def test_one_rank_gradients_match_reference(one_rank):
    ref_cfg, cfg, p_np, x_np = _case("granite-moe-1b-a400m", 32.0, 2)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    # a fixed random projection of the output: gradients of order one
    g = np.random.default_rng(9).standard_normal(x_np.shape).astype(np.float32)

    def ref_loss(pp, xx):
        return jnp.sum(ref_moe_block_ep(pp, ref_cfg, xx, jmesh, ("data",)) * g)

    ref_g, ref_gx = jax.grad(ref_loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(x_np))
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in p_np.items()}
    x = torch.from_numpy(x_np).requires_grad_()
    (moe_block_ep(p, cfg, x, one_rank, ("data",)) * torch.from_numpy(g)).sum().backward()
    for k in ("w1", "w2", "w3", "router", "norm"):
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(ref_g[k]), atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_gx), atol=1e-4)
    assert float(p["w1"].grad.abs().max()) > 0


def test_expert_count_must_split_over_the_model_axis(one_rank):
    from repro_torch.launch.mesh import make_abstract_mesh

    _, cfg, p_np, x_np = _case("granite-moe-1b-a400m", 1.25, 3)
    p = {k: torch.from_numpy(v) for k, v in p_np.items()}
    with pytest.raises(ValueError, match="do not split"):
        moe_block_ep(p, cfg, torch.from_numpy(x_np), make_abstract_mesh((1, 3), ("data", "model")),
                     ("data",))


REF_SCRIPT = r"""
import dataclasses, json, os, sys
import numpy as np, jax, jax.numpy as jnp
import repro.configs.all_archs
from repro.configs.base import ARCHS
from repro.models.moe import moe_block_ep
where = sys.argv[1]
case = json.load(open(os.path.join(where, "case.json")))
cfg = dataclasses.replace(ARCHS[case["arch"]].reduced(), capacity_factor=case["capacity_factor"])
load = lambda k: jnp.asarray(np.load(os.path.join(where, k + ".npy")))
p = {k: load(k) for k in ("w1", "w3", "w2", "router", "norm")}
mesh = jax.make_mesh(tuple(case["mesh"]), ("data", "model"))
out = jax.jit(lambda p_, x_: moe_block_ep(p_, cfg, x_, mesh, ("data",)))(p, load("x"))
np.save(os.path.join(where, "ref_out.npy"), np.asarray(out))
"""


def _run_ranks(tmp_path, extra=()):
    """``tests/_moe_ep_rank.py`` as four processes over ``tmp_path`` (and
    any ``extra`` processes started beside them), each to a clean exit."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    procs = list(extra) + [
        subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "_moe_ep_rank.py"),
                          str(r), "4", str(tmp_path)], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, env=env) for r in range(4)]
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=WAIT_S)
            assert proc.returncode == 0, err[-3000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "granite-moe-1b-a400m"])
def test_four_ranks_gspmd_block_matches_plain(name, tmp_path):
    _, cfg, p_np, x_np = _case(name, 1.25, 5, b=4, s=32)
    g = np.random.default_rng(6).standard_normal(x_np.shape).astype(np.float32)
    for k, v in {**p_np, "x": x_np, "g": g}.items():
        np.save(tmp_path / f"{k}.npy", v)
    (tmp_path / "case.json").write_text(json.dumps(
        {"arch": name, "capacity_factor": 1.25, "mesh": [2, 2], "block": "gspmd"}))
    _run_ranks(tmp_path)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in p_np.items()}
    x = torch.from_numpy(x_np).requires_grad_()
    want = moe_block(p, cfg, x)
    (want * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(np.load(tmp_path / "port_out.npy"), want.detach().numpy(),
                               atol=1e-5, rtol=0)
    for k, t in {"x": x, **p}.items():
        np.testing.assert_allclose(np.load(tmp_path / f"port_grad_{k}.npy"), t.grad.numpy(),
                                   atol=1e-4, rtol=0, err_msg=k)
    assert float(p["w2"].grad.abs().max()) > 0


@pytest.mark.parametrize("capacity_factor", [64.0, 1.25], ids=["ample", "default"])
def test_four_ranks_match_reference(capacity_factor, tmp_path):
    _, cfg, p_np, x_np = _case("qwen3-moe-30b-a3b", capacity_factor, 4, b=4, s=32)
    for k, v in {**p_np, "x": x_np}.items():
        np.save(tmp_path / f"{k}.npy", v)
    (tmp_path / "case.json").write_text(json.dumps(
        {"arch": "qwen3-moe-30b-a3b", "capacity_factor": capacity_factor, "mesh": [2, 2]}))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp_path)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu"))
    ranks = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "_moe_ep_rank.py"),
                               str(r), "4", str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for r in range(4)]
    try:
        for proc in [ref] + ranks:
            _, err = proc.communicate(timeout=WAIT_S)
            assert proc.returncode == 0, err[-3000:]
    finally:
        for proc in [ref] + ranks:
            if proc.poll() is None:
                proc.kill()
    got, want = np.load(tmp_path / "port_out.npy"), np.load(tmp_path / "ref_out.npy")
    assert got.shape == want.shape == x_np.shape
    gap = float(np.abs(got - want).max())
    print(f"4 ranks, capacity factor {capacity_factor}: max gap {gap:.3g}")
    assert gap <= 1e-5
