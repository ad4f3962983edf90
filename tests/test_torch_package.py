"""Package-level contracts of the PyTorch/CUDA port (``src/repro_torch``).

  * its configuration tree is the reference's, field for field;
  * no module of the port (nor ``chip_smoke.py``) imports JAX or the
    reference package — checked on the source text and in a fresh process;
  * its entry points run on the GPU unless the caller names the CPU, and
    with no GPU they raise ``NoGPUError`` instead of carrying on;
  * ``chip_smoke.py`` fails, and prints no result, without a GPU or outside
    a checkout of the repository.
"""

import ast
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import repro.api as ref_api
import repro_torch
from repro_torch import api
from repro_torch.device import NoGPUError, resolve_device

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SECTIONS = tuple(f.name for f in dataclasses.fields(ref_api.HetaConfig))


def _fields(cls):
    return [(f.name, f.type, f.default if f.default is not dataclasses.MISSING
             else f.default_factory()) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("section", SECTIONS)
def test_config_section_fields_match_reference(section):
    ref_cls = type(getattr(ref_api.HetaConfig(), section))
    port_cls = type(getattr(api.HetaConfig(), section))
    assert port_cls.__name__ == ref_cls.__name__
    assert _fields(port_cls) == _fields(ref_cls)


def test_config_round_trips_between_packages():
    ref = ref_api.HetaConfig().updated(
        data=dict(scale=0.01, fanouts=(3, 2)), serve=dict(cache_mb=9, node_block=256),
        kernels=dict(block_n=8))
    port = api.HetaConfig.from_dict(ref.to_dict())
    assert port.to_dict() == ref.to_dict()
    assert port.to_flat_kwargs() == ref.to_flat_kwargs()
    assert [f.name for f in dataclasses.fields(api.HetaConfig)] == \
        [f.name for f in dataclasses.fields(ref_api.HetaConfig)]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_neither_jax_nor_reference(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_port_imports_leave_jax_and_reference_unloaded():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'modules': len(mods), 'bad': bad}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["modules"] >= 30
    assert res["bad"] == []


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_run_without_a_gpu(no_gpu):
    with pytest.raises(NoGPUError, match="device='cpu'"):
        api.Heta(api.HetaConfig())
    with pytest.raises(NoGPUError):
        api.Heta(api.HetaConfig(), device="cuda")
    from repro_torch.launch import serve

    with pytest.raises(NoGPUError):
        serve.main(["--scale", "0.002"])
    assert api.Heta(api.HetaConfig(), device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    assert api.NoGPUError is NoGPUError and repro_torch.api is api


def test_library_surfaces_default_to_the_gpu(no_gpu):
    """The store, the cache, infer_all and the weight carry-over also run
    on the GPU unless the CPU is named."""
    import numpy as np

    from repro_torch.convert import stacks_from_reference
    from repro_torch.embed.cache import CacheAllocation, FeatureCache
    from repro_torch.embed.profiler import HotnessProfile, measure_miss_penalty
    from repro_torch.serve import full_graph as fg

    tables = {"a": np.zeros((4, 2), np.float32)}
    alloc = CacheAllocation({"a": 2}, {"a": 16}, 16, "t")
    hot = HotnessProfile({"a": np.ones(4)})
    store_kw = dict(target_type="a", num_classes=2, hidden=2, embeddings=tables,
                    layer_of={"a": 1}, head={"w": np.zeros((2, 2), np.float32),
                                             "b": np.zeros(2, np.float32)})
    stacks = {"layer1": {"w": np.zeros((1, 1, 2, 2))}, "head": {"b": np.zeros(2)}}
    for make in (lambda: fg.EmbeddingStore(**store_kw),
                 lambda: FeatureCache(tables, {}, alloc, hot),
                 lambda: fg.infer_all(None, None, {}, tables),
                 lambda: stacks_from_reference(stacks),
                 lambda: measure_miss_penalty(2, False, n_rows=4, repeats=1)):
        with pytest.raises(NoGPUError):
            make()
    assert fg.EmbeddingStore(**store_kw, device="cpu").device == torch.device("cpu")
    assert FeatureCache(tables, {}, alloc, hot, device="cpu").device == torch.device("cpu")
    assert stacks_from_reference(stacks, "cpu")["layer1"]["w"].device.type == "cpu"


def test_chip_smoke_fails_without_gpu_and_outside_checkout(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    runs = [subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                           capture_output=True, text=True, env=env, timeout=300)]
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs.append(subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                               text=True, env=env, cwd=str(tmp_path), timeout=300))
    for out in runs:
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_sampler_worker_stays_torch_free(tmp_path):
    """What a spawned sampler worker pays: in a fresh process, unpickling a
    ``SampleStageTask`` (with its staging recipe, batch arena and fault
    plan), its ``setup`` and one item import neither torch nor JAX nor the
    reference package, whether its graph store is a shared-memory segment
    or an on-disk mmap store; the slot it writes holds the consumer's
    staging of the same batch, bit for bit."""
    import pickle

    import numpy as np

    from repro_torch.data.faults import FaultPlan, FaultSpec
    from repro_torch.data.staging import stack_batch_host, unpack_slot
    from repro_torch.graph.mmap_store import MmapGraphHandle, mmap_share_graph

    sess = api.Heta(api.HetaConfig().updated(
        data=dict(scale=0.002, fanouts=(3, 2), batch_size=8),
        model=dict(train_learnable=False),
        pipeline=dict(enabled=True, num_workers=1)), device="cpu")
    sess.build_graph(), sess.partition(), sess.profile_and_cache(), sess.compile()
    recipe = sess.executor.worker_stage_recipe(sess, sess.plan)
    assert recipe is not None
    want = stack_batch_host(recipe, sess._batch_for_step(0), sess.engine.tables_snapshot())
    for kind in ("shm", "mmap"):
        store, arena, task = sess._pool_task(
            sess._schedule(0), sess.config.run.seed + 1, recipe=recipe,
            faults=FaultPlan((FaultSpec("raise_item", step=99),)))
        mstore = None
        try:
            if kind == "mmap":
                mstore = mmap_share_graph(sess.graph, include_features=False)
                task = dataclasses.replace(task, handle=mstore.handle)
                assert isinstance(task.handle, MmapGraphHandle)
            blob = tmp_path / f"task-{kind}.pkl"
            blob.write_bytes(pickle.dumps(task))
            code = (
                "import json, pickle, sys\n"
                f"task = pickle.loads(open({str(blob)!r}, 'rb').read())\n"
                "task.bind_worker(0, 0)\n"
                "task.setup()\n"
                "ref = task(0)\n"
                "task.teardown()\n"
                "bad = sorted(k for k in sys.modules\n"
                "             if k.split('.')[0] in ('torch', 'jax', 'jaxlib', 'repro'))\n"
                "print(json.dumps({'slot': ref.slot, 'use': ref.use, 'staged': ref.staged,\n"
                "                  'bad': bad}))\n"
            )
            env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
            out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                                 text=True, env=env, cwd=str(REPO), timeout=300)
            assert out.returncode == 0, out.stderr
            res = json.loads(out.stdout.strip().splitlines()[-1])
            assert res["bad"] == [] and res["staged"], (kind, res)
            batch, host = unpack_slot(arena.resolve(res["slot"], res["use"]), sess.spec)
            assert set(host) == set(want)
            for k, v in want.items():
                np.testing.assert_array_equal(host[k], v)
            del batch, host
        finally:
            store.unlink()
            arena.unlink()
            if mstore is not None:
                mstore.unlink()


def test_lm_training_modules_stay_jax_free_and_the_data_package_torch_free():
    """In fresh processes: ``repro_torch.data`` (with the LM token pipeline)
    imports none of torch, JAX and the reference package, and feeds a
    batch; ``repro_torch.launch.train_lm`` imports neither JAX nor the
    reference package."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    checks = {
        "repro_torch.data": ("torch", "jax", "jaxlib", "repro"),
        "repro_torch.launch.train_lm": ("jax", "jaxlib", "repro"),
    }
    for module, banned in checks.items():
        code = (
            "import importlib, json, sys\n"
            f"importlib.import_module({module!r})\n"
            "from repro_torch.data.pipeline import SyntheticCorpus, TokenPipeline\n"
            "pipe = TokenPipeline(SyntheticCorpus(vocab=64, seq_len=8, num_shards=2), 2)\n"
            "shape = list(next(pipe)['tokens'].shape)\n"
            "pipe.close()\n"
            "print(json.dumps({'shape': shape, 'mods': sorted({k.split('.')[0] for k in "
            "sys.modules})}))\n"
        )
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=env, cwd=str(REPO), timeout=300)
        assert out.returncode == 0, out.stderr
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["shape"] == [2, 8]
        assert not set(banned) & set(res["mods"]), (module, set(banned) & set(res["mods"]))
