"""The port's launch tooling (``repro_torch.launch.{mesh,sharding,specs}``)
against the reference's (``repro.launch``), on the CPU.

  * ``plan_step`` and ``input_specs`` for every arch x input shape: the
    same plan, the same batch keys, shapes and dtypes (meta tensors against
    ``ShapeDtypeStruct``);
  * ``abstract_params``, ``abstract_state`` and ``abstract_cache`` against
    the reference's ``eval_shape``, leaf by leaf: the same paths and shapes,
    and the same dtypes but for the Adam moments, which the port keeps in
    float32 from the start (``models/transformer.py``'s note; the
    reference's are in the parameters' type until the first update);
  * ``param_pspecs``, ``state_pspecs``, ``batch_pspecs`` and
    ``cache_pspecs`` equal to the reference's, as tuples, on abstract
    meshes (16, 16), (2, 16, 16), (2, 2) and (1, 4);
  * ``placements``: a tuple of axes on one dim is ``Shard`` on each, in
    mesh order, and any other order raises;
  * the per-device argument bytes the dry run lays out (DTensors on
    ``meta`` over a fake process group) equal those the reference's specs
    imply: each leaf's dims divided by the sizes of the axes that shard
    them, in the port's dtypes.
"""

import functools
import math

import pytest
import torch
import torch.distributed as dist

import repro.configs.all_archs  # noqa: F401
from repro.configs.base import ARCHS as REF_ARCHS
from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.launch import sharding as ref_sharding
from repro.launch import specs as ref_specs
from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh
import repro_torch.configs.all_archs  # noqa: F401
from repro_torch.configs.base import ARCHS, INPUT_SHAPES
from repro_torch.launch import dryrun, sharding, specs
from repro_torch.launch.mesh import MeshError, make_abstract_mesh, make_production_mesh

ARCH_NAMES = sorted(ARCHS)
SHAPE_NAMES = sorted(INPUT_SHAPES)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}


def _flat(tree, prefix=""):
    """``{"a/b": leaf}`` of nested dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def _ref_abstract(name):
    cfg = REF_ARCHS[name]
    return ref_specs.abstract_params(cfg), ref_specs.abstract_state(cfg)


@functools.lru_cache(maxsize=None)
def _port_abstract(name):
    cfg = ARCHS[name]
    return specs.abstract_params(cfg), specs.abstract_state(cfg)


@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_plan_and_input_specs_match_reference(name, shape_name):
    cfg, shape = ARCHS[name], INPUT_SHAPES[shape_name]
    ref_cfg, ref_shape = REF_ARCHS[name], REF_SHAPES[shape_name]
    plan, ref_plan = specs.plan_step(cfg, shape), ref_specs.plan_step(ref_cfg, ref_shape)
    assert (plan.kind, plan.window, plan.cache_len, plan.skip_reason) == (
        ref_plan.kind, ref_plan.window, ref_plan.cache_len, ref_plan.skip_reason)
    got, want = specs.input_specs(cfg, shape), ref_specs.input_specs(ref_cfg, ref_shape)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert _dtype_name(got[k]) == str(want[k].dtype), k
    if plan.kind == "decode":
        cache = _flat(specs.abstract_cache(cfg, shape))
        ref_cache = _flat(ref_specs.abstract_cache(ref_cfg, ref_shape))
        assert sorted(cache) == sorted(ref_cache)
        for k, leaf in ref_cache.items():
            assert cache[k].device.type == "meta"
            assert tuple(cache[k].shape) == tuple(leaf.shape), k
            assert _dtype_name(cache[k]) == str(leaf.dtype), k


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_abstract_params_and_state_match_reference(name):
    (params, state), (ref_params, ref_state) = _port_abstract(name), _ref_abstract(name)
    got, want = _flat(params), _flat(ref_params)
    assert sorted(got) == sorted(want)
    for k, leaf in want.items():
        assert got[k].device.type == "meta"
        assert (tuple(got[k].shape), _dtype_name(got[k])) == (tuple(leaf.shape),
                                                               str(leaf.dtype)), k
    got, want = _flat(state), _flat(ref_state)
    assert sorted(got) == sorted(want)
    for k, leaf in want.items():
        assert tuple(got[k].shape) == tuple(leaf.shape), k
        moment = k.startswith("opt/m/") or k.startswith("opt/v/")
        assert _dtype_name(got[k]) == ("float32" if moment else str(leaf.dtype)), k
    assert state["opt"]["step"].device.type == "cpu"  # the one tensor with storage


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_pspecs_match_reference(name, mesh_name):
    shape_, axes = MESHES[mesh_name]
    mesh, ref_mesh = make_abstract_mesh(shape_, axes), ref_abstract_mesh(shape_, axes)
    cfg, ref_cfg = ARCHS[name], REF_ARCHS[name]
    (params, state), (ref_params, ref_state) = _port_abstract(name), _ref_abstract(name)
    assert _as_tuples(sharding.param_pspecs(cfg, params, mesh)) == _as_tuples(
        ref_sharding.param_pspecs(ref_cfg, ref_params, ref_mesh))
    assert _as_tuples(sharding.state_pspecs(cfg, state, mesh)) == _as_tuples(
        ref_sharding.state_pspecs(ref_cfg, ref_state, ref_mesh))
    for shape_name in SHAPE_NAMES:
        shape, ref_shape = INPUT_SHAPES[shape_name], REF_SHAPES[shape_name]
        batch = specs.input_specs(cfg, shape)
        ref_batch = ref_specs.input_specs(ref_cfg, ref_shape)
        if specs.plan_step(cfg, shape).kind == "decode":
            batch, ref_batch = {"token": batch["token"]}, {"token": ref_batch["token"]}
            assert _as_tuples(sharding.cache_pspecs(cfg, specs.abstract_cache(cfg, shape), mesh)) \
                == _as_tuples(ref_sharding.cache_pspecs(
                    ref_cfg, ref_specs.abstract_cache(ref_cfg, ref_shape), ref_mesh)), shape_name
        assert _as_tuples(sharding.batch_pspecs(cfg, shape, batch, mesh)) == _as_tuples(
            ref_sharding.batch_pspecs(ref_cfg, ref_shape, ref_batch, ref_mesh)), shape_name


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    P = sharding.PartitionSpec
    assert sharding.placements(mesh, P(("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert sharding.placements(mesh, P(None, None)) == [Replicate()] * 3
    assert sharding.placements(mesh, P(None, ("pod", "data", "model"))) == [Shard(1)] * 3
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements(mesh, P(("data", "pod"), None))
    assert sharding.named(mesh, {"a": P("model"), "b": {"c": P()}}) == {
        "a": [Replicate(), Replicate(), Shard(0)], "b": {"c": [Replicate()] * 3}}


@pytest.fixture(scope="module")
def fake_groups():
    """Fake process groups for the dry run's layout, closed at the end."""
    if dist.is_initialized():
        pytest.fail("a default process group is already open in this worker")
    yield dryrun.fake_world
    if dist.is_initialized():
        dist.destroy_process_group()


def _implied_bytes(tree, spec_tree, sizes):
    """Bytes of each leaf's local shard that a spec implies: every dim
    divided by the sizes of the axes that shard it."""
    total = 0
    for k, leaf in _flat(tree).items():
        spec = _flat(spec_tree)[k]
        n = 1
        for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * leaf.dim()):
            axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
            d = math.prod(sizes[a] for a in axes)
            assert dim % d == 0
            n *= dim // d
        total += n * leaf.element_size()
    return total


@pytest.mark.parametrize("mesh_name", ["16x16", "2x2"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_argument_bytes_follow_reference_specs(name, mesh_name, fake_groups):
    from torch.distributed.device_mesh import init_device_mesh

    shape_, axes = MESHES[mesh_name]
    fake_groups(math.prod(shape_))
    mesh = init_device_mesh("cpu", shape_, mesh_dim_names=axes)
    ref_mesh = ref_abstract_mesh(shape_, axes)
    sizes = dict(zip(axes, shape_))
    cfg, ref_cfg = ARCHS[name], REF_ARCHS[name]
    _, state = _port_abstract(name)
    _, ref_state = _ref_abstract(name)
    ref_specs_tree = ref_sharding.state_pspecs(ref_cfg, ref_state, ref_mesh)
    placed = dryrun.place(mesh, state, sharding.state_pspecs(cfg, state, mesh))
    got = dryrun._argument_bytes(placed)
    assert got == _implied_bytes(state, ref_specs_tree, sizes)
    shape = INPUT_SHAPES["train_4k"]
    batch = specs.input_specs(cfg, shape)
    ref_b = ref_sharding.batch_pspecs(ref_cfg, REF_SHAPES["train_4k"],
                                      ref_specs.input_specs(ref_cfg, REF_SHAPES["train_4k"]),
                                      ref_mesh)
    placed = dryrun.place(mesh, batch, sharding.batch_pspecs(cfg, shape, batch, mesh))
    assert dryrun._argument_bytes(placed) == _implied_bytes(batch, ref_b, sizes)


def test_production_mesh_needs_its_devices(fake_groups):
    fake_groups(4)
    with pytest.raises(MeshError, match="world size 4") as e:
        make_production_mesh(device_type="cpu")
    assert "256" in str(e.value)
    with pytest.raises(MeshError, match="512"):
        make_production_mesh(multi_pod=True, device_type="cpu")
