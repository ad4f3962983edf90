"""The port's tuning table (``repro_torch.kernels.ops`` resolution,
``repro_torch.kernels.autotune``) against the reference's on the CPU.

The key (``shape_class``), the table lookup and the resolution order are
the reference's: on the same table in the reference's schema and the same
options they give the same blocks, except that where the reference falls
back to its TPU ``DEFAULT_BLOCKS`` the port leaves the field to each CUDA
entry point's shape rule (``None``).  The analytic sweep is deterministic,
the committed table is a measured one from an H100, the measured mode
refuses to run without a card, and sessions with ``kernels.autotune`` (or a
``block_n``) train as the reference's do: CPU tensors run the plain
versions, so their 3 losses are within 1e-5 of the reference's (fp32; the
plain versions sum in PyTorch's order, the reference's Pallas kernels run
in interpret mode).
"""

import json

import numpy as np
import pytest
import torch

from repro.api import CacheConfig as RefCacheConfig
from repro.api import DataConfig as RefDataConfig
from repro.api import Heta as RefHeta
from repro.api import HetaConfig as RefHetaConfig
from repro.api import KernelConfig as RefKernelConfig
from repro.api import ModelConfig as RefModelConfig
from repro.api import RunConfig as RefRunConfig
from repro.kernels import autotune as ref_autotune
from repro.kernels import ops as ref_ops
from repro_torch.api import Heta, HetaConfig
from repro_torch.api.config import KernelConfig
from repro_torch.convert import stacks_from_reference
from repro_torch.core.relmod import get_relation_module
from repro_torch.kernels import autotune
from repro_torch.kernels import ops as kops
from repro_torch.kernels.stacked_relation_agg import ops as sra

ATOL = 1e-5
BLOCK_FIELDS = ("block_n", "block_out", "block_in")

# (op, n, f, d_in, d_out): a grid over the three tuned ops, n on and off
# powers of two (1000 and 1024 share a class, 1025 does not; n < 8 buckets
# to 8), the fanouts and widths of the paths and of the reference's shapes
SHAPES = [(op, n, f, di, do)
          for op in autotune.OPS
          for n in (1, 7, 8, 1000, 1024, 1025, 4096)
          for f, di, do in ((1, 128, 64), (3, 128, 64), (25, 789, 349))]
# option sets: autotune off and on, each with no override, one, and all three
OPTIONS = [dict(autotune=a, **o) for a in (False, True)
           for o in ({}, dict(block_n=64), dict(block_out=256, block_in=32),
                     dict(block_n=16, block_out=64, block_in=32))]


@pytest.mark.parametrize("op,n,f,di,do", SHAPES)
def test_shape_class_matches_reference(op, n, f, di, do):
    assert kops.shape_class(op, n, f, di, do) == ref_ops.shape_class(op, n, f, di, do)


def _reference_schema_table(path):
    """One table in the reference's schema: a winner for half of the grid's
    shape classes (the other half misses), with every field set."""
    r = np.random.default_rng(0)
    entries = {}
    for i, (op, n, f, di, do) in enumerate(SHAPES):
        if i % 2:
            continue
        entries[ref_ops.shape_class(op, n, f, di, do)] = dict(
            block_n=int(r.choice([16, 64, 256])), block_out=int(r.choice([64, 128])),
            block_in=int(r.choice([32, 512])), source="analytic", cost_us=1.0)
    table = {"version": 1, "mode": "analytic", "backend": "any",
             "budget_bytes": ref_ops.VMEM_BUDGET_BYTES, "entries": entries}
    path.write_text(json.dumps(table))
    return str(path)


@pytest.mark.parametrize("options", OPTIONS, ids=lambda o: "-".join(f"{k}={v}" for k, v in
                                                                    o.items()))
def test_lookup_and_resolve_blocks_match_reference(tmp_path, options):
    """On one table in the reference's schema, the port's lookup_blocks and
    resolve_blocks give the reference's blocks, but None where the reference
    took a field from DEFAULT_BLOCKS (neither an override nor a table hit
    set it): the port leaves that field to the shape's rule."""
    path = _reference_schema_table(tmp_path / "table.json")
    port_opts, ref_opts = KernelConfig(**options), ref_ops.KernelOptions(**options)
    for op, n, f, di, do in SHAPES:
        ref_hit = ref_ops.lookup_blocks(op, n, f, di, do, path=path)
        assert kops.lookup_blocks(op, n, f, di, do, path=path) == ref_hit
        want = ref_ops.resolve_blocks(ref_opts, op, n, f, di, do, path=path)
        got = kops.resolve_blocks(port_opts, op, n, f, di, do, path=path)
        for i, field in enumerate(BLOCK_FIELDS):
            from_default = options.get(field) is None and (
                not options["autotune"] or ref_hit is None)
            if from_default:
                assert want[i] == ref_ops.DEFAULT_BLOCKS[i] and got[i] is None
            else:
                assert got[i] == want[i], (op, n, f, di, do, field)
    # no options at all: the reference's defaults, the port's rules
    assert ref_ops.resolve_blocks(None, *SHAPES[0], path=path) == ref_ops.DEFAULT_BLOCKS
    assert kops.resolve_blocks(None, *SHAPES[0], path=path) == (None, None, None)


def test_load_tuning_table_refuses_a_wrong_version(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"version": 2, "entries": {}}))
    with pytest.raises(ValueError, match="version"):
        kops.load_tuning_table(str(p))
    # a missing file is an empty table, as the reference's
    assert kops.load_tuning_table(str(tmp_path / "none.json")) == \
        ref_ops.load_tuning_table(str(tmp_path / "none.json"))


def test_save_table_round_trips_and_clears_cache(tmp_path):
    p = tmp_path / "t.json"
    key = kops.shape_class("stacked_mean_linear", 1024, 3, 128, 64)
    table = {"version": 1, "mode": "analytic", "backend": "any", "entries": {
        key: dict(block_n=64, block_out=64, block_in=32, source="analytic", cost_us=1.0)}}
    autotune.save_table(table, p)
    assert kops.load_tuning_table(str(p)) == table
    assert kops.resolve_blocks(KernelConfig(autotune=True), "stacked_mean_linear", 1000, 3,
                               128, 64, path=str(p)) == (64, 64, 32)
    autotune.save_table(dict(table, entries={}), p)
    assert kops.load_tuning_table(str(p))["entries"] == {}


def test_analytic_build_table_is_bit_identical_and_validates():
    details = {}
    t1 = autotune.build_table(details=details)
    t2 = autotune.build_table()
    assert json.dumps(t1, sort_keys=True) == json.dumps(t2, sort_keys=True)
    autotune.validate_table(t1)
    assert t1["mode"] == "analytic" and t1["backend"] == "any"
    keys = {kops.shape_class(op, n, f, di, do)
            for op, rb, n, f, di, do in autotune.DEFAULT_SHAPES}
    assert set(t1["entries"]) == keys  # two serving slot counts share a class
    for key, e in t1["entries"].items():
        assert (e["block_n"], e["block_out"], e["block_in"]) in \
            [tuple(c) for c in details[key]["candidates"]]
        assert e["cost_us"] == round(min(details[key]["costs_us"].values()), 3)


def test_committed_table_is_measured_and_validates():
    """The committed table: measured on an NVIDIA card (its name and power
    limit recorded), every winner among the layouts its shape class
    launches, and every shape the port's paths launch covered."""
    with open(kops.TUNING_TABLE_PATH) as fh:
        table = json.load(fh)
    autotune.validate_table(table)
    assert table["mode"] == "measured" and table["backend"] == "cuda"
    name, limit = (part.strip() for part in table["card"].rsplit(",", 1))
    assert name.startswith("NVIDIA") and limit.endswith(" W") and float(limit[:-2]) > 0
    for key, e in table["entries"].items():
        op, _, nb, fb, dib, dob = key.split("/")
        assert (e["block_n"], e["block_out"], e["block_in"]) in autotune.candidates(
            op, int(nb[1:]), int(fb[1:]), int(dib[2:]), int(dob[2:]))
        assert e["source"] == "measured" and e["cost_us"] > 0
    for op, rb, n, f, di, do in autotune.DEFAULT_SHAPES[:14]:
        assert kops.shape_class(op, n, f, di, do) in table["entries"], (op, n, f, di, do)


@pytest.mark.parametrize("op,rb,n,f,di,do", autotune.DEFAULT_SHAPES)
def test_rules_are_candidates_and_candidates_fit(op, rb, n, f, di, do):
    """The shape rule's layout is one of the candidates, and every candidate
    fits one block's shared memory in each variant."""
    cands = autotune.candidates(op, n, f, di, do)
    assert cands == sorted(set(cands))
    for variant in autotune.VARIANTS[op]:
        assert autotune.rule_blocks(op, rb, n, f, di, do, variant) in cands
        for c in cands:
            assert autotune._work(op, rb, n, f, di, do, c, variant)[2] <= autotune.SMEM_BYTES


def test_measured_cost_us_raises_without_a_card():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA device"):
        autotune.measured_cost_us("stacked_mean_linear", 1024, 3, 128, 64, 16, 64, 32)
    with pytest.raises(RuntimeError, match="CUDA device"):
        autotune.build_table(mode="measured")


def _table(entries, **top):
    return {"version": 1, "mode": "analytic", "backend": "any", "entries": entries, **top}


GOOD_KEY = "stacked_mean_linear/float32/n1024/f25/di128/do64"
GOOD = dict(block_n=64, block_out=64, block_in=32, source="analytic", cost_us=1.0)


@pytest.mark.parametrize("table,match", [
    ({"version": 2, "entries": {}}, "version"),
    (_table({"not/a/key": GOOD}), "malformed"),
    (_table({GOOD_KEY.replace("mean_linear", "nonsense"): GOOD}), "unknown op"),
    (_table({GOOD_KEY: dict(GOOD, block_n=0)}), "block_n"),
    (_table({GOOD_KEY: dict(GOOD, block_in=True)}), "block_in"),
    (_table({GOOD_KEY: dict(GOOD, source="vibes")}), "source"),
    (_table({GOOD_KEY: dict(GOOD, block_n=128)}), "launches"),  # the TPU's node block
    (_table({GOOD_KEY: dict(GOOD, block_out=128)}), "launches"),
    (_table({"stacked_softmax_combine/float32/n1024/f4/di64/do64":
             dict(GOOD, block_n=32, block_out=1024, block_in=16)}), "launches"),
    (_table({}, mode="measured", backend="cuda"), "card"),
], ids=["version", "key", "op", "zero", "bool", "source", "tpu-block", "column-tile",
        "rows-past-threads", "no-card"])
def test_validate_table_rejects(table, match):
    with pytest.raises(ValueError, match=match):
        autotune.validate_table(table)


def test_cpu_tensors_read_no_table(monkeypatch):
    """On CPU tensors stacked_agg never asks for a layout: no table and no
    block_* field is read, whatever the options."""
    def refuse(*a, **k):
        raise AssertionError("resolve_blocks asked on the CPU")

    monkeypatch.setattr(sra, "resolve_blocks", refuse)
    r = np.random.default_rng(3)
    rb, n, f, di, do, U = 4, 40, 3, 16, 12, 2
    stacks = {"w": torch.from_numpy(r.standard_normal((U, di, do)).astype(np.float32)),
              "b": torch.from_numpy(r.standard_normal((U, do)).astype(np.float32))}
    h = torch.from_numpy(r.standard_normal((rb, n, f, di)).astype(np.float32))
    mask = torch.from_numpy(r.random((rb, n, f)) > 0.3)
    out = sra.stacked_agg(get_relation_module("rgcn"), stacks,
                          {"relation": r.integers(0, U, rb)}, h, None, mask,
                          opts=KernelConfig(autotune=True, block_n=3))
    assert out.shape == (rb, n, do)


def _fit_pair(model, kernels):
    """3 frozen steps of the reference (Pallas in interpret mode, with the
    same kernel options) and of the port on the CPU from one initial state."""
    ref_cfg = RefHetaConfig(
        data=RefDataConfig(dataset="ogbn-mag", scale=0.002, fanouts=(3, 2), batch_size=8),
        model=RefModelConfig(model=model, hidden=32, num_heads=4, train_learnable=False),
        run=RefRunConfig(steps=3, seed=0),
        cache=RefCacheConfig(cache_mb=1),
        kernels=RefKernelConfig(interpret=True, **kernels),
    )
    ref = RefHeta(ref_cfg)
    ref.build_graph(), ref.partition(), ref.profile_and_cache(), ref.compile()
    d = ref_cfg.to_dict()
    d["kernels"] = dict(kernels)
    port = Heta(HetaConfig.from_dict(d), device="cpu")
    assert port.config.kernels.autotune == kernels.get("autotune", False)
    port.build_graph(), port.partition(), port.profile_and_cache()
    stacks = {layer: {leaf: np.asarray(v) for leaf, v in entry.items()}
              for layer, entry in ref.state["stacks"].items()}
    port.compile(state={"stacks": stacks_from_reference(stacks, "cpu")})
    return ref.fit()["losses"], port.fit()["losses"]


@pytest.mark.parametrize("kernels", [dict(autotune=True), dict(autotune=True, block_n=64)],
                         ids=["autotune", "autotune-block_n"])
@pytest.mark.parametrize("model", ["rgcn", "hgt"])
def test_autotune_fit_matches_reference(model, kernels):
    """kernels.autotune=True (and a block_n) trains: the port's 3 raf_spmd
    losses are within 1e-5 of the reference's under the same options."""
    want, got = _fit_pair(model, kernels)
    assert len(got) == 3 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
