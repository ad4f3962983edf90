"""The port's legacy training entry points against the JAX reference's.

  * ``repro_torch.launch.train.train_hgnn`` takes the reference's keywords
    with its defaults (plus ``device``), builds the same flat config, and
    returns the same result keys as ``repro.launch.train.train_hgnn`` at
    ``tests/test_api.py``'s arguments; from the reference's initial
    parameter stacks its losses are the reference's within 1e-5 (the HGNN
    fit parity tests' tolerance) and those of
    ``Heta(HetaConfig.from_flat_kwargs(...), device="cpu").run()`` bit for
    bit.
  * The CLI aliases ``--naive`` and ``--hotness-only`` parse to the config of
    ``--placement naive`` and ``--cache-policy hotness``.
"""

import inspect

import numpy as np
import pytest

from repro.api import Heta as RefHeta
from repro.api import HetaConfig as RefHetaConfig
from repro.launch.train import train_hgnn as ref_train_hgnn
from repro_torch.api import Heta, HetaConfig
from repro_torch.convert import stacks_from_reference
from repro_torch.launch import train

# tests/test_api.py::test_train_hgnn_wrapper_result_keys
KWARGS = dict(dataset="ogbn-mag", scale=0.002, model="rgcn", num_partitions=2, batch_size=16,
              fanouts=(3, 2), steps=2, cache_mb=2)
ATOL = 1e-5  # tests/test_torch_train.py::test_fit_matches_reference


def _start_from_reference_stacks(monkeypatch):
    """Make every port session that compiles without a state start from the
    reference's initial parameter stacks for ``KWARGS`` (the two packages
    draw their initial weights from different generators)."""
    ref = RefHeta(RefHetaConfig.from_flat_kwargs(**KWARGS))
    ref.build_graph(), ref.partition(), ref.profile_and_cache(), ref.compile()
    stacks = {layer: {leaf: np.asarray(v) for leaf, v in entry.items()}
              for layer, entry in ref.state["stacks"].items()}
    compile_ = Heta.compile

    def compile_from_reference(self, *args, **kwargs):
        if not args and kwargs.get("state") is None:
            kwargs["state"] = {"stacks": stacks_from_reference(stacks, "cpu")}
        return compile_(self, *args, **kwargs)

    monkeypatch.setattr(Heta, "compile", compile_from_reference)


def test_signature_is_the_references_plus_device():
    ref = inspect.signature(ref_train_hgnn).parameters
    port = inspect.signature(train.train_hgnn).parameters
    assert list(port) == list(ref) + ["device"]
    for name, p in ref.items():
        assert port[name].default == p.default, name
    assert port["device"].default is None


def test_flat_config_matches_the_references():
    kw = dict(KWARGS, hotness_only=True, naive_placement=True, lr=1e-2, seed=3)
    port = HetaConfig.from_flat_kwargs(**kw).to_flat_kwargs()
    assert port == RefHetaConfig.from_flat_kwargs(**kw).to_flat_kwargs()


def test_train_hgnn_result_keys_and_losses(monkeypatch):
    ref = ref_train_hgnn(**KWARGS)
    _start_from_reference_stacks(monkeypatch)
    got = train.train_hgnn(**KWARGS, device="cpu")
    for key in ("losses", "step_time_s", "hit_rates", "partitioning", "meta_local",
                "cache_allocation"):
        assert key in ref and key in got, key
    assert set(got) >= set(ref), sorted(set(ref) - set(got))
    assert len(got["losses"]) == 2 and got["meta_local"]
    np.testing.assert_allclose(got["losses"], ref["losses"], atol=ATOL, rtol=0)
    direct = Heta(HetaConfig.from_flat_kwargs(**KWARGS), device="cpu").run()
    assert got["losses"] == direct["losses"]


@pytest.mark.parametrize("alias, spelled", [
    (["--naive"], ["--placement", "naive"]),
    (["--hotness-only"], ["--cache-policy", "hotness"]),
    (["--naive", "--hotness-only"], ["--placement", "naive", "--cache-policy", "hotness"]),
])
def test_cli_aliases_parse_to_the_spelled_out_flags(alias, spelled):
    ap = train._parser()
    base = ["--scale", "0.002", "--steps", "2"]
    got = train._config(ap, ap.parse_args(base + alias))
    want = train._config(ap, ap.parse_args(base + spelled))
    assert got == want
    assert got != train._config(ap, ap.parse_args(base))
