"""The ``ParallelCtx`` knobs of the port (``repro_torch.models``) against the
reference's ``forward(pctx=...)``, ``loss_fn(pctx=...)`` and
``make_prefill_step(pctx=...)`` on a (1, 1) jax mesh, at reduced sizes in
fp32 (the port's context on an abstract (1, 1) mesh: plain tensors, one
device).

  * The chunked attention (``attn_chunk``): ``_einsum_attention_chunked``
    against ``_xla_attention_chunked`` for causal and windowed masks, GQA,
    a chunk that divides ``sk`` and one that does not (the whole einsum,
    as there): within 1e-5; and through a whole forward (llama, window or
    none) within 1e-4, as the LM tests hold a forward.
  * ``ssd_chunk`` (mamba2, chunk 16 of 64 positions) within 1e-4;
    ``ssd_bf16`` within 2e-2 relative Frobenius error (two bf16 SSDs
    that round in different places: each is 1.2e-2 from the fp32 answer,
    and they are 2.7e-3 apart, 0.05 at the worst logit of 4.2).
  * ``remat_policy="dots"``: ``loss_fn``'s gradients within 1e-4 of the
    reference's under the same policy, and bit-equal to the port's
    ``"full"`` (the same recomputation, only what is saved differs).
  * The hybrid prefill (jamba, cut to one period) under ``moe=
    "expert_parallel"``, ``sp_attention`` and ``constrain_activations``:
    bit-equal to the port's prefill without a context (on one device each
    is the identity), and within 1e-4 of the reference's under the same
    context (the cache at atol = rtol = 1e-4: its SSM states reach 1.6e-4
    apart at their size).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.all_archs  # noqa: F401
from repro.configs.base import ARCHS as REF_ARCHS
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import loss_fn as ref_loss_fn
from repro.models import make_prefill_step as ref_make_prefill_step
from repro.models.attention import _xla_attention_chunked as ref_chunked
from repro.models.transformer import ParallelCtx as RefParallelCtx
from _lm_train import flat, make_batch, perturb
import repro_torch.configs.all_archs  # noqa: F401
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import forward, make_prefill_step
from repro_torch.models import transformer
from repro_torch.models.attention import _einsum_attention, _einsum_attention_chunked
from repro_torch.models.transformer import ParallelCtx

S = 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the reduced models are small and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def _pctxs(jmesh, **kw):
    """The reference's context on a (1, 1) jax mesh and the port's on an
    abstract (1, 1) mesh, with the same knobs."""
    return (RefParallelCtx(mesh=jmesh, dp_axes=("data",), **kw),
            ParallelCtx(mesh=make_abstract_mesh((1, 1), ("data", "model")), dp_axes=("data",),
                        **kw))


def _weights(name, seed=0, **replace):
    ref_cfg = dataclasses.replace(REF_ARCHS[name].reduced(), **replace)
    cfg = dataclasses.replace(get_arch(name).reduced(), **replace)
    r = np.random.default_rng(seed)
    tree = perturb(jax.tree.map(np.asarray, ref_init_params(ref_cfg, jax.random.PRNGKey(seed))), r)
    return ref_cfg, cfg, tree, r


@pytest.mark.parametrize("chunk", [16, 20], ids=["divides", "does-not-divide"])
@pytest.mark.parametrize("window", [None, 10], ids=["causal", "window"])
def test_chunked_attention_matches_reference(window, chunk):
    r = np.random.default_rng(chunk + (window or 0))
    q, k, v = (r.standard_normal((2, 48, h, 16)).astype(np.float32) for h in (4, 2, 2))
    want = np.asarray(ref_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, window,
                                  chunk=chunk))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = _einsum_attention_chunked(tq, tk, tv, True, window, chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    whole = _einsum_attention(tq, tk, tv, True, window).numpy()
    np.testing.assert_allclose(got, whole, atol=1e-5, rtol=0)
    if 48 % chunk:  # the reference's rule: the whole einsum
        assert np.array_equal(got, whole)


@pytest.mark.parametrize("window", [None, 24], ids=["causal", "window"])
def test_forward_with_attn_chunk_matches_reference(window, jmesh):
    ref_cfg, cfg, tree, r = _weights("llama3.2-3b", 1)
    batch = make_batch(cfg, r, s=S)
    ref_pctx, pctx = _pctxs(jmesh, attn_chunk=16)
    want = np.asarray(ref_forward(ref_cfg, jax.tree.map(jnp.asarray, tree),
                                  {"tokens": jnp.asarray(batch["tokens"])}, window=window,
                                  remat=False, pctx=ref_pctx))
    params = lm_params_from_reference(tree, "cpu")
    got = forward(cfg, params, {"tokens": batch["tokens"]}, window=window, use_kernel=False,
                  pctx=pctx).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    plain = forward(cfg, params, {"tokens": batch["tokens"]}, window=window,
                    use_kernel=False).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=0)


@pytest.mark.parametrize("knob,atol", [({"ssd_chunk": 16}, 1e-4), ({"ssd_bf16": True}, 2e-2)],
                         ids=["ssd_chunk", "ssd_bf16"])
def test_mamba_ssd_knobs_match_reference(knob, atol, jmesh):
    ref_cfg, cfg, tree, r = _weights("mamba2-1.3b", 2)
    batch = make_batch(cfg, r, s=S)
    ref_pctx, pctx = _pctxs(jmesh, **knob)
    want = np.asarray(ref_forward(ref_cfg, jax.tree.map(jnp.asarray, tree),
                                  {"tokens": jnp.asarray(batch["tokens"])}, remat=False,
                                  pctx=ref_pctx))
    got = forward(cfg, lm_params_from_reference(tree, "cpu"), {"tokens": batch["tokens"]},
                  use_kernel=False, pctx=pctx).numpy()
    gap = float(np.abs(got - want).max())
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    print(f"{knob}: max gap {gap:.3g}, relative Frobenius {rel:.3g}")
    if knob.get("ssd_bf16"):  # two bf16 computations: held as a whole
        assert rel <= atol
    else:
        assert gap <= atol


def test_remat_dots_matches_reference_and_full(jmesh):
    ref_cfg, cfg, tree, r = _weights("llama3.2-3b", 3)
    batch = make_batch(cfg, r, s=S)
    ref_pctx, pctx = _pctxs(jmesh, remat_policy="dots")
    ref_grads = flat(jax.grad(lambda p: ref_loss_fn(
        ref_cfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, pctx=ref_pctx))(
            jax.tree.map(jnp.asarray, tree)))
    params = lm_params_from_reference(tree, "cpu")
    _, dots = transformer._value_and_grad(cfg, params, batch, pctx=pctx)
    _, full = transformer._value_and_grad(cfg, params, batch,
                                          pctx=dataclasses.replace(pctx, remat_policy="full"))
    dots, full = flat(dots), flat(full)
    assert sorted(dots) == sorted(ref_grads)
    for k in ref_grads:
        np.testing.assert_allclose(dots[k], ref_grads[k], atol=1e-4, rtol=0, err_msg=k)
        assert np.array_equal(dots[k], full[k]), k


def test_remat_dots_saves_the_products_without_a_batch_dim():
    saveable = transformer._dots_saveable
    from torch.utils.checkpoint import CheckpointPolicy

    assert saveable(None, torch.ops.aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert saveable(None, torch.ops.aten.addmm.default) == CheckpointPolicy.MUST_SAVE
    for op in (torch.ops.aten.bmm.default, torch.ops.aten.mul.Tensor,
               torch.ops.aten.exp.default):
        assert saveable(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


def test_hybrid_prefill_under_pctx():
    from jax.sharding import AxisType

    name = "jamba-1.5-large-398b"
    period = REF_ARCHS[name].reduced().period
    ref_cfg, cfg, tree, r = _weights(name, 4, num_layers=period, capacity_factor=64.0)
    tokens = r.integers(0, cfg.vocab, (2, 32))
    knobs = dict(moe="expert_parallel", sp_attention=True, constrain_activations=True)
    # the reference's sharding constraints take a mesh of Auto axes, in context
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    ref_pctx, pctx = _pctxs(jmesh, **knobs)
    with jmesh:
        ref_logits, ref_cache = ref_make_prefill_step(ref_cfg, pctx=ref_pctx)(
            jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(tokens)})
    params = lm_params_from_reference(tree, "cpu")
    logits, cache = make_prefill_step(cfg, use_kernel=False, pctx=pctx)(params,
                                                                         {"tokens": tokens})
    plain_logits, plain_cache = make_prefill_step(cfg, use_kernel=False)(params,
                                                                         {"tokens": tokens})
    assert torch.equal(logits, plain_logits)
    assert sorted(cache) == sorted(plain_cache) == sorted(ref_cache)
    for k in cache:
        assert torch.equal(cache[k], plain_cache[k]), k
    gap = float(np.abs(logits.numpy() - np.asarray(ref_logits)).max())
    cache_gap = max(float(np.abs(cache[k].numpy() - np.asarray(ref_cache[k])).max())
                    for k in cache)
    print(f"jamba, one period, under pctx: logits {gap:.3g}, cache {cache_gap:.3g}")
    assert gap <= 1e-4
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(ref_cache[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)
