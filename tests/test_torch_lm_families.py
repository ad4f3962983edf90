"""The rest of the LM workbench's serving in the PyTorch/CUDA port against the
JAX reference, on the CPU: the MoE decoders (granite-moe-1b-a400m,
qwen3-moe-30b-a3b), Mamba-2 (mamba2-1.3b), the Jamba hybrid
(jamba-1.5-large-398b), the vision model (llava-next-34b) and the audio
encoder (hubert-xlarge).

Each configuration at its ``reduced()`` size in fp32: the reference's
``init_params`` tree, with every leaf its initializer sets to a constant
perturbed (``norm``, ``gnorm``, ``conv_b``, ``dt_bias``, ``A_log``,
``D_skip``), goes through ``repro_torch.convert.lm_params_from_reference``
into the port, and both packages get the same numpy tokens, frames and
patches.  Checked: the init tree; ``forward`` with the flash-attention path
(the reference's Pallas kernel in interpret mode, the port's plain version)
and with the einsum path; prefill logits and every cache entry; 4 decode
steps; the sliding-window decode past its window; the encoder-only
refusals; and the MoE and Mamba-2 pieces one by one.  Tolerance: atol/rtol
1e-4 (fp32; XLA and PyTorch round in their own order).

Jamba is held block by block.  Its 16 reduced layers amplify fp32 rounding
(1e-7 of noise on its embeddings moves its logits by 4.1e-4), and the
reference's own forward, jitted and run eagerly, differs from itself by
3.2e-4 (``test_jamba_is_beyond_whole_model_parity_in_fp32``): no two fp32
computations of it agree to 1e-4.  So
its tests record every block call of the reference's entry point (run
eagerly under ``jax.disable_jit``) and of the port's, and check: the same
blocks in the same order on bit-equal parameter rows (the period's wiring);
each port block, on the reference block's inputs, within 1e-4 of its
outputs (the cache entries included); the port's final norm and head on the
reference's last hidden state within 1e-4 of its logits.  The whole-model
gap is printed (``pytest -s``).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.all_archs  # noqa: F401
import repro.models.transformer as ref_transformer
from repro.configs.base import ARCHS as REF_ARCHS
from repro.models import forward as ref_forward
from repro.models import init_decode_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import make_prefill_step as ref_prefill_step
from repro.models import make_serve_step as ref_serve_step
from repro.models import mamba2 as ref_mamba2
from repro.models import moe as ref_moe
import repro_torch.models.transformer as transformer
from _lm_blocks import leaves, recorded, replay
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve
from repro_torch.launch.serve import pad_kv_cache
from repro_torch.models import (forward, init_decode_cache, init_params, make_prefill_step,
                                make_serve_step)
from repro_torch.models import mamba2, moe
from repro_torch.models.attention import attention_block
from repro_torch.models.layers import rms_norm

TOL = dict(atol=1e-4, rtol=1e-4)
NAMES = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "mamba2-1.3b", "jamba-1.5-large-398b",
         "llava-next-34b", "hubert-xlarge")
DEEP = ("jamba-1.5-large-398b",)  # held block by block (module note)
B, S, N, WINDOW, WINDOW_STEPS = 2, 16, 4, 8, 12
CONSTANT_LEAVES = ("norm", "gnorm", "final_norm", "conv_b", "dt_bias", "A_log", "D_skip")


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _perturb(tree, r):
    """Every leaf the initializer sets to a constant, drawn at random: the
    scales around 1, the biases and ``A_log`` around 0."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, r)
        elif k in ("conv_b", "dt_bias", "A_log"):
            out[k] = (r.standard_normal(v.shape) * 0.1).astype(v.dtype)
        elif k in CONSTANT_LEAVES:
            out[k] = (1.0 + r.standard_normal(v.shape) * 0.1).astype(v.dtype)
        else:
            out[k] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    name = request.param
    ref_cfg = REF_ARCHS[name].reduced()
    cfg = get_arch(name).reduced()
    r = np.random.default_rng(sum(map(ord, name)))
    params_np = _perturb(_np_tree(ref_init_params(ref_cfg, jax.random.PRNGKey(0))), r)
    c = types.SimpleNamespace(
        name=name, cfg=cfg, ref_cfg=ref_cfg, params_np=params_np,
        ref_params=jax.tree.map(jnp.asarray, params_np),
        params=lm_params_from_reference(params_np, "cpu"),
        tokens=r.integers(0, cfg.vocab, (B, S + N)),
        frames=r.standard_normal((B, S + N, cfg.frontend_dim)).astype(np.float32),
        patches=r.standard_normal((B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32),
        P=cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    return c


def _batch(case, hi):
    """The numpy inputs of the first ``hi`` positions (the vision model's
    patches come whole, before the text)."""
    if case.cfg.frontend == "audio":
        return {"frames": case.frames[:, :hi]}
    batch = {"tokens": case.tokens[:, :hi]}
    if case.cfg.frontend == "vision":
        batch["patch_embeds"] = case.patches
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    print(f"{what}: max abs gap {np.abs(got - ref).max():.3g}")  # read with pytest -s
    np.testing.assert_allclose(got, ref, err_msg=what, **TOL)


def _ref_kwargs(kw):
    """The reference's block keywords in the port's terms."""
    out = {}
    for k, v in kw.items():
        if k == "use_pallas":
            out["use_kernel"] = v
        elif k == "compute_dtype":
            out[k] = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[v]
        elif k != "pctx":
            out[k] = v
    return out


def _held(case, run_ref, run_port, what, logits_of=None):
    """``run_ref()`` and ``run_port()`` each return a list of outputs
    (logits, cache entries).  Whole, within 1e-4, except for the DEEP
    configurations, which are held block by block (module note):
    ``logits_of`` maps the reference's recorded block calls to ``[(last
    hidden state, logits index)]`` for the final norm and head."""
    if case.name not in DEEP:
        for i, (got, ref) in enumerate(zip(run_port(), run_ref(), strict=True)):
            _close(got, ref, f"{case.name} {what} [{i}]")
        return
    with jax.disable_jit(), recorded(ref_transformer) as ref_calls:
        ref = run_ref()
    with recorded(transformer) as port_calls:
        got = run_port()
    gap = max(float(np.abs(np.asarray(g) - np.asarray(r)).max()) for g, r in zip(got, ref))
    print(f"{case.name} {what}: whole-model gap {gap:.3g} (not held: module note)")
    assert [c[0] for c in port_calls] == [c[0] for c in ref_calls]
    for i, (mine, theirs) in enumerate(zip(port_calls, ref_calls)):
        assert sorted(mine[1]) == sorted(theirs[1])
        for leaf, a in theirs[1].items():
            assert np.array_equal(mine[1][leaf], a), f"block call {i} ({mine[0]}) row of {leaf}"
    worst = replay(ref_calls, case.cfg, "cpu", 1e-4, _ref_kwargs)
    print(f"{case.name} {what}: {len(ref_calls)} block calls, max gap block by block {worst:.3g}")
    with torch.inference_mode():
        for hidden, k in logits_of(ref_calls):
            x = rms_norm(torch.from_numpy(hidden), case.params["final_norm"], case.cfg.norm_eps)
            _close(x @ case.params["head"], ref[k], f"{case.name} {what}: final norm and head")
    for g in got:
        assert bool(torch.isfinite(torch.as_tensor(np.asarray(g))).all())


def _step_outputs(n_steps, last_only):
    """The last hidden state of each of ``n_steps`` equal runs of blocks."""
    def of(calls):
        per = len(calls) // n_steps
        out = []
        for t in range(n_steps):
            hidden = leaves(calls[(t + 1) * per - 1][4])[0]
            out.append((hidden[:, -1:] if last_only and t == 0 else hidden, t))
        return out
    return of


def test_jamba_is_beyond_whole_model_parity_in_fp32():
    """Why jamba is held block by block (module note): the reference's own
    forward, jitted and run eagerly, differs from itself by more than 1e-4,
    and 1e-7 of relative noise on the port's embeddings moves its logits by
    more than 1e-4; one block of it moves by far less."""
    ref_cfg = REF_ARCHS["jamba-1.5-large-398b"].reduced()
    cfg = get_arch("jamba-1.5-large-398b").reduced()
    params_np = _np_tree(ref_init_params(ref_cfg, jax.random.PRNGKey(0)))
    ref_params = jax.tree.map(jnp.asarray, params_np)
    tokens = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab, (B, S + N)))
    jitted = ref_forward(ref_cfg, ref_params, {"tokens": tokens}, remat=False)
    with jax.disable_jit():
        eager = ref_forward(ref_cfg, ref_params, {"tokens": tokens}, remat=False)
    self_gap = float(jnp.abs(jitted - eager).max())
    params = lm_params_from_reference(params_np, "cpu")
    base = forward(cfg, params, {"tokens": np.asarray(tokens)}, use_kernel=False)
    noise = torch.randn(params["embed"].shape, generator=torch.Generator().manual_seed(0))
    params["embed"] = params["embed"] * (1 + 1e-7 * noise)
    moved = float((forward(cfg, params, {"tokens": np.asarray(tokens)}, use_kernel=False)
                   - base).abs().max())
    print(f"jamba reduced: the reference jitted vs eager {self_gap:.3g}; the port's logits "
          f"moved {moved:.3g} by 1e-7 of noise on the embeddings")
    assert self_gap > 1e-4 and moved > 1e-4


# --------------------------------------------------------------------------
# configs and parameters
# --------------------------------------------------------------------------


def _param_gap(cfg):
    """The tree ``init_params`` draws, less ``param_count``, in the
    reference as in the port (ROADMAP.md §C, R7): the count has one
    ``d_inner`` vector per Mamba block where the tree has two (``conv_b``
    and ``gnorm``), an MLP norm where ``d_ff`` is 0 and there is no MLP, and
    an embedding the audio model does not have."""
    gap = cfg.n_periods * len(cfg.mamba_slots) * cfg.d_inner
    if cfg.d_ff == 0:
        gap -= cfg.n_periods * (cfg.period - len(cfg.moe_slots)) * cfg.d_model
    if cfg.frontend == "audio":
        gap -= cfg.vocab * cfg.d_model
    return gap


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_param_count_gap_is_the_references(name, reduced):
    """At every size of every configuration, the reference's tree (shapes
    only) and the port's rule for its gap to ``param_count`` agree."""
    cfg = REF_ARCHS[name].reduced() if reduced else REF_ARCHS[name]
    tree = _flat(jax.eval_shape(lambda: ref_init_params(cfg, jax.random.PRNGKey(0))))
    n = sum(int(np.prod(a.shape)) for a in tree.values())
    port = get_arch(name).reduced() if reduced else get_arch(name)
    assert n == port.param_count() + _param_gap(port)


def test_init_params_tree_matches_reference(case):
    """Same leaves, shapes and types as the reference's tree, in bf16 too
    (the router and the SSM's dt_bias, A_log, D_skip stay float32); as many
    parameters as the reference's tree; the seed decides the draw."""
    mine = _flat(init_params(case.cfg, seed=3, device="cpu"))
    ref = _flat(case.params_np)
    assert sorted(mine) == sorted(ref)
    for path, leaf in ref.items():
        assert tuple(mine[path].shape) == leaf.shape, path
        assert mine[path].dtype == torch.float32
    n = sum(t.numel() for t in mine.values())
    assert n == sum(a.size for a in ref.values())
    assert n == case.cfg.param_count() + _param_gap(case.cfg)
    assert case.cfg.param_count() == case.ref_cfg.param_count()
    again = _flat(init_params(case.cfg, seed=3, device="cpu"))
    other = _flat(init_params(case.cfg, seed=4, device="cpu"))
    assert all(torch.equal(again[p], mine[p]) for p in mine)
    assert not torch.equal(other["head"], mine["head"])
    bf = dataclasses.replace(case.cfg, dtype="bfloat16")
    mine16 = _flat(init_params(bf, seed=0, device="cpu"))
    ref16 = _flat(jax.eval_shape(lambda: ref_init_params(
        dataclasses.replace(case.ref_cfg, dtype="bfloat16"), jax.random.PRNGKey(0))))
    fp32 = sorted(p for p, a in ref16.items() if a.dtype == jnp.float32)
    assert fp32 == sorted(p for p, t in mine16.items() if t.dtype == torch.float32)
    assert all(t.dtype == torch.bfloat16 for p, t in mine16.items() if p not in fp32)
    if case.cfg.moe_slots:
        assert "blocks/moe/router" in fp32
    if case.cfg.mamba_slots:
        assert {"blocks/mamba/dt_bias", "blocks/mamba/A_log", "blocks/mamba/D_skip"} <= set(fp32)


def test_weights_carry_over_in_their_own_types():
    """``lm_params_from_reference`` keeps the float32 leaves of a bf16 tree
    float32 and takes the audio tree, which has no embedding."""
    cfg = dataclasses.replace(REF_ARCHS["jamba-1.5-large-398b"].reduced(), dtype="bfloat16")
    tree = _np_tree(ref_init_params(cfg, jax.random.PRNGKey(1)))
    mine = lm_params_from_reference(tree, "cpu")
    for kind, leaf in (("moe", "router"), ("mamba", "dt_bias"), ("mamba", "A_log"),
                       ("mamba", "D_skip")):
        assert mine["blocks"][kind][leaf].dtype == torch.float32, leaf
        np.testing.assert_array_equal(mine["blocks"][kind][leaf].numpy(),
                                      tree["blocks"][kind][leaf])
    assert mine["blocks"]["moe"]["w1"].dtype == torch.bfloat16
    np.testing.assert_array_equal(mine["blocks"]["mamba"]["wx"].float().numpy(),
                                  tree["blocks"]["mamba"]["wx"].astype(np.float32))
    audio = _np_tree(ref_init_params(REF_ARCHS["hubert-xlarge"].reduced(), jax.random.PRNGKey(2)))
    assert "embed" not in audio
    mine = lm_params_from_reference(audio, "cpu")
    assert sorted(mine) == sorted(audio)
    np.testing.assert_array_equal(mine["frontend_proj"].numpy(), audio["frontend_proj"])


def test_slot_rows_follow_the_reference():
    """Jamba's period: 1 attention, 7 Mamba, 4 MoE and 4 MLP slots, each on
    its own stack row, in both of the reference's indexing rules."""
    cfg = get_arch("jamba-1.5-large-398b")
    want = [("mamba", 0, "mlp", 0), ("mamba", 1, "moe", 0), ("mamba", 2, "mlp", 1),
            ("attn", 0, "moe", 1), ("mamba", 3, "mlp", 2), ("mamba", 4, "moe", 2),
            ("mamba", 5, "mlp", 3), ("mamba", 6, "moe", 3)]
    assert transformer._slot_rows(cfg) == want
    assert transformer._slot_rows(cfg, prefill=True) == want
    assert transformer._slot_rows(get_arch("mamba2-1.3b")) == [("mamba", 0, None, None)]
    assert transformer._slot_rows(get_arch("granite-moe-1b-a400m")) == [("attn", 0, "moe", 0)]


# --------------------------------------------------------------------------
# forward, prefill, decode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [True, False], ids=["flash", "einsum"])
def test_forward_matches_reference(case, use_kernel):
    batch = _batch(case, S + N)

    def run_port():
        got = forward(case.cfg, case.params, batch, use_kernel=use_kernel)
        assert got.shape == (B, case.P + S + N, case.cfg.vocab)
        return [got]

    _held(case, lambda: [ref_forward(case.ref_cfg, case.ref_params, _jax(batch),
                                     use_pallas=use_kernel, remat=False)],
          run_port, f"forward ({'flash' if use_kernel else 'einsum'})",
          _step_outputs(1, last_only=False))


def _ref_prefill(case):
    logits, cache = ref_prefill_step(case.ref_cfg, use_pallas=True)(
        case.ref_params, _jax(_batch(case, S)))
    return logits, cache


def test_prefill_matches_reference(case):
    """Prefill logits and every cache entry; an encoder-only configuration's
    prefill is its forward, with no cache."""
    def run_port():
        logits, cache = make_prefill_step(case.cfg)(case.params, _batch(case, S))
        return [logits] + [cache[k] for k in sorted(cache)]

    def run_ref():
        logits, cache = _ref_prefill(case)
        return [logits] + [cache[k] for k in sorted(cache)]

    keys = sorted(make_prefill_step(case.cfg)(case.params, _batch(case, S))[1])
    want = ({"k", "v"} if case.cfg.attn_slots and case.cfg.is_decoder else set())
    want |= {"conv", "ssm"} if case.cfg.mamba_slots else set()
    assert set(keys) == want
    _held(case, run_ref, run_port, "prefill", _step_outputs(1, last_only=True))


def test_decode_matches_reference(case):
    """Prefill S positions, pad the KV entries by N as the serve CLI does,
    then N decode steps teacher-forced with the same tokens on both
    sides; every cache entry after the last."""
    if not case.cfg.is_decoder:
        pytest.skip("encoder-only: no decode step (test_encoder_only_refuses_decode)")
    start = case.P + S

    def run_port():
        logits, cache = make_prefill_step(case.cfg)(case.params, _batch(case, S))
        cache, seq, step = pad_kv_cache(cache, N), [logits], make_serve_step(case.cfg)
        for i in range(N):
            logits, cache = step(case.params, cache, case.tokens[:, S + i:S + i + 1], start + i)
            seq.append(logits)
        return seq + [cache[k] for k in sorted(cache)]

    def run_ref():
        logits, cache = _ref_prefill(case)
        pad = [(0, 0)] * 6
        pad[3] = (0, N)
        cache = {k: jnp.pad(v, pad) if k in ("k", "v") else v for k, v in cache.items()}
        seq, step = [logits], ref_serve_step(case.ref_cfg, donate=False)
        for i in range(N):
            logits, cache = step(case.ref_params, cache, jnp.asarray(case.tokens[:, S + i:S + i + 1]),
                                 jnp.asarray(start + i, jnp.int32))
            seq.append(logits)
        return seq + [cache[k] for k in sorted(cache)]

    _held(case, run_ref, run_port, "prefill + decode", _step_outputs(N + 1, last_only=True))


def test_window_decode_past_the_window_matches_reference(case):
    """A ring buffer of WINDOW slots fed WINDOW_STEPS tokens through decode,
    as the serve CLI's --window mode does (the text alone)."""
    if not (case.cfg.is_decoder and case.cfg.attn_slots):
        pytest.skip("no attention, or no decode step: no window")

    def run_port():
        cache, seq = init_decode_cache(case.cfg, B, WINDOW, device="cpu"), []
        step = make_serve_step(case.cfg, window=WINDOW)
        for pos in range(WINDOW_STEPS):
            logits, cache = step(case.params, cache, case.tokens[:, pos:pos + 1], pos)
            seq.append(logits)
        return seq + [cache[k] for k in sorted(cache)]

    def run_ref():
        cache, seq = ref_init_cache(case.ref_cfg, B, WINDOW), []
        step = ref_serve_step(case.ref_cfg, window=WINDOW, donate=False)
        for pos in range(WINDOW_STEPS):
            logits, cache = step(case.ref_params, cache, jnp.asarray(case.tokens[:, pos:pos + 1]),
                                 jnp.asarray(pos, jnp.int32))
            seq.append(logits)
        return seq + [cache[k] for k in sorted(cache)]

    _held(case, run_ref, run_port, "window decode", _step_outputs(WINDOW_STEPS, False))


def test_decode_agrees_with_forward_in_the_port(case):
    """prefill(S) then decode(token S + i) gives forward's logits at S + i.
    With capacity_factor 64, as the reference's own test: at 1.25 a
    prefill of many tokens drops picks that a one-token decode keeps."""
    if not case.cfg.is_decoder or case.cfg.frontend == "vision":
        pytest.skip("encoder-only, or decode takes no patches")
    if case.name in DEEP:
        pytest.skip("held block by block against the reference (module note)")
    cfg = dataclasses.replace(case.cfg, capacity_factor=64.0)
    full = forward(cfg, case.params, _batch(case, S + N))
    logits, cache = make_prefill_step(cfg)(case.params, _batch(case, S))
    _close(logits[:, 0], full[:, S - 1], "prefill vs forward")
    cache, step = pad_kv_cache(cache, N), make_serve_step(cfg)
    for pos in range(S, S + N):
        logits, cache = step(case.params, cache, case.tokens[:, pos:pos + 1], pos)
        _close(logits[:, 0], full[:, pos], f"decode vs forward at {pos}")


def test_encoder_only_refuses_decode():
    cfg = get_arch("hubert-xlarge").reduced()
    with pytest.raises(ValueError, match="encoder-only"):
        make_serve_step(cfg)
    params = init_params(cfg, 0, "cpu")
    frames = np.random.default_rng(0).standard_normal((2, 8, cfg.frontend_dim))
    logits, cache = make_prefill_step(cfg)(params, {"frames": frames.astype(np.float32)})
    assert logits.shape == (2, 8, cfg.vocab) and cache == {}
    with pytest.raises(ValueError):
        ref_serve_step(REF_ARCHS["hubert-xlarge"].reduced())


def test_pctx_still_raises():
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    p = {k: v[0, 0] for k, v in init_params(cfg, 0, "cpu")["blocks"]["attn"].items()}
    with pytest.raises(NotImplementedError, match="pctx"):
        attention_block(p, cfg, torch.zeros(1, 2, cfg.d_model), torch.arange(2), pctx=object())


# --------------------------------------------------------------------------
# MoE and Mamba-2, piece by piece
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_case():
    ref_cfg = REF_ARCHS["granite-moe-1b-a400m"].reduced()
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    tree = _perturb(_np_tree(ref_init_params(ref_cfg, jax.random.PRNGKey(5))),
                    np.random.default_rng(5))
    p_np = {k: v[0, 0] for k, v in tree["blocks"]["moe"].items()}
    # hidden states share a direction, as a model's do, so the router leans
    # to some experts and the capacity rule has picks to drop
    r = np.random.default_rng(6)
    x = (r.standard_normal((4, 32, cfg.d_model)) + r.standard_normal(cfg.d_model))
    x = x.astype(np.float32)
    return types.SimpleNamespace(cfg=cfg, ref_cfg=ref_cfg, x=x,
                                 p={k: torch.from_numpy(np.array(v)) for k, v in p_np.items()},
                                 ref_p={k: jnp.asarray(v) for k, v in p_np.items()})


def test_route_matches_reference(moe_case):
    h = moe_case.x.reshape(-1, moe_case.cfg.d_model)
    idx, w, probs = moe._route(moe_case.cfg, torch.from_numpy(h), moe_case.p["router"])
    ridx, rw, rprobs = ref_moe._route(moe_case.ref_cfg, jnp.asarray(h), moe_case.ref_p["router"])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    _close(w, rw, "route weights")
    _close(probs, rprobs, "route probs")
    assert torch.all(w[:, :-1] >= w[:, 1:])  # sorted, descending


@pytest.mark.parametrize("T", [1, 4, 31, 64, 128, 8192])
@pytest.mark.parametrize("cf", [1.25, 64.0])
def test_capacity_matches_reference(T, cf):
    for name in ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b"):
        cfg = dataclasses.replace(get_arch(name), capacity_factor=cf)
        ref = dataclasses.replace(REF_ARCHS[name], capacity_factor=cf)
        assert moe._capacity(cfg, T) == ref_moe._capacity(ref, T)


def test_moe_block_drops_at_capacity_like_the_reference(moe_case):
    """At capacity_factor 1.25, 128 tokens over 4 experts drop picks; the
    same picks drop on both sides, and the auxiliaries agree; at 64 none
    drops."""
    x = moe_case.x
    y, aux = moe.moe_block(moe_case.p, moe_case.cfg, torch.from_numpy(x), return_aux=True)
    ry, raux = ref_moe.moe_block(moe_case.ref_p, moe_case.ref_cfg, jnp.asarray(x),
                                 return_aux=True)
    _close(y, ry, "moe_block")
    _close(aux["aux_loss"], raux["aux_loss"], "aux_loss")
    assert float(aux["dropped"]) == pytest.approx(float(raux["dropped"]), abs=1e-7)
    # "dropped" is the share of empty capacity slots: the picks kept are
    # (1 - dropped)·E·C, fewer than T·k at 1.25 and all of them at 64
    T, E, K = x.shape[0] * x.shape[1], moe_case.cfg.moe_experts, moe_case.cfg.moe_topk
    kept = round((1 - float(aux["dropped"])) * E * moe._capacity(moe_case.cfg, T))
    assert kept < T * K
    no_drop = dataclasses.replace(moe_case.cfg, capacity_factor=64.0)
    _, aux64 = moe.moe_block(moe_case.p, no_drop, torch.from_numpy(x), return_aux=True)
    assert round((1 - float(aux64["dropped"])) * E * moe._capacity(no_drop, T)) == T * K
    stats = moe.router_stats(moe_case.cfg, moe_case.p, torch.from_numpy(x))
    rstats = ref_moe.router_stats(moe_case.ref_cfg, moe_case.ref_p, jnp.asarray(x))
    _close(stats["expert_load"], rstats["expert_load"], "expert_load")
    _close(stats["entropy"], rstats["entropy"], "entropy")


@pytest.fixture(scope="module")
def ssm_case():
    ref_cfg = REF_ARCHS["mamba2-1.3b"].reduced()
    cfg = get_arch("mamba2-1.3b").reduced()
    tree = _perturb(_np_tree(ref_init_params(ref_cfg, jax.random.PRNGKey(7))),
                    np.random.default_rng(7))
    p_np = {k: v[0, 0] for k, v in tree["blocks"]["mamba"].items()}
    return types.SimpleNamespace(cfg=cfg, ref_cfg=ref_cfg, r=np.random.default_rng(8),
                                 p={k: torch.from_numpy(np.array(v)) for k, v in p_np.items()},
                                 ref_p={k: jnp.asarray(v) for k, v in p_np.items()})


def test_causal_conv_matches_reference(ssm_case):
    r = ssm_case.r
    x = r.standard_normal((2, 9, 24)).astype(np.float32)
    w = r.standard_normal((4, 24)).astype(np.float32)
    b = r.standard_normal(24).astype(np.float32)
    got = mamba2._causal_conv(*map(torch.from_numpy, (x, w, b)))
    _close(got, ref_mamba2._causal_conv(*map(jnp.asarray, (x, w, b))), "causal conv")


@pytest.mark.parametrize("s,chunk", [(16, 128), (64, 16), (40, 8)])
def test_ssd_chunked_matches_reference(ssm_case, s, chunk):
    """Within one chunk and over several (the inter-chunk recurrence), with
    the final state."""
    r, cfg = ssm_case.r, ssm_case.cfg
    nh, hp, Nst = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x = r.standard_normal((2, s, nh, hp)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((2, s, nh)))).astype(np.float32)
    A = -np.exp(r.standard_normal(nh) * 0.3).astype(np.float32)
    Bm, Cm = (r.standard_normal((2, s, Nst)).astype(np.float32) for _ in range(2))
    y, H = mamba2._ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk=chunk,
                               return_state=True)
    ry, rH = ref_mamba2._ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk,
                                     return_state=True)
    _close(y, ry, "ssd y")
    _close(H, rH, "ssd final state")


def test_ssd_refuses_a_sequence_the_chunk_does_not_divide(ssm_case):
    cfg = ssm_case.cfg
    x = torch.zeros(1, 130, cfg.ssm_heads, cfg.ssm_head_dim)
    dt = torch.ones(1, 130, cfg.ssm_heads)
    BC = torch.zeros(1, 130, cfg.ssm_state)
    with pytest.raises(ValueError, match="divide the SSD chunk"):
        mamba2._ssd_chunked(x, dt, -torch.ones(cfg.ssm_heads), BC, BC)
    forward_cfg = get_arch("mamba2-1.3b").reduced()
    params = init_params(forward_cfg, 0, "cpu")
    with pytest.raises(ValueError, match="divide the SSD chunk"):
        forward(forward_cfg, params, {"tokens": np.zeros((1, 129), np.int64)})


def test_mamba_blocks_match_reference(ssm_case):
    """The prefill block, then decode steps against the states it left."""
    r, cfg = ssm_case.r, ssm_case.cfg
    x = r.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    _close(mamba2.mamba_block(ssm_case.p, cfg, torch.from_numpy(x)),
           ref_mamba2.mamba_block(ssm_case.ref_p, ssm_case.ref_cfg, jnp.asarray(x)),
           "mamba block")
    y, (conv, ssm) = transformer._mamba_prefill(ssm_case.p, cfg, torch.from_numpy(x))
    ry, (rconv, rssm) = ref_transformer._mamba_prefill(ssm_case.ref_p, ssm_case.ref_cfg,
                                                       jnp.asarray(x))
    _close(y, ry, "mamba prefill")
    _close(conv, rconv, "conv state")
    _close(ssm, rssm, "ssm state")
    conv, ssm = conv.clone(), ssm.clone()
    for i in range(3):
        xt = r.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        yt, conv_out, ssm_out = mamba2.decode_mamba_block(ssm_case.p, cfg, torch.from_numpy(xt),
                                                          conv, ssm)
        assert conv_out is conv and ssm_out is ssm  # updated in place
        ry, rconv, rssm = ref_mamba2.decode_mamba_block(ssm_case.ref_p, ssm_case.ref_cfg,
                                                        jnp.asarray(xt), rconv, rssm)
        _close(yt, ry, f"decode step {i}")
        _close(conv, rconv, f"conv state after step {i}")
        _close(ssm, rssm, f"ssm state after step {i}")


# --------------------------------------------------------------------------
# the serve CLI's LM half
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-1.3b"])
def test_serve_cli_repeats_itself(arch):
    base = ["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "12",
            "--new-tokens", "3", "--seed", "5"]
    out = serve.main(base)
    assert out["tokens"].shape == (2, 3) and out["start"] == 12
    np.testing.assert_array_equal(out["tokens"], serve.main(base)["tokens"])


def test_serve_cli_vision_draws_patches_and_decodes_after_them(monkeypatch):
    """R6: the vision model's prefill gets patches drawn from the seed after
    the prompt, and decode starts at frontend_tokens + S."""
    import repro_torch.models as models

    positions, batches = [], []
    prefill, serve_step = models.make_prefill_step, models.make_serve_step

    def spy_prefill(cfg, *a, **k):
        fn = prefill(cfg, *a, **k)
        return lambda params, batch: (batches.append(batch), fn(params, batch))[1]

    def spy_serve(cfg, *a, **k):
        fn = serve_step(cfg, *a, **k)
        return lambda params, cache, token, pos: (positions.append(pos),
                                                  fn(params, cache, token, pos))[1]

    monkeypatch.setattr(models, "make_prefill_step", spy_prefill)
    monkeypatch.setattr(models, "make_serve_step", spy_serve)
    out = serve.main(["--arch", "llava-next-34b", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--new-tokens", "3", "--seed", "9"])
    cfg = get_arch("llava-next-34b").reduced()
    P = cfg.frontend_tokens
    assert out["start"] == P + 8 and positions == [P + 8, P + 9, P + 10]
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, cfg.vocab, (2, 8))
    patches = rng.standard_normal((2, P, cfg.frontend_dim)).astype(np.float32)
    (batch,) = batches
    np.testing.assert_array_equal(batch["tokens"].numpy(), prompts)
    np.testing.assert_array_equal(batch["patch_embeds"], patches)


def test_serve_cli_refuses_the_encoder_only_model():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])
