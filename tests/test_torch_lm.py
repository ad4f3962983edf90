"""The LM workbench's dense decoders in the PyTorch/CUDA port against the JAX
reference, on the CPU.

For llama3.2-3b, qwen2-1.5b (QKV bias), yi-6b and chatglm3-6b (half-dim
RoPE), each at its ``reduced()`` size in fp32, the reference's
``init_params`` tree (biases and norm scales perturbed, so that those
paths carry non-trivial values) goes through
``repro_torch.convert.lm_params_from_reference`` into the port, and both
sides run the same numpy tokens: the forward with the flash-attention path
(the reference's Pallas kernel in interpret mode, the port's plain
version) and with the einsum path; prefill logits and cache; 4 decode
steps; the sliding-window decode past its window.  Tolerance: atol/rtol
1e-4 (fp32; XLA and PyTorch sum the products in their own order).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.all_archs  # noqa: F401
from repro.configs.base import ARCHS as REF_ARCHS
from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.models import forward as ref_forward
from repro.models import init_decode_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import make_prefill_step as ref_prefill_step
from repro.models import make_serve_step as ref_serve_step
from repro.models.layers import apply_rope as ref_apply_rope
from repro.models.layers import rms_norm as ref_rms_norm
import repro_torch.configs.all_archs  # noqa: F401
from repro_torch.configs import INPUT_SHAPES, get_arch
from repro_torch.configs.base import ARCHS
from repro_torch.convert import lm_params_from_reference
from repro_torch.device import NoGPUError
from repro_torch.launch import serve
from repro_torch.models import (forward, init_decode_cache, init_params, make_prefill_step,
                                make_serve_step)
from repro_torch.models.attention import CacheOverflowError
from repro_torch.models.layers import apply_rope, rms_norm

TOL = dict(atol=1e-4, rtol=1e-4)
DENSE = ("llama3.2-3b", "qwen2-1.5b", "yi-6b", "chatglm3-6b")
OTHERS = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "mamba2-1.3b",
          "jamba-1.5-large-398b", "llava-next-34b", "hubert-xlarge")
B, S, N, WINDOW, WINDOW_STEPS = 2, 16, 4, 8, 12


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _perturb(tree, r):
    """Random biases and norm scales (the initializer leaves them 0 and 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, r)
        elif k in ("bq", "bk", "bv"):
            out[k] = (r.standard_normal(v.shape) * 0.1).astype(v.dtype)
        elif "norm" in k:
            out[k] = (1.0 + r.standard_normal(v.shape) * 0.1).astype(v.dtype)
        else:
            out[k] = v
    return out


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module", params=DENSE)
def case(request):
    name = request.param
    ref_cfg = REF_ARCHS[name].reduced()
    cfg = get_arch(name).reduced()
    r = np.random.default_rng(sum(map(ord, name)))
    params_np = _perturb(_np_tree(ref_init_params(ref_cfg, jax.random.PRNGKey(0))), r)
    tokens = r.integers(0, cfg.vocab, (B, S + N))
    return types.SimpleNamespace(
        name=name, cfg=cfg, ref_cfg=ref_cfg, params_np=params_np,
        ref_params=_jax_tree(params_np), params=lm_params_from_reference(params_np, "cpu"),
        tokens=tokens)


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    print(f"{what}: max abs gap {np.abs(got - ref).max():.3g}")  # read with pytest -s
    np.testing.assert_allclose(got, ref, err_msg=what, **TOL)


# --------------------------------------------------------------------------
# configs and parameters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_configs_match_reference(name):
    ref, port = REF_ARCHS[name], ARCHS[name]
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    assert port.param_count() == ref.param_count()
    assert port.reduced().param_count() == ref.reduced().param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert (port.hd, port.n_periods, port.mamba_slots) == (ref.hd, ref.n_periods,
                                                          ref.mamba_slots)
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_init_params_tree_matches_reference(case):
    """Same leaves, shapes and types as the reference's tree; as many
    parameters as ``param_count``; the seed decides the draw."""
    mine = _flat(init_params(case.cfg, seed=3, device="cpu"))
    ref = _flat(case.params_np)
    assert sorted(mine) == sorted(ref)
    for path, leaf in ref.items():
        assert tuple(mine[path].shape) == leaf.shape, path
        assert mine[path].dtype == torch.float32
    assert sum(t.numel() for t in mine.values()) == case.cfg.param_count()
    again = _flat(init_params(case.cfg, seed=3, device="cpu"))
    other = _flat(init_params(case.cfg, seed=4, device="cpu"))
    assert all(torch.equal(again[p], mine[p]) for p in mine)
    assert not torch.equal(other["head"], mine["head"])
    wq = mine["blocks/attn/wq"]
    assert abs(float(wq.std()) - case.cfg.d_model ** -0.5) < 0.1 * case.cfg.d_model ** -0.5


def test_bf16_parameters_carry_over_exactly():
    cfg = dataclasses.replace(REF_ARCHS["qwen2-1.5b"].reduced(), dtype="bfloat16")
    tree = _np_tree(ref_init_params(cfg, jax.random.PRNGKey(1)))
    mine = lm_params_from_reference(tree, "cpu")
    assert mine["head"].dtype == torch.bfloat16
    np.testing.assert_array_equal(mine["head"].float().numpy(),
                                  tree["head"].astype(np.float32))
    np.testing.assert_array_equal(mine["blocks"]["mlp"]["w2"].float().numpy(),
                                  tree["blocks"]["mlp"]["w2"].astype(np.float32))
    as32 = lm_params_from_reference(tree, "cpu", dtype=torch.float32)
    assert as32["embed"].dtype == torch.float32


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_reference(fraction, dtype):
    r = np.random.default_rng(int(fraction * 10))
    x = r.standard_normal((2, 9, 3, 64)).astype(np.float32)
    scale = (1 + 0.1 * r.standard_normal(64)).astype(np.float32)
    pos2 = r.integers(0, 5000, (2, 9)).astype(np.int32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, dtype)
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    got = rms_norm(tx, torch.from_numpy(scale).to(tx.dtype), 1e-5)
    ref = ref_rms_norm(jx, jnp.asarray(scale, dtype), 1e-5)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)
    for positions in (np.arange(9, dtype=np.int32), pos2):
        got = apply_rope(tx, torch.from_numpy(positions), fraction, 10_000.0)
        ref = ref_apply_rope(jx, jnp.asarray(positions), fraction, 10_000.0)
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)
    if fraction < 1:  # the second half of each head passes through
        torch.testing.assert_close(got[..., 32:], tx[..., 32:], atol=0, rtol=0)


# --------------------------------------------------------------------------
# forward, prefill, decode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [True, False], ids=["flash", "einsum"])
def test_forward_matches_reference(case, use_kernel):
    batch = {"tokens": case.tokens}
    got = forward(case.cfg, case.params, batch, use_kernel=use_kernel)
    ref = ref_forward(case.ref_cfg, case.ref_params, {"tokens": jnp.asarray(case.tokens)},
                      use_pallas=use_kernel)
    assert got.shape == (B, S + N, case.cfg.vocab)
    _close(got, ref, f"{case.name} forward")


def test_prefill_then_decode_match_reference(case):
    """Prefill S tokens, pad the cache by N as the serve CLI does, then N
    decode steps teacher-forced with the same tokens on both sides."""
    prompt = case.tokens[:, :S]
    logits, cache = make_prefill_step(case.cfg)(case.params, {"tokens": prompt})
    ref_logits, ref_cache = ref_prefill_step(case.ref_cfg, use_pallas=True)(
        case.ref_params, {"tokens": jnp.asarray(prompt)})
    _close(logits, ref_logits, "prefill logits")
    for k in ("k", "v"):
        assert cache[k].shape == ref_cache[k].shape
        _close(cache[k], ref_cache[k], f"prefill cache {k}")
    pad = [(0, 0)] * 6
    pad[3] = (0, N)
    ref_cache = {k: jnp.pad(v, pad) for k, v in ref_cache.items()}
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, N)) for k, v in cache.items()}
    step = make_serve_step(case.cfg)
    ref_step = ref_serve_step(case.ref_cfg, donate=False)
    for pos in range(S, S + N):
        tok = case.tokens[:, pos:pos + 1]
        logits, cache = step(case.params, cache, torch.from_numpy(tok), pos)
        ref_logits, ref_cache = ref_step(case.ref_params, ref_cache, jnp.asarray(tok),
                                         jnp.asarray(pos, jnp.int32))
        _close(logits, ref_logits, f"decode logits at {pos}")
    for k in ("k", "v"):
        _close(cache[k], ref_cache[k], f"decode cache {k}")


def test_window_decode_past_the_window_matches_reference(case):
    """A ring buffer of WINDOW slots fed WINDOW_STEPS tokens through decode,
    as the serve CLI's --window mode does; the last logits also equal the
    windowed forward's."""
    cache = init_decode_cache(case.cfg, B, WINDOW, device="cpu")
    ref_cache = ref_init_cache(case.ref_cfg, B, WINDOW)
    step = make_serve_step(case.cfg, window=WINDOW)
    ref_step = ref_serve_step(case.ref_cfg, window=WINDOW, donate=False)
    for pos in range(WINDOW_STEPS):
        tok = case.tokens[:, pos:pos + 1]
        logits, cache = step(case.params, cache, torch.from_numpy(tok), pos)
        ref_logits, ref_cache = ref_step(case.ref_params, ref_cache, jnp.asarray(tok),
                                         jnp.asarray(pos, jnp.int32))
        _close(logits, ref_logits, f"window decode logits at {pos}")
    for k in ("k", "v"):
        _close(cache[k], ref_cache[k], f"window cache {k}")
    full = forward(case.cfg, case.params, {"tokens": case.tokens[:, :WINDOW_STEPS]},
                   window=WINDOW)
    _close(logits[:, 0], full[:, -1], "window decode vs windowed forward")


def test_decode_agrees_with_forward_in_the_port(case):
    """prefill(tokens[:S]) then decode(token S + i) gives forward's logits
    at position S + i."""
    full = forward(case.cfg, case.params, {"tokens": case.tokens})
    logits, cache = make_prefill_step(case.cfg)(case.params, {"tokens": case.tokens[:, :S]})
    _close(logits[:, 0], full[:, S - 1], "prefill vs forward")
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, N)) for k, v in cache.items()}
    step = make_serve_step(case.cfg)
    for pos in range(S, S + N):
        logits, cache = step(case.params, cache,
                             torch.from_numpy(case.tokens[:, pos:pos + 1]), pos)
        _close(logits[:, 0], full[:, pos], f"decode vs forward at {pos}")


def test_cache_overflow_raises():
    """Without a window, a position past the cache raises (the reference's
    dynamic_update_slice clamps it onto the last slot)."""
    cfg = get_arch("llama3.2-3b").reduced()
    params = init_params(cfg, 0, "cpu")
    cache = init_decode_cache(cfg, 1, 4, device="cpu")
    step = make_serve_step(cfg)
    tok = torch.zeros((1, 1), dtype=torch.long)
    for pos in range(4):
        step(params, cache, tok, pos)
    with pytest.raises(CacheOverflowError, match="outside a KV cache of 4"):
        step(params, cache, tok, 4)
    step_w = make_serve_step(cfg, window=4)
    logits, _ = step_w(params, cache, tok, 9)  # a ring buffer wraps instead
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("name", OTHERS)
def test_configs_this_slice_does_not_run_raise(name):
    cfg = get_arch(name).reduced()
    for make in (lambda: init_params(cfg, 0, "cpu"), lambda: make_prefill_step(cfg),
                 lambda: make_serve_step(cfg), lambda: init_decode_cache(cfg, 1, 4, device="cpu"),
                 lambda: forward(cfg, {}, {"tokens": np.zeros((1, 2), np.int64)})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make()


# --------------------------------------------------------------------------
# the serve CLI's LM half
# --------------------------------------------------------------------------


def test_serve_cli_runs_on_the_cpu_and_needs_a_gpu_by_default(monkeypatch, capsys):
    base = ["--arch", "chatglm3-6b", "--batch", "2", "--prompt-len", "12",
            "--new-tokens", "3"]
    out = serve.main(base + ["--device", "cpu", "--seed", "5"])
    assert out["tokens"].shape == (2, 3)
    again = serve.main(base + ["--device", "cpu", "--seed", "5"])
    np.testing.assert_array_equal(out["tokens"], again["tokens"])
    win = serve.main(base + ["--device", "cpu", "--window", "8"])
    assert win["tokens"].shape == (2, 3)
    text = capsys.readouterr().out
    assert "prefill 2x12" in text and "window=8" in text
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoGPUError):
        serve.main(base)
