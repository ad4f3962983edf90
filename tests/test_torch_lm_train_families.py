"""LM training in the PyTorch/CUDA port against the JAX reference, on the CPU:
the MoE decoders (granite-moe-1b-a400m, qwen3-moe-30b-a3b), Mamba-2
(mamba2-1.3b), the vision model (llava-next-34b, text positions scored),
the audio encoder (hubert-xlarge, no shift) and the Jamba hybrid
(jamba-1.5-large-398b).  The dense decoders, the optimizer, the schedules,
the pipeline and the CLI are in ``tests/test_torch_lm_train.py``, whose
module note gives the checks and tolerances; they are the same here.

Jamba is held block by block, as in ``tests/test_torch_lm_families.py``:
its 16 reduced layers amplify fp32 rounding past 1e-4, so no two fp32
computations of its whole model agree that closely.  Each block kind
(attention, Mamba-2, MoE, MLP) at its widths, on the same inputs and
cotangent, gives its output and its vjp (into the input and every
parameter) within atol/rtol 1e-4 of the reference's; the whole model's loss and
gradient gaps are printed (``pytest -s``), not held.

Measured gaps: loss at most 9.5e-7; gradients 1.6e-5 (mamba2, whose SSD
sums its decays in its own order), 8e-7 elsewhere; parameters a step at a
time 5.8e-5 (mamba2), 1.9e-5 elsewhere; jamba's block vjps at most 3.3e-4
(its Mamba block, whose gradients reach 48), inside atol/rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attention
from repro.models import mamba2 as ref_mamba2
from repro.models import moe as ref_moe
from _lm_train import (Pair, flat, hold_with_exemption, make_batch, max_gap, port_loss_grads,
                       train_side_by_side)
from repro_torch.configs import get_arch
from repro_torch.models import attention, init_train_state, make_train_step, mamba2, moe

NAMES = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "mamba2-1.3b", "llava-next-34b",
         "hubert-xlarge")
JAMBA = "jamba-1.5-large-398b"
LR = 3e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the reduced models' tensors are small, and the
    suite's workers share the cores (many threads each only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    return Pair(request.param)


def test_loss_and_gradients_match_reference(pair):
    batch = make_batch(pair.cfg, pair.r)
    want, want_g = pair.ref_loss_grads(pair.ref_params(), batch)
    got, got_g = port_loss_grads(pair.cfg, pair.port_state()["params"], batch)
    print(f"{pair.name}: loss gap {abs(got - want):.3g}, largest gradient gap "
          f"{max_gap(got_g, want_g):.3g}")
    assert abs(got - want) <= 1e-4
    assert sorted(got_g) == sorted(want_g)
    for path, g in want_g.items():
        np.testing.assert_allclose(got_g[path], g, atol=1e-4, rtol=0, err_msg=path)


def test_train_steps_match_reference(pair):
    ref_losses, losses, per_step = train_side_by_side(pair)
    print(f"{pair.name}: free-running losses {losses}, reference {ref_losses}")
    np.testing.assert_allclose(losses, ref_losses, atol=1e-4, rtol=0)
    for k, (ref_state, state, grads) in enumerate(per_step):
        assert int(state["opt"]["step"]) == int(ref_state["opt"]["step"]) == k + 1
        gaps = [hold_with_exemption(flat(state["params"]), flat(ref_state["params"]),
                                    [grads], LR, 1e-4, f"step {k} params")]
        for m in ("m", "v"):
            gaps.append(hold_with_exemption(flat(state["opt"][m]), flat(ref_state["opt"][m]),
                                            [grads], LR, 1e-5, f"step {k} {m}"))
        print(f"{pair.name} step {k}: params {gaps[0][0]:.3g} ({gaps[0][1]} exempt), m "
              f"{gaps[1][0]:.3g}, v {gaps[2][0]:.3g}")


@pytest.fixture(scope="module")
def jamba():
    return Pair(JAMBA)


def _block_fns(cfg, ref_cfg, s):
    """Each block kind's (reference, port) function of (params, x)."""
    ref_pos, pos = jnp.arange(s, dtype=jnp.int32), torch.arange(s, dtype=torch.int32)
    return {
        "attn": (lambda p, x: ref_attention.attention_block(p, ref_cfg, x, ref_pos),
                 lambda p, x: attention.attention_block(p, cfg, x, pos, use_kernel=False)),
        "mamba": (lambda p, x: ref_mamba2.mamba_block(p, ref_cfg, x),
                  lambda p, x: mamba2.mamba_block(p, cfg, x)),
        "moe": (lambda p, x: ref_moe.moe_block(p, ref_cfg, x),
                lambda p, x: moe.moe_block(p, cfg, x)),
        "mlp": (lambda p, x: ref_moe.mlp_block(p, ref_cfg, x),
                lambda p, x: moe.mlp_block(p, cfg, x)),
    }


@pytest.mark.parametrize("kind", ["attn", "mamba", "moe", "mlp"])
def test_jamba_block_gradients_match_reference(jamba, kind):
    """One block of each kind from jamba's weights (period 1, its first
    row), at its widths: output and vjp within atol/rtol 1e-4 of the
    reference's (the Mamba block's A_log gradients reach 48: relative)."""
    cfg, s = jamba.cfg, 64
    p_np = {k: np.array(v[1, 0]) for k, v in jamba.params_np["blocks"][kind].items()}
    r = np.random.default_rng(sum(map(ord, kind)))
    # hidden states sharing a direction, as a model's do (the router leans)
    x = (r.standard_normal((2, s, cfg.d_model)) + r.standard_normal(cfg.d_model))
    x = x.astype(np.float32)
    ct = r.standard_normal(x.shape).astype(np.float32)
    ref_fn, port_fn = _block_fns(cfg, jamba.ref_cfg, s)[kind]
    ry, vjp = jax.vjp(jax.jit(ref_fn), {k: jnp.asarray(v) for k, v in p_np.items()},
                      jnp.asarray(x))
    rgp, rgx = vjp(jnp.asarray(ct))
    p = {k: torch.tensor(v, requires_grad=True) for k, v in p_np.items()}
    xt = torch.tensor(x, requires_grad=True)
    y = port_fn(p, xt)
    grads = torch.autograd.grad(y, [xt, *p.values()], torch.from_numpy(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry), atol=1e-4, rtol=1e-4)
    gaps = {"x": float(np.abs(grads[0].numpy() - np.asarray(rgx)).max())}
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(rgx), atol=1e-4, rtol=1e-4)
    for k, g in zip(p, grads[1:]):
        gaps[k] = float(np.abs(g.numpy() - np.asarray(rgp[k])).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(rgp[k]), atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    print(f"jamba {kind} block vjp gaps: {gaps}")


def test_jamba_whole_model_loss_and_gradients(jamba):
    """Printed, not held (module note); finite, the same leaves."""
    batch = make_batch(jamba.cfg, jamba.r)
    want, want_g = jamba.ref_loss_grads(jamba.ref_params(), batch)
    got, got_g = port_loss_grads(jamba.cfg, jamba.port_state()["params"], batch)
    print(f"jamba reduced: loss gap {abs(got - want):.3g}, largest gradient gap "
          f"{max_gap(got_g, want_g):.3g} (not held: module note)")
    assert np.isfinite(got) and all(np.isfinite(g).all() for g in got_g.values())


@pytest.mark.parametrize("name", NAMES + (JAMBA,))
def test_train_step_decreases_loss(name):
    """The port's counterpart of tests/test_arch_smoke.py's: 4 steps on one
    fixed batch, every loss finite, the last below the first."""
    cfg = get_arch(name).reduced()
    batch = make_batch(cfg, np.random.default_rng(0))
    state = init_train_state(cfg, 0, "cpu")
    step = make_train_step(cfg, donate=False)
    losses = []
    for _ in range(4):
        state, loss = step(state, batch)
        assert np.isfinite(float(loss))
        losses.append(float(loss))
    assert losses[-1] < losses[0]
