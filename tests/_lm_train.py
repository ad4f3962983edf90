"""Shared pieces of the LM training tests (``tests/test_torch_lm_train*.py``):
the reference's and the port's states from one numpy parameter tree, their
losses and gradients on one batch, and their train steps side by side.

Parameters come from the reference's ``init_params`` with every leaf its
initializer sets to a constant perturbed (the scales around 1, the biases
and ``A_log`` around 0), as in ``tests/test_torch_lm_families.py``; batches
are numpy, made from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs.all_archs  # noqa: F401
from repro.configs.base import ARCHS as REF_ARCHS
from repro.models import init_params as ref_init_params
from repro.models import loss_fn as ref_loss_fn
from repro.models import make_train_step as ref_make_train_step
from repro.optim.adam import adam_init as ref_adam_init
import repro_torch.configs.all_archs  # noqa: F401
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_reference
import repro_torch.models.transformer as transformer
from repro_torch.models import init_train_state, make_train_step

B, S = 2, 64
CONSTANT_LEAVES = ("norm", "gnorm", "final_norm", "conv_b", "dt_bias", "A_log", "D_skip")
NEAR_ZERO = 8e-8  # 8 x Adam's eps: tests/test_torch_train.py's exemption


def perturb(tree, r):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, r)
        elif k in ("bq", "bk", "bv", "conv_b", "dt_bias", "A_log"):
            out[k] = (r.standard_normal(v.shape) * 0.1).astype(v.dtype)
        elif k in CONSTANT_LEAVES:
            out[k] = (1.0 + r.standard_normal(v.shape) * 0.1).astype(v.dtype)
        else:
            out[k] = v
    return out


def flat(tree, prefix=""):
    """``{"a/b/c": leaf}`` of a nest of dicts, leaves as numpy."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v.detach().cpu().numpy()
        else:
            out[prefix + k] = np.asarray(v)
    return out


def make_batch(cfg, r, b=B, s=S):
    """numpy training inputs of ``b`` x ``s`` positions (the vision model's
    ``s`` holds its patches; the audio model takes frames)."""
    if cfg.frontend == "audio":
        return {"frames": r.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32),
                "labels": r.integers(0, cfg.vocab, (b, s))}
    n = s - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    batch = {"tokens": r.integers(0, cfg.vocab, (b, n)), "labels": r.integers(0, cfg.vocab, (b, n))}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = r.standard_normal(
            (b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


class Pair:
    """One reduced configuration on both sides, from the same weights."""

    def __init__(self, name):
        self.name = name
        self.ref_cfg = REF_ARCHS[name].reduced()
        self.cfg = get_arch(name).reduced()
        self.r = np.random.default_rng(sum(map(ord, name)))
        self.params_np = perturb(jax.tree.map(np.asarray, ref_init_params(
            self.ref_cfg, jax.random.PRNGKey(0))), self.r)
        self._ref_grad = jax.jit(jax.value_and_grad(
            lambda p, b: ref_loss_fn(self.ref_cfg, p, b)))

    def ref_params(self):
        return jax.tree.map(jnp.asarray, self.params_np)

    def port_state(self):
        """``init_train_state``'s tree holding the reference's weights."""
        state = init_train_state(self.cfg, 0, "cpu")
        state["params"] = lm_params_from_reference(self.params_np, "cpu")
        return state

    def ref_loss_grads(self, params, batch):
        loss, grads = self._ref_grad(params, jax_batch(batch))
        return float(loss), flat(grads)


def port_loss_grads(cfg, params, batch, **kw):
    """``loss_fn`` and its gradient at every leaf, as ``(float, flat dict)``."""
    loss, grads = transformer._value_and_grad(cfg, params, batch, **kw)
    return float(loss), flat(grads)


def max_gap(a: dict, b: dict) -> float:
    assert sorted(a) == sorted(b)
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def port_state_of(ref_state):
    """The port's copy of a reference train state."""
    conv = lambda tree: lm_params_from_reference(jax.tree.map(np.asarray, tree), "cpu")
    opt = ref_state["opt"]
    return {"params": conv(ref_state["params"]),
            "opt": {"m": conv(opt["m"]), "v": conv(opt["v"]),
                    "step": torch.tensor(int(opt["step"]), dtype=torch.int32)}}


def train_side_by_side(pair, steps=3):
    """``steps`` train steps of the reference (jitted, not donated) and of the
    port (donated), each on its own fresh batch, run twice: free (each side
    from its own last state: the losses) and in lockstep (the port from a copy
    of the reference's state before each step: one step's parameters and
    moments at a time, with the gradients both sides take there).  Adam turns
    a near-zero gradient's rounding into an update difference of up to 2 lr
    (``hold_with_exemption``), and such a difference moves every later
    gradient, so parameters are held a step at a time.  Returns ``(ref
    losses, free port losses, [(ref state, port state, (port grads, ref
    grads))] a step)``."""
    ref_state = {"params": pair.ref_params()}
    ref_state["opt"] = ref_adam_init(ref_state["params"])
    free = pair.port_state()
    ref_step = ref_make_train_step(pair.ref_cfg, donate=False)
    step = make_train_step(pair.cfg)
    ref_losses, losses, per_step = [], [], []
    for _ in range(steps):
        batch = make_batch(pair.cfg, pair.r)
        state = port_state_of(ref_state)
        grads = (port_loss_grads(pair.cfg, state["params"], batch)[1],
                 pair.ref_loss_grads(ref_state["params"], batch)[1])
        ref_state, ref_loss = ref_step(ref_state, jax_batch(batch))
        state, _ = step(state, batch)
        free, loss = step(free, batch)
        ref_losses.append(float(ref_loss))
        losses.append(float(loss))
        per_step.append((ref_state, state, grads))
    return ref_losses, losses, per_step


def hold_with_exemption(got: dict, want: dict, grads, lr: float, atol: float, what: str):
    """Every entry within ``atol``, except entries whose two gradients
    differed at a step where either lay within NEAR_ZERO of zero: Adam
    divides by ``sqrt(v) + eps``, so there fp32 rounding of the gradient
    becomes an update difference of up to ``2 lr`` a step
    (``tests/test_torch_train.py``'s rule); those are held to ``2 lr`` a
    step.  Returns (the largest gap held to ``atol``, the number exempt)."""
    worst, n_exempt = 0.0, 0
    for path, w in want.items():
        exempt = np.zeros(w.shape, dtype=bool)
        for g_port, g_ref in grads:
            gp, gr = g_port[path], g_ref[path]
            exempt |= (np.minimum(np.abs(gp), np.abs(gr)) <= NEAR_ZERO) & (gp != gr)
        diff = np.abs(got[path].astype(np.float64) - w.astype(np.float64))
        held = diff[~exempt]
        if held.size:
            worst = max(worst, float(held.max()))
            assert held.max() <= atol, f"{what} {path}: {held.max():.3g} > {atol}"
        assert diff.max() <= 2 * lr * len(grads), f"{what} {path}: exempt {diff.max():.3g}"
        n_exempt += int(exempt.sum())
    return worst, n_exempt
