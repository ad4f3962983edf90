"""LM training in the PyTorch/CUDA port against the JAX reference, on the CPU:
the dense decoders (llama3.2-3b, qwen2-1.5b, yi-6b, chatglm3-6b), the
in-place AdamW step, the schedules, the token pipeline and the CLI.  The
MoE, Mamba-2, hybrid, vision and audio configurations are in
``tests/test_torch_lm_train_families.py``.

Each configuration at its ``reduced()`` size in fp32, from the reference's
weights (``tests/_lm_train.py``), on numpy batches of 2 x 64:

  * ``loss_fn`` and its gradients: loss within 1e-4, every gradient leaf
    within atol 1e-4;
  * 3 steps of ``make_train_step`` (donated) against the reference's: the
    losses within 1e-4; a step at a time from the reference's state, the
    parameters within 1e-4 and the moments within 1e-5, except where a
    gradient lies within 8 x eps of zero (``hold_with_exemption``);
  * the donated step bit for bit the functional one; ``remat`` on and off
    within 1e-6; the state's keys and types after a step the reference's.

Measured gaps (pytest -s prints them): loss and gradients at most 9.5e-7
and 8.8e-7; parameters a step at a time at most 9.6e-6, moments 8.0e-9.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticCorpus as RefCorpus
from repro.data import TokenPipeline as RefPipeline
from repro.models import init_train_state as ref_init_train_state
from repro.models import make_train_step as ref_make_train_step
from repro.optim.schedule import cosine_schedule as ref_cosine
from repro.optim.schedule import linear_warmup as ref_warmup
from _lm_train import (Pair, flat, hold_with_exemption, jax_batch, make_batch, max_gap,
                       port_loss_grads, train_side_by_side)
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticCorpus, TokenPipeline
from repro_torch.device import NoGPUError
from repro_torch.launch import train_lm
from repro_torch.models import init_train_state, make_train_step
from repro_torch.optim import AdamConfig, adam_update, adam_update_, cosine_schedule, linear_warmup
from repro_torch.optim import adam as adam_mod
from repro_torch.optim.adam import tree_map

DENSE = ("llama3.2-3b", "qwen2-1.5b", "yi-6b", "chatglm3-6b")
LR = 3e-4  # make_train_step's default AdamConfig


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the reduced models' tensors are small, and the
    suite's workers share the cores (many threads each only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    return Pair(request.param)


def test_loss_and_gradients_match_reference(pair):
    batch = make_batch(pair.cfg, pair.r)
    want, want_g = pair.ref_loss_grads(pair.ref_params(), batch)
    got, got_g = port_loss_grads(pair.cfg, pair.port_state()["params"], batch)
    print(f"{pair.name}: loss gap {abs(got - want):.3g}, largest gradient gap "
          f"{max_gap(got_g, want_g):.3g}")  # read with pytest -s
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


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def test_donated_step_updates_in_place_bitwise_as_adam_update(monkeypatch):
    """``donate=True`` writes the update into the state's own tensors and
    returns the same dict; given the step's gradients, every bit equals
    ``adam_update``'s new trees from the state before the step.  The
    functional step (``donate=False``) follows the same losses within 1e-6:
    its gradients may differ from the donated run's in the last bit, because
    MKL's products depend on where their operands lie in memory."""
    import repro_torch.models.transformer as transformer

    cfg = get_arch("llama3.2-3b").reduced()
    donated = init_train_state(cfg, 3, "cpu")
    functional = {"params": _clone(donated["params"]), "opt": _clone(donated["opt"])}
    seen = []

    def update_(adam_cfg, params, grads, opt):
        before = (_clone(params), _clone(opt))
        out = adam_update_(adam_cfg, params, grads, opt)
        seen.append((adam_update(adam_cfg, *before[:1], grads, before[1]), out))
        return out

    monkeypatch.setattr(transformer, "adam_update_", update_)

    def buffers(state):  # every tensor but the step counter, a CPU scalar
        return adam_mod.tree_leaves([state["params"], state["opt"]["m"], state["opt"]["v"]])

    ptrs = [t.data_ptr() for t in buffers(donated)]
    step_d, step_f = make_train_step(cfg), make_train_step(cfg, donate=False)
    r = np.random.default_rng(5)
    for k in range(3):
        batch = make_batch(cfg, r)
        out, loss_d = step_d(donated, batch)
        assert out is donated
        functional, loss_f = step_f(functional, batch)
        assert abs(float(loss_d) - float(loss_f)) <= 1e-6
        (want_p, want_opt), (got_p, got_opt) = seen[k]
        assert got_p is donated["params"] and got_opt is donated["opt"]
        for a, b in zip(adam_mod.tree_leaves([got_p, got_opt]),
                        adam_mod.tree_leaves([want_p, want_opt])):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert [t.data_ptr() for t in buffers(donated)] == ptrs
    assert int(donated["opt"]["step"]) == 3
    assert not any(t.requires_grad for t in buffers(donated))


@pytest.mark.parametrize("clip,decay,lr_scale", [(0.0, 0.0, 1.0), (1.0, 0.01, 1.0),
                                                 (0.05, 0.1, "tensor")])
def test_in_place_adam_is_bitwise_adam_update(monkeypatch, clip, decay, lr_scale):
    """Leaves of every rank (a scalar too), bf16 and fp32 parameters,
    gradients given as strided views, each leaf updated a slice at a time
    (UPDATE_SLICE shrunk so that every leaf with more than one row is cut):
    bit for bit ``adam_update``.  bf16 moments are refused."""
    monkeypatch.setattr(adam_mod, "UPDATE_SLICE", 7)
    r = np.random.default_rng(int(clip * 100 + decay * 1000))
    shapes = {"a": (5, 3, 4), "b": (13,), "c": (), "d": (6, 2)}
    dtypes = {"a": torch.bfloat16, "b": torch.float32, "c": torch.float32, "d": torch.bfloat16}
    params = {k: torch.tensor(r.standard_normal(s), dtype=torch.float32).to(dtypes[k])
              for k, s in shapes.items()}
    state = {"m": {k: torch.zeros(s) for k, s in shapes.items()},
             "v": {k: torch.zeros(s) for k, s in shapes.items()},
             "step": torch.zeros((), dtype=torch.int32)}
    cfg = AdamConfig(lr=5e-3, grad_clip=clip, weight_decay=decay)
    scale = torch.tensor(0.7) if lr_scale == "tensor" else lr_scale
    new_p, new_s = _clone(params), _clone(state)
    for _ in range(3):
        grads = {k: torch.tensor(r.standard_normal(s[::-1] if len(s) > 1 else s),
                                 dtype=torch.float32).to(dtypes[k]) for k, s in shapes.items()}
        grads = {k: g.permute(tuple(reversed(range(g.dim())))) for k, g in grads.items()}  # strided
        want_p, want_s = adam_update(cfg, new_p, grads, new_s, lr_scale=scale)
        got_p, got_s = adam_update_(cfg, params, grads, state, lr_scale=scale)
        assert got_p is params and got_s is state
        for k in shapes:
            for a, b in ((params[k], want_p[k]), (state["m"][k], want_s["m"][k]),
                         (state["v"][k], want_s["v"][k])):
                assert a.dtype == b.dtype and torch.equal(a, b), k
        assert torch.equal(state["step"], want_s["step"])
        new_p, new_s = want_p, want_s
    bf16 = {"m": {"b": torch.zeros(13, dtype=torch.bfloat16)},
            "v": {"b": torch.zeros(13, dtype=torch.bfloat16)},
            "step": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(ValueError, match="float32 moments"):
        adam_update_(cfg, {"b": params["b"]}, {"b": params["b"]}, bf16)


@pytest.mark.parametrize("name", ["llama3.2-3b", "granite-moe-1b-a400m", "mamba2-1.3b"])
def test_remat_on_and_off_agree(name):
    """Remat recomputes each period in the backward; the loss and every
    gradient equal the stored pass's within 1e-6 (MoE routing included)."""
    cfg = get_arch(name).reduced()
    params = init_train_state(cfg, 1, "cpu")["params"]
    batch = make_batch(cfg, np.random.default_rng(2))
    on, g_on = port_loss_grads(cfg, params, batch, remat=True)
    off, g_off = port_loss_grads(cfg, params, batch, remat=False)
    assert abs(on - off) <= 1e-6
    assert max_gap(g_on, g_off) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_keys_and_types_after_a_step_match_reference(dtype):
    """After one step: the reference's tree, leaf for leaf, in its types
    (bf16 parameters, float32 moments, an int32 step counter of 1)."""
    ref_cfg = dataclasses.replace(Pair("llama3.2-3b").ref_cfg, dtype=dtype)
    cfg = dataclasses.replace(get_arch("llama3.2-3b").reduced(), dtype=dtype)
    batch = make_batch(cfg, np.random.default_rng(0))
    ref_state, _ = ref_make_train_step(ref_cfg, donate=False)(
        ref_init_train_state(ref_cfg, jax.random.PRNGKey(0)), jax_batch(batch))
    state, loss = make_train_step(cfg)(init_train_state(cfg, 0, "cpu"), batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    got = _dtypes({"params": state["params"], "m": state["opt"]["m"], "v": state["opt"]["v"]})
    want = _dtypes({"params": ref_state["params"], "m": ref_state["opt"]["m"],
                    "v": ref_state["opt"]["v"]})
    assert got == want
    assert state["opt"]["step"].dtype == torch.int32 and int(state["opt"]["step"]) == 1
    assert str(ref_state["opt"]["step"].dtype) == "int32" and int(ref_state["opt"]["step"]) == 1


def _dtypes(tree, prefix=""):
    """``{path: (shape, type name)}`` of a tree of torch or jax arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dtypes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("warmup,total", [(0, 1), (10, 100), (25, 40), (7, 7)])
def test_schedules_match_reference(warmup, total):
    steps = np.arange(-2, total + 12)
    for s in steps:
        np.testing.assert_array_equal(linear_warmup(int(s), warmup).numpy(),
                                      np.asarray(ref_warmup(int(s), warmup)))
        got = cosine_schedule(torch.tensor(s, dtype=torch.int32), total, warmup, 0.2)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_cosine(jnp.asarray(s), total,
                                                                      warmup, 0.2)),
                                   rtol=1e-6, atol=0)


def test_corpus_sequences_match_reference():
    for kw in (dict(vocab=1000, seq_len=32, num_shards=4, seed=7), dict(vocab=50, seq_len=5)):
        ref, port = RefCorpus(**kw), SyntheticCorpus(**kw)
        for shard, i in ((0, 0), (1, 5), (3, 1000)):
            a, b = port.sequence(shard, i), ref.sequence(shard, i)
            assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
        got, want = port.batch(2, 3, 4), ref.batch(2, 3, 4)
        for k in ("tokens", "labels"):
            assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("hosts", [1, 2])
def test_token_pipeline_batches_match_reference(hosts):
    corpus = dict(vocab=512, seq_len=16, num_shards=5)
    pipes = []
    try:
        for h in range(hosts):
            pipes.append((TokenPipeline(SyntheticCorpus(**corpus), 6, host_id=h, num_hosts=hosts),
                          RefPipeline(RefCorpus(**corpus), 6, host_id=h, num_hosts=hosts)))
        for _ in range(3):
            for port, ref in pipes:
                got, want = next(port), next(ref)
                assert sorted(got) == sorted(want)
                for k in want:
                    assert np.array_equal(got[k], want[k])
                assert got["tokens"].shape == (6 // hosts, 16)
    finally:
        for port, ref in pipes:
            port.close()
            ref.close()
    with pytest.raises(ValueError):
        TokenPipeline(SyntheticCorpus(**corpus), 5, num_hosts=2)


def test_token_pipeline_place_fn_and_close():
    """``place_fn`` maps each batch; ``close()`` joins the producer, is
    idempotent, and ``__next__`` after it raises instead of hanging."""
    corpus = SyntheticCorpus(vocab=64, seq_len=8, num_shards=2)
    pipe = TokenPipeline(corpus, 2, place_fn=train_lm.pinned_place(torch.device("cpu")))
    batch = next(pipe)
    assert all(isinstance(v, torch.Tensor) for v in batch.values())
    want = np.concatenate([corpus.batch(0, 0, 1)["tokens"], corpus.batch(1, 0, 1)["tokens"]])
    assert np.array_equal(batch["tokens"].numpy(), want)
    pipe.close()
    pipe.close()
    assert not pipe._prefetcher._thread.is_alive()
    with pytest.raises(RuntimeError):
        next(pipe)


@pytest.mark.parametrize("name", DENSE)
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
        assert math.isfinite(float(loss))
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_pipeline_feeds_training():
    """The port's counterpart of tests/test_data_pipeline.py's."""
    cfg = get_arch("qwen2-1.5b").reduced()
    pipe = TokenPipeline(SyntheticCorpus(vocab=cfg.vocab, seq_len=32, num_shards=2), 2,
                         place_fn=train_lm.pinned_place(torch.device("cpu")))
    try:
        state, step = init_train_state(cfg, 0, "cpu"), make_train_step(cfg)
        for _ in range(2):
            state, loss = step(state, next(pipe))
            assert math.isfinite(float(loss))
    finally:
        pipe.close()


def test_train_lm_cli_runs_on_the_cpu(capsys):
    losses = train_lm.main(["--device", "cpu", "--steps", "4", "--batch", "2", "--seq-len", "32"])
    out = capsys.readouterr().out
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    assert "llama3.2-3b-reduced" in out and ("improving" in out or "flat" in out)
    with pytest.raises(SystemExit, match="text decoder"):
        train_lm.main(["--device", "cpu", "--arch", "llava-next-34b"])


def test_train_lm_cli_needs_a_gpu_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoGPUError):
        train_lm.main(["--steps", "1"])
    with pytest.raises(NoGPUError):
        init_train_state(get_arch("llama3.2-3b").reduced())
