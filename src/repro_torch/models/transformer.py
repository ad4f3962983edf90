"""Period-structured transformer LM: one implementation, ten architectures.

The port's copy of ``repro/models/transformer.py``.  Parameters are stacked
on the period axis, ``(n_periods, n_slots, ...)``, as in the reference, and
the period loop is a Python loop.  Block kinds inside a period (attention /
Mamba-2, dense MLP / MoE) are static Python structure.

Entry points:
  * ``init_params``       — materialize parameters on a device from a seed;
  * ``forward``           — prefill forward to logits;
  * ``loss_fn``           — next-token cross-entropy (float32 ``log_softmax``);
  * ``init_train_state``/``make_train_step`` — AdamW over the parameter
    tree, the state updated in place (the reference donates it);
  * ``make_prefill_step`` — (params, batch) -> (last-position logits, cache);
    for an encoder-only configuration, (forward logits, {});
  * ``init_decode_cache``/``make_serve_step`` — single-token decode against
    the KV and SSM caches (sliding-window ring buffer with ``window``), the
    cache updated in place.

Serving (``forward``, prefill, decode) runs under ``torch.inference_mode()``
(``torch.no_grad()`` where the parameters are DTensors, which inference
tensors cannot be)
and reaches the flash-attention kernel by default.  Training differentiates
a forward of its own (``_train_logits``) through the einsum attention path
(``use_kernel=False``, as the reference trains on its XLA path,
``make_train_step(use_pallas=False)``): the kernel has no backward, and on
CUDA ``flash_attention`` raises under grad, so ``use_kernel=True`` there
fails on the first step.  With ``remat`` (the default) each period runs
under ``torch.utils.checkpoint`` and is recomputed in the backward, the
counterpart of the reference's ``jax.checkpoint`` of the scan body; nothing
on the path draws random numbers, so the recomputation equals the first
pass, MoE routing included.

Where training departs from the reference: ``init_train_state`` draws the
moments as float32 zeros, where the reference's are zeros in the
parameters' type until its first update promotes them (the same values);
``make_train_step(donate=True)`` writes the update into the state's own
tensors (``repro_torch.optim.adam_update_``, bit for bit ``adam_update``)
and returns the same dict; the step counter stays a CPU scalar, as in
``adam_init``.

Batch dicts by family: decoder LMs take ``{tokens}`` (training adds
``labels``); the vision model adds ``patch_embeds`` ``[b, frontend_tokens,
frontend_dim]`` (its frontend is a stub: precomputed embeddings through
``frontend_proj``, put before the text; its loss scores text positions
only); the audio model takes ``{frames}`` ``[b, s, frontend_dim]`` and its
loss takes no shift.  Numpy or tensors; they are moved to the parameters'
device (DTensors are taken as they are).

``ParallelCtx`` is the reference's, field for field.  ``forward``,
``loss_fn`` and ``make_prefill_step`` take it as ``pctx=`` and thread it as
the reference does: ``constrain_activations`` pins the residual stream to
``(dp, None, None)`` before every block (a DTensor redistribution; plain
tensors pass on a one-device mesh), ``attn_chunk`` and ``sp_attention``
reach ``attention_block``, ``moe="expert_parallel"`` selects
``moe_block_ep``, ``ssd_chunk`` and ``ssd_bf16`` reach ``mamba_block`` (not
the prefill's Mamba blocks, which the reference runs at its default chunk
in fp32 whatever the context), and ``remat_policy="dots"`` keeps the
reference's ``dots_with_no_batch_dims_saveable``: each period is
checkpointed with a selective policy that saves the outputs of ``aten.mm``
and ``aten.addmm`` (the products with no batch dimension) and recomputes
every other op, ``bmm`` and the einsums with a batch dimension included.
``"full"`` and ``"none"`` recompute everything, as the reference's
``forward`` does under ``remat`` (only ``"dots"`` changes its policy).
``make_train_step`` takes no ``pctx``, as the reference's; a step under one
is ``loss_fn(..., pctx=pctx)``'s value and gradient, then AdamW (the dry
run builds it so).  Under ``init_params(device="meta")`` nothing is drawn:
the leaves are allocated on the meta device (the dry run's abstract state).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import attention_block, attn_params, decode_attention_block
from repro_torch.models.layers import (SHAPE_ONLY, constrain, embed_init, grad_like,
                                      he_init, reduce_partial, rms_norm)
from repro_torch.models.mamba2 import (_causal_conv, _ssd_chunked, decode_mamba_block,
                                       mamba_block, mamba_params)
from repro_torch.models.moe import mlp_block, mlp_params, moe_block, moe_block_ep, moe_params
from repro_torch.optim.adam import AdamConfig, adam_update, adam_update_, tree_map

__all__ = [
    "ParallelCtx",
    "init_params",
    "forward",
    "loss_fn",
    "init_train_state",
    "make_train_step",
    "init_decode_cache",
    "make_serve_step",
    "make_prefill_step",
]


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """Optional explicit-parallelism context (the reference's, field for
    field; see the module note).  ``mesh`` is a ``DeviceMesh`` (or, where
    no collective runs, ``repro_torch.launch.mesh.AbstractMesh``);
    ``moe='expert_parallel'`` switches MoE blocks to ``moe_block_ep``."""

    mesh: object
    dp_axes: tuple
    model_axis: str = "model"
    moe: str = "gspmd"  # gspmd | expert_parallel
    sp_attention: bool = False  # sequence-parallel attention
    attn_chunk: int = 0  # >0: chunked (flash-style) einsum attention
    ssd_chunk: int = 128  # SSD chunk length
    ssd_bf16: bool = False  # mixed-precision SSD
    remat_policy: str = "full"  # full | dots | none
    constrain_activations: bool = False  # pin residual stream to (dp, None, None)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the products with no batch
    dimension, recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _take(blocks: Dict, kind: str, period: int, idx: int) -> Dict:
    return {leaf: a[period, idx] for leaf, a in blocks[kind].items()}


def _slot_rows(cfg: ArchConfig, prefill: bool = False) -> List[Tuple]:
    """Per slot of a period: ``(mixer kind, its stack row, FFN kind or
    None, its stack row)``.  ``forward`` and decode count rows per kind in
    slot order (the reference's ``take``); prefill takes a MoE slot's row
    from ``cfg.moe_slots.index(slot)`` and an MLP slot's from its place
    among the non-MoE slots (the reference's ``make_prefill_step``).  The
    two agree when ``moe_slots`` is ascending, as in every registered
    configuration."""
    seen = {"attn": 0, "mamba": 0, "mlp": 0, "moe": 0}
    non_moe = [t for t in range(cfg.period) if t not in cfg.moe_slots]
    rows = []
    for slot in range(cfg.period):
        mixer = "attn" if slot in cfg.attn_slots else "mamba"
        row = (mixer, seen[mixer])
        seen[mixer] += 1
        if slot in cfg.moe_slots:
            row += ("moe", cfg.moe_slots.index(slot) if prefill else seen["moe"])
            seen["moe"] += 1
        elif cfg.d_ff > 0:
            row += ("mlp", non_moe.index(slot) if prefill else seen["mlp"])
            seen["mlp"] += 1
        else:
            row += (None, None)
        rows.append(row)
    return rows


def _serving(params: Dict):
    """The context a serving step runs in: ``inference_mode``, or
    ``no_grad`` for DTensor parameters (the dry run)."""
    return torch.no_grad() if isinstance(params["head"], DTensor) else torch.inference_mode()


def _device(params: Dict) -> torch.device:
    return params["head"].device


def _tokens(params: Dict, tokens) -> torch.Tensor:
    if isinstance(tokens, DTensor):
        return tokens.to(torch.long)
    return torch.as_tensor(tokens, dtype=torch.long, device=_device(params))


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Dict:
    """Parameters of ``cfg`` in its dtype on ``device`` (``None``: the
    GPU), drawn from one generator seeded with ``seed`` on that device,
    leaf by leaf in the reference's key order (attention, Mamba, MLP, MoE,
    embedding (absent for audio), head, frontend projection).  On
    ``device="meta"`` the leaves are allocated and nothing is drawn."""
    device = resolve_device(device)
    dtype = _dtype(cfg)
    if device.type == "meta":
        gen = SHAPE_ONLY
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    n_attn = len(cfg.attn_slots)
    n_mamba = len(cfg.mamba_slots)
    n_moe = len(cfg.moe_slots)
    n_mlp = (cfg.period - n_moe) if cfg.d_ff > 0 else 0
    P = cfg.n_periods
    blocks: Dict = {}
    if n_attn:
        blocks["attn"] = attn_params(gen, cfg, dtype, (P, n_attn))
    if n_mamba:
        blocks["mamba"] = mamba_params(gen, cfg, dtype, (P, n_mamba))
    if n_mlp:
        blocks["mlp"] = mlp_params(gen, cfg, dtype, (P, n_mlp))
    if n_moe:
        blocks["moe"] = moe_params(gen, cfg, dtype, (P, n_moe))
    params: Dict = {
        "blocks": blocks,
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if cfg.frontend != "audio":
        params["embed"] = embed_init(gen, (cfg.vocab, cfg.d_model), dtype)
    params["head"] = he_init(gen, (cfg.d_model, cfg.vocab), dtype, fan_in=cfg.d_model)
    if cfg.frontend:
        params["frontend_proj"] = he_init(gen, (cfg.frontend_dim, cfg.d_model), dtype,
                                          fan_in=cfg.frontend_dim)
    return params


def _on(a, device) -> torch.Tensor:
    return a if isinstance(a, DTensor) else torch.as_tensor(a, device=device)


def _embed_inputs(cfg: ArchConfig, params: Dict, batch: Dict) -> torch.Tensor:
    dev = _device(params)
    if cfg.frontend == "audio":
        frames = _on(batch["frames"], dev)
        return frames.to(_dtype(cfg)) @ params["frontend_proj"]
    x = reduce_partial(F.embedding(_tokens(params, batch["tokens"]), params["embed"]))
    if cfg.frontend == "vision":
        patches = _on(batch["patch_embeds"], dev)
        x = torch.cat([patches.to(x.dtype) @ params["frontend_proj"], x], dim=1)
    return x


def _mamba_prefill(p: Dict, cfg: ArchConfig, x: torch.Tensor):
    """Mamba block that also returns (conv_state, final ssm state)."""
    b, s, D = x.shape
    di, nh, hp = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    z = h @ p["wz"]
    xproj = h @ p["wx"]
    xin = F.silu(_causal_conv(xproj, p["conv_w"], p["conv_b"]))
    B_ = h @ p["wB"]
    C_ = h @ p["wC"]
    dt = F.softplus((h @ p["wdt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(b, s, nh, hp)
    y, H = _ssd_chunked(xh, dt, A, B_, C_, return_state=True)
    y = y + (p["D_skip"][:, None] * xh.float()).to(y.dtype)
    y = y.reshape(b, s, di)
    y = rms_norm(y, p["gnorm"], cfg.norm_eps) * F.silu(z)
    # fewer than k-1 prompt tokens give a shorter state, as in the reference
    conv_state = xproj[:, -(cfg.ssm_conv - 1):, :]
    return x + reduce_partial(y @ p["wo"]), (conv_state, H)


def _period(cfg: ArchConfig, take, per: int, rows: List[Tuple], x: torch.Tensor,
            positions: torch.Tensor, window: Optional[int], use_kernel: bool,
            cache_out: Optional[Dict] = None,
            pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """One period's blocks over ``x``; ``take(kind, per, row)`` gives a
    block's parameters.  With ``cache_out`` (prefill), each attention
    block's (k, v) is written into ``cache_out["k"/"v"]`` and each Mamba
    block's states into ``cache_out["conv"/"ssm"]``, at ``[per, row]``.
    ``pctx``: see the module note."""
    prefill = cache_out is not None
    for mixer, m, ffn, f in rows:
        if pctx is not None and pctx.constrain_activations:
            # keep the residual stream batch-sharded (the reference's
            # with_sharding_constraint before every block)
            x = constrain(x, pctx.mesh, (pctx.dp_axes, None, None))
        p = take(mixer, per, m)
        if mixer == "attn" and not prefill:
            x = attention_block(p, cfg, x, positions, window=window, use_kernel=use_kernel,
                                pctx=pctx)
        elif mixer == "attn":
            x, (k, v) = attention_block(p, cfg, x, positions, window=window,
                                        use_kernel=use_kernel, return_kv=True, pctx=pctx)
            cache_out["k"][per, m] = k
            cache_out["v"][per, m] = v
        elif not prefill:
            if pctx is None:
                x = mamba_block(p, cfg, x)
            else:
                x = mamba_block(p, cfg, x, chunk=pctx.ssd_chunk,
                                compute_dtype=torch.bfloat16 if pctx.ssd_bf16 else torch.float32)
        else:
            x, (conv, ssm) = _mamba_prefill(p, cfg, x)
            cache_out["conv"][per, m] = conv
            cache_out["ssm"][per, m] = ssm
        if ffn == "moe" and pctx is not None and pctx.moe == "expert_parallel":
            x = moe_block_ep(take(ffn, per, f), cfg, x, pctx.mesh, pctx.dp_axes,
                             pctx.model_axis)
        elif ffn is not None:
            x = (moe_block if ffn == "moe" else mlp_block)(take(ffn, per, f), cfg, x)
    return x


def _layers(cfg: ArchConfig, params: Dict, x: torch.Tensor, positions: torch.Tensor,
            window: Optional[int], use_kernel: bool, cache_out: Optional[Dict] = None,
            pctx: Optional[ParallelCtx] = None):
    """Every period's blocks over ``x`` (see ``_period``)."""
    rows = _slot_rows(cfg, prefill=cache_out is not None)
    take = partial(_take, params["blocks"])
    for per in range(cfg.n_periods):
        x = _period(cfg, take, per, rows, x, positions, window, use_kernel, cache_out, pctx)
    return x


def forward(
    cfg: ArchConfig,
    params: Dict,
    batch: Dict,
    window: Optional[int] = None,
    use_kernel: bool = True,
    pctx: Optional[ParallelCtx] = None,
) -> torch.Tensor:
    """``batch`` (see the module note) -> logits ``[b, s, vocab]``."""
    with _serving(params):
        x = _embed_inputs(cfg, params, batch)
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        x = _layers(cfg, params, x, positions, window, use_kernel, pctx=pctx)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x @ params["head"]


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def _train_logits(cfg: ArchConfig, params: Dict, batch: Dict, window: Optional[int],
                  use_kernel: bool, remat: bool,
                  pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """The forward to logits with grad: ``_embed_inputs`` -> periods (each
    under ``checkpoint`` with ``remat``) -> final norm -> head.  Every stack
    entry of a block leaf reaches its period as a view from one ``unbind``
    of the leaf, so the backward stacks each leaf's gradient once (indexing
    each entry instead builds a zero-filled leaf-sized gradient per entry).
    ``pctx.remat_policy == "dots"`` saves the products with no batch dim."""
    x = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    entries = {kind: {leaf: a.flatten(0, 1).unbind(0) for leaf, a in blk.items()}
               for kind, blk in params["blocks"].items()}
    slots = {kind: next(iter(blk.values())).shape[1] for kind, blk in params["blocks"].items()}

    def take(kind, per, row):
        # a DTensor entry's gradient comes back in the entry's own placements,
        # so that unbind's backward stacks gradients placed alike
        return {leaf: grad_like(views[per * slots[kind] + row])
                for leaf, views in entries[kind].items()}

    rows = _slot_rows(cfg)
    kw = {}
    if pctx is not None and pctx.remat_policy == "dots":
        kw["context_fn"] = partial(create_selective_checkpoint_contexts, _dots_saveable)
    for per in range(cfg.n_periods):
        if remat:
            x = checkpoint(_period, cfg, take, per, rows, x, positions, window, use_kernel,
                           None, pctx, use_reentrant=False, **kw)
        else:
            x = _period(cfg, take, per, rows, x, positions, window, use_kernel, pctx=pctx)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["head"]


def loss_fn(cfg: ArchConfig, params: Dict, batch: Dict, use_kernel: bool = False,
            remat: bool = True, window: Optional[int] = None,
            pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``batch["labels"]``, with
    grad: the vision model scores its text positions only, the audio encoder
    takes no shift, ``log_softmax`` runs in float32."""
    logits = _train_logits(cfg, params, batch, window, use_kernel, remat, pctx)
    labels = _on(batch["labels"], logits.device).to(torch.long)
    if cfg.frontend == "vision":
        logits = logits[:, cfg.frontend_tokens:]  # loss on text positions only
    if cfg.is_decoder and cfg.frontend != "audio":
        logits, labels = logits[:, :-1], labels[:, 1:]  # next-token prediction
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])
    return nll.mean()


def _value_and_grad(cfg: ArchConfig, params: Dict, batch: Dict,
                    **kw) -> Tuple[torch.Tensor, Dict]:
    """``loss_fn`` (keywords passed on) and its gradient at every parameter
    leaf, as ``(loss, tree like params)``; the caller's tensors are left as
    they are (autograd tracks detached aliases of them)."""
    live = []

    def track(t):
        live.append(t.detach().requires_grad_())
        return live[-1]

    tracked = tree_map(track, params)
    with torch.enable_grad():
        loss = loss_fn(cfg, tracked, batch, **kw)
        grads = iter(torch.autograd.grad(loss, live))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def init_train_state(cfg: ArchConfig, seed: int = 0, device=None) -> Dict:
    """``{"params": init_params(cfg, seed, device), "opt": {"m", "v",
    "step"}}``: the moments float32 zeros in the parameters' shapes (see the
    module note), the step an int32 scalar on the CPU."""
    params = init_params(cfg, seed, device)

    def zeros(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)

    return {"params": params, "opt": {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                                      "step": torch.zeros((), dtype=torch.int32)}}


def make_train_step(cfg: ArchConfig, adam_cfg: Optional[AdamConfig] = None,
                    use_kernel: bool = False, donate: bool = True):
    """``step(state, batch) -> (state, loss)``: ``loss_fn`` (remat on) and
    its gradients over every parameter leaf, then AdamW (``adam_cfg``, by
    default lr 3e-4, weight decay 0.01, clip 1.0).  ``donate=True`` writes
    the parameters and moments into the state's tensors and returns the same
    dict; ``donate=False`` returns new trees."""
    adam_cfg = adam_cfg or AdamConfig(lr=3e-4, weight_decay=0.01, grad_clip=1.0)

    def step(state: Dict, batch: Dict) -> Tuple[Dict, torch.Tensor]:
        params = state["params"]
        loss, grads = _value_and_grad(cfg, params, batch, use_kernel=use_kernel)
        if donate:
            adam_update_(adam_cfg, params, grads, state["opt"])
            return state, loss
        params, opt = adam_update(adam_cfg, params, grads, state["opt"])
        return {"params": params, "opt": opt}, loss

    return step


def init_decode_cache(
    cfg: ArchConfig,
    batch_size: int,
    cache_len: int,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> Dict:
    """Allocate the decode cache: ``{"k", "v"}``, each ``(n_periods,
    n_attn, B, cache_len, KV, hd)``, where there is attention, and
    ``{"conv" (n_periods, n_mamba, B, k-1, d_inner), "ssm" (n_periods,
    n_mamba, B, heads, head_dim, state), float32}`` where there is Mamba.
    ``cache_len`` is the KV span: full context for exact attention,
    ``window`` for the sliding-window ring buffer."""
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    P, B = cfg.n_periods, batch_size
    cache: Dict = {}
    n_attn, n_mamba = len(cfg.attn_slots), len(cfg.mamba_slots)
    if n_attn:
        shape = (P, n_attn, B, cache_len, cfg.num_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if n_mamba:
        cache["conv"] = torch.zeros((P, n_mamba, B, cfg.ssm_conv - 1, cfg.d_inner),
                                    dtype=dtype, device=device)
        cache["ssm"] = torch.zeros((P, n_mamba, B, cfg.ssm_heads, cfg.ssm_head_dim,
                                    cfg.ssm_state), dtype=torch.float32, device=device)
    return cache


def make_serve_step(cfg: ArchConfig, window: Optional[int] = None):
    """One-token decode: ``(params, cache, token [B, 1], pos) -> (logits
    [B, 1, vocab], cache)``, the cache updated in place and returned.  An
    encoder-only configuration has no decode step: ``ValueError``."""
    if not cfg.is_decoder:
        raise ValueError(f"{cfg.name} is encoder-only; no decode step (DESIGN.md §4)")
    rows = _slot_rows(cfg)

    def step(params: Dict, cache: Dict, token, pos):
        with _serving(params):
            x = params["embed"][_tokens(params, token)]  # [B, 1, D]
            blocks = params["blocks"]
            for per in range(cfg.n_periods):
                for mixer, m, ffn, f in rows:
                    p = _take(blocks, mixer, per, m)
                    if mixer == "attn":
                        x, _, _ = decode_attention_block(p, cfg, x, cache["k"][per, m],
                                                         cache["v"][per, m], int(pos),
                                                         window=window)
                    else:
                        x, _, _ = decode_mamba_block(p, cfg, x, cache["conv"][per, m],
                                                     cache["ssm"][per, m])
                    if ffn == "moe":
                        x = moe_block(_take(blocks, "moe", per, f), cfg, x)
                    elif ffn == "mlp":
                        x = mlp_block(_take(blocks, "mlp", per, f), cfg, x)
            x = rms_norm(x, params["final_norm"], cfg.norm_eps)
            return x @ params["head"], cache

    return step


def make_prefill_step(cfg: ArchConfig, use_kernel: bool = True,
                      pctx: Optional[ParallelCtx] = None):
    """``(params, batch) -> (last-position logits [b, 1, vocab], decode
    cache)``; the cache holds the prompt's ``s`` positions (with a vision
    frontend, the patches' and then the text's).  Encoder-only: ``(forward
    logits [b, s, vocab], {})``, there being no cache (and, as in the
    reference, no ``pctx``).  ``pctx``: see the module note."""
    if not cfg.is_decoder:
        def enc_step(params: Dict, batch: Dict):
            return forward(cfg, params, batch, use_kernel=use_kernel), {}

        return enc_step

    def step(params: Dict, batch: Dict):
        with _serving(params):
            x = _embed_inputs(cfg, params, batch)
            b, s, _ = x.shape
            positions = torch.arange(s, dtype=torch.int32, device=x.device)
            P, cache = cfg.n_periods, {}
            if cfg.attn_slots:
                shape = (P, len(cfg.attn_slots), b, s, cfg.num_kv_heads, cfg.hd)
                cache["k"], cache["v"] = x.new_empty(shape), x.new_empty(shape)
            if cfg.mamba_slots:
                n = len(cfg.mamba_slots)
                cache["conv"] = x.new_empty((P, n, b, min(s, cfg.ssm_conv - 1), cfg.d_inner))
                cache["ssm"] = x.new_empty((P, n, b, cfg.ssm_heads, cfg.ssm_head_dim,
                                            cfg.ssm_state), dtype=torch.float32)
            x = _layers(cfg, params, x, positions, None, use_kernel, cache_out=cache, pctx=pctx)
            x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
            return x @ params["head"], cache

    return step
