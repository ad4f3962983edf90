"""Period-structured transformer LM: one implementation, ten architectures.

The port's copy of the serving half of ``repro/models/transformer.py``.
Parameters are stacked on the period axis, ``(n_periods, n_slots, ...)``, as
in the reference, and the period loop is a Python loop.  Block kinds inside
a period (attention / Mamba-2, dense MLP / MoE) are static Python
structure.  Each entry point returns or is a plain callable over a dict of
tensors that runs under ``torch.inference_mode()``.

Entry points:
  * ``init_params``       — materialize parameters on a device from a seed;
  * ``forward``           — prefill forward to logits;
  * ``make_prefill_step`` — (params, batch) -> (last-position logits, cache);
    for an encoder-only configuration, (forward logits, {});
  * ``init_decode_cache``/``make_serve_step`` — single-token decode against
    the KV and SSM caches (sliding-window ring buffer with ``window``), the
    cache updated in place.

Batch dicts by family: decoder LMs take ``{tokens}``; the vision model adds
``patch_embeds`` ``[b, frontend_tokens, frontend_dim]`` (its frontend is a
stub: precomputed embeddings through ``frontend_proj``, put before the
text); the audio model takes ``{frames}`` ``[b, s, frontend_dim]``.  LM
training (``loss_fn``, ``init_train_state``, ``make_train_step``) waits for
a later slice (ROADMAP.md §A.3), as does ``ParallelCtx`` (§A.5).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import attention_block, attn_params, decode_attention_block
from repro_torch.models.layers import embed_init, he_init, rms_norm
from repro_torch.models.mamba2 import (_causal_conv, _ssd_chunked, decode_mamba_block,
                                       mamba_block, mamba_params)
from repro_torch.models.moe import mlp_block, mlp_params, moe_block, moe_params

__all__ = [
    "init_params",
    "forward",
    "init_decode_cache",
    "make_serve_step",
    "make_prefill_step",
]


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


def _device(params: Dict) -> torch.device:
    return params["head"].device


def _tokens(params: Dict, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.long, device=_device(params))


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Dict:
    """Parameters of ``cfg`` in its dtype on ``device`` (``None``: the
    GPU), drawn from one generator seeded with ``seed`` on that device,
    leaf by leaf in the reference's key order (attention, Mamba, MLP, MoE,
    embedding (absent for audio), head, frontend projection)."""
    device = resolve_device(device)
    dtype = _dtype(cfg)
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


def _embed_inputs(cfg: ArchConfig, params: Dict, batch: Dict) -> torch.Tensor:
    dev = _device(params)
    if cfg.frontend == "audio":
        frames = torch.as_tensor(batch["frames"], device=dev)
        return frames.to(_dtype(cfg)) @ params["frontend_proj"]
    x = params["embed"][_tokens(params, batch["tokens"])]
    if cfg.frontend == "vision":
        patches = torch.as_tensor(batch["patch_embeds"], device=dev)
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
    return x + y @ p["wo"], (conv_state, H)


def _layers(cfg: ArchConfig, params: Dict, x: torch.Tensor, positions: torch.Tensor,
            window: Optional[int], use_kernel: bool, cache_out: Optional[Dict] = None):
    """Every period's blocks over ``x``.  With ``cache_out`` (prefill),
    each attention block's (k, v) is written into ``cache_out["k"/"v"]``
    and each Mamba block's states into ``cache_out["conv"/"ssm"]``, at
    ``[period, row]``."""
    blocks = params["blocks"]
    prefill = cache_out is not None
    rows = _slot_rows(cfg, prefill=prefill)
    for per in range(cfg.n_periods):
        for mixer, m, ffn, f in rows:
            p = _take(blocks, mixer, per, m)
            if mixer == "attn" and not prefill:
                x = attention_block(p, cfg, x, positions, window=window, use_kernel=use_kernel)
            elif mixer == "attn":
                x, (k, v) = attention_block(p, cfg, x, positions, window=window,
                                            use_kernel=use_kernel, return_kv=True)
                cache_out["k"][per, m] = k
                cache_out["v"][per, m] = v
            elif not prefill:
                x = mamba_block(p, cfg, x)
            else:
                x, (conv, ssm) = _mamba_prefill(p, cfg, x)
                cache_out["conv"][per, m] = conv
                cache_out["ssm"][per, m] = ssm
            if ffn == "moe":
                x = moe_block(_take(blocks, "moe", per, f), cfg, x)
            elif ffn == "mlp":
                x = mlp_block(_take(blocks, "mlp", per, f), cfg, x)
    return x


def forward(
    cfg: ArchConfig,
    params: Dict,
    batch: Dict,
    window: Optional[int] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """``batch`` (see the module note) -> logits ``[b, s, vocab]``."""
    with torch.inference_mode():
        x = _embed_inputs(cfg, params, batch)
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        x = _layers(cfg, params, x, positions, window, use_kernel)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x @ params["head"]


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
        with torch.inference_mode():
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


def make_prefill_step(cfg: ArchConfig, use_kernel: bool = True):
    """``(params, batch) -> (last-position logits [b, 1, vocab], decode
    cache)``; the cache holds the prompt's ``s`` positions (with a vision
    frontend, the patches' and then the text's).  Encoder-only: ``(forward
    logits [b, s, vocab], {})``, there being no cache."""
    if not cfg.is_decoder:
        def enc_step(params: Dict, batch: Dict):
            return forward(cfg, params, batch, use_kernel=use_kernel), {}

        return enc_step

    def step(params: Dict, batch: Dict):
        with torch.inference_mode():
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
            x = _layers(cfg, params, x, positions, None, use_kernel, cache_out=cache)
            x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
            return x @ params["head"], cache

    return step
