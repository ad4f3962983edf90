"""Period-structured transformer LM, the dense decoders' serving path.

The port's copy of ``repro/models/transformer.py`` for the dense decoders
(llama3.2-3b, qwen2-1.5b, yi-6b, chatglm3-6b): parameters are stacked on
the period axis, ``(n_periods, n_slots, ...)``, as in the reference, and
the period loop is a Python loop.  Each entry point returns or is a plain
callable over a dict of tensors that runs under ``torch.inference_mode()``.

Entry points:
  * ``init_params``       — materialize parameters on a device from a seed;
  * ``forward``           — prefill forward to logits;
  * ``make_prefill_step`` — (params, batch) -> (last-position logits, cache);
  * ``init_decode_cache``/``make_serve_step`` — single-token decode against
    the KV cache (sliding-window ring buffer with ``window``), the cache
    updated in place.

Configurations with Mamba-2 or MoE slots, or a modality frontend, raise
``NotImplementedError``: they wait for a later slice of the port, as does
training the LM (ROADMAP.md §1).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import attention_block, attn_params, decode_attention_block
from repro_torch.models.layers import embed_init, he_init, rms_norm
from repro_torch.models.moe import mlp_block, mlp_params

__all__ = [
    "init_params",
    "forward",
    "init_decode_cache",
    "make_serve_step",
    "make_prefill_step",
]


def _check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not run."""
    missing = []
    if cfg.mamba_slots:
        missing.append("Mamba-2 blocks")
    if cfg.moe_slots:
        missing.append("MoE blocks")
    if cfg.frontend:
        missing.append(f"the {cfg.frontend} frontend")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet; the port runs the dense "
            "decoders (ROADMAP.md §1: the rest of the LM workbench)")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _take(blocks: Dict, kind: str, period: int, idx: int) -> Dict:
    return {leaf: a[period, idx] for leaf, a in blocks[kind].items()}


def _tokens(params: Dict, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.long, device=params["embed"].device)


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Dict:
    """Parameters of ``cfg`` in its dtype on ``device`` (``None``: the
    GPU), drawn from one generator seeded with ``seed`` on that device,
    leaf by leaf in a fixed order (attention, MLP, embedding, head)."""
    _check_supported(cfg)
    device = resolve_device(device)
    dtype = _dtype(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n_attn = len(cfg.attn_slots)
    n_mlp = cfg.period if cfg.d_ff > 0 else 0
    blocks: Dict = {}
    if n_attn:
        blocks["attn"] = attn_params(gen, cfg, dtype, (cfg.n_periods, n_attn))
    if n_mlp:
        blocks["mlp"] = mlp_params(gen, cfg, dtype, (cfg.n_periods, n_mlp))
    return {
        "blocks": blocks,
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dtype),
        "head": he_init(gen, (cfg.d_model, cfg.vocab), dtype, fan_in=cfg.d_model),
    }


def _layers(cfg: ArchConfig, params: Dict, x: torch.Tensor, positions: torch.Tensor,
            window: Optional[int], use_kernel: bool, kv_out: Optional[Dict] = None):
    """Every period's blocks over ``x``; with ``kv_out``, each attention
    block's (k, v) is written into ``kv_out["k"/"v"][period, slot]``."""
    blocks = params["blocks"]
    for per in range(cfg.n_periods):
        for slot in range(cfg.period):
            a = cfg.attn_slots.index(slot)
            p = _take(blocks, "attn", per, a)
            if kv_out is None:
                x = attention_block(p, cfg, x, positions, window=window, use_kernel=use_kernel)
            else:
                x, (k, v) = attention_block(p, cfg, x, positions, window=window,
                                            use_kernel=use_kernel, return_kv=True)
                kv_out["k"][per, a] = k
                kv_out["v"][per, a] = v
            if cfg.d_ff > 0:
                x = mlp_block(_take(blocks, "mlp", per, slot), cfg, x)
    return x


def forward(
    cfg: ArchConfig,
    params: Dict,
    batch: Dict,
    window: Optional[int] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """``batch["tokens"]`` ``[b, s]`` -> logits ``[b, s, vocab]``."""
    _check_supported(cfg)
    with torch.inference_mode():
        x = params["embed"][_tokens(params, batch["tokens"])]
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
    """Allocate the decode cache ``{"k", "v"}``, each ``(n_periods,
    n_attn, B, cache_len, KV, hd)``.  ``cache_len`` is the KV span: full
    context for exact attention, ``window`` for the sliding-window ring
    buffer."""
    _check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    shape = (cfg.n_periods, len(cfg.attn_slots), batch_size, cache_len, cfg.num_kv_heads,
             cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def make_serve_step(cfg: ArchConfig, window: Optional[int] = None):
    """One-token decode: ``(params, cache, token [B, 1], pos) -> (logits
    [B, 1, vocab], cache)``, the cache updated in place and returned."""
    _check_supported(cfg)

    def step(params: Dict, cache: Dict, token, pos):
        with torch.inference_mode():
            x = params["embed"][_tokens(params, token)]  # [B, 1, D]
            blocks = params["blocks"]
            for per in range(cfg.n_periods):
                for slot in range(cfg.period):
                    a = cfg.attn_slots.index(slot)
                    x, _, _ = decode_attention_block(
                        _take(blocks, "attn", per, a), cfg, x, cache["k"][per, a],
                        cache["v"][per, a], int(pos), window=window)
                    if cfg.d_ff > 0:
                        x = mlp_block(_take(blocks, "mlp", per, slot), cfg, x)
            x = rms_norm(x, params["final_norm"], cfg.norm_eps)
            return x @ params["head"], cache

    return step


def make_prefill_step(cfg: ArchConfig, use_kernel: bool = True):
    """``(params, batch) -> (last-position logits [b, 1, vocab], decode
    cache)``; the cache holds the prompt's ``s`` positions."""
    _check_supported(cfg)

    def step(params: Dict, batch: Dict):
        with torch.inference_mode():
            x = params["embed"][_tokens(params, batch["tokens"])]
            b, s, _ = x.shape
            positions = torch.arange(s, dtype=torch.int32, device=x.device)
            shape = (cfg.n_periods, len(cfg.attn_slots), b, s, cfg.num_kv_heads, cfg.hd)
            cache = {"k": x.new_empty(shape), "v": x.new_empty(shape)}
            x = _layers(cfg, params, x, positions, None, use_kernel, kv_out=cache)
            x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
            return x @ params["head"], cache

    return step
