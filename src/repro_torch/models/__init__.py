"""The LM workbench's serving path (``repro/models`` in the reference): every
registered configuration (dense and MoE decoders, Mamba-2, the Jamba
hybrid, the vision and audio frontends) through prefill and token-by-token
decode, with the flash-attention kernel in every prefill attention layer.
Training waits for a later slice (ROADMAP.md §A.3)."""

from repro_torch.models.transformer import (
    forward,
    init_decode_cache,
    init_params,
    make_prefill_step,
    make_serve_step,
)

__all__ = [
    "forward",
    "init_decode_cache",
    "init_params",
    "make_prefill_step",
    "make_serve_step",
]
