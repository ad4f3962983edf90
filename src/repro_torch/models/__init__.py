"""The LM workbench's dense decoders (``repro/models`` in the reference):
prefill and token-by-token decode, with the flash-attention kernel in
every prefill attention layer."""

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
