"""The LM workbench (``repro/models`` in the reference): every registered
configuration (dense and MoE decoders, Mamba-2, the Jamba hybrid, the vision
and audio frontends) through prefill and token-by-token decode, with the
flash-attention kernel in every prefill attention layer, and through
training (next-token loss, AdamW with the state updated in place) on the
einsum attention path, as the reference trains."""

from repro_torch.models.transformer import (
    forward,
    init_decode_cache,
    init_params,
    init_train_state,
    loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

__all__ = [
    "forward",
    "init_decode_cache",
    "init_params",
    "init_train_state",
    "loss_fn",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
]
