"""llava-next-34b — VLM decoder backbone with anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

The vision tower + projector are a STUB per the assignment brief:
``input_specs`` provides precomputed patch embeddings (anyres tiles folded
into the token axis); this config is the language decoder that consumes them.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128,
    frontend="vision", frontend_dim=1152, frontend_tokens=576,
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf (LLaVA-NeXT anyres)",
))
