"""chatglm3-6b — dense GQA decoder with 2d (half-dim) RoPE [arXiv:2406.12793]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab=65024, head_dim=128,
    rope_fraction=0.5, qkv_bias=True, rope_theta=10_000.0,
    citation="arXiv:2406.12793 (ChatGLM family); GLM 2d-RoPE",
))
