"""yi-6b — llama-architecture dense decoder with GQA kv=4 [arXiv:2403.04652]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab=64000, head_dim=128,
    rope_theta=5_000_000.0,
    citation="arXiv:2403.04652 (Yi: Open Foundation Models)",
))
