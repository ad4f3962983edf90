"""qwen2-1.5b — dense GQA decoder with QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab=151936, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0,
    citation="arXiv:2407.10671 (Qwen2 technical report)",
))
