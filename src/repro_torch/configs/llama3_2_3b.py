"""llama3.2-3b — small Llama-3 dense decoder [hf:meta-llama/Llama-3.2-1B]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab=128256, head_dim=128,
    rope_theta=500_000.0,
    citation="hf:meta-llama/Llama-3.2-1B (Llama-3.2 family card)",
))
