"""granite-moe-1b-a400m — 32-expert top-8 MoE decoder
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab=49155, head_dim=64,
    moe_slots=(0,), moe_experts=32, moe_topk=8, moe_d_ff=512,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
