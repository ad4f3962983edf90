"""qwen3-moe-30b-a3b — 128-expert top-8 MoE decoder [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab=151936, head_dim=128,
    moe_slots=(0,), moe_experts=128, moe_topk=8, moe_d_ff=768,
    citation="hf:Qwen/Qwen3-30B-A3B",
))
