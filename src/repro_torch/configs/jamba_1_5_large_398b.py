"""jamba-1.5-large-398b — hybrid Mamba+attention, 1:7 interleave, 16e top-2 MoE
[arXiv:2403.19887].

Period of 8 layers: attention at slot 3, Mamba elsewhere (1:7); MoE replaces
the dense MLP on every other slot (4 of 8), giving 36 MoE layers over 72.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab=65536, head_dim=128,
    period=8, attn_slots=(3,), moe_slots=(1, 3, 5, 7),
    moe_experts=16, moe_topk=2,
    ssm_state=128, ssm_head_dim=128,
    citation="arXiv:2403.19887 (Jamba); 1.5-large scale per model card",
))
