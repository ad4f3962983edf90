"""mamba2-1.3b — attention-free SSM with SSD (state-space duality)
[arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab=50280,
    period=1, attn_slots=(), moe_slots=(),
    ssm_state=128, ssm_head_dim=64,
    citation="arXiv:2405.21060 (Mamba-2 / SSD)",
))
