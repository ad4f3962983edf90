"""hubert-xlarge — encoder-only audio transformer (w2v2 arch)
[arXiv:2106.07447].

The mel-spectrogram + conv feature extractor is a STUB per the assignment
brief: ``input_specs`` provides precomputed frame embeddings.  Encoder-only
⇒ no decode step; decode_32k / long_500k are skipped (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab=504, head_dim=80,
    causal=False, is_decoder=False,
    frontend="audio", frontend_dim=512,
    citation="arXiv:2106.07447 (HuBERT)",
))
