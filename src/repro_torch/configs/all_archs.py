"""Import every architecture config to populate the registry."""
import repro_torch.configs.llama3_2_3b  # noqa: F401
import repro_torch.configs.yi_6b  # noqa: F401
import repro_torch.configs.jamba_1_5_large_398b  # noqa: F401
import repro_torch.configs.mamba2_1_3b  # noqa: F401
import repro_torch.configs.llava_next_34b  # noqa: F401
import repro_torch.configs.qwen3_moe_30b_a3b  # noqa: F401
import repro_torch.configs.qwen2_1_5b  # noqa: F401
import repro_torch.configs.granite_moe_1b_a400m  # noqa: F401
import repro_torch.configs.hubert_xlarge  # noqa: F401
import repro_torch.configs.chatglm3_6b  # noqa: F401
