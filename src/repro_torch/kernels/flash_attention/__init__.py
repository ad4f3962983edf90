"""Blocked online-softmax attention, the LM workbench's prefill attention
(``csrc/flash_attention.cu``)."""

from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import attention_mask, attention_ref  # noqa: F401
