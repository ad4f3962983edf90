"""Architecture + input-shape config system (the port's copy of the
reference's ``configs/base.py``, field for field).

Every assigned architecture is a declarative :class:`ArchConfig`; the model
stack (``repro_torch.models.transformer``) interprets it.  Layer structure is a
repeating *period* of blocks (e.g. Jamba's 1-attention:7-Mamba interleave is
``period=8`` with attention at slot 3), with parameters stacked on the
period axis; the port walks the periods in a Python loop.

``reduced()`` returns the smoke-test variant (≤2 periods, d_model ≤ 512,
≤4 experts) exercised on CPU; the full dense configs run on the GPU
(``chip_smoke.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "register", "get_arch", "ARCHS"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # layer pattern
    period: int = 1  # layers per repeating group
    attn_slots: Tuple[int, ...] = (0,)  # slots within the period that are attention
    # (remaining slots are mamba blocks)
    moe_slots: Tuple[int, ...] = ()  # slots whose MLP is MoE
    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_d_ff: int = 0  # per-expert FFN dim (0 -> d_ff)
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    # attention details
    qkv_bias: bool = False
    rope_fraction: float = 1.0  # chatglm applies RoPE to half the dims
    rope_theta: float = 500_000.0
    causal: bool = True
    is_decoder: bool = True  # encoder-only archs have no decode step
    sliding_window: Optional[int] = None  # used for the long-context decode shape
    # modality frontend stubs (audio/vlm): input_specs provides embeddings
    frontend: Optional[str] = None  # None | "vision" | "audio"
    frontend_dim: int = 0
    frontend_tokens: int = 0  # vision: patches per example (anyres tiles folded)
    # numerics
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    citation: str = ""

    def __post_init__(self):
        if self.num_layers % self.period:
            raise ValueError(f"{self.name}: num_layers % period != 0")
        for s in self.moe_slots:
            assert 0 <= s < self.period
        for s in self.attn_slots:
            assert 0 <= s < self.period

    # -- derived --------------------------------------------------------------

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def n_periods(self) -> int:
        return self.num_layers // self.period

    @property
    def mamba_slots(self) -> Tuple[int, ...]:
        if self.family not in ("ssm", "hybrid"):
            return ()
        return tuple(s for s in range(self.period) if s not in self.attn_slots)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def attention_free(self) -> bool:
        return len(self.attn_slots) == 0

    def param_count(self) -> int:
        """Total parameters (exact, matches init shapes)."""
        D, V = self.d_model, self.vocab
        n = V * D  # embed
        if not self.tie_embeddings:
            n += D * V
        n += D  # final norm
        per_attn = D * self.num_heads * self.hd + 2 * D * self.num_kv_heads * self.hd
        per_attn += self.num_heads * self.hd * D + D  # wo + norm
        if self.qkv_bias:
            per_attn += (self.num_heads + 2 * self.num_kv_heads) * self.hd
        per_mlp = 3 * D * self.d_ff + D
        per_moe = self.moe_experts * 3 * D * self.expert_ff + D * self.moe_experts + D
        di, nh, N = self.d_inner, self.ssm_heads, self.ssm_state
        per_mamba = D * 2 * di + 2 * D * N + D * nh  # z,x,B,C,dt projections
        per_mamba += self.ssm_conv * di + 3 * nh + di + di * D + D  # conv,A,D,dtb,norm,out
        total_layers = 0
        for s in range(self.period):
            if s in self.attn_slots:
                blk = per_attn
            else:
                blk = per_mamba
            blk += per_moe if s in self.moe_slots else per_mlp
            total_layers += blk
        n += total_layers * self.n_periods
        if self.frontend:
            n += self.frontend_dim * D  # projector stub
        return n

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: top-k of E experts)."""
        if not self.moe_experts:
            return self.param_count()
        full = self.param_count()
        per_moe_all = self.moe_experts * 3 * self.d_model * self.expert_ff
        per_moe_act = self.moe_topk * 3 * self.d_model * self.expert_ff
        n_moe_layers = len(self.moe_slots) * self.n_periods
        return full - n_moe_layers * (per_moe_all - per_moe_act)

    # -- smoke-test reduction ---------------------------------------------------

    def reduced(self) -> "ArchConfig":
        """≤2-period, d_model≤512, ≤4-expert variant of the same family."""
        d = 256
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=self.period * min(2, self.n_periods),
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d // heads,
            d_ff=512,
            vocab=512,
            moe_experts=min(self.moe_experts, 4) if self.moe_experts else 0,
            moe_topk=min(self.moe_topk, 2) if self.moe_topk else 0,
            moe_d_ff=128 if self.moe_experts else 0,
            ssm_state=min(self.ssm_state, 64) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            frontend_dim=64 if self.frontend else 0,
            frontend_tokens=min(self.frontend_tokens, 16) if self.frontend else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


ARCHS: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs.all_archs  # noqa: F401  (populate registry)

    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    return ARCHS[name]
