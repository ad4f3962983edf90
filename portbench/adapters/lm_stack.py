"""The port's period-stacked LM (``repro_torch.models.transformer``) at one
layer a period: the configuration file read into the port's
``ArchConfig``, the benchmark's leaves laid out as the port's parameter
tree (each block leaf ``[layers, 1, ...]``, a view of the drawn tensor), and
a tree of the port's (parameters, gradients or moments) read back as the
benchmark's leaves."""

from __future__ import annotations

from typing import Dict

import torch

_BLOCKS = ("attn", "mlp", "moe")


def arch(cfg: dict):
    """The configuration as the port's ``ArchConfig``."""
    from repro_torch.configs.base import ArchConfig

    from portbench.reference.spec import check_run_as

    run = check_run_as(cfg)
    moe = run["ffn"] == "moe"
    return ArchConfig(
        name=cfg["name"], family=run["family"], num_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], head_dim=cfg["head_dim"], period=1, attn_slots=(0,),
        moe_slots=(0,) if moe else (),
        moe_experts=cfg["num_local_experts"] if moe else 0,
        moe_topk=cfg["num_experts_per_tok"] if moe else 0,
        moe_d_ff=cfg["intermediate_size"] if moe else 0,
        capacity_factor=run["capacity_factor"] if moe else 1.25,
        rope_fraction=run["rope_fraction"],
        rope_theta=run["rope_theta"],
        causal=run["causal"], is_decoder=run["decoder"],
        frontend=run["frontend"], frontend_dim=cfg.get("conv_dim_last", 0),
        norm_eps=run["norm_eps"],
        dtype=run["params_dtype"], tie_embeddings=False)


def to_port(leaves: Dict[str, torch.Tensor]) -> Dict:
    """The port's parameter tree over ``leaves`` (no copy)."""
    tree: Dict = {"blocks": {}}
    for name, t in leaves.items():
        kind, _, leaf = name.partition(".")
        if kind in _BLOCKS:
            tree["blocks"].setdefault(kind, {})[leaf] = t.unsqueeze(1)
        else:
            tree[name] = t
    return tree


def from_port(tree: Dict) -> Dict[str, torch.Tensor]:
    """A tree in the port's layout as the benchmark's leaves (views)."""
    out = {}
    for kind, blk in tree["blocks"].items():
        for leaf, t in blk.items():
            out[f"{kind}.{leaf}"] = t.squeeze(1)
    out.update({k: v for k, v in tree.items() if k != "blocks"})
    return out


def train_state(leaves: Dict[str, torch.Tensor]) -> Dict:
    """The port's train state over ``leaves``: float32 zero moments and a
    step counter on the host, as ``init_train_state`` makes them."""
    params = to_port(leaves)

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)

    return {"params": params, "opt": {"m": zeros(params), "v": zeros(params),
                                      "step": torch.zeros((), dtype=torch.int32)}}
