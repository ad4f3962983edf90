"""Train an LM configuration (its reduced variant) on the token pipeline:
the port's counterpart of ``examples/train_lm.py``.

The full LM training path: synthetic sharded corpus -> prefetching
pipeline (each batch copied to the device from pinned memory) ->
period-structured transformer -> AdamW, the state updated in place, loss
falling over a few hundred steps.  The flags, the reduced configuration,
the refusal of frontend models and the closing line are the reference
example's; ``--device`` is the port's: the GPU by default (``NoGPUError``
without one), ``--device cpu`` runs the plain path.

Usage:
  python -m repro_torch.launch.train_lm --arch qwen3-moe-30b-a3b --steps 100
  python -m repro_torch.launch.train_lm --device cpu --steps 4 --batch 2 --seq-len 32
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List

import numpy as np
import torch

__all__ = ["pinned_place", "main"]


def pinned_place(device: torch.device) -> Callable[[Dict], Dict]:
    """A ``TokenPipeline`` ``place_fn``: each numpy array of a batch as a
    tensor on ``device``, copied there from pinned host memory on a GPU
    (asynchronously: the pinned block is not reused before its copy ends)."""
    def place(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        return out

    return place


def main(argv=None) -> List[float]:
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticCorpus, TokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.models import init_train_state, make_train_step
    from repro_torch.optim import AdamConfig

    ap = argparse.ArgumentParser(description="Train a reduced LM configuration on the "
                                             "synthetic token pipeline (PyTorch/CUDA port).")
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).reduced()
    if cfg.frontend:
        raise SystemExit("pick a text decoder arch for this example")
    device = resolve_device(args.device)
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"L={cfg.num_layers} d={cfg.d_model}, on {device}")

    corpus = SyntheticCorpus(vocab=cfg.vocab, seq_len=args.seq_len, num_shards=8)
    pipe = TokenPipeline(corpus, global_batch=args.batch, prefetch=2,
                         place_fn=pinned_place(device))
    losses = []
    t0 = time.time()
    try:
        state = init_train_state(cfg, 0, device)
        step = make_train_step(cfg, AdamConfig(lr=1e-3, grad_clip=1.0))
        for i in range(args.steps):
            state, loss = step(state, next(pipe))
            losses.append(float(loss))
            if i % 10 == 0:
                print(f"step {i:4d}  loss {losses[-1]:.4f}")
    finally:
        pipe.close()
    k = max(1, len(losses) // 10)
    print(f"\nloss {np.mean(losses[:k]):.4f} -> {np.mean(losses[-k:]):.4f} "
          f"in {time.time()-t0:.0f}s "
          f"({'improving' if np.mean(losses[-k:]) < np.mean(losses[:k]) else 'flat'})")
    return losses


if __name__ == "__main__":
    main()
