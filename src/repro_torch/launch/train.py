"""End-to-end Heta training driver of the port (thin CLI over ``repro_torch.api``).

The twin of ``python -m repro.launch.train``: synthetic HetG →
meta-partitioning (§5) → hotness + miss-penalty profiling → cache
allocation (§6) → RAF training (§4), on the GPU by default.  Flags are
derived from :class:`repro_torch.api.HetaConfig` (``add_config_args``), so
they are the reference CLI's; ``--device cpu`` runs the plain PyTorch path.

Usage:
  python -m repro_torch.launch.train --scale 0.1 --batch-size 1024
  python -m repro_torch.launch.train --model hgt --scale 0.1 --batch-size 1024
  python -m repro_torch.launch.train --device cpu --scale 0.002 --steps 2
  python -m repro_torch.launch.train --executor raf --scale 0.1 --batch-size 1024
  python -m repro_torch.launch.train --device cpu --scale 0.002 --steps 4 \
      --pipeline --num-workers 2 --snapshot-policy fresh
  python -m repro_torch.launch.train --shm-cleanup --device cpu --scale 0.002
  python -m repro_torch.launch.train --device cpu --scale 0.002 --naive --hotness-only

Prints per-step losses, then the result dict as JSON and the final loss.
``--pipeline`` overlaps host sampling and staging with the device step (a
producer thread, or ``--num-workers`` sampler processes over shared
memory); ``--num-trainers 2 --no-train-learnable`` runs the data-parallel
fit in two trainer processes over a shared graph store (``--scale-store
mmap`` for the on-disk one).  ``--shm-cleanup`` first unlinks the
shared-memory segments and on-disk mmap stores that crashed runs of the
port left behind (names ``heta-tshm-<pid>-*`` in ``/dev/shm`` and
``heta-tmmap-<pid>-*`` in the store root, whose creator is gone), then
trains as usual.  The reference's legacy aliases are kept: ``--naive`` is
``--placement naive`` and ``--hotness-only`` is ``--cache-policy hotness``.

``train_hgnn(...)`` is the reference's legacy keyword entry point, a thin
wrapper over ``Heta(HetaConfig.from_flat_kwargs(...), device=device).run()``
with the reference's keywords and defaults plus ``device``; prefer the
session API for new code.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["main", "train_hgnn"]


def train_hgnn(
    dataset: str = "ogbn-mag",
    scale: Optional[float] = None,
    model: str = "rgcn",
    num_partitions: int = 4,
    mesh_shape: Tuple[int, int] = (1, 1),
    batch_size: int = 32,
    fanouts: Sequence[int] = (4, 3),
    hidden: int = 64,
    steps: int = 20,
    lr: float = 5e-3,
    cache_mb: int = 4,
    hotness_only: bool = False,
    naive_placement: bool = False,
    learnable_dim: int = 64,
    seed: int = 0,
    log_every: int = 0,
    executor: str = "raf_spmd",
    device: Optional[str] = None,
) -> Dict:
    """Deprecated compatibility wrapper: ``Heta(HetaConfig.from_flat_kwargs(
    **kwargs), device=device).run()``, with the reference's result keys
    (``losses``, ``step_time_s``, ``setup_s``, ``hit_rates``,
    ``partitioning``, ``meta_local``, ``cache_allocation``, ...).  Use
    :class:`repro_torch.api.Heta` for new code."""
    from repro_torch.api import Heta, HetaConfig

    cfg = HetaConfig.from_flat_kwargs(
        dataset=dataset, scale=scale, model=model, num_partitions=num_partitions,
        mesh_shape=tuple(mesh_shape), batch_size=batch_size,
        fanouts=tuple(fanouts), hidden=hidden, steps=steps, lr=lr,
        cache_mb=cache_mb, hotness_only=hotness_only,
        naive_placement=naive_placement, learnable_dim=learnable_dim,
        seed=seed, log_every=log_every, executor=executor,
    )
    return Heta(cfg, device=device).run()


def _parser() -> argparse.ArgumentParser:
    from repro_torch.api import add_config_args

    ap = argparse.ArgumentParser(
        description="Heta training on the PyTorch/CUDA port.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "PyTorch path)")
    add_config_args(ap)
    ap.add_argument("--naive", action="store_true",
                    help="legacy alias for --placement naive")
    ap.add_argument("--hotness-only", action="store_true",
                    help="legacy alias for --cache-policy hotness")
    ap.add_argument("--shm-cleanup", action="store_true",
                    help="sweep orphaned /dev/shm segments and mmap stores left "
                         "by crashed runs of the port, then train as usual")
    return ap


def _config(ap: argparse.ArgumentParser, args: argparse.Namespace):
    """The run's ``HetaConfig`` from parsed flags, the legacy aliases and the
    CLI's ``log_every`` default applied."""
    from repro_torch.api import config_from_args, executors

    cfg = config_from_args(args)
    if cfg.run.executor not in executors.available():
        ap.error(f"unknown --executor {cfg.run.executor!r}; "
                 f"available: {executors.available()}")
    if args.naive:
        cfg = cfg.updated(partition=dict(placement="naive"))
    if args.hotness_only:
        cfg = cfg.updated(cache=dict(policy="hotness"))
    if args.log_every is None:
        cfg = cfg.updated(run=dict(log_every=1))
    return cfg


def main(argv=None) -> dict:
    from repro_torch.api import Heta

    ap = _parser()
    args = ap.parse_args(argv)
    if args.shm_cleanup:
        from repro_torch.graph.mmap_store import cleanup_stale_stores
        from repro_torch.graph.shm import cleanup_stale_segments

        removed = cleanup_stale_segments()
        print(f"shm-cleanup: removed {len(removed)} stale segment(s)"
              + "".join(f"\n  {n}" for n in removed))
        reaped = cleanup_stale_stores()
        print(f"shm-cleanup: removed {len(reaped)} stale mmap store(s)"
              + "".join(f"\n  {n}" for n in reaped))
    cfg = _config(ap, args)
    sess = Heta(cfg, device=args.device)
    metrics = sess.run()
    print(json.dumps({k: v for k, v in metrics.items() if k != "losses"}, indent=1,
                     default=str))
    if metrics["losses"]:
        print(f"final loss: {metrics['losses'][-1]:.4f}")
    return metrics


if __name__ == "__main__":
    main()
