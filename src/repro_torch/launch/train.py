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

Prints per-step losses, then the result dict as JSON and the final loss.
The reference CLI's ``--shm-cleanup`` has no counterpart: the port has no
shared-memory stores yet.  Nor have its legacy aliases ``--naive`` and
``--hotness-only``: use ``--placement naive`` and ``--cache-policy hotness``.
"""

from __future__ import annotations

import argparse
import json

__all__ = ["main"]


def _parser() -> argparse.ArgumentParser:
    from repro_torch.api import add_config_args

    ap = argparse.ArgumentParser(
        description="Heta training on the PyTorch/CUDA port.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "PyTorch path)")
    add_config_args(ap)
    return ap


def main(argv=None) -> dict:
    from repro_torch.api import Heta, config_from_args, executors

    ap = _parser()
    args = ap.parse_args(argv)
    cfg = config_from_args(args)
    if cfg.run.executor not in executors.available():
        ap.error(f"unknown --executor {cfg.run.executor!r}; "
                 f"available: {executors.available()}")
    if args.log_every is None:
        cfg = cfg.updated(run=dict(log_every=1))
    sess = Heta(cfg, device=args.device)
    metrics = sess.run()
    print(json.dumps({k: v for k, v in metrics.items() if k != "losses"}, indent=1,
                     default=str))
    if metrics["losses"]:
        print(f"final loss: {metrics['losses'][-1]:.4f}")
    return metrics


if __name__ == "__main__":
    main()
