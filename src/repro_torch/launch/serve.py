"""HGNN serving entry point of the port: layer-wise inference + embedding server.

Builds a session on the GPU (or ``--device cpu``), trains it for
``--steps`` steps (``Heta.fit``, 0 keeps the seeded init), materializes
every node's embedding via layer-wise full-graph inference
(``Heta.infer_all``), starts the micro-batching ``EmbeddingServer``
(``Heta.serve``) and drives it with concurrent lookup threads — printing
the inference time split, p50/p99 latency, QPS and per-type cache hit
rates.  All ``HetaConfig`` flags apply (``--scale``, ``--steps``,
``--serve-max-batch``, ``--serve-cache-mb``, ...).

Usage:
  python -m repro_torch.launch.serve --scale 0.1
  python -m repro_torch.launch.serve --model rgat --scale 0.1
  python -m repro_torch.launch.serve --scale 0.002 --device cpu
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import List, Tuple

import numpy as np

__all__ = ["run_clients", "main"]


def _parser() -> argparse.ArgumentParser:
    from repro_torch.api import add_config_args

    ap = argparse.ArgumentParser(
        description="HGNN online-inference tier of the PyTorch/CUDA port: "
                    "layer-wise full-graph inference + micro-batching "
                    "embedding server.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--requests", type=int, default=256,
                    help="lookup requests to fire at the server (default: 256)")
    ap.add_argument("--concurrency", type=int, default=8,
                    help="concurrent client threads (default: 8)")
    ap.add_argument("--ids-per-request", type=int, default=4,
                    help="node ids per lookup (default: 4)")
    ap.add_argument("--max-degree", type=int, default=16,
                    help="cap the synthetic graph's in-degree (0 = uncapped)")
    add_config_args(ap)
    return ap


def run_clients(server, n_target: int, requests: int, concurrency: int,
                ids_per_request: int, seed: int) -> Tuple[List, float]:
    """Fire ``requests`` lookups of ``ids_per_request`` target ids from
    ``concurrency`` threads (thread k draws ids from ``seed + k``).
    Returns ``([(nids, ServeResult), ...], wall seconds)``; a failed query
    re-raises here."""
    answers: List = []
    errors: List[BaseException] = []
    lock = threading.Lock()

    def client(k: int) -> None:
        rng = np.random.default_rng(seed + k)
        try:
            for _ in range(requests // concurrency):
                nids = rng.integers(0, n_target, ids_per_request)
                res = server.query(nids)
                with lock:
                    answers.append((nids, res))
        except BaseException as exc:  # surfaced to the caller below
            with lock:
                errors.append(exc)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return answers, wall


def main(argv=None) -> None:
    from repro_torch.api import Heta, HetaConfig, config_from_args
    from repro_torch.serve import bounded_graph

    args = _parser().parse_args(argv)
    cfg = config_from_args(args, HetaConfig())
    sess = Heta(cfg, device=args.device)
    g = sess.build_graph()
    if args.max_degree:
        g = bounded_graph(g, args.max_degree)
        sess.build_graph(g)
    print(f"graph: {g.name}  nodes={g.total_nodes:,}  edges={g.total_edges:,}  "
          f"device={sess.device}")
    sess.partition()
    sess.profile_and_cache()
    sess.compile()
    sess.fit()
    print(f"trained {cfg.run.steps} steps (loss {sess.losses[-1]:.4f})"
          if sess.losses else "no training")

    t0 = time.perf_counter()
    store = sess.infer_all()
    tm = store.timings
    print(f"infer_all: {sum(a.shape[0] for a in store.embeddings.values()):,} "
          f"embeddings across {len(store.embeddings)} types "
          f"({store.nbytes / 2**20:.1f} MiB) in {time.perf_counter() - t0:.2f} s "
          f"(host gather {tm['host_gather_s']:.2f} s, h2d {tm['h2d_s']:.2f} s, "
          f"compute {tm['compute_s']:.2f} s, d2h {tm['d2h_s']:.2f} s)")

    server = sess.serve()
    try:
        _, wall = run_clients(server, g.num_nodes[g.target_type], args.requests,
                              args.concurrency, args.ids_per_request, cfg.run.seed)
        stats = server.stats()
        print(f"served {stats.count} requests in {wall:.2f} s "
              f"({args.concurrency} clients, flush policy: "
              f"max_batch={cfg.serve.max_batch}, "
              f"max_wait_ms={cfg.serve.max_wait_ms})")
        print(stats.render())
    finally:
        sess.close_serving()


if __name__ == "__main__":
    main()
