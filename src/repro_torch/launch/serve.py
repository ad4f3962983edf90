"""Serving entry point of the port: the HGNN online-inference tier and the LM
workbench.

**HGNN tier** (default): builds a session on the GPU (or ``--device
cpu``), trains it for ``--steps`` steps (``Heta.fit``, 0 keeps the seeded
init), materializes every node's embedding via layer-wise full-graph
inference (``Heta.infer_all``), starts the micro-batching
``EmbeddingServer`` (``Heta.serve``) and drives it with concurrent lookup
threads — printing the inference time split, p50/p99 latency, QPS and
per-type cache hit rates.  All ``HetaConfig`` flags apply (``--scale``, ``--steps``,
``--serve-max-batch``, ``--serve-cache-mb``, ...).

**LM workbench** (``--arch NAME``, the dense decoders): batched prefill
(the flash-attention kernel in every attention layer) and token-by-token
greedy decode against the KV cache, as ``repro/launch/serve.py`` does;
``--window`` feeds the prompt through decode into a ring-buffer cache
instead.  ``--reduced`` (the default) runs the shrunken config,
``--no-reduced`` the full one (on the GPU).

Usage:
  python -m repro_torch.launch.serve --scale 0.1
  python -m repro_torch.launch.serve --model rgat --scale 0.1
  python -m repro_torch.launch.serve --scale 0.002 --device cpu
  python -m repro_torch.launch.serve --arch llama3.2-3b --device cpu \
      --batch 2 --prompt-len 16 --new-tokens 8 [--window 8]
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import List, Tuple

import numpy as np
import torch

__all__ = ["run_clients", "serve_lm", "main"]


def _parser() -> argparse.ArgumentParser:
    from repro_torch.api import add_config_args

    ap = argparse.ArgumentParser(
        description="Serving entry point of the PyTorch/CUDA port: the HGNN "
                    "online-inference tier (default) or the LM decode "
                    "workbench (--arch).")
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
    lm = ap.add_argument_group("LM workbench (--arch)")
    lm.add_argument("--arch", default=None,
                    help="run the LM decode workbench for this dense decoder "
                         "instead of the HGNN tier (e.g. llama3.2-3b)")
    lm.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="LM workbench only: run the reduced config "
                         "(--no-reduced for full size)")
    lm.add_argument("--batch", type=int, default=4,
                    help="LM workbench only: decode batch size")
    lm.add_argument("--prompt-len", type=int, default=64,
                    help="LM workbench only: prefill prompt length")
    lm.add_argument("--new-tokens", type=int, default=32,
                    help="LM workbench only: tokens to decode")
    lm.add_argument("--window", type=int, default=0,
                    help="LM workbench only: sliding-window size (0 = full attention)")
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(args) -> dict:
    """The LM workbench: prefill a batch of random prompts (drawn from
    ``--seed``), then decode ``--new-tokens`` greedily.  Returns the
    generated tokens ``[B, N]`` and the two times."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import (init_decode_cache, init_params, make_prefill_step,
                                    make_serve_step)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.is_decoder:
        raise SystemExit(f"{args.arch} is encoder-only (no decode step)")
    device = resolve_device(args.device)
    seed = args.seed if args.seed is not None else 0
    rng = np.random.default_rng(seed)
    params = init_params(cfg, seed, device)
    B, S, N = args.batch, args.prompt_len, args.new_tokens
    window = args.window or None

    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=device)
    t0 = time.perf_counter()
    if window:
        # window mode: ring-buffer cache; feed the prompt token-by-token
        cache = init_decode_cache(cfg, B, window, device=device)
        serve = make_serve_step(cfg, window=window)
        for pos in range(S):
            logits, cache = serve(params, cache, prompts[:, pos:pos + 1], pos)
    else:
        logits, cache = make_prefill_step(cfg)(params, {"tokens": prompts})
        cache = {k: F.pad(c, (0, 0, 0, 0, 0, N)) for k, c in cache.items()}
        serve = make_serve_step(cfg)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    print(f"{cfg.name} on {device}: prefill {B}x{S}: {prefill_s * 1e3:.0f} ms")

    token = logits[:, -1:].argmax(dim=-1)
    out = []
    t0 = time.perf_counter()
    for pos in range(S, S + N):
        logits, cache = serve(params, cache, token, pos)
        token = logits.argmax(dim=-1)
        out.append(token)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"decode {N} tokens: {dt * 1e3:.0f} ms ({dt / max(N, 1) * 1e3:.1f} ms/token, "
          f"window={window})")
    tokens = torch.cat(out, dim=1).cpu().numpy() if out else np.zeros((B, 0), np.int64)
    return {"tokens": tokens, "prefill_s": prefill_s, "decode_s": dt}


def main(argv=None):
    from repro_torch.api import Heta, HetaConfig, config_from_args
    from repro_torch.serve import bounded_graph

    args = _parser().parse_args(argv)
    if args.arch:
        return serve_lm(args)
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
