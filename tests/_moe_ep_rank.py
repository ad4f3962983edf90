"""One rank of ``tests/test_torch_moe_ep.py``'s multi-rank check, run as a
process of its own: ``python _moe_ep_rank.py RANK WORLD DIR``.

It joins a gloo group through ``file://DIR/rendezvous``, builds the (data,
model) mesh named in ``DIR/case.json``, places the numpy inputs of ``DIR``
as DTensors (the experts over model, router and norm replicated), runs the
block and, on rank 0, writes the whole output to ``DIR/port_out.npy``.
The block is ``moe_block_ep`` (x over (data, model) on its batch and
sequence) or, with ``"block": "gspmd"`` in the case, ``moe_block`` (x over
data on its batch, as the sharding rules place it) with the gradients of
``(out * g).sum()`` (``g`` from ``DIR/g.npy``) written to
``DIR/port_grad_<name>.npy`` for x and each parameter.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def main(rank: int, world: int, where: str) -> None:
    torch.set_num_threads(1)
    case = json.load(open(os.path.join(where, "case.json")))
    dist.init_process_group("gloo", init_method=f"file://{where}/rendezvous", rank=rank,
                            world_size=world)
    try:
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        import repro_torch.configs.all_archs  # noqa: F401
        from repro_torch.configs import get_arch
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.models.moe import moe_block, moe_block_ep

        cfg = dataclasses.replace(get_arch(case["arch"]).reduced(),
                                  capacity_factor=case["capacity_factor"])
        mesh = make_test_mesh(*case["mesh"], device_type="cpu")
        load = lambda k: torch.from_numpy(np.load(os.path.join(where, f"{k}.npy")))
        p = {k: distribute_tensor(load(k), mesh, [Replicate(), Shard(0)])
             for k in ("w1", "w3", "w2")}
        p.update({k: distribute_tensor(load(k), mesh, [Replicate(), Replicate()])
                  for k in ("router", "norm")})
        if case.get("block") == "gspmd":
            for v in p.values():
                v.requires_grad_()
            x = distribute_tensor(load("x"), mesh, [Shard(0), Replicate()]).requires_grad_()
            out = moe_block(p, cfg, x)
            g = distribute_tensor(load("g"), mesh, list(out.placements))
            (out * g).sum().backward()
            grads = {"x": x.grad, **{k: v.grad for k, v in p.items()}}
            grads = {k: v.full_tensor() for k, v in grads.items()}
        else:
            x = distribute_tensor(load("x"), mesh, [Shard(0), Shard(1)])
            out, grads = moe_block_ep(p, cfg, x, mesh, ("data",)), {}
        out = out.full_tensor()
        if rank == 0:
            np.save(os.path.join(where, "port_out.npy"), out.detach().numpy())
            for k, v in grads.items():
                np.save(os.path.join(where, f"port_grad_{k}.npy"), v.numpy())
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
