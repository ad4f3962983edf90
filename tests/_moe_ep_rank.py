"""One rank of ``tests/test_torch_moe_ep.py``'s multi-rank check, run as a
process of its own: ``python _moe_ep_rank.py RANK WORLD DIR``.

It joins a gloo group through ``file://DIR/rendezvous``, builds the (data,
model) mesh named in ``DIR/case.json``, places the numpy inputs of ``DIR``
as DTensors (x over (data, model) on its batch and sequence, the experts
over model, router and norm replicated), runs ``moe_block_ep`` and, on
rank 0, writes the whole output to ``DIR/port_out.npy``.
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
        from repro_torch.models.moe import moe_block_ep

        cfg = dataclasses.replace(get_arch(case["arch"]).reduced(),
                                  capacity_factor=case["capacity_factor"])
        mesh = make_test_mesh(*case["mesh"], device_type="cpu")
        load = lambda k: torch.from_numpy(np.load(os.path.join(where, f"{k}.npy")))
        p = {k: distribute_tensor(load(k), mesh, [Replicate(), Shard(0)])
             for k in ("w1", "w3", "w2")}
        p.update({k: distribute_tensor(load(k), mesh, [Replicate(), Replicate()])
                  for k in ("router", "norm")})
        x = distribute_tensor(load("x"), mesh, [Shard(0), Shard(1)])
        out = moe_block_ep(p, cfg, x, mesh, ("data",)).full_tensor()
        if rank == 0:
            np.save(os.path.join(where, "port_out.npy"), out.numpy())
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
