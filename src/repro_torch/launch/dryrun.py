"""Multi-pod dry run: every (arch × shape × mesh) step on the meta device.

The port's counterpart of ``repro/launch/dryrun.py``.  For each combination
it

  1. opens PyTorch's fake process group of 256 (16 x 16) or 512 (2 x 16 x
     16) ranks as the default group, builds the production mesh over it
     and plays rank 0;
  2. lays the train state (or the parameters), the batch and the decode
     cache out as DTensors on the ``meta`` device by the rule tables of
     ``launch.sharding`` (no storage anywhere);
  3. runs the step — train (``loss_fn``'s value and gradient, then
     AdamW), prefill or serve — with ``use_kernel=False``, as the
     reference lowers with ``use_pallas=False``;
  4. records what the run shows into ``results/dryrun/*.json``.

A sharding mismatch or an op with no sharding rule surfaces as an error
here, as a failed lower or compile does in the reference: the record gets
status ``error`` and the CLI exits non-zero.

What a record holds, and how it is counted:

  * ``memory.argument_bytes`` — per device: the bytes of every argument's
    local shard (rank 0's).  There is no compiler, so ``output_bytes``,
    ``temp_bytes`` and ``peak_bytes`` are None, as are ``bytes_accessed``
    and ``transcendentals``; ``compile_s`` is the seconds of the step's
    meta run (the arguments are placed before it, uncounted).
  * ``flops`` — per device: the formulas of
    ``torch.utils.flop_counter.FlopCounterMode`` applied to every op of
    rank 0's local shards (DTensor ops are counted where they run, on the
    local tensors; products, attention and convolutions, forward,
    backward and every recomputation under remat).
  * ``collectives`` — the bytes of each collective by the reference's names
    (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``)
    plus ``total`` and ``count_*``: the result bytes of each
    ``_c10d_functional`` (and ``c10d``) collective that DTensor or the
    model issues on rank 0, the reference's proxy.
  * ``collectives_by_line`` and ``flops_by_line`` (with ``--by-line N``
    only): the N model source lines (the innermost frame under
    ``repro_torch/models/``, the autograd call for a backward) whose ops
    moved the most collective bytes and did the most FLOPs, each as
    ``[line, op, amount]``.
  * The layer loop is plain Python, so every layer runs and is counted: the
    reference's 1- and 2-period extrapolation has no counterpart
    (``loop_collectives`` equals ``collectives``; ``per_period`` is None).

Where the run leaves DTensor's own sharding rules (each is listed here,
and its collective is counted):

  * ``models/layers.py`` ``replicate_like``: positions, masks and RoPE
    tables made inside the model are lifted to ``Replicate()`` (no
    collective: every rank computes the same values);
  * ``models/moe.py`` ``moe_block_ep``: each rank's shard is taken with
    ``to_local`` after placing x as ``(dp, model, None)`` (a redistribution,
    counted) and the result is rebuilt with ``from_local`` and put back in
    x's placements (an all-gather of the sequence, counted); the
    all-to-alls are the model's own;
  * a head count the model axis does not divide (llama's 24 heads or 8 kv
    heads on 16) cannot be split into heads while sharded: the projection
    is gathered first (DTensor's redistribution, counted as an
    all-gather), where GSPMD pads.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results/dryrun]
  python -m repro_torch.launch.dryrun --arch granite-moe-1b-a400m --shape train_4k --by-line 8
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from collections import Counter
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ARCHS, INPUT_SHAPES, ArchConfig, InputShape
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.launch.sharding import (
    batch_pspecs,
    cache_pspecs,
    param_pspecs,
    placements,
    state_pspecs,
)
from repro_torch.launch.specs import (
    abstract_cache,
    abstract_params,
    abstract_state,
    input_specs,
    plan_step,
)
from repro_torch.optim.adam import AdamConfig

__all__ = ["run_one", "CollectiveCounter", "fake_world", "place"]

# the reference's names for the collectives DTensor and the model issue
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced":
    "reduce-scatter", "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
}


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Counts, on this rank's local tensors, the result bytes of every
    collective (``self.collectives``, the reference's keys) and the FLOPs
    of every op by ``FlopCounterMode``'s formulas (``self.flops``).  A
    DTensor op is handed back to DTensor (``NotImplemented``), so what is
    seen is what it runs locally, its redistributions included."""

    def __init__(self, by_line: bool = False):
        super().__init__()
        self.collectives: Dict[str, int] = {}
        self._flops = FlopCounterMode(display=False)
        # (model source line, op) -> collective bytes / FLOPs, when asked
        self.by_line: Optional[Dict[str, Counter]] = (
            {"collectives": Counter(), "flops": Counter()} if by_line else None)

    @property
    def flops(self) -> int:
        return self._flops.get_total_flops()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # DTensor's ops are seen again as the local ops they run; its shape
        # propagation runs each op once more on fake tensors of the global
        # shapes, which no rank computes
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        packet = func._overloadpacket
        flops0 = self.flops
        self._flops._count_flops(packet, out, args, kwargs)
        nbytes = 0
        if func.namespace in ("_c10d_functional", "c10d"):
            name = _COLLECTIVES.get(packet.__name__)
            if name is not None:
                nbytes = _nbytes(out[0] if func.namespace == "c10d" else out)
                c = self.collectives
                c[name] = c.get(name, 0) + nbytes
                c["total"] = c.get("total", 0) + nbytes
                c[f"count_{name}"] = c.get(f"count_{name}", 0) + 1
        if self.by_line is not None and (nbytes or self.flops > flops0):
            key = (_model_line(), packet.__name__)
            self.by_line["collectives"][key] += nbytes
            self.by_line["flops"][key] += self.flops - flops0
        return out


def _model_line() -> str:
    """``file:line`` of the innermost frame of the call stack that lies in
    ``repro_torch/models/`` (``?`` when none does)."""
    for frame in reversed(traceback.extract_stack()):
        if f"repro_torch{os.sep}models{os.sep}" in frame.filename:
            return f"{os.path.basename(frame.filename)}:{frame.lineno}"
    return "?"


def fake_world(world: int) -> None:
    """Make the fake process group of ``world`` ranks (this process rank 0)
    the default group.  A fake group of another size is replaced; a real
    default group is refused."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"the dry run plays rank 0 of a fake {world}-rank group; this process "
                f"already has a real default group ({dist.get_backend()}, world size "
                f"{dist.get_world_size()}): run it in a process of its own")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def place(mesh, tree, specs):
    """Each tensor of ``tree`` (nested dicts) as a DTensor by its spec; a
    tensor off the meta device (the train state's CPU step counter) stays
    as it is."""
    if isinstance(tree, dict):
        return {k: place(mesh, v, specs[k]) for k, v in tree.items()}
    if tree.device.type != "meta":
        return tree
    return distribute_tensor(tree, mesh, placements(mesh, specs))


def _argument_bytes(*trees) -> int:
    total = 0
    for tree in trees:
        if isinstance(tree, dict):
            total += _argument_bytes(*tree.values())
        elif isinstance(tree, DTensor):
            total += _nbytes(tree.to_local())
        elif isinstance(tree, torch.Tensor):
            total += _nbytes(tree)
    return total


def _pctx(mesh, variant: Optional[str]):
    """The reference's §Perf variant string, e.g. "ep", "act", "q64",
    "ep,nr", as ``(ParallelCtx or None, remat)``."""
    if not variant:
        return None, True
    from repro_torch.models.transformer import ParallelCtx

    toks = set(variant.split(","))
    kw = {}
    if "ep" in toks:
        kw["moe"] = "expert_parallel"
    if "act" in toks:
        kw["constrain_activations"] = True
    if "sp" in toks:
        kw["sp_attention"] = True
    for t in toks:
        if t.startswith("q") and t[1:].isdigit():
            kw["ssd_chunk"] = int(t[1:])
        if t.startswith("fa") and t[2:].isdigit():
            kw["attn_chunk"] = int(t[2:])
    if "ssdbf16" in toks:
        kw["ssd_bf16"] = True
    if "rp" in toks:
        kw["remat_policy"] = "dots"
    return ParallelCtx(mesh=mesh, dp_axes=tuple(data_axes(mesh)), **kw), "nr" not in toks


def _prepare(cfg: ArchConfig, shape: InputShape, mesh, variant: Optional[str] = None):
    """Place the step's arguments on ``mesh``: ``(plan, argument bytes per
    device, the step as a thunk)``."""
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adam import adam_update

    plan = plan_step(cfg, shape)
    specs = input_specs(cfg, shape)
    pctx, remat = _pctx(mesh, variant)

    if plan.kind == "train":
        state = abstract_state(cfg)
        state = place(mesh, state, state_pspecs(cfg, state, mesh))
        batch = place(mesh, specs, batch_pspecs(cfg, shape, specs, mesh))
        adam = AdamConfig(lr=3e-4, weight_decay=0.01, grad_clip=1.0)

        def step():
            _, grads = tfm._value_and_grad(cfg, state["params"], batch, use_kernel=False,
                                           remat=remat, pctx=pctx)
            adam_update(adam, state["params"], grads, state["opt"])

        return plan, _argument_bytes(state, batch), step
    params = abstract_params(cfg)
    params = place(mesh, params, param_pspecs(cfg, params, mesh))
    if plan.kind == "prefill":
        batch = place(mesh, specs, batch_pspecs(cfg, shape, specs, mesh))
        prefill = tfm.make_prefill_step(cfg, use_kernel=False, pctx=pctx)
        return plan, _argument_bytes(params, batch), lambda: prefill(params, batch)
    # decode: one token at the cache's last slot (the port's position is a
    # host int; no shape depends on it)
    cache = abstract_cache(cfg, shape)
    cache = place(mesh, cache, cache_pspecs(cfg, cache, mesh))
    token = place(mesh, {"token": specs["token"]},
                  batch_pspecs(cfg, shape, {"token": specs["token"]}, mesh))["token"]
    serve = tfm.make_serve_step(cfg, window=plan.window)
    arg_bytes = _argument_bytes(params, cache, token) + _nbytes(specs["pos"])
    return plan, arg_bytes, lambda: serve(params, cache, token, plan.cache_len - 1)


def _analyze(cfg: ArchConfig, shape: InputShape, mesh, variant: Optional[str] = None,
             by_line: int = 0) -> Dict:
    """One step on ``mesh``, its arguments placed before the count starts;
    with ``by_line``, that many top model lines for collectives and FLOPs."""
    plan, arg_bytes, step = _prepare(cfg, shape, mesh, variant)
    counter = CollectiveCounter(by_line=by_line > 0)
    t0 = time.time()
    with counter:
        step()
    return {
        "plan": plan,
        "compile_s": round(time.time() - t0, 2),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": None, "temp_bytes": None,
                   "peak_bytes": None},
        "flops": float(counter.flops),
        "collectives": dict(counter.collectives),
        **({f"{kind}_by_line": [[line, op, amount]
                                for (line, op), amount in tally.most_common(by_line) if amount]
            for kind, tally in counter.by_line.items()} if by_line else {}),
    }


def run_one(
    arch: str, shape_name: str, multi_pod: bool = False, out_dir: Optional[str] = None,
    variant: Optional[str] = None, mesh=None, by_line: int = 0,
) -> Dict:
    """One combination's record.  ``mesh`` (a ``DeviceMesh`` over the fake
    group) replaces the production mesh, for tests at a small size;
    ``by_line`` adds the top model lines (see the module docstring)."""
    cfg = ARCHS[arch]
    shape = INPUT_SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if mesh is not None:
        mesh_name = "x".join(str(n) for n in mesh.shape)
    if variant:
        mesh_name += f"+{variant}"
    rec: Dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "variant": variant,
        "family": cfg.family,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "n_periods": cfg.n_periods,
    }
    plan = plan_step(cfg, shape)
    if plan.kind == "skip":
        rec.update(status="skip", reason=plan.skip_reason)
        _save(rec, out_dir)
        return rec

    t0 = time.time()
    try:
        if mesh is None:
            fake_world(512 if multi_pod else 256)
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        full = _analyze(cfg, shape, mesh, variant=variant, by_line=by_line)
        rec.update(
            status="ok",
            step_kind=plan.kind,
            window=plan.window,
            total_s=round(time.time() - t0, 2),
            compile_s=full["compile_s"],
            memory=full["memory"],
            flops=full["flops"],
            bytes_accessed=None,
            transcendentals=None,
            collectives=full["collectives"],
            loop_collectives=full["collectives"],
            per_period=None,
            num_devices=mesh.size(),
            **{k: full[k] for k in ("collectives_by_line", "flops_by_line") if k in full},
        )
    except Exception as e:  # a failure here is a framework bug — surface it
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    _save(rec, out_dir)
    return rec


def _save(rec: Dict, out_dir: Optional[str]):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    import repro_torch.configs.all_archs  # noqa: F401

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default=None, help="e.g. 'ep' (expert-parallel MoE)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--by-line", type=int, default=0, metavar="N",
                    help="also record and print the N model lines with the most "
                         "collective bytes and FLOPs")
    args = ap.parse_args(argv)

    combos = []
    archs = sorted(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = sorted(INPUT_SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                combos.append((a, s, mp))

    fails = 0
    for a, s, mp in combos:
        rec = run_one(a, s, multi_pod=mp, out_dir=args.out, variant=args.variant,
                      by_line=args.by_line)
        status = rec["status"]
        extra = ""
        if status == "ok":
            extra = (
                f" kind={rec['step_kind']} total={rec['total_s']}s "
                f"args={rec['memory']['argument_bytes'] / 2**30:.2f}GiB/device "
                f"flops={rec['flops']:.3e}/device "
                f"coll={rec['collectives'].get('total', 0) / 2**30:.2f}GiB"
            )
        elif status == "error":
            fails += 1
            extra = " " + rec["error"][:160]
        elif status == "skip":
            extra = " " + rec["reason"]
        print(f"[{status:>5}] {a} × {s} × {rec['mesh']}{extra}", flush=True)
        for line, op, amount in rec.get("collectives_by_line", []):
            print(f"    coll {amount / 2**30:10.2f} GiB  {op:24s} {line}")
        for line, op, amount in rec.get("flops_by_line", []):
            print(f"    flops {amount:.3e}  {op:24s} {line}")
    if dist.is_initialized():
        dist.destroy_process_group()
    if fails:
        raise SystemExit(f"{fails} combinations failed")


if __name__ == "__main__":
    main()
