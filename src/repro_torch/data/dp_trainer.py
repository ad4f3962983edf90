"""Multi-process data-parallel RAF training over a shared graph store.

DESIGN.md §13: ``Heta.fit`` with ``scale.num_trainers = N > 1`` spawns
``N-1`` trainer processes (the session's own process is rank 0), each of
which attaches the *same* graph store — a ``/dev/shm`` segment
(:func:`repro_torch.graph.shm.share_graph`) or an on-disk memory-mapped store
(:func:`repro_torch.graph.mmap_store.mmap_share_graph`), per ``scale.store`` —
builds the identical deterministic session (same config, same
name-derived parameter init, same plan), and trains under one of two
disciplines (``scale.mode``):

``"global"`` — stripe parallelism over the *global* batch schedule.
    Trainer ``r`` samples, stages and computes global steps
    ``r, r+N, 2N+r, …`` with the executor's fused train step (the same
    program the single-process fit runs, ``sync_stack_grads``
    included) and publishes the updated state bytes through the shm
    exchange; the other trainers adopt them. Because every step runs the
    single-process program on the single-process state sequence, the
    loss trajectory is **bit-identical** to ``fit`` with
    ``num_trainers = 1`` — while the expensive host work (sampling +
    staging, and each step's device compute) is owned by exactly one
    trainer. Works with any staged-protocol executor.

``"local"`` — hierarchy-owned sub-batch data parallelism (raf_spmd).
    :func:`repro_torch.core.meta_partition.hierarchical_partition` assigns
    every train node to exactly one ``(group, sub-partition)``; trainer
    ``r`` samples sub-batches of ``batch_size // N`` seeds from the
    train nodes it owns, computes raw stack gradients
    (:func:`repro_torch.core.raf_spmd.grad_step`), pre-scales them by its
    batch share and contributes them to the exchange, which sums
    contributions in **fixed rank order** — so the reduced gradient is
    bitwise identical on every rank — before each rank runs
    :func:`repro_torch.core.raf_spmd.apply_step`
    (``sync_stack_grads`` + Adam) on the sum. Parameters therefore stay
    bit-identical *across trainers* (asserted via state hashes at the
    end of every DP fit); the trajectory differs from the single-process
    schedule (different seed routing), which is why parity CI runs
    ``"global"``.

The exchange itself (:class:`DPExchange`) is a fixed-slot ring over one
shm segment (:func:`repro_torch.graph.shm.share_arrays` layout, so the
DESIGN.md §12 janitor discipline covers it): per slot an int64 control
record ``[writing, contrib, ready, consumed]`` mutated only under one
``multiprocessing.Condition``, float64 per-rank loss/batch-size rows,
and the flattened payload pytree. Writers block until the slot's
previous generation is fully consumed; readers block until the slot is
ready; every wait polls peer liveness and times out loudly. With
``scale.overlap`` (default) each trainer stages its next owned batch in
a daemon thread, so host sampling hides behind the exchange waits —
scale-out adds bandwidth, not a barrier.

v1 limits (recorded follow-ons, DESIGN.md §13): learnable-table
training is rejected when the engine would apply sparse row updates
(``plan.learn_feats``) — table-gradient exchange is not wired; periodic
mid-fit checkpointing is skipped during a DP fit (checkpoint before or
after); trainer processes are supervised (a dead peer fails the fit
loudly) but not respawned.

The port's copy of the reference's ``repro/data/dp_trainer.py``.  The
exchange stays numpy over the port's shared memory, not
``torch.distributed``: the fixed rank order of :meth:`DPExchange.contribute`
is what makes ``"local"`` ranks bit-identical, and neither gloo nor NCCL
fixes the order of an all-reduce's sum (NCCL also wants a GPU per rank).
What differs from the reference:

* the state pytree helpers (:func:`_host_leaves`, :func:`_adopt`,
  :func:`state_sha`) walk the port's tensor trees
  (:func:`repro_torch.optim.adam.tree_leaves` / ``tree_map``): a leaf goes
  to the wire as ``detach().cpu().numpy()`` at least 1-d (Adam's ``step``
  is a 0-d int32 tensor) and comes back reshaped, as its predecessor's
  dtype, on its predecessor's device;
* ``"local"`` mode runs :func:`repro_torch.core.raf_spmd.grad_step` and
  :func:`~repro_torch.core.raf_spmd.apply_step` in place of the
  reference's jitted ``make_grad_step`` / ``make_apply_step``, and has no
  ``plan.mesh`` (the port's shards share one device);
* :func:`_trainer_main` takes two arguments beyond the reference's: the
  parent session's device as a string (a rank runs there, never on a
  fall-back; ``Heta(cfg)`` alone would mean the GPU), and the parent's
  ``torch.get_num_threads()``, which the child sets before it builds its
  session: on the CPU a matrix product's summation order follows the
  intra-op thread count, and ``"global"`` bit-identity needs the child's
  steps summed as the parent's;
* a child's report carries two keys beyond the reference's:
  ``kernel_launches`` (per kernel of ``repro_torch.kernels.ops.KERNELS``,
  the launches and launch shapes of the child's own loop — launch counters
  are per process) and ``loop_start`` (the wall clock, ``time.time()``,
  at which its loop began); ``results()["scale"]`` gains
  ``trainer_reports`` (each child's report without its losses) and
  ``startup_s`` (per child, seconds from its spawn to the start of its
  loop);
* on CUDA, :func:`run_dp_fit` builds every kernel in rank 0 before it
  spawns, so the ranks only load the libraries; ranks are spawned, never
  forked, so each opens its own CUDA context.

This module imports torch only inside functions, as the reference imports
jax: ``repro_torch.data`` is what spawned sampler workers unpickle into,
and they stay torch-free.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.graph.shm import (ArraysHandle, SharedArrays, _open_attached,
                                   _view, share_arrays)

__all__ = [
    "DPError",
    "DPExchange",
    "attach_exchange",
    "create_exchange",
    "run_dp_fit",
]

_DEPTH = 4  # exchange ring slots (state/grad generations in flight)
_TIMEOUT_S = 300.0  # covers child startup: spawn + torch import + build + load


class DPError(RuntimeError):
    """A DP trainer peer died, timed out, or diverged."""


# --------------------------------------------------------------------------
# shm exchange — fixed-slot ring, deterministic fixed-rank-order reduction
# --------------------------------------------------------------------------


def _leaf_template(leaves) -> Tuple[Tuple[Tuple[int, ...], str], ...]:
    """(shape, dtype) per payload leaf — the exchange's wire contract."""
    return tuple(
        (tuple(np.shape(x)), np.dtype(np.asarray(x).dtype).str) for x in leaves
    )


class DPExchange:
    """One slot-ring exchange among ``num_ranks`` trainer processes.

    See the module docstring for the protocol. All control-word mutation
    happens under ``cond``'s lock (full memory barriers on acquire and
    release), so no cross-process atomics are needed; payload reads
    happen outside the lock but only in the window where the slot's
    writers are blocked on its ``consumed`` count.
    """

    # ctl columns: [writing step, contributions done, ready step, consumers done]
    _WRITING, _CONTRIB, _READY, _CONSUMED = range(4)

    def __init__(self, views: Dict[str, np.ndarray], cond, rank: int,
                 num_ranks: int, depth: int, num_leaves: int,
                 timeout_s: float = _TIMEOUT_S,
                 alive: Optional[Callable[[], None]] = None,
                 owner_store: Optional[SharedArrays] = None,
                 attached_shm=None):
        self._ctl = views["ctl"]
        self._loss = views["loss"]
        self._bs = views["bs"]
        self._slots = [
            [views[f"s{j}/{n}"] for n in range(num_leaves)]
            for j in range(depth)
        ]
        self.cond = cond
        self.rank = rank
        self.num_ranks = num_ranks
        self.depth = depth
        self.timeout_s = timeout_s
        self.alive = alive
        self._owner_store = owner_store
        self._attached = attached_shm

    # -- waiting ------------------------------------------------------------

    def _await(self, pred, what: str) -> None:
        """Wait for ``pred`` under the (already held) condition, polling
        peer liveness every second; :class:`DPError` on timeout/dead peer."""
        deadline = time.monotonic() + self.timeout_s
        next_alive = 0.0
        while not pred():
            now = time.monotonic()
            if now >= deadline:
                raise DPError(
                    f"rank {self.rank}: timed out after {self.timeout_s:.0f}s "
                    f"waiting for {what}")
            if self.alive is not None and now >= next_alive:
                self.alive()  # raises DPError when a peer is gone
                next_alive = now + 1.0
            self.cond.wait(timeout=min(0.2, deadline - now))

    def _writable(self, slot: int, k: int) -> bool:
        c = self._ctl[slot]
        drained = c[self._CONSUMED] == self.num_ranks
        return drained and (c[self._READY] in (k - self.depth, -1))

    # -- protocol -----------------------------------------------------------

    def contribute(self, k: int, leaves: Sequence[np.ndarray], order: int,
                   num_contrib: int, loss: float, batch_size: int) -> None:
        """Add this rank's payload for ring step ``k``.

        ``order`` is this rank's index among the step's contributors (the
        fixed reduction order); the first contributor copies, later ones
        accumulate in turn, so the sum is associativity-deterministic.
        The last contribution marks the slot ready."""
        slot = k % self.depth
        ctl = self._ctl
        with self.cond:
            if order == 0:
                self._await(lambda: self._writable(slot, k),
                            f"slot {slot} to drain (step {k})")
                ctl[slot, self._WRITING] = k
                ctl[slot, self._CONTRIB] = 0
            else:
                self._await(
                    lambda: (ctl[slot, self._WRITING] == k
                             and ctl[slot, self._CONTRIB] == order),
                    f"reduction turn {order} of step {k}")
            for view, leaf in zip(self._slots[slot], leaves):
                arr = np.asarray(leaf)
                if order == 0:
                    np.copyto(view, arr, casting="no")
                else:
                    view += arr
            self._loss[slot, self.rank] = float(loss)
            self._bs[slot, self.rank] = int(batch_size)
            ctl[slot, self._CONTRIB] += 1
            if ctl[slot, self._CONTRIB] == num_contrib:
                ctl[slot, self._READY] = k
                ctl[slot, self._CONSUMED] = 0
            self.cond.notify_all()

    def consume(self, k: int) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
        """Copy step ``k``'s reduced payload out of the ring (then ack).

        Returns ``(leaf copies, loss row, batch-size row)`` — copies, so
        the slot can be recycled immediately after the ack."""
        slot = k % self.depth
        with self.cond:
            self._await(lambda: self._ctl[slot, self._READY] == k,
                        f"publication of step {k}")
        # safe outside the lock: writers of step k+depth are blocked on
        # this slot's consumed count until every rank acks
        leaves = [np.array(v) for v in self._slots[slot]]
        loss = self._loss[slot].copy()
        bs = self._bs[slot].copy()
        self.ack(k)
        return leaves, loss, bs

    def ack(self, k: int) -> None:
        """Mark step ``k`` consumed by this rank (contributors that keep
        their own copy ack without reading)."""
        slot = k % self.depth
        with self.cond:
            self._ctl[slot, self._CONSUMED] += 1
            self.cond.notify_all()

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        self._slots = []
        self._ctl = self._loss = self._bs = None
        if self._attached is not None:
            att, self._attached = self._attached, None
            att.close()
        if self._owner_store is not None:
            self._owner_store.close()

    def unlink(self) -> None:
        self._slots = []
        self._ctl = self._loss = self._bs = None
        if self._owner_store is not None:
            store, self._owner_store = self._owner_store, None
            store.unlink()


def _exchange_arrays(template, num_ranks: int, depth: int) -> Dict[str, np.ndarray]:
    arrays: Dict[str, np.ndarray] = {}
    ctl = np.zeros((depth, 4), np.int64)
    ctl[:, DPExchange._WRITING] = -1
    ctl[:, DPExchange._READY] = -1
    ctl[:, DPExchange._CONSUMED] = num_ranks  # virgin slots are writable
    arrays["ctl"] = ctl
    arrays["loss"] = np.zeros((depth, num_ranks), np.float64)
    arrays["bs"] = np.zeros((depth, num_ranks), np.int64)
    for j in range(depth):
        for n, (shape, dtype) in enumerate(template):
            arrays[f"s{j}/{n}"] = np.zeros(shape, np.dtype(dtype))
    return arrays


def create_exchange(template_leaves, num_ranks: int, cond,
                    depth: int = _DEPTH,
                    timeout_s: float = _TIMEOUT_S) -> DPExchange:
    """Rank 0 (the session process) allocates the exchange segment sized
    for ``template_leaves`` (the flattened payload pytree) and returns its
    writable client; ``.handle`` on the client's ``owner_store`` travels
    to the spawned trainers."""
    template = _leaf_template(template_leaves)
    store = share_arrays(
        _exchange_arrays(template, num_ranks, depth),
        meta={"kind": "dp-exchange", "num_ranks": str(num_ranks),
              "depth": str(depth), "leaves": str(len(template))},
    )
    ex = DPExchange(store.arrays(), cond, 0, num_ranks, depth,
                    len(template), timeout_s, owner_store=store)
    ex.handle = store.handle
    return ex


def attach_exchange(handle: ArraysHandle, cond, rank: int,
                    template_leaves=None,
                    timeout_s: float = _TIMEOUT_S) -> DPExchange:
    """A spawned trainer's writable client of an existing exchange.

    When ``template_leaves`` is given, their (shape, dtype) layout is
    checked against the segment's — a mismatch means the child's
    deterministic rebuild diverged from the parent's, which would corrupt
    the reduction; fail before touching the ring."""
    meta = handle.meta_dict
    num_ranks = int(meta["num_ranks"])
    depth = int(meta["depth"])
    num_leaves = int(meta["leaves"])
    if template_leaves is not None:
        refs = dict(handle.arrays)
        want = _leaf_template(template_leaves)
        if len(want) != num_leaves:
            raise DPError(
                f"rank {rank}: exchange has {num_leaves} payload leaves, "
                f"local state has {len(want)}")
        for n, (shape, dtype) in enumerate(want):
            ref = refs[f"s0/{n}"]
            if tuple(ref.shape) != shape or np.dtype(ref.dtype) != np.dtype(dtype):
                raise DPError(
                    f"rank {rank}: payload leaf {n} mismatch — exchange "
                    f"{tuple(ref.shape)}/{ref.dtype}, local {shape}/{dtype}")
    shm = _open_attached(handle.segment, handle.owner_pid)
    views = {k: _view(shm.buf, r, writeable=True) for k, r in handle.arrays}
    return DPExchange(views, cond, rank, num_ranks, depth, num_leaves,
                      timeout_s, attached_shm=shm)


# --------------------------------------------------------------------------
# per-trainer loop
# --------------------------------------------------------------------------


class _Prefetch:
    """Sample+stage this trainer's upcoming batches in a daemon thread so
    host work overlaps the exchange waits (``scale.overlap``); with
    ``overlap=False`` staging runs inline (the barrier debugging mode).
    Errors surface on the consuming ``get``."""

    def __init__(self, make: Callable[[int], tuple], steps: Sequence[int],
                 depth: int = 2, overlap: bool = True):
        self._make = make
        self._overlap = overlap
        self._err: Optional[BaseException] = None
        if not overlap:
            return
        self._q: "queue.Queue" = queue.Queue(max(1, depth))
        self._stop = threading.Event()
        self._steps = list(steps)
        self._thread = threading.Thread(
            target=self._run, name="dp-prefetch", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for i in self._steps:
                t0 = time.perf_counter()
                item = self._make(i)
                host_s = time.perf_counter() - t0
                while not self._stop.is_set():
                    try:
                        self._q.put((i, item, host_s), timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # surfaced by get()
            self._err = e
            try:
                self._q.put_nowait(None)
            except queue.Full:
                pass

    def get(self, i: int):
        if not self._overlap:
            t0 = time.perf_counter()
            item = self._make(i)
            return item, time.perf_counter() - t0
        while True:
            if self._err is not None:
                raise self._err
            try:
                got = self._q.get(timeout=0.5)
            except queue.Empty:
                continue
            if got is None:
                if self._err is not None:
                    raise self._err
                raise DPError("prefetch thread exited unexpectedly")
            step, item, host_s = got
            if step != i:
                raise DPError(f"prefetch out of order: wanted {i}, got {step}")
            return item, host_s

    def close(self) -> None:
        if not self._overlap:
            return
        self._stop.set()
        while True:  # unblock a producer stuck on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=2.0)


def _host_leaves(tree) -> List[np.ndarray]:
    # at-least-1-d is the exchange wire contract: shm's ascontiguousarray
    # promotes 0-d arrays (e.g. the Adam step counter) to (1,) anyway, so
    # canonicalise here and restore the true shape in _adopt
    from repro_torch.optim.adam import tree_leaves

    return [np.atleast_1d(x.detach().cpu().numpy()) for x in tree_leaves(tree)]


def _adopt(tree, host_leaves: Sequence[np.ndarray]):
    """Rebuild ``tree`` from exchanged host bytes, each leaf on its
    predecessor's device as its dtype (exact bytes in, exact values out)."""
    import torch

    from repro_torch.optim.adam import tree_leaves, tree_map

    fresh = {
        id(x): torch.from_numpy(  # undo the at-least-1-d wire shape
            np.asarray(h).reshape(tuple(x.shape))).to(device=x.device, dtype=x.dtype)
        for x, h in zip(tree_leaves(tree), host_leaves)
    }
    return tree_map(lambda x: fresh[id(x)], tree)


def state_sha(state) -> str:
    """Order-stable content hash of a state tree (cross-rank identity
    checks at the end of every DP fit)."""
    import hashlib

    from repro_torch.optim.adam import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(state):
        a = np.ascontiguousarray(leaf.detach().cpu().numpy())
        h.update(str(a.shape).encode())
        h.update(a.dtype.str.encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _hierarchy(sess):
    from repro_torch.core.meta_partition import hierarchical_partition

    g, s = sess.config.scale.resolved_hierarchy
    return hierarchical_partition(
        sess.graph, g, s, num_layers=sess.config.num_layers,
        seed=sess.config.run.seed)


def _dp_loop_global(sess, exch: DPExchange, rank: int, num_ranks: int,
                    start_step: int, steps: int, overlap: bool) -> List[float]:
    """Stripe discipline: owner of step ``i`` (rank ``i % N``) runs the
    fused step and publishes the updated state; everyone else adopts it.
    Returns the global loss trajectory (bit-identical to single-process)."""
    ex, plan = sess.executor, sess.plan
    state = sess.state
    B = sess.config.data.batch_size
    owned = [start_step + k for k in range(steps)
             if k % num_ranks == rank]

    def make(i):
        b = sess._batch_for_step(i)
        return b, ex.stage(sess, plan, b)

    pf = _Prefetch(make, owned, overlap=overlap)
    losses: List[float] = []
    try:
        for k in range(steps):
            i = start_step + k
            if k % num_ranks == rank:
                (b, arrays), host_s = pf.get(i)
                state, loss, dt = ex.step_staged(sess, plan, state, b, arrays)
                exch.contribute(k, _host_leaves(state), order=0,
                                num_contrib=1, loss=loss, batch_size=B)
                exch.ack(k)  # the owner keeps its own copy
                sess.host_times.append(host_s)
                sess.step_times.append(dt)
            else:
                leaves, loss_row, _ = exch.consume(k)
                state = _adopt(state, leaves)
                loss = float(loss_row[k % num_ranks])
            losses.append(loss)
    finally:
        pf.close()
    sess.state = state
    return losses


def _dp_loop_local(sess, exch: DPExchange, rank: int, num_ranks: int,
                   start_step: int, steps: int, overlap: bool) -> List[float]:
    """Ownership discipline: each rank draws sub-batches from the train
    nodes its hierarchy sub-partition owns, raw stack gradients are summed
    in fixed rank order, and every rank applies ``sync_stack_grads`` +
    Adam to the identical sum."""
    import torch

    from repro_torch.core import raf_spmd
    from repro_torch.data.worker_pool import EpochSchedule
    from repro_torch.graph.sampler import NeighborSampler
    from repro_torch.optim.adam import tree_map

    cfg = sess.config
    plan = sess.plan
    hier = _hierarchy(sess)
    owned_nodes = hier.trainer_train_nodes(sess.graph, rank)
    local_bs = max(1, cfg.data.batch_size // num_ranks)
    if len(owned_nodes) < local_bs:
        raise DPError(
            f"rank {rank} owns {len(owned_nodes)} train nodes < local batch "
            f"size {local_bs}; use fewer trainers or a larger graph")
    local_graph = dataclasses.replace(sess.graph, train_nodes=owned_nodes)
    sampler = NeighborSampler(local_graph, sess.spec, local_bs,
                              seed=cfg.run.seed + 1)
    sched = EpochSchedule(cfg.run.seed + 2 + 7919 * (rank + 1),
                          sampler.steps_per_epoch(), start_step=start_step)
    local_combine = cfg.partition.placement == "meta"

    def grad_step(stacks, arrays):
        loss, grads, _ = raf_spmd.grad_step(plan.plan, stacks, arrays, local_combine,
                                            cfg.kernels, learn_feats=False)
        return loss, grads

    share = 1.0 / num_ranks  # equal local batches -> sum of scaled = mean

    def make(k):
        es, idx = sched.seed_and_index(k)
        b = sampler.batch_at(idx, epoch_seed=es)
        return b, sess.executor.stage(sess, plan, b)

    pf = _Prefetch(make, range(steps), overlap=overlap)
    state = sess.state
    losses: List[float] = []
    try:
        for k in range(steps):
            (b, arrays), host_s = pf.get(k)
            t0 = time.perf_counter()
            loss_r, grads = grad_step(state["stacks"], arrays)
            grads = tree_map(lambda g: g * share, grads)
            loss_r = float(loss_r)
            exch.contribute(k, _host_leaves(grads), order=rank,
                            num_contrib=num_ranks, loss=loss_r,
                            batch_size=local_bs)
            # the prefetch thread stages batch k+1 while this blocks
            sum_leaves, loss_row, bs_row = exch.consume(k)
            gsum = _adopt(grads, sum_leaves)
            stacks, opt = raf_spmd.apply_step(plan.plan, sess.adam_cfg, state["stacks"],
                                              state["opt"], gsum)
            if sess.device.type == "cuda":
                torch.cuda.synchronize(sess.device)
            state = {"stacks": stacks, "opt": opt}
            sess.host_times.append(host_s)
            sess.step_times.append(time.perf_counter() - t0)
            # fixed-order float64 combine -> identical float on every rank
            losses.append(float((loss_row * bs_row).sum() / bs_row.sum()))
    finally:
        pf.close()
    sess.state = state
    return losses


def _dp_loop(sess, exch, rank, num_ranks, start_step, steps, mode, overlap):
    if mode == "local":
        return _dp_loop_local(sess, exch, rank, num_ranks, start_step, steps,
                              overlap)
    return _dp_loop_global(sess, exch, rank, num_ranks, start_step, steps,
                           overlap)


def _payload_template(sess, mode):
    """The exchanged pytree per discipline: full executor state (global)
    or the stack gradients, which share the stacks' structure (local)."""
    tree = sess.state if mode == "global" else sess.state["stacks"]
    return _host_leaves(tree)


# --------------------------------------------------------------------------
# spawned trainer entry
# --------------------------------------------------------------------------


def _trainer_main(cfg_dict: Dict, store_handle, exch_handle, cond, rank: int,
                  num_ranks: int, start_step: int, steps: int, mode: str,
                  overlap: bool, parent_pid: int, result_q, device: str,
                  num_threads: int) -> None:
    """Entry of a spawned trainer: attach the shared store, rebuild the
    deterministic session on ``device`` with ``num_threads`` intra-op
    threads (the parent's), join the exchange, run the loop, report."""
    import torch

    from repro_torch.api.config import HetaConfig
    from repro_torch.api.session import Heta
    from repro_torch.graph.mmap_store import attach_any
    from repro_torch.kernels.ops import KERNELS, reset_launch_counts

    def parent_alive():
        try:
            os.kill(parent_pid, 0)
        except OSError:
            raise DPError(f"rank {rank}: parent process {parent_pid} is gone")

    attached = None
    exch = None
    try:
        # the pool-less profile pass is bit-identical to the pooled one;
        # don't nest sampler pools inside trainer processes
        cfg = HetaConfig.from_dict(cfg_dict).updated(
            pipeline=dict(num_workers=0))
        torch.set_num_threads(num_threads)
        attached = attach_any(store_handle)
        sess = Heta(cfg, device=device)
        sess.build_graph(graph=attached.graph)
        sess.partition()
        sess.profile_and_cache()
        sess.compile()
        exch = attach_exchange(exch_handle, cond, rank,
                               template_leaves=_payload_template(sess, mode))
        exch.alive = parent_alive
        reset_launch_counts()  # count this rank's loop only
        loop_start = time.time()
        t0 = time.perf_counter()
        losses = _dp_loop(sess, exch, rank, num_ranks, start_step, steps,
                          mode, overlap)
        result_q.put({
            "rank": rank,
            "ok": True,
            "losses": losses,
            "state_sha": state_sha(sess.state),
            "wall_s": time.perf_counter() - t0,
            "host_s": float(sum(sess.host_times)),
            "device_s": float(sum(sess.step_times)),
            "kernel_launches": {
                name: {"launches": info.launches,
                       "shapes": [[list(k), c] for k, c in info.shapes.items()]}
                for name, info in KERNELS.items()},
            "loop_start": loop_start,
        })
    except BaseException as e:
        try:
            result_q.put({"rank": rank, "ok": False,
                          "error": f"{type(e).__name__}: {e}"})
        except Exception:
            pass
        raise
    finally:
        if exch is not None:
            exch.close()
        if attached is not None:
            attached.close()


# --------------------------------------------------------------------------
# the fit itself (rank 0 = the calling session's process)
# --------------------------------------------------------------------------


def _share_store(sess):
    kind = sess.config.scale.store
    if kind == "mmap":
        from repro_torch.graph.mmap_store import mmap_share_graph

        return mmap_share_graph(sess.graph, include_features=True)
    from repro_torch.graph.shm import share_graph

    return share_graph(sess.graph, include_features=True)


def run_dp_fit(sess, steps: int, timeout_s: float = _TIMEOUT_S) -> Dict:
    """Drive one multi-process data-parallel fit (see module docstring).

    The calling session is trainer rank 0: it exports the graph into the
    configured shared store, allocates the exchange, spawns ranks
    ``1..N-1`` (spawn context — trainer children need their own torch and,
    on the GPU, their own CUDA context) on the session's device,
    runs its own loop, then cross-checks every child's loss trajectory
    and final-state hash bitwise before tearing the segments down.
    Updates the session books (losses, step/host times, step position)
    exactly like the in-process fit, so ``results()``, ``evaluate()``
    and ``save()`` keep working afterwards."""
    import torch

    from repro_torch.api.session import HetaStageError

    cfg = sess.config
    sc = cfg.scale
    N = sc.num_trainers
    if getattr(sess.plan, "learn_feats", False) or (
            sc.mode == "local" and cfg.model.train_learnable):
        raise HetaStageError(
            "scale-out trains with frozen learnable tables "
            "(model.train_learnable=False): cross-trainer table-gradient "
            "exchange is a recorded DESIGN.md §13 follow-on")
    if sc.mode == "local" and sess.executor.name != "raf_spmd":
        raise HetaStageError(
            f"scale.mode='local' needs the raf_spmd executor (gradient "
            f"extraction), got {sess.executor.name!r}")
    if sess.device.type == "cuda":
        # one build before the spawn: the ranks only load the libraries
        from repro_torch.kernels import build

        build.build()
    start_step = sess._steps_done
    t_wall = time.perf_counter()
    n0 = len(sess.step_times)
    ctx = mp.get_context("spawn")
    cond = ctx.Condition()
    result_q = ctx.Queue()
    store = _share_store(sess)
    exch = create_exchange(_payload_template(sess, sc.mode), N, cond,
                           timeout_s=timeout_s)
    procs: List[mp.Process] = []
    spawned_at: Dict[int, float] = {}
    try:
        from repro_torch.data.worker_pool import _spawnable_main

        with _spawnable_main():  # heredoc-script-safe spawn (see worker_pool)
            for rank in range(1, N):
                p = ctx.Process(
                    target=_trainer_main,
                    args=(cfg.to_dict(), store.handle, exch.handle, cond,
                          rank, N, start_step, steps, sc.mode, sc.overlap,
                          os.getpid(), result_q, str(sess.device),
                          torch.get_num_threads()),
                    name=f"dp-trainer-{rank}",
                    daemon=True,
                )
                spawned_at[rank] = time.time()
                p.start()
                procs.append(p)

        def peers_alive():
            dead = [p.name for p in procs
                    if p.exitcode is not None and p.exitcode != 0]
            if dead:
                raise DPError(f"trainer process(es) died: {dead}")

        exch.alive = peers_alive
        losses = _dp_loop(sess, exch, 0, N, start_step, steps, sc.mode,
                          sc.overlap)
        sha0 = state_sha(sess.state)

        # collect + cross-check every child before declaring success
        reports: Dict[int, Dict] = {}
        deadline = time.monotonic() + timeout_s
        while len(reports) < N - 1:
            peers_alive()
            try:
                r = result_q.get(timeout=0.5)
            except queue.Empty:
                if time.monotonic() >= deadline:
                    missing = sorted(set(range(1, N)) - set(reports))
                    raise DPError(
                        f"timed out waiting for trainer report(s) {missing}")
                continue
            reports[r["rank"]] = r
        failed = {k: r["error"] for k, r in reports.items() if not r["ok"]}
        if failed:
            raise DPError(f"trainer failure(s): {failed}")
        for rank, r in sorted(reports.items()):
            if r["losses"] != losses:
                raise DPError(
                    f"rank {rank} loss trajectory diverged from rank 0 "
                    f"(determinism violation)")
            if r["state_sha"] != sha0:
                raise DPError(
                    f"rank {rank} final state hash {r['state_sha'][:12]}… != "
                    f"rank 0 {sha0[:12]}… (determinism violation)")
        for p in procs:
            p.join(timeout=30.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10.0)
        exch.unlink()
        store.unlink()
        result_q.close()

    # session books — mirrors the in-process fit's accounting
    sess.losses.extend(losses)
    sess._steps_done += steps
    wall = time.perf_counter() - t_wall
    sess._fit_wall_s += wall
    sess._fit_steps += steps
    sess._fit_serial_s += (sum(sess.host_times[n0:])
                           + sum(sess.step_times[n0:]))
    g, s = sc.resolved_hierarchy
    out = sess.results()
    out["scale"] = {
        "num_trainers": N,
        "hierarchy": [g, s],
        "mode": sc.mode,
        "store": sc.store,
        "overlap": sc.overlap,
        "state_sha": sha0,
        "trainer_wall_s": {r: rep["wall_s"] for r, rep in
                           sorted(reports.items())},
        "fit_wall_s": wall,
        "trainer_reports": {r: {k: v for k, v in rep.items() if k != "losses"}
                            for r, rep in sorted(reports.items())},
        "startup_s": {r: rep["loop_start"] - spawned_at[r]
                      for r, rep in sorted(reports.items())},
    }
    return out
