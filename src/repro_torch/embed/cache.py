"""Miss-penalty-aware device feature cache (paper §6).

Two pieces:

  * :func:`allocate_cache` — the hierarchical allocation policy: the per-type
    cache budget is proportional to ``count_a × o_a`` (hotness × miss-penalty
    ratio), then each type's budget is filled with its hottest nodes.  A
    ``hotness_only`` switch reproduces the paper's ablation baseline.

  * :class:`FeatureCache` — a device cache (PyTorch tensors on the session's
    device) in front of host numpy feature tables.  Read-only types cache
    feature rows; learnable types cache the row *and* its Adam states
    (non-replicative: each row lives in exactly one place, paper §6 'Cache
    Consistency').  Multi-device splits use the paper's mod-hash: row
    ``nid`` belongs to shard ``nid % num_shards``.

All-hit fetches gather on the device through the ``gather_rows`` kernel
(``repro_torch.kernels.gather_rows``); mixed fetches assemble hits and host
misses with PyTorch indexing.  Online admission: every ``fetch`` bumps
per-node access counters, ``take_access_counts`` drains them, and
:meth:`FeatureCache.update_residency` moves the cache to a new plan
incrementally (kept rows stay on the device, evicted learnable rows write
home first, only admitted rows move host→device).

The learnable write path: ``fetch_states`` returns a minibatch's rows with
their row-aligned Adam states (hits from the device copy, misses from the
host), and ``write_learnable`` writes the updated triple back to its single
authoritative copy — device rows in place, host rows on the host.
``merged_learnable_state`` / ``residency`` / ``set_residency`` serve the
session's checkpoints, and ``consistency_check`` verifies the
non-replicative invariant (unique slots, the mod-hash shard rule).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.embed.profiler import HotnessProfile, MissPenaltyProfile, row_bytes

__all__ = ["CacheAllocation", "allocate_cache", "FeatureCache"]


# --------------------------------------------------------------------------
# allocation policy
# --------------------------------------------------------------------------


@dataclasses.dataclass
class CacheAllocation:
    rows: Dict[str, int]  # ntype -> number of cached rows
    bytes_: Dict[str, int]  # ntype -> bytes allotted
    total_bytes: int
    policy: str

    def render(self) -> str:
        lines = [f"  cache allocation ({self.policy}, {self.total_bytes/2**20:.0f} MiB):"]
        for t in sorted(self.rows):
            lines.append(
                f"    {t:<18} rows={self.rows[t]:>9,}  {self.bytes_[t]/2**20:8.1f} MiB"
            )
        return "\n".join(lines)


def allocate_cache(
    hotness: HotnessProfile,
    penalties: MissPenaltyProfile,
    total_bytes: int,
    num_nodes: Dict[str, int],
    hotness_only: bool = False,
    bytes_per_elem: int = 4,
) -> CacheAllocation:
    """Split ``total_bytes`` across node types ∝ count_a × o_a (paper §6).

    ``hotness_only=True`` drops the o_a factor (ablation baseline).  Budgets
    are capped at the type's full table size; freed budget is redistributed
    proportionally among uncapped types.
    """
    types = sorted(penalties.ratios)
    score = {
        t: float(hotness.total(t)) * (1.0 if hotness_only else penalties.ratios[t])
        for t in types
    }
    rbytes = {
        t: row_bytes(penalties.dims[t], penalties.learnable[t], bytes_per_elem)
        for t in types
    }
    cap = {t: num_nodes[t] * rbytes[t] for t in types}
    alloc = {t: 0.0 for t in types}
    remaining, active = float(total_bytes), set(t for t in types if score[t] > 0)
    # waterfill: proportional split, capping saturated types and reflowing
    while remaining > 1 and active:
        tot = sum(score[t] for t in active)
        newly_capped = set()
        spent = 0.0
        for t in active:
            give = remaining * score[t] / tot
            room = cap[t] - alloc[t]
            take = min(give, room)
            alloc[t] += take
            spent += take
            if alloc[t] >= cap[t] - 1e-6:
                newly_capped.add(t)
        remaining -= spent
        active -= newly_capped
        if not newly_capped:
            break
    rows = {t: int(alloc[t] // rbytes[t]) for t in types}
    return CacheAllocation(
        rows=rows,
        bytes_={t: rows[t] * rbytes[t] for t in types},
        total_bytes=total_bytes,
        policy="hotness-only" if hotness_only else "hotness×miss-penalty",
    )


# --------------------------------------------------------------------------
# the cache itself
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _TypeCache:
    ids: np.ndarray  # [C] cached node ids (host copy for bookkeeping)
    slot_of: np.ndarray  # [num_nodes] -> cache slot or -1
    data: torch.Tensor  # [C, d] cached rows (device)
    m: Optional[torch.Tensor]  # [C, d] Adam moment (learnable only)
    v: Optional[torch.Tensor]  # [C, d] Adam variance
    shard_of: np.ndarray  # [C] mod-hash shard of each cached row
    hits: int = 0
    misses: int = 0


class FeatureCache:
    """Device cache over host tables with per-type budgets.

    ``host_tables``: ntype -> np.ndarray features.  For learnable types the
    host table *is* the learnable parameter store; its Adam states live in
    ``host_m``/``host_v``.  ``fetch`` returns gathered rows as a tensor on
    ``device`` (``None``: the GPU, or ``NoGPUError`` without one).
    """

    def __init__(
        self,
        host_tables: Dict[str, np.ndarray],
        learnable_types: Dict[str, int],  # ntype -> dim
        allocation: CacheAllocation,
        hotness: HotnessProfile,
        num_shards: int = 1,
        kernels=None,
        device=None,
    ):
        self.host = dict(host_tables)
        self.learnable = dict(learnable_types)
        self.num_shards = num_shards
        self.device = resolve_device(device)
        # guards the hit/miss and access counters against concurrent readers
        self._stats_lock = threading.Lock()
        # per-node access counters for online re-admission: every fetch
        # bumps the rows it touched (hits and misses alike)
        self._access: Dict[str, np.ndarray] = {
            t: np.zeros(a.shape[0], np.float64) for t, a in self.host.items()
        }
        # kernels config knob: all-hit gathers go through the gather_rows
        # kernel op (kernels.gather)
        self.kernels = kernels
        self.host_m: Dict[str, np.ndarray] = {}
        self.host_v: Dict[str, np.ndarray] = {}
        self.caches: Dict[str, _TypeCache] = {}
        for t, dim in learnable_types.items():
            if t not in self.host:
                raise ValueError(f"learnable type {t} missing host table")
            self.host_m[t] = np.zeros_like(self.host[t])
            self.host_v[t] = np.zeros_like(self.host[t])
        for t, n_rows in allocation.rows.items():
            if n_rows <= 0 or t not in self.host:
                continue
            ids = hotness.hottest(t, n_rows)
            slot_of = np.full(self.host[t].shape[0], -1, dtype=np.int64)
            slot_of[ids] = np.arange(len(ids))
            learn = t in self.learnable
            self.caches[t] = _TypeCache(
                ids=ids,
                slot_of=slot_of,
                data=self._to_device(self.host[t][ids]),
                m=self._to_device(self.host_m[t][ids]) if learn else None,
                v=self._to_device(self.host_v[t][ids]) if learn else None,
                shard_of=ids % num_shards,
            )

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- reads --------------------------------------------------------------

    def _device_gather(self, data: torch.Tensor, slots: np.ndarray) -> torch.Tensor:
        """Device-side gather of cached rows — the paper-§6 cache fetch hot
        path, through the ``gather_rows`` kernel op when ``kernels.gather``
        is on."""
        from repro_torch.kernels.gather_rows import gather_rows_cfg

        return gather_rows_cfg(data, slots, self.kernels)

    def fetch(self, ntype: str, nids: np.ndarray) -> torch.Tensor:
        """Gather rows for ``nids``; cache hits read device memory, misses
        transfer from host.  Returns a device tensor [len(nids), d]."""
        with self._stats_lock:
            np.add.at(self._access[ntype], nids, 1.0)
        c = self.caches.get(ntype)
        if c is None:
            return self._to_device(self.host[ntype][nids])
        slots = c.slot_of[nids]
        hit = slots >= 0
        with self._stats_lock:
            c.hits += int(hit.sum())
            c.misses += int((~hit).sum())
        if hit.all():
            return self._device_gather(c.data, slots)
        # partial hits: hits from the device copy, misses from the host
        out = torch.empty((len(nids), self.host[ntype].shape[1]),
                          dtype=c.data.dtype, device=self.device)
        hit_pos = torch.from_numpy(np.nonzero(hit)[0]).to(self.device)
        miss_pos = torch.from_numpy(np.nonzero(~hit)[0]).to(self.device)
        out[hit_pos] = c.data[torch.from_numpy(slots[hit]).to(self.device)]
        out[miss_pos] = self._to_device(self.host[ntype][nids[~hit]])
        return out

    def fetch_states(self, ntype: str, nids: np.ndarray):
        """(rows, m, v) on the device for a learnable type: the rows through
        :meth:`fetch` (so hit/miss counters and the all-hit gather kernel
        apply), the Adam states from the device copy for hits and the host
        for misses."""
        rows = self.fetch(ntype, nids)
        c = self.caches.get(ntype)
        if c is None or c.m is None:
            return (rows, self._to_device(self.host_m[ntype][nids]),
                    self._to_device(self.host_v[ntype][nids]))
        slots = c.slot_of[nids]
        hit = slots >= 0
        if hit.all():
            sl = torch.from_numpy(slots).to(self.device)
            return rows, c.m[sl], c.v[sl]
        m = self._to_device(self.host_m[ntype][nids])
        v = self._to_device(self.host_v[ntype][nids])
        if hit.any():
            pos = torch.from_numpy(np.nonzero(hit)[0]).to(self.device)
            sl = torch.from_numpy(slots[hit]).to(self.device)
            m[pos] = c.m[sl]
            v[pos] = c.v[sl]
        return rows, m, v

    def write_learnable(self, ntype: str, nids: np.ndarray, rows: torch.Tensor,
                        m: torch.Tensor, v: torch.Tensor) -> None:
        """Write updated learnable rows (and their Adam states) to their
        single authoritative copy: cached rows on the device, the rest on
        the host."""
        if ntype not in self.learnable:
            raise ValueError(f"{ntype} is not learnable")
        c = self.caches.get(ntype)
        if c is None:
            self.host[ntype][nids] = rows.cpu().numpy()
            self.host_m[ntype][nids] = m.cpu().numpy()
            self.host_v[ntype][nids] = v.cpu().numpy()
            return
        slots = c.slot_of[nids]
        hit = slots >= 0
        if hit.any():
            sl = torch.from_numpy(slots[hit]).to(self.device)
            sel = torch.from_numpy(np.nonzero(hit)[0]).to(self.device)
            c.data[sl] = rows[sel]
            c.m[sl] = m[sel]
            c.v[sl] = v[sel]
        if (~hit).any():
            miss = nids[~hit]
            sel = torch.from_numpy(np.nonzero(~hit)[0]).to(rows.device)
            self.host[ntype][miss] = rows[sel].cpu().numpy()
            self.host_m[ntype][miss] = m[sel].cpu().numpy()
            self.host_v[ntype][miss] = v[sel].cpu().numpy()

    def fetch_many(self, requests: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Batched multi-type lookup: one device gather per node type.

        ``requests`` maps ntype -> nid array (any integer dtype / shape [n]).
        The serving hot path coalesces every request in a micro-batch flush
        into a single ``fetch_many`` call, so a flush costs one gather per
        *type* rather than one per request; hit/miss counters accrue exactly
        as the equivalent sequence of :meth:`fetch` calls would."""
        return {
            t: self.fetch(t, np.asarray(nids, dtype=np.int64))
            for t, nids in requests.items()
            if len(nids)
        }

    # -- online admission (observed-traffic residency) -------------------------

    def take_access_counts(self, reset: bool = True) -> Dict[str, np.ndarray]:
        """Drain the per-node access counters (ntype -> float64 [num_nodes]).

        ``reset=True`` (the default) zeroes them, so successive calls see
        disjoint observation windows — the natural input for an EMA."""
        with self._stats_lock:
            out = {t: a.copy() for t, a in self._access.items()}
            if reset:
                for a in self._access.values():
                    a[:] = 0.0
        return out

    def update_residency(
        self, allocation: CacheAllocation, hotness: HotnessProfile
    ) -> Dict[str, Dict[str, int]]:
        """Incrementally move the cache to a new allocation/hotness plan.

        Per type: the new resident set is the plan's ``rows[t]`` hottest
        ids.  Rows resident under both plans are *kept* — their device
        copy is gathered in place, no host traffic.  Evicted learnable
        rows write row + Adam states back to host before leaving.  Only
        admitted rows transfer host→device.  Each type's cache is rebuilt
        and swapped in with one attribute assignment, so a concurrent
        ``fetch`` that already grabbed the old object sees a coherent
        (merely stale) view.

        Returns ntype -> {"kept", "admitted", "evicted"} row counts.
        """
        moves: Dict[str, Dict[str, int]] = {}
        dev = self.device
        for t in sorted(self.host):
            n_rows = int(allocation.rows.get(t, 0))
            old = self.caches.get(t)
            if n_rows <= 0 and old is None:
                continue
            new_ids = (
                np.asarray(hotness.hottest(t, n_rows), np.int64)
                if n_rows > 0 else np.zeros(0, np.int64)
            )
            old_slots = (
                old.slot_of[new_ids] if old is not None
                else np.full(len(new_ids), -1, np.int64)
            )
            kept = old_slots >= 0
            n_evicted = 0
            if old is not None:
                stay = np.zeros(len(old.ids), bool)
                stay[old_slots[kept]] = True
                ev = ~stay
                n_evicted = int(ev.sum())
                if n_evicted and t in self.learnable:
                    ev_ids = old.ids[ev]
                    ev_sl = torch.from_numpy(np.nonzero(ev)[0]).to(dev)
                    self.host[t][ev_ids] = old.data[ev_sl].cpu().numpy()
                    self.host_m[t][ev_ids] = old.m[ev_sl].cpu().numpy()
                    self.host_v[t][ev_ids] = old.v[ev_sl].cpu().numpy()
            if n_rows <= 0:
                del self.caches[t]
                moves[t] = {"kept": 0, "admitted": 0, "evicted": n_evicted}
                continue
            dim = self.host[t].shape[1]
            dtype = torch.from_numpy(self.host[t][:0]).dtype
            learn = t in self.learnable
            data = torch.zeros((len(new_ids), dim), dtype=dtype, device=dev)
            m = torch.zeros_like(data) if learn else None
            v = torch.zeros_like(data) if learn else None
            if kept.any():
                dst = torch.from_numpy(np.nonzero(kept)[0]).to(dev)
                src = torch.from_numpy(old_slots[kept]).to(dev)
                data[dst] = old.data[src]
                if learn:
                    m[dst] = old.m[src]
                    v[dst] = old.v[src]
            if (~kept).any():
                dst = torch.from_numpy(np.nonzero(~kept)[0]).to(dev)
                admit = new_ids[~kept]
                data[dst] = self._to_device(self.host[t][admit])
                if learn:
                    m[dst] = self._to_device(self.host_m[t][admit])
                    v[dst] = self._to_device(self.host_v[t][admit])
            slot_of = np.full(self.host[t].shape[0], -1, dtype=np.int64)
            slot_of[new_ids] = np.arange(len(new_ids))
            self.caches[t] = _TypeCache(
                ids=new_ids,
                slot_of=slot_of,
                data=data,
                m=m,
                v=v,
                shard_of=new_ids % self.num_shards,
                hits=old.hits if old is not None else 0,
                misses=old.misses if old is not None else 0,
            )
            moves[t] = {
                "kept": int(kept.sum()),
                "admitted": int((~kept).sum()),
                "evicted": n_evicted,
            }
        return moves

    # -- checkpoint support ------------------------------------------------------

    def merged_learnable_state(self):
        """(tables, m, v): per learnable type, the host array with cached
        rows merged in — the coherent full-table state a checkpoint stores.
        Caller holds the engine's table lock."""
        tables, m, v = {}, {}, {}
        for t in self.learnable:
            tab = self.host[t].copy()
            mm = self.host_m[t].copy()
            vv = self.host_v[t].copy()
            c = self.caches.get(t)
            if c is not None:
                tab[c.ids] = c.data.cpu().numpy()
                if c.m is not None:
                    mm[c.ids] = c.m.cpu().numpy()
                    vv[c.ids] = c.v.cpu().numpy()
            tables[t], m[t], v[t] = tab, mm, vv
        return tables, m, v

    def residency(self) -> Dict[str, np.ndarray]:
        """ntype -> cached node ids (the §6 residency profile)."""
        return {t: c.ids.copy() for t, c in self.caches.items()}

    def set_residency(self, ids_by_type: Dict[str, np.ndarray]) -> None:
        """Rebuild every per-type cache to exactly these resident ids,
        sourcing rows (and Adam states) from the host tables — the restore
        path: callers write the authoritative full tables home first.
        Caller holds the engine's table lock."""
        for t in list(self.caches):
            if t not in ids_by_type:
                del self.caches[t]
        for t, ids in ids_by_type.items():
            if t not in self.host:
                continue
            ids = np.asarray(ids, np.int64)
            slot_of = np.full(self.host[t].shape[0], -1, dtype=np.int64)
            slot_of[ids] = np.arange(len(ids))
            learn = t in self.learnable
            old = self.caches.get(t)
            self.caches[t] = _TypeCache(
                ids=ids,
                slot_of=slot_of,
                data=self._to_device(self.host[t][ids]),
                m=self._to_device(self.host_m[t][ids]) if learn else None,
                v=self._to_device(self.host_v[t][ids]) if learn else None,
                shard_of=ids % self.num_shards,
                hits=old.hits if old is not None else 0,
                misses=old.misses if old is not None else 0,
            )

    # -- stats ----------------------------------------------------------------

    def hit_rates(self) -> Dict[str, float]:
        out = {}
        with self._stats_lock:
            for t, c in self.caches.items():
                tot = c.hits + c.misses
                out[t] = c.hits / tot if tot else 0.0
        return out

    def reset_stats(self) -> None:
        with self._stats_lock:
            for c in self.caches.values():
                c.hits = c.misses = 0

    def miss_time(self, penalties: MissPenaltyProfile, bytes_per_elem: int = 4) -> float:
        """Estimated seconds spent on cache misses so far (penalty model)."""
        t_total = 0.0
        with self._stats_lock:
            for t, c in self.caches.items():
                rb = row_bytes(penalties.dims[t], penalties.learnable[t], bytes_per_elem)
                t_total += c.misses * penalties.ratios[t] * rb
        return t_total

    def consistency_check(self) -> bool:
        """Non-replicative invariant: a cached row's host copy is never read
        or written — verify slots are unique and shard assignment follows the
        mod-hash rule (paper §6)."""
        for c in self.caches.values():
            if len(np.unique(c.ids)) != len(c.ids):
                return False
            if not np.array_equal(c.shard_of, c.ids % self.num_shards):
                return False
        return True
