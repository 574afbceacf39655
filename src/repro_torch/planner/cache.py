"""Size-bucketed, thread-safe LRU plan cache with JSON disk persistence.

Message sizes are continuous but plans are not size-sensitive within a
small factor, so requests are snapped to *geometric buckets*: bucket k
covers (base·g^(k-1), base·g^k] and is represented by its upper bound.
Every request inside a bucket shares one cached plan, which keeps the
cache small (log-many buckets across the whole useful size range) while
bounding the pricing error a shared plan can introduce.

Entries are JSON-serializable dicts (see plan_to_json/plan_from_json), so
`save()`/`load()` round-trip through disk and warm plans survive process
restarts.
"""
from __future__ import annotations

import json
import math
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field

from repro_torch.core.plans import Plan, ReduceOp, Step, Transfer
from repro_torch.runtime.metrics import default_metrics


# ---------------------------------------------------------------------------
# Plan IR <-> JSON
# ---------------------------------------------------------------------------
def _blk(b) -> tuple[int, ...] | None:
    return None if b is None else tuple(int(x) for x in b)


def plan_to_json(plan: Plan) -> dict:
    """Serialize the plan, block annotations included — a disk-warm plan
    must stay lowerable (`core.lower`) after the round-trip. The 4-tuple
    rows stay readable by pre-block-IR entries (3-tuples load as
    unannotated)."""
    return {
        "name": plan.name, "n": plan.n, "size": plan.size,
        "servers": plan.servers, "num_blocks": plan.num_blocks,
        "family": plan.family,
        "steps": [{
            "transfers": [[t.src, t.dst, t.size,
                           None if t.blocks is None else list(t.blocks)]
                          for t in st.transfers],
            "reduces": [[r.server, r.fan_in, r.size,
                         None if r.blocks is None else list(r.blocks)]
                        for r in st.reduces],
        } for st in plan.steps],
    }


def plan_from_json(d: dict) -> Plan:
    steps = []
    for sd in d["steps"]:
        st = Step()
        st.transfers = [Transfer(int(row[0]), int(row[1]), float(row[2]),
                                 blocks=_blk(row[3]) if len(row) > 3
                                 else None)
                        for row in sd["transfers"]]
        st.reduces = [ReduceOp(int(row[0]), int(row[1]), float(row[2]),
                               blocks=_blk(row[3]) if len(row) > 3
                               else None)
                      for row in sd["reduces"]]
        steps.append(st)
    nb = d.get("num_blocks")
    return Plan(d["name"], int(d["n"]), float(d["size"]), steps=steps,
                servers=d.get("servers"),
                num_blocks=None if nb is None else int(nb),
                family=str(d.get("family", "allreduce")))


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    disk_loads: int = 0
    puts: int = 0
    load_errors: int = 0     # corrupt entries/files skipped by load()

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    COUNTERS = ("hits", "misses", "evictions", "disk_loads", "puts",
                "load_errors")

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "disk_loads": self.disk_loads,
                "puts": self.puts, "load_errors": self.load_errors,
                "hit_rate": self.hit_rate}

    def absorb(self, d: dict) -> None:
        """Accumulate persisted counters (a restored snapshot's lifetime
        stats) into this instance; unknown/derived keys (hit_rate) are
        ignored."""
        for k in self.COUNTERS:
            v = d.get(k)
            if isinstance(v, (int, float)):
                setattr(self, k, getattr(self, k) + int(v))


class PlanCache:
    """LRU over canonical plan keys. Values are JSON-serializable dicts;
    callers attach deserialized objects under the `_obj` key (kept out of
    the persisted form) to avoid re-parsing on every warm hit."""

    def __init__(self, capacity: int = 128, *, bucket_base: int = 4096,
                 bucket_growth: float = 2.0, path: str | None = None,
                 autosave: bool = False):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if bucket_growth <= 1.0:
            raise ValueError("bucket_growth must be > 1")
        self.capacity = capacity
        self.bucket_base = int(bucket_base)
        self.bucket_growth = float(bucket_growth)
        self.path = path
        self.autosave = autosave
        self.stats = CacheStats()
        self._lock = threading.RLock()
        self._entries: OrderedDict[str, dict] = OrderedDict()
        if path and os.path.exists(path):
            self.load(path)

    # ---- size bucketing ----------------------------------------------------
    def bucket(self, nbytes: int | float) -> int:
        """Snap a request size to its geometric bucket's representative
        (upper-bound) size. bucket(base) == base; bucket(base+1) == the
        next bucket up."""
        nbytes = float(nbytes)
        if nbytes <= self.bucket_base:
            return self.bucket_base
        k = math.ceil(round(
            math.log(nbytes / self.bucket_base)
            / math.log(self.bucket_growth), 12))
        return int(round(self.bucket_base * self.bucket_growth ** k))

    # ---- core ops ----------------------------------------------------------
    def get(self, key: str) -> dict | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.stats.misses += 1
                default_metrics().counter(
                    "plan_cache_misses_total",
                    "plan-cache lookups that missed").inc()
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            default_metrics().counter(
                "plan_cache_hits_total",
                "plan-cache lookups served warm").inc()
            return entry

    def put(self, key: str, entry: dict) -> None:
        snapshot = None
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            self.stats.puts += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.evictions += 1
            if self.autosave and self.path:
                snapshot = self._snapshot_locked()
        m = default_metrics()
        m.counter("plan_cache_puts_total", "plan-cache inserts").inc()
        m.gauge("plan_cache_entries", "entries currently cached"
                ).set(len(self))
        # Serialize + write outside the lock: an autosave (whole-file JSON
        # rewrite) must not block concurrent get()s on the hot path.
        # Concurrent writers each replace atomically; last one wins.
        if snapshot is not None:
            self._write(self.path, *snapshot)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def drop_derived(self, kinds: tuple[str, ...] = ("bucket_plan",)) -> int:
        """Invalidate derived *executable* artifacts while keeping the
        priced plans: pops every entry's `_exec` map (lowered
        `CompiledSchedule`s, keyed by placement) and evicts whole entries
        whose `kind` is in `kinds` (bucket plans — their chosen size is a
        function of the axis sizes they were priced for). Returns the
        number of artifacts dropped. Used by
        `core.bucketing.invalidate_schedules` after a remesh/resume."""
        dropped = 0
        with self._lock:
            for key in list(self._entries):
                entry = self._entries[key]
                if entry.get("kind") in kinds:
                    del self._entries[key]
                    dropped += 1
                    continue
                execs = entry.pop("_exec", None)
                if execs:
                    dropped += len(execs)
        return dropped

    def derived_count(self, kinds: tuple[str, ...] = ("bucket_plan",)) -> int:
        """Number of derived executable artifacts currently cached
        (lowered schedules + bucket-plan entries) — the set
        `drop_derived` would remove."""
        with self._lock:
            count = 0
            for entry in self._entries.values():
                if entry.get("kind") in kinds:
                    count += 1
                else:
                    count += len(entry.get("_exec") or ())
            return count

    # ---- persistence -------------------------------------------------------
    def _snapshot_locked(self) -> tuple[dict, dict]:
        """(entries, stats) under the lock — the stats block rides in the
        snapshot so a restart reports true lifetime hit rates instead of
        starting the counters over."""
        entries = {k: {kk: vv for kk, vv in v.items()
                       if not kk.startswith("_")}
                   for k, v in self._entries.items()}
        stats = {k: getattr(self.stats, k) for k in CacheStats.COUNTERS}
        return entries, stats

    @staticmethod
    def _write(path: str, payload: dict, stats: dict | None = None) -> None:
        tmp = f"{path}.tmp{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "entries": payload,
                       "stats": stats or {}}, f)
        os.replace(tmp, path)

    def save(self, path: str | None = None) -> None:
        path = path or self.path
        if not path:
            raise ValueError("no persistence path configured")
        with self._lock:
            payload, stats = self._snapshot_locked()
        self._write(path, payload, stats)

    @staticmethod
    def _entry_valid(v) -> bool:
        """Structural validation of one persisted entry: a decodable file
        can still carry truncated/bit-flipped entries (DESIGN.md §12).
        Plan entries must round-trip `plan_from_json`; axis-plan and
        bucket-plan entries must carry their row lists. Never raises."""
        if not isinstance(v, dict):
            return False
        try:
            if "plan" in v:
                plan_from_json(v["plan"])
                return "algo" in v and "predicted_time" in v
            if "axis_plans" in v:
                return all(isinstance(row, (list, tuple)) and len(row) >= 3
                           for row in v["axis_plans"])
            if "bucket_floats" in v:     # bucket-plan sweep entry
                return "num_buckets" in v
        except Exception:
            return False
        return True    # unknown entry shape: let the reader decide

    def _count_load_error(self, n: int = 1) -> None:
        self.stats.load_errors += n
        default_metrics().counter(
            "planner_cache_load_errors_total",
            "corrupt plan-cache files/entries skipped at load").inc(n)

    def load(self, path: str | None = None) -> int:
        path = path or self.path
        if not path:
            raise ValueError("no persistence path configured")
        try:
            with open(path) as f:
                payload = json.load(f)
        except FileNotFoundError:
            return 0
        except (OSError, ValueError):
            # truncated/corrupt persistence file: startup proceeds with a
            # cold cache instead of crashing the service (DESIGN.md §12)
            with self._lock:
                self._count_load_error()
            return 0
        if not isinstance(payload, dict):
            with self._lock:
                self._count_load_error()
            return 0
        entries = payload.get("entries", {})
        if not isinstance(entries, dict):
            with self._lock:
                self._count_load_error()
            return 0
        bad = [k for k, v in entries.items() if not self._entry_valid(v)]
        for k in bad:
            entries.pop(k)
        with self._lock:
            if bad:
                self._count_load_error(len(bad))
            # restore lifetime counters BEFORE counting this load's disk
            # hits, so the persisted history and the fresh activity both
            # land exactly once
            stats = payload.get("stats")
            if isinstance(stats, dict):
                self.stats.absorb(stats)
            for k, v in entries.items():
                if k not in self._entries:
                    self._entries[k] = v
                    self.stats.disk_loads += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.evictions += 1
        return len(entries)
