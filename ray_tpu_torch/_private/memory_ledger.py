# Copied from ray_tpu/_private/memory_ledger.py (JAX-free): module names read ray_tpu_torch.
"""Cluster memory & per-job usage ledger.

The object plane already *tracks* everything the ledger needs — per
object ownership, size, pin state, spill state live in the daemon's
object table (`daemon.ObjectEntry`) — it just never *exported* it:
the metrics pipe only carried node-level aggregates
(`rt_object_store_bytes_used`, `rt_spilled_bytes`), so nobody could
answer whose bytes fill an arena or which job's pins block eviction.

Reference: the plasma store + raylet keep per-object ownership and
spill URLs queryable cluster-wide (`ray memory`,
util/state/memory_utils.py over ObjectTableData); the multi-tenant
scheduling literature (PAPERS.md ring-all-reduce fair-share) needs
*measured* per-job usage before quotas can be enforced. This module is
that measurement substrate.

Two halves:

* ``build_node_report`` — a pure fold of one node's object-table
  snapshot into a compact per-node memory report: arena used/capacity,
  per-(job, owner) byte totals, the top-K largest live objects,
  dead-owner pin candidates (owner pid probed node-locally), and the
  spill/restore op counters rates are differenced from. Runs OFF the
  hot path, on each daemon's memory-report tick
  (``memory_report_interval_s``) — the microbench ``memory_report_ms``
  keeps the fold honest at 10k live objects.

* ``MemoryLedger`` — the head-side aggregate: latest report per node,
  per-job byte·seconds (object bytes integrated over report
  intervals) and chip·seconds (from the step-telemetry records already
  flowing), spill/restore rates per node, and the doctor's
  ``verdict.memory``: nodes near arena capacity, leak suspects
  (objects held past ``doctor_leak_age_s`` by dead owners), and spill
  thrash (restore rate ≈ spill rate — the store is paging, not
  spilling cold data).

Exported series (ride ``metrics_summary`` → Prometheus ``/metrics``
and the head's time-series ring, so trends survive the live window):

* ``rt_job_object_bytes``             gauge    {job}
* ``rt_job_object_byte_seconds_total`` counter {job}
* ``rt_job_chip_seconds_total``        counter {job}
* ``rt_object_owner_bytes``           gauge    {job, owner kind}

Data-plane provenance (ISSUE 20): the ledger additionally folds the
two record kinds the object read path emits through the metrics pipe —
``transfer`` records (one per completed/aborted pull or spill restore,
emitted by the daemon that moved the bytes) and ``get`` records
(per-(provenance, src, task-class) aggregates drained from each
worker's get path, never one record per get) — into a bounded
per-(job, src_node, dst_node) transfer matrix plus per-job locality
counters:

* ``rt_object_transfer_bytes_total``  counter  {job, src, dst}
* ``rt_object_pull_ms``               gauge    {job, src, dst} (mean)
* ``rt_job_locality_hits_total``      counter  {job}
* ``rt_job_locality_misses_total``    counter  {job}
* ``rt_object_spills_total`` / ``rt_object_restores_total`` gain
  per-``{job}`` tag series merged alongside the core per-node series

Label cardinality is bounded by construction: jobs are few, src/dst
are NODE ids (the matrix is at most jobs x nodes^2, flows evicted past
``_MAX_FLOWS``), and the owner label carries the owning-context KIND
(driver/task/actor), never a per-entity id — a per-id or per-flow-id
label would mint one Prometheus series per task/transfer over the
cluster's lifetime, the exact pattern lint rule RT010 bans. The full
per-owner map is served by ``memory_summary`` / ``/api/memory``; the
full matrix (with task-class attribution) by ``transfer_summary`` /
``/api/transfers``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "build_node_report",
    "MemoryLedger",
    "NEAR_CAPACITY_FRACTION",
    "PROVENANCE_CLASSES",
]

#: Arena used/capacity fraction past which a node is "near capacity"
#: in the doctor verdict (above the spill threshold's 0.8 steady
#: state: a node the spiller cannot keep under 0.9 is in trouble).
NEAR_CAPACITY_FRACTION = 0.9

#: Dead-owner candidates carried per node report (size-descending;
#: a leak worth paging about is big, and the bound keeps reports
#: O(topk), not O(objects)).
_MAX_DEAD_OWNER_OBJECTS = 64

#: Spill ops per window below which thrash detection stays quiet —
#: a handful of pressure-driven spills is normal operation.
_THRASH_MIN_OPS = 4

#: Jobs tracked in the byte·s / chip·s accumulators before the
#: smallest consumers are evicted (bounded head memory forever).
_MAX_JOBS = 256

#: (job, src, dst) transfer-matrix rows kept before the smallest flow
#: is evicted — at most jobs x nodes^2 in practice, this cap is the
#: backstop against job churn minting rows forever.
_MAX_FLOWS = 512

#: (job, task-class) get-attribution rows kept (task classes are code,
#: bounded in practice; the cap bounds adversarial name churn).
_MAX_TASK_ROWS = 256

#: Remote bytes a task class must pull before the misplacement verdict
#: will convict it — nobody gets paged over a 100 KB arg.
_MISPLACED_MIN_BYTES = 1 << 20

#: Get provenance classes the worker read path reports (see
#: worker._record_get): where the resolved bytes actually came from.
PROVENANCE_CLASSES = (
    "inline",          # small value answered from a cache / the head table
    "local",           # local arena hit (the copy was already here)
    "pull",            # pulled from a remote node's arena
    "restore_local",   # restored from THIS node's spill storage
    "restore_remote",  # pulled from a REMOTE node's spill storage
)


def _flat_owner(job: str, owner: str) -> str:
    return f"{job}|{owner}"


def build_node_report(
    node: str,
    entries: Iterable[tuple],
    size_info: dict,
    spill_stats: Optional[dict] = None,
    spill_ops: int = 0,
    restore_ops: int = 0,
    job_spill_ops: Optional[Dict[str, int]] = None,
    job_restore_ops: Optional[Dict[str, int]] = None,
    topk: int = 20,
    now: Optional[float] = None,
    pid_alive: Optional[Callable[[int], bool]] = None,
) -> dict:
    """Fold one node's object-table snapshot into a memory report.

    ``entries`` is an iterable of tuples
    ``(oid, size, job, owner, owner_pid, created_ts, pinned, spilled,
    in_shm)`` — ``oid`` anything with ``.hex()`` (hex is only paid for
    the few objects that land in top-K / candidate lists). Pure except
    for the owner-pid liveness probe, which runs once per distinct pid
    and only for pids that produced still-held bytes.
    """
    now = time.time() if now is None else float(now)
    if pid_alive is None:
        pid_alive = _default_pid_alive()
    owners: Dict[str, dict] = {}
    attributed = 0
    shm_bytes = 0
    top: List[tuple] = []
    dead: List[tuple] = []
    alive_cache: Dict[int, bool] = {}

    def _alive(pid: int) -> bool:
        cached = alive_cache.get(pid)
        if cached is None:
            cached = alive_cache[pid] = bool(pid_alive(pid))
        return cached

    n_entries = 0
    for (
        oid,
        size,
        job,
        owner,
        owner_pid,
        created_ts,
        pinned,
        spilled,
        in_shm,
    ) in entries:
        n_entries += 1
        size = int(size)
        if in_shm:
            shm_bytes += size
        if job:
            row = owners.get(_flat_owner(job, owner))
            if row is None:
                row = owners[_flat_owner(job, owner)] = {
                    "job": job,
                    "owner": owner,
                    "bytes": 0,
                    "objects": 0,
                    "pinned_objects": 0,
                    "spilled_bytes": 0,
                }
            if in_shm:
                row["bytes"] += size
                attributed += size
            if spilled:
                row["spilled_bytes"] += size
            row["objects"] += 1
            if pinned:
                row["pinned_objects"] += 1
        record = (size, oid, job, owner, owner_pid, created_ts, pinned, spilled)
        top.append(record)
        if owner_pid and not _alive(owner_pid):
            dead.append(record)
    top.sort(key=lambda r: r[0], reverse=True)
    dead.sort(key=lambda r: r[0], reverse=True)

    def _obj_row(record: tuple) -> dict:
        size, oid, job, owner, owner_pid, created_ts, pinned, spilled = record
        return {
            "object_id": oid.hex() if hasattr(oid, "hex") else str(oid),
            "size": size,
            "job": job,
            "owner": owner,
            "owner_pid": owner_pid,
            "owner_alive": _alive(owner_pid) if owner_pid else True,
            "age_s": round(now - created_ts, 3) if created_ts else 0.0,
            "pinned": bool(pinned),
            "spilled": bool(spilled),
        }

    used = int(size_info.get("used", 0))
    spill_stats = spill_stats or {}
    return {
        "node": node,
        "time": now,
        "arena_used": used,
        "arena_capacity": int(size_info.get("capacity", 0)),
        "arena_objects": int(size_info.get("num_objects", 0)),
        "tracked_objects": n_entries,
        "shm_bytes": shm_bytes,
        "spilled_bytes": int(spill_stats.get("spilled_bytes", 0)),
        "spilled_objects": int(spill_stats.get("spilled_objects", 0)),
        "spill_ops_total": int(spill_ops),
        "restore_ops_total": int(restore_ops),
        # Cumulative per-job op counts (satellite: the verdict's
        # restore-dominated call must be job-named, and node-level
        # totals can't say WHOSE working set is paging). Latest-report
        # semantics like every other field: the ledger sums the latest
        # value across nodes, it never differences these.
        "job_spill_ops": {
            str(j): int(n) for j, n in (job_spill_ops or {}).items()
        },
        "job_restore_ops": {
            str(j): int(n) for j, n in (job_restore_ops or {}).items()
        },
        "owners": owners,
        "attributed_bytes": attributed,
        # Attribution is judged against what the arena reports in use:
        # allocator slack and ownerless objects both show up here.
        "attribution_fraction": round(attributed / used, 4) if used else 1.0,
        "top_objects": [_obj_row(r) for r in top[: max(0, int(topk))]],
        "dead_owner_objects": [
            _obj_row(r) for r in dead[:_MAX_DEAD_OWNER_OBJECTS]
        ],
    }


def _default_pid_alive() -> Callable[[int], bool]:
    def alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:
            return True  # exists, other uid
        except OSError:
            return True  # can't tell: never convict on a probe error
        return True

    return alive


class MemoryLedger:
    """Head-side aggregate over per-node memory reports.

    Bounded: one latest report per node, one accumulator row per job
    (smallest evicted past ``_MAX_JOBS``), rates from differencing the
    previous report's counters — nothing here grows with object count
    or cluster lifetime.
    """

    def __init__(self, max_owner_series: int = 20):
        self._lock = threading.Lock()
        self.reports: Dict[str, dict] = {}  # node -> latest report
        self._rates: Dict[str, dict] = {}  # node -> spill/restore rates
        self._job_byte_s: Dict[str, float] = {}
        self._job_chip_s: Dict[str, float] = {}
        self._max_owner_series = max(1, int(max_owner_series))
        # Transfer matrix: (job, src, dst) -> flow row. "bytes" counts
        # only COMPLETED transfers — an aborted pull bumps "aborted"
        # and nothing else, so a holder dying mid-pull can never be
        # double-billed as moved bytes (the retry that succeeds bills
        # them once).
        self._flows: Dict[Tuple[str, str, str], dict] = {}
        # Per-job get provenance: job -> {provenance: {gets, bytes,
        # wait_ms}} (provenance keys from PROVENANCE_CLASSES — fixed).
        self._job_prov: Dict[str, Dict[str, dict]] = {}
        # Per-job locality counters: job -> [hits, misses].
        self._locality: Dict[str, list] = {}
        # Per-(job, task-class) get attribution for the misplacement
        # verdict: remote vs local bytes, plus the src-node histogram
        # of the remote share.
        self._task_gets: Dict[Tuple[str, str], dict] = {}

    # -- folds ---------------------------------------------------------
    def fold(self, report: dict) -> None:
        """Fold one node report: replace the node's latest view,
        integrate per-job byte·seconds over the interval since the
        node's previous report, and difference spill/restore counters
        into rates."""
        node = str(report.get("node", ""))
        with self._lock:
            prev = self.reports.get(node)
            now = float(report.get("time", time.time()))
            if prev is not None:
                dt = now - float(prev.get("time", now))
                if 0.0 < dt < 3600.0:
                    for row in prev.get("owners", {}).values():
                        job = row.get("job", "")
                        if job:
                            self._bump(
                                self._job_byte_s, job, row["bytes"] * dt
                            )
                    spills = report.get("spill_ops_total", 0) - prev.get(
                        "spill_ops_total", 0
                    )
                    restores = report.get(
                        "restore_ops_total", 0
                    ) - prev.get("restore_ops_total", 0)
                    self._rates[node] = {
                        "window_s": round(dt, 3),
                        "spill_ops": max(0, spills),
                        "restore_ops": max(0, restores),
                        "spill_per_s": round(max(0, spills) / dt, 3),
                        "restore_per_s": round(max(0, restores) / dt, 3),
                    }
            self.reports[node] = report

    def add_step(self, record: dict) -> None:
        """Accumulate one step-telemetry record's chip·seconds — each
        (step, rank) record is ``step_ms`` of one chip's work for its
        job. Called at record-APPEND time (daemon
        ``_apply_metric_record``) so the accounting is exact: a
        periodic re-scan of the bounded diagnostic step ring would
        silently drop records that aged out between folds, and a
        wall-clock watermark would drop same-timestamp stragglers."""
        job = str(record.get("job", "") or "")
        if not job or record.get("warmup"):
            return
        with self._lock:
            self._bump(
                self._job_chip_s,
                job,
                float(record.get("step_ms", 0.0)) / 1000.0,
            )

    def record_transfer(
        self,
        job: str,
        src: str,
        dst: str,
        kind: str,
        nbytes: float,
        ms: float = 0.0,
    ) -> None:
        """Fold one daemon-side transfer record into the matrix.

        ``kind``: ``pull`` (remote arena -> dst), ``pull_spill``
        (remote node's SPILL storage -> dst: restore traffic that also
        crossed the wire), ``restore`` (dst's own spill -> dst arena),
        or ``aborted`` (a pull that died mid-flight: counted, never
        billed as transferred bytes)."""
        key = (str(job or ""), str(src or ""), str(dst or ""))
        with self._lock:
            row = self._flows.get(key)
            if row is None:
                row = self._flows[key] = {
                    "bytes": 0,
                    "ms": 0.0,
                    "pulls": 0,
                    "restores": 0,
                    "aborted": 0,
                    "restored_bytes": 0,
                }
                if len(self._flows) > _MAX_FLOWS:
                    victim = min(
                        (k for k in self._flows if k != key),
                        key=lambda k: self._flows[k]["bytes"],
                    )
                    self._flows.pop(victim)
            if kind == "aborted":
                row["aborted"] += 1
                return
            row["bytes"] += int(nbytes)
            row["ms"] += float(ms)
            if kind == "restore":
                row["restores"] += 1
                row["restored_bytes"] += int(nbytes)
            else:
                row["pulls"] += 1
                if kind == "pull_spill":
                    row["restored_bytes"] += int(nbytes)

    def record_gets(
        self,
        job: str,
        provenance: str,
        src: str,
        dst: str,
        task: str,
        count: float,
        nbytes: float,
        ms: float = 0.0,
    ) -> None:
        """Fold one worker-side get-provenance aggregate (a batch of
        ``count`` gets that resolved the same way): per-job provenance
        totals, the locality hit/miss counters, and the per-task-class
        remote-vs-local attribution the misplacement verdict reads."""
        job = str(job or "")
        provenance = str(provenance or "")
        if provenance not in PROVENANCE_CLASSES:
            return
        count = int(count)
        nbytes = int(nbytes)
        remote = provenance in ("pull", "restore_remote")
        with self._lock:
            prov = self._job_prov.get(job)
            if prov is None:
                if len(self._job_prov) >= _MAX_JOBS:
                    return
                prov = self._job_prov[job] = {}
            row = prov.setdefault(
                provenance, {"gets": 0, "bytes": 0, "wait_ms": 0.0}
            )
            row["gets"] += count
            row["bytes"] += nbytes
            row["wait_ms"] += float(ms)
            loc = self._locality.setdefault(job, [0, 0])
            if provenance in ("inline", "local"):
                loc[0] += count
            else:
                loc[1] += count
            tkey = (job, str(task or ""))
            trow = self._task_gets.get(tkey)
            if trow is None:
                if len(self._task_gets) >= _MAX_TASK_ROWS:
                    return
                trow = self._task_gets[tkey] = {
                    "remote_bytes": 0,
                    "local_bytes": 0,
                    "wait_ms": 0.0,
                    "by_src": {},
                }
            trow["wait_ms"] += float(ms)
            if remote:
                trow["remote_bytes"] += nbytes
                if src:
                    by_src = trow["by_src"]
                    by_src[src] = by_src.get(src, 0) + nbytes
            else:
                trow["local_bytes"] += nbytes

    def drop_node(self, node: str) -> None:
        """A node died: its arena is gone, so its report must not keep
        attributing bytes (the ledger's byte·s already banked what it
        consumed while alive)."""
        with self._lock:
            self.reports.pop(node, None)
            self._rates.pop(node, None)

    @staticmethod
    def _bump(table: Dict[str, float], key: str, amount: float) -> None:
        table[key] = table.get(key, 0.0) + amount
        if len(table) > _MAX_JOBS:
            # Never evict the key just bumped: a full table would
            # otherwise pop every NEW job's first (smallest) row on
            # insert, permanently starving job #257 of accounting.
            victim = min(
                (k for k in table if k != key), key=table.get
            )
            table.pop(victim)

    # -- views ---------------------------------------------------------
    def jobs(self) -> Dict[str, dict]:
        """Per-job usage rows across the latest node reports plus the
        integrated accumulators."""
        with self._lock:
            out: Dict[str, dict] = {}
            for report in self.reports.values():
                for row in report.get("owners", {}).values():
                    job = row.get("job", "")
                    if not job:
                        continue
                    agg = out.setdefault(
                        job,
                        {
                            "object_bytes": 0,
                            "objects": 0,
                            "pinned_objects": 0,
                            "spilled_bytes": 0,
                        },
                    )
                    agg["object_bytes"] += row["bytes"]
                    agg["objects"] += row["objects"]
                    agg["pinned_objects"] += row["pinned_objects"]
                    agg["spilled_bytes"] += row["spilled_bytes"]
            for report in self.reports.values():
                # Per-job spill/restore OPS (cumulative per node; the
                # latest reports sum to the cluster total — these are
                # never differenced, unlike the node-level rates).
                for field, src_key in (
                    ("spill_ops", "job_spill_ops"),
                    ("restore_ops", "job_restore_ops"),
                ):
                    for job, n in report.get(src_key, {}).items():
                        agg = out.setdefault(
                            job,
                            {
                                "object_bytes": 0,
                                "objects": 0,
                                "pinned_objects": 0,
                                "spilled_bytes": 0,
                            },
                        )
                        agg[field] = agg.get(field, 0) + int(n)
            for job, total in self._job_byte_s.items():
                out.setdefault(
                    job,
                    {
                        "object_bytes": 0,
                        "objects": 0,
                        "pinned_objects": 0,
                        "spilled_bytes": 0,
                    },
                )["object_byte_seconds"] = round(total, 1)
            for job, total in self._job_chip_s.items():
                out.setdefault(
                    job,
                    {
                        "object_bytes": 0,
                        "objects": 0,
                        "pinned_objects": 0,
                        "spilled_bytes": 0,
                    },
                )["chip_seconds"] = round(total, 3)
            return out

    def owners(self) -> List[dict]:
        """Per-(job, owner) rows summed across nodes, bytes
        descending (the full map; metric export truncates)."""
        with self._lock:
            merged: Dict[str, dict] = {}
            for report in self.reports.values():
                for key, row in report.get("owners", {}).items():
                    agg = merged.get(key)
                    if agg is None:
                        merged[key] = dict(row)
                    else:
                        for field in (
                            "bytes",
                            "objects",
                            "pinned_objects",
                            "spilled_bytes",
                        ):
                            agg[field] += row[field]
        return sorted(
            merged.values(), key=lambda r: r["bytes"], reverse=True
        )

    def summary(self) -> dict:
        """The cluster view `ray_tpu_torch memory` / ``/api/memory`` serve."""
        with self._lock:
            reports = list(self.reports.values())
            rates = dict(self._rates)
        used = sum(r.get("arena_used", 0) for r in reports)
        capacity = sum(r.get("arena_capacity", 0) for r in reports)
        attributed = sum(r.get("attributed_bytes", 0) for r in reports)
        top: List[dict] = []
        for report in reports:
            top.extend(report.get("top_objects", ()))
        top.sort(key=lambda r: r.get("size", 0), reverse=True)
        return {
            "time": time.time(),
            "totals": {
                "arena_used": used,
                "arena_capacity": capacity,
                "spilled_bytes": sum(
                    r.get("spilled_bytes", 0) for r in reports
                ),
                "attributed_bytes": attributed,
                "attribution_fraction": (
                    round(attributed / used, 4) if used else 1.0
                ),
            },
            "jobs": self.jobs(),
            "owners": self.owners(),
            "top_objects": top[: self._max_owner_series],
            "nodes": reports,
            "rates": rates,
        }

    def transfer_summary(self) -> dict:
        """The data-plane view ``transfer_summary`` / ``/api/transfers``
        / ``ray_tpu_torch memory --transfers`` serve: the full per-(job, src,
        dst) matrix (bytes descending), per-job get provenance and
        locality, the top remote-pulling task classes, and per-job
        spill/restore op totals."""
        with self._lock:
            flows = [
                {
                    "job": job,
                    "src": src,
                    "dst": dst,
                    "cross_node": bool(src and dst and src != dst),
                    **dict(row),
                    "mb_per_s": (
                        round(row["bytes"] / row["ms"] / 1e3, 2)
                        if row["ms"] > 0
                        else 0.0
                    ),
                }
                for (job, src, dst), row in self._flows.items()
            ]
            provenance = {
                job: {p: dict(r) for p, r in rows.items()}
                for job, rows in self._job_prov.items()
            }
            locality = {
                job: {
                    "hits": hits,
                    "misses": misses,
                    "hit_fraction": (
                        round(hits / (hits + misses), 4)
                        if hits + misses
                        else 1.0
                    ),
                }
                for job, (hits, misses) in self._locality.items()
            }
            tasks = [
                {
                    "job": job,
                    "task": task,
                    "remote_bytes": row["remote_bytes"],
                    "local_bytes": row["local_bytes"],
                    "wait_ms": round(row["wait_ms"], 3),
                    "by_src": dict(row["by_src"]),
                }
                for (job, task), row in self._task_gets.items()
            ]
        flows.sort(key=lambda f: f["bytes"], reverse=True)
        tasks.sort(key=lambda t: t["remote_bytes"], reverse=True)
        jobs = self.jobs()
        return {
            "time": time.time(),
            "flows": flows,
            "provenance": provenance,
            "locality": locality,
            "tasks": tasks,
            "job_spill_ops": {
                job: row["spill_ops"]
                for job, row in jobs.items()
                if row.get("spill_ops")
            },
            "job_restore_ops": {
                job: row["restore_ops"]
                for job, row in jobs.items()
                if row.get("restore_ops")
            },
        }

    def metric_entries(self) -> Dict[str, dict]:
        """The ledger's Prometheus series, shaped like
        ``metrics_summary`` entries so they ride the existing
        exposition + time-series paths unchanged."""
        jobs = self.jobs()
        entries: Dict[str, dict] = {}
        if jobs:
            entries["rt_job_object_bytes"] = {
                "kind": "gauge",
                "unit": "bytes",
                "description": "Object-store bytes attributed to each job",
                "value": sum(j["object_bytes"] for j in jobs.values()),
                "by_tags": {
                    f"job={job}": {"value": row["object_bytes"]}
                    for job, row in jobs.items()
                },
            }
            byte_s = {
                job: row["object_byte_seconds"]
                for job, row in jobs.items()
                if "object_byte_seconds" in row
            }
            if byte_s:
                entries["rt_job_object_byte_seconds_total"] = {
                    "kind": "counter",
                    "unit": "byte_seconds",
                    "description": (
                        "Object bytes integrated over time per job "
                        "(the ledger's usage-for-billing series)"
                    ),
                    "total": sum(byte_s.values()),
                    "by_tags": {
                        f"job={job}": {"total": v}
                        for job, v in byte_s.items()
                    },
                }
            chip_s = {
                job: row["chip_seconds"]
                for job, row in jobs.items()
                if "chip_seconds" in row
            }
            if chip_s:
                entries["rt_job_chip_seconds_total"] = {
                    "kind": "counter",
                    "unit": "chip_seconds",
                    "description": (
                        "Measured chip-seconds per job from step "
                        "telemetry (sum of per-rank step_ms)"
                    ),
                    "total": sum(chip_s.values()),
                    "by_tags": {
                        f"job={job}": {"total": v}
                        for job, v in chip_s.items()
                    },
                }
        owners = self.owners()
        if owners:
            # Owner label = the owning-context KIND (driver / task /
            # actor), never the id: a per-id label value mints one
            # Prometheus series per task forever (top-K per scrape
            # still churns the label set over the cluster's lifetime)
            # — the exact pattern lint rule RT010 bans. The full
            # per-owner map is served by /api/memory and the CLI.
            by_kind: Dict[str, int] = {}
            for row in owners:
                kind = (row["owner"] or "unknown").split(":", 1)[0]
                key = f"job={row['job']}|owner={kind}"
                by_kind[key] = by_kind.get(key, 0) + row["bytes"]
            entries["rt_object_owner_bytes"] = {
                "kind": "gauge",
                "unit": "bytes",
                "description": (
                    "Object-store bytes per (job, owner kind: "
                    "driver/task/actor) — per-owner detail is "
                    "/api/memory"
                ),
                "value": sum(r["bytes"] for r in owners),
                "by_tags": {
                    key: {"value": v} for key, v in by_kind.items()
                },
            }
        # Data-plane series. src_node/dst_node are NODE ids as
        # SEPARATE labels — the only identity granularity RT010
        # permits on these series (a per-object, per-transfer, or
        # fused src-dst-pair label would mint unbounded Prometheus
        # series). Tag keys stay alphabetical so they round-trip
        # through prometheus._parse_tag_key like worker-built tags.
        with self._lock:
            flows = {k: dict(v) for k, v in self._flows.items()}
            locality = {
                job: tuple(hm) for job, hm in self._locality.items()
            }
        if flows:
            entries["rt_object_transfer_bytes_total"] = {
                "kind": "counter",
                "unit": "bytes",
                "description": (
                    "Object bytes moved into each node's store per "
                    "(job, src node, dst node): pulls plus spill "
                    "restores; aborted pulls bill nothing"
                ),
                "total": sum(r["bytes"] for r in flows.values()),
                "by_tags": {
                    f"dst_node={dst}|job={job}|src_node={src}": {
                        "total": row["bytes"]
                    }
                    for (job, src, dst), row in flows.items()
                },
            }
            pull_ms = {
                key: row
                for key, row in flows.items()
                if row["pulls"] + row["restores"] > 0
            }
            if pull_ms:
                entries["rt_object_pull_ms"] = {
                    "kind": "gauge",
                    "unit": "ms",
                    "description": (
                        "Mean transfer latency per (job, src node, "
                        "dst node) flow — cumulative detail is "
                        "/api/transfers"
                    ),
                    "value": round(
                        sum(r["ms"] for r in pull_ms.values())
                        / max(
                            1,
                            sum(
                                r["pulls"] + r["restores"]
                                for r in pull_ms.values()
                            ),
                        ),
                        3,
                    ),
                    "by_tags": {
                        f"dst_node={dst}|job={job}|src_node={src}": {
                            "value": round(
                                row["ms"]
                                / (row["pulls"] + row["restores"]),
                                3,
                            )
                        }
                        for (job, src, dst), row in pull_ms.items()
                    },
                }
        if locality:
            for name, index, what in (
                ("rt_job_locality_hits_total", 0, "inline/local"),
                ("rt_job_locality_misses_total", 1, "pull/restore"),
            ):
                entries[name] = {
                    "kind": "counter",
                    "unit": "gets",
                    "description": (
                        f"rt.get resolutions per job whose bytes were "
                        f"{what}"
                    ),
                    "total": sum(hm[index] for hm in locality.values()),
                    "by_tags": {
                        f"job={job}": {"total": hm[index]}
                        for job, hm in locality.items()
                    },
                }
        # Per-job spill/restore op tag series, merged by the head's
        # metrics_summary INTO the core per-node entries of the same
        # name (node totals stay; the job dimension rides alongside).
        jobs = self.jobs()
        for name, field, what in (
            ("rt_object_spills_total", "spill_ops", "spilled"),
            ("rt_object_restores_total", "restore_ops", "restored"),
        ):
            per_job = {
                job: row[field]
                for job, row in jobs.items()
                if row.get(field)
            }
            if per_job:
                entries[name] = {
                    "kind": "counter",
                    "unit": "ops",
                    "description": (
                        f"Objects {what} (per-job attribution from "
                        "the memory ledger)"
                    ),
                    "by_tags": {
                        f"job={job}": {"total": n}
                        for job, n in per_job.items()
                    },
                }
        return entries

    # -- doctor --------------------------------------------------------
    def verdict(
        self,
        leak_age_s: float,
        now: Optional[float] = None,
        job_ended: Optional[Callable[[str], bool]] = None,
        near_capacity_fraction: float = NEAR_CAPACITY_FRACTION,
    ) -> dict:
        """``verdict.memory``: (a) nodes near arena capacity, (b) leak
        suspects — objects held past ``leak_age_s`` whose owner
        process died (node-local pid probe) or whose job already ended,
        (c) spill thrash — a window where restores keep up with
        spills, i.e. the store is paging its working set."""
        now = time.time() if now is None else float(now)
        job_ended = job_ended or (lambda job: False)
        with self._lock:
            reports = list(self.reports.values())
            rates = dict(self._rates)
        near: List[dict] = []
        suspects: List[dict] = []
        thrash: List[dict] = []
        for report in reports:
            node = report.get("node", "")
            used = report.get("arena_used", 0)
            capacity = report.get("arena_capacity", 0)
            if capacity and used / capacity >= near_capacity_fraction:
                near.append(
                    {
                        "node": node,
                        "used": used,
                        "capacity": capacity,
                        "fraction": round(used / capacity, 4),
                        "detail": (
                            f"node {node[:12]} arena at "
                            f"{100.0 * used / capacity:.0f}% of "
                            f"{capacity / 1e6:.0f} MB — spilling can't "
                            "keep up; add nodes or shed the top owners"
                        ),
                    }
                )
            seen: set = set()
            candidates = list(report.get("dead_owner_objects", ()))
            for row in report.get("top_objects", ()):
                # A clean-exited owner leaves owner_alive False too;
                # top objects additionally catch ended-job leaks whose
                # owner pid was recycled.
                if not row.get("owner_alive", True) or (
                    row.get("job") and job_ended(row["job"])
                ):
                    candidates.append(row)
            for row in candidates:
                oid = row.get("object_id", "")
                if oid in seen:
                    continue
                seen.add(oid)
                age = float(row.get("age_s", 0.0))
                if age <= leak_age_s:
                    continue
                dead_owner = not row.get("owner_alive", True)
                ended = bool(row.get("job")) and job_ended(row["job"])
                if not (dead_owner or ended):
                    continue
                why = (
                    "owner process died"
                    if dead_owner
                    else "owning job already ended"
                )
                suspects.append(
                    {
                        "node": node,
                        "object_id": oid,
                        "size": row.get("size", 0),
                        "job": row.get("job", ""),
                        "owner": row.get("owner", ""),
                        "age_s": age,
                        "pinned": row.get("pinned", False),
                        "detail": (
                            f"object {oid[:12]} "
                            f"({row.get('size', 0) / 1e6:.1f} MB, owner "
                            f"{row.get('owner', '?')}) still held "
                            f"after {age:.1f}s (> {leak_age_s:g}s leak "
                            f"deadline) but its {why} — a dropped ref "
                            "or a leaked borrow is pinning it"
                        ),
                    }
                )
        for node, rate in rates.items():
            spills = rate.get("spill_ops", 0)
            restores = rate.get("restore_ops", 0)
            if (
                spills >= _THRASH_MIN_OPS
                and restores >= 0.5 * spills
            ):
                thrash.append(
                    {
                        "node": node,
                        "spill_per_s": rate.get("spill_per_s", 0.0),
                        "restore_per_s": rate.get("restore_per_s", 0.0),
                        "detail": (
                            f"node {node[:12]} spilled {spills} and "
                            f"restored {restores} objects in "
                            f"{rate.get('window_s', 0):g}s — restore "
                            "rate ≈ spill rate means the working set "
                            "exceeds the arena (thrash), not cold data "
                            "aging out"
                        ),
                    }
                )
        suspects.sort(key=lambda s: s.get("size", 0), reverse=True)
        used = sum(r.get("arena_used", 0) for r in reports)
        attributed = sum(r.get("attributed_bytes", 0) for r in reports)
        return {
            "near_capacity": near,
            "leak_suspects": suspects,
            "spill_thrash": thrash,
            "attribution_fraction": (
                round(attributed / used, 4) if used else 1.0
            ),
            "params": {
                "leak_age_s": leak_age_s,
                "near_capacity_fraction": near_capacity_fraction,
            },
        }

    def data_verdict(
        self,
        locality_miss_threshold: float = 0.5,
        node_has_capacity: Optional[Callable[[str], bool]] = None,
        min_remote_bytes: int = _MISPLACED_MIN_BYTES,
    ) -> dict:
        """``verdict.data``: (a) the hottest cross-node flow, (b) a
        pull-dominated vs restore-dominated classification per job
        that moved bytes (restore-dominated = the working set is
        paging through spill, add memory; pull-dominated = the bytes
        crossed nodes, fix placement), (c) misplaced-task suspects —
        task classes whose gets pulled most of their bytes remotely
        while a copy-holding node had capacity to run them.

        ``node_has_capacity`` answers "could the src node have hosted
        the task" (the head passes a scheduler-view probe); with no
        probe every copy-holder is assumed to have had room — the
        conservative direction for an observability verdict would be
        the opposite, but an instrument that never convicts teaches
        nothing, and the probe is always supplied in production.
        """
        node_has_capacity = node_has_capacity or (lambda node: True)
        summary = self.transfer_summary()
        hottest = None
        for flow in summary["flows"]:
            if flow["cross_node"] and flow["bytes"] > 0:
                hottest = flow  # flows are bytes-descending
                break
        job_rows: Dict[str, dict] = {}
        for flow in summary["flows"]:
            row = job_rows.setdefault(
                flow["job"],
                {"transfer_bytes": 0, "restored_bytes": 0},
            )
            row["transfer_bytes"] += flow["bytes"]
            row["restored_bytes"] += flow["restored_bytes"]
        for job, row in job_rows.items():
            pulled = row["transfer_bytes"] - row["restored_bytes"]
            row["classification"] = (
                "restore_dominated"
                if row["restored_bytes"] >= max(1, pulled)
                else "pull_dominated"
            )
            row["restore_ops"] = summary["job_restore_ops"].get(job, 0)
        misplaced: List[dict] = []
        for trow in summary["tasks"]:
            total = trow["remote_bytes"] + trow["local_bytes"]
            if (
                trow["remote_bytes"] < min_remote_bytes
                or not total
                or trow["remote_bytes"] / total < locality_miss_threshold
            ):
                continue
            if not trow["by_src"]:
                continue
            src = max(trow["by_src"], key=trow["by_src"].get)
            if not node_has_capacity(src):
                continue
            frac = trow["remote_bytes"] / total
            misplaced.append(
                {
                    "job": trow["job"],
                    "task": trow["task"] or "driver",
                    "remote_bytes": trow["remote_bytes"],
                    "remote_fraction": round(frac, 4),
                    "src": src,
                    "wait_ms": trow["wait_ms"],
                    "detail": (
                        f"task class {trow['task'] or 'driver'!r} "
                        f"(job {trow['job'][:8]}) pulled "
                        f"{trow['remote_bytes'] / 1e6:.1f} MB remotely "
                        f"({100 * frac:.0f}% of its get bytes), mostly "
                        f"from node {src[:12]}, which had capacity — "
                        "schedule it there (or co-locate its inputs) "
                        "and those gets become local arena hits"
                    ),
                }
            )
        misplaced.sort(key=lambda s: s["remote_bytes"], reverse=True)
        return {
            "hottest_flow": hottest,
            "jobs": job_rows,
            "locality": summary["locality"],
            "misplaced_tasks": misplaced,
            "params": {
                "locality_miss_threshold": locality_miss_threshold,
                "min_remote_bytes": min_remote_bytes,
            },
        }
