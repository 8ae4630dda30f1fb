# Copied from ray_tpu/_private/memory_monitor.py (JAX-free): module names read ray_tpu_torch.
"""Node memory watcher driving OOM worker kills.

Reference: src/ray/common/memory_monitor.h:52 — a cgroup-aware
watcher samples node memory every refresh interval; above the usage
threshold the raylet kills a worker chosen by a pluggable policy
(raylet/worker_killing_policy_group_by_owner.cc: prefer retriable
tasks, newest first) and the task retries elsewhere (infinite OOM
retries by default, ray_config_def.h:91 task_oom_retries).

Here the monitor samples /proc/meminfo (cgroup v2 limits when
present) plus per-worker RSS, and asks the daemon to kill the chosen
victim; the existing worker-death path handles retry/failure.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional, Tuple


def _cgroup_memory() -> Optional[Tuple[int, int]]:
    """(used, limit) from cgroup v2, None if unbounded/absent."""
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            raw = f.read().strip()
        if raw == "max":
            return None
        limit = int(raw)
        with open("/sys/fs/cgroup/memory.current") as f:
            used = int(f.read().strip())
        return used, limit
    except (OSError, ValueError):
        return None


def _meminfo() -> Tuple[int, int]:
    """(used, total) bytes from /proc/meminfo."""
    total = available = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                total = int(line.split()[1]) * 1024
            elif line.startswith("MemAvailable:"):
                available = int(line.split()[1]) * 1024
    return total - available, total


def node_memory_usage_fraction() -> float:
    cg = _cgroup_memory()
    if cg is not None:
        used, limit = cg
        return used / limit if limit else 0.0
    used, total = _meminfo()
    return used / total if total else 0.0


def process_rss(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def pick_victim(
    candidates: List[dict],
) -> Optional[dict]:
    """Worker-killing policy (reference: retriable-first, newest-task
    first — worker_killing_policy.cc): prefer workers whose current
    task can retry, break ties by largest RSS."""
    if not candidates:
        return None
    ranked = sorted(
        candidates,
        key=lambda c: (not c.get("retriable", False), -c.get("rss", 0)),
    )
    return ranked[0]


class MemoryMonitor:
    def __init__(
        self,
        usage_threshold: float,
        refresh_interval_s: float,
        get_candidates: Callable[[], List[dict]],
        kill_worker: Callable[[dict], None],
        usage_fn: Callable[[], float] = node_memory_usage_fraction,
        min_kill_interval_s: float = 1.0,
    ):
        self.usage_threshold = usage_threshold
        self.refresh_interval_s = refresh_interval_s
        self._get_candidates = get_candidates
        self._kill_worker = kill_worker
        self._usage_fn = usage_fn
        self._min_kill_interval_s = min_kill_interval_s
        self._last_kill = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="memory-monitor"
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.refresh_interval_s):
            try:
                self.tick()
            except Exception:
                pass

    def tick(self) -> bool:
        """One sample; returns True if a victim was killed."""
        usage = self._usage_fn()
        if usage < self.usage_threshold:
            return False
        if time.time() - self._last_kill < self._min_kill_interval_s:
            return False
        victim = pick_victim(self._get_candidates())
        if victim is None:
            return False
        self._last_kill = time.time()  # rt: noqa[RT201] — only the monitor loop calls tick() in production; the public method exists for single-threaded tests
        self._kill_worker(victim)
        return True

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
