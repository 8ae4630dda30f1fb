# Copied from ray_tpu/_private/node.py (JAX-free): module names read ray_tpu_torch, and the TPU resource is the GPU.
"""Session bootstrap: start/stop node processes.

Mirrors the reference's Node/services layer (reference:
python/ray/_private/node.py:37, services.py:829 — spawns GCS, raylet,
dashboard, log monitor). Here a head "session" embeds the NodeDaemon
(raylet+GCS) in the driver process behind its Unix socket, so a bare
`init()` needs no separate binaries; `init(address=...)` instead
connects to a daemon started by `rt start --head` (cli.py).
"""

from __future__ import annotations

import atexit
import os
import tempfile
import time
from typing import Dict, Optional

from .accelerators import detect_accelerators
from .config import Config
from .daemon import NodeDaemon
from .rpc import configure_chaos
from .worker import CoreWorker, set_global_worker


class Session:
    def __init__(
        self,
        num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None,
        resources: Optional[Dict[str, float]] = None,
        system_config: Optional[dict] = None,
        address: Optional[str] = None,
        session_dir: Optional[str] = None,
    ):
        self.config = Config.from_env(system_config)
        if self.config.testing_rpc_failure:
            configure_chaos(self.config.testing_rpc_failure)
        self.daemon: Optional[NodeDaemon] = None
        if address is None:
            self.session_dir = session_dir or tempfile.mkdtemp(
                prefix=f"rt_session_{int(time.time())}_"
            )
            total = dict(resources or {})
            total.setdefault(
                "CPU", float(num_cpus if num_cpus is not None else os.cpu_count())
            )
            detected, labels = detect_accelerators(
                {"GPU": float(num_gpus)} if num_gpus is not None else None
            )
            for name, amount in detected.items():
                if amount:
                    total.setdefault(name, amount)
            total.setdefault("memory", float(2**34))
            self.daemon = NodeDaemon(
                self.session_dir,
                total,
                self.config,
                is_head=True,
                labels=labels,
            )
            self.daemon.start()
            address = self.daemon.socket_path  # driver rides the local Unix socket
        self.address = address
        self.worker = CoreWorker(address, role="driver")
        set_global_worker(self.worker)
        atexit.register(self.shutdown)

    def shutdown(self) -> None:
        try:
            atexit.unregister(self.shutdown)
        except Exception:
            pass
        set_global_worker(None)
        # Worker teardown can fail under extreme conditions (observed:
        # thread creation raising on a pid-exhausted host) — the
        # daemon, which owns the spawned worker TREE, must still be
        # torn down or orphaned workers outlive the session.
        try:
            if self.worker is not None:
                self.worker.shutdown()
        finally:
            self.worker = None
            if self.daemon is not None:
                daemon, self.daemon = self.daemon, None  # rt: noqa[RT201] — atexit.unregister above runs before teardown: the finalizer and a live caller never overlap
                daemon.shutdown()
