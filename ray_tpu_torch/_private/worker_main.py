# Copied from ray_tpu/_private/worker_main.py (JAX-free): module names read ray_tpu_torch.
"""Worker process entrypoint (reference:
python/ray/_private/workers/default_worker.py — connects the embedded
core worker and runs the task execution loop)."""

from __future__ import annotations

import os
import sys


def main() -> None:
    socket_path = os.environ["RT_SOCKET"]
    profile_dir = os.environ.get("RT_WORKER_PROFILE")
    prof = None
    if profile_dir:
        # Startup-cost diagnosis: profile interpreter + CoreWorker
        # init (imports, store attach, register) and dump BEFORE the
        # task loop. Same-thread enable/disable only — cProfile hooks
        # are per-thread, so a timer-thread disable would leave the
        # main thread profiled (and slowed ~2x) forever.
        import cProfile

        prof = cProfile.Profile()
        prof.enable()
    from .worker import CoreWorker, set_global_worker

    worker = CoreWorker(socket_path, role="worker")
    set_global_worker(worker)
    if prof is not None:
        prof.disable()
        prof.dump_stats(
            os.path.join(profile_dir, f"worker-{os.getpid()}.prof")
        )
    try:
        worker.run_task_loop()
    finally:
        worker.shutdown()


if __name__ == "__main__":
    sys.exit(main())
