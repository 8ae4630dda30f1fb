# Copied from ray_tpu/job_submission.py (JAX-free), with the entrypoint given the host's card visibility:
# module names read ray_tpu_torch.
"""Job submission: run driver scripts against a live cluster.

Reference: python/ray/dashboard/modules/job/ — JobSubmissionClient
(sdk.py) submits an entrypoint command; a JobSupervisor
(job_supervisor.py) runs it as a subprocess with the cluster address
injected, captures logs, and tracks status (job_manager.py). Here the
supervisor is a named JobManager actor on the cluster, so any client
process connected to the cluster can submit/inspect jobs.
"""

from __future__ import annotations

import enum
import json
import os
import subprocess
import tempfile
import threading
import time
import uuid
from typing import Dict, List, Optional

JOB_MANAGER_NAME = "_rt_job_manager"
_NAMESPACE = "_rt_jobs"


class JobStatus(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


def _restore_host_cards(env: dict) -> None:
    """Give an entrypoint the cards of the host that started the
    cluster, as the reference's job supervisor does: the manager is a
    CPU worker, whose env hides them (`CUDA_VISIBLE_DEVICES=""`), and
    the daemon keeps the host's value beside it."""
    from ._private.daemon import HOST_CUDA_VISIBLE_DEVICES

    if HOST_CUDA_VISIBLE_DEVICES not in env:
        return
    host = json.loads(env.pop(HOST_CUDA_VISIBLE_DEVICES))
    if host is None:
        env.pop("CUDA_VISIBLE_DEVICES", None)
    else:
        env["CUDA_VISIBLE_DEVICES"] = host


class JobManager:
    """Actor body (reference: job_manager.py + per-job supervisor)."""

    def __init__(self, cluster_address: str):
        self._address = cluster_address
        self._jobs: Dict[str, dict] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()
        self._log_dir = tempfile.mkdtemp(prefix="rt_job_logs_")

    def submit(
        self,
        entrypoint: str,
        job_id: Optional[str] = None,
        runtime_env: Optional[dict] = None,
        metadata: Optional[dict] = None,
    ) -> str:
        job_id = job_id or f"rtjob-{uuid.uuid4().hex[:10]}"
        with self._lock:
            if job_id in self._jobs:
                raise ValueError(f"job {job_id!r} already exists")
            self._jobs[job_id] = {
                "job_id": job_id,
                "entrypoint": entrypoint,
                "status": JobStatus.PENDING.value,
                "metadata": metadata or {},
                "start_time": time.time(),
                "end_time": None,
            }
        log_path = os.path.join(self._log_dir, f"{job_id}.log")
        env = dict(os.environ)
        env["RT_ADDRESS"] = self._address
        _restore_host_cards(env)
        runtime_env = runtime_env or {}
        env.update(runtime_env.get("env_vars") or {})
        cwd = runtime_env.get("working_dir") or None
        log_file = open(log_path, "wb")
        try:
            proc = subprocess.Popen(
                entrypoint,
                shell=True,
                env=env,
                cwd=cwd,
                stdout=log_file,
                stderr=subprocess.STDOUT,
            )
        except OSError as e:
            log_file.close()
            with self._lock:
                self._jobs[job_id]["status"] = JobStatus.FAILED.value
                self._jobs[job_id]["message"] = repr(e)
            return job_id
        log_file.close()  # child owns its copy of the fd
        with self._lock:
            self._jobs[job_id]["status"] = JobStatus.RUNNING.value
            self._jobs[job_id]["log_path"] = log_path
            self._procs[job_id] = proc
        threading.Thread(
            target=self._watch, args=(job_id, proc), daemon=True
        ).start()
        return job_id

    def _watch(self, job_id: str, proc: subprocess.Popen) -> None:
        code = proc.wait()  # rt: noqa[RT008] — a job runs until IT decides; liveness is the daemon's job
        with self._lock:
            job = self._jobs[job_id]
            if job["status"] == JobStatus.RUNNING.value:
                job["status"] = (
                    JobStatus.SUCCEEDED.value
                    if code == 0
                    else JobStatus.FAILED.value
                )
            job["end_time"] = time.time()
            job["exit_code"] = code
            self._procs.pop(job_id, None)

    def status(self, job_id: str) -> Optional[str]:
        with self._lock:
            job = self._jobs.get(job_id)
            return job["status"] if job else None

    def info(self, job_id: str) -> Optional[dict]:
        with self._lock:
            job = self._jobs.get(job_id)
            return dict(job) if job else None

    def logs(self, job_id: str) -> str:
        with self._lock:
            job = self._jobs.get(job_id)
        if not job or "log_path" not in job:
            return ""
        try:
            with open(job["log_path"], "rb") as f:
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def stop(self, job_id: str) -> bool:
        with self._lock:
            proc = self._procs.get(job_id)
            job = self._jobs.get(job_id)
        if proc is None or job is None:
            return False
        proc.terminate()
        with self._lock:
            # The watcher may have recorded completion between our
            # snapshot and the terminate — don't overwrite a final
            # SUCCEEDED/FAILED with STOPPED.
            if job["status"] == JobStatus.RUNNING.value:
                job["status"] = JobStatus.STOPPED.value
        return True

    def list(self) -> List[dict]:
        with self._lock:
            return [dict(j) for j in self._jobs.values()]


class JobSubmissionClient:
    """(reference: dashboard/modules/job/sdk.py)."""

    def __init__(self, address: Optional[str] = None):
        import ray_tpu_torch as rt

        if not rt.is_initialized():
            rt.init(address=address, ignore_reinit_error=True)
        self._rt = rt
        self._manager = self._get_or_create_manager()

    def _get_or_create_manager(self):
        rt = self._rt
        try:
            return rt.get_actor(JOB_MANAGER_NAME, namespace=_NAMESPACE)
        except ValueError:
            pass
        from . import api as rt_api

        cluster_address = rt_api._session.address
        actor_cls = rt.remote(
            num_cpus=0, name=JOB_MANAGER_NAME, namespace=_NAMESPACE
        )(JobManager)
        manager = actor_cls.remote(cluster_address)
        rt.get(manager.list.remote(), timeout=60)
        return manager

    def submit_job(
        self,
        *,
        entrypoint: str,
        job_id: Optional[str] = None,
        runtime_env: Optional[dict] = None,
        metadata: Optional[dict] = None,
    ) -> str:
        return self._rt.get(
            self._manager.submit.remote(
                entrypoint, job_id, runtime_env, metadata
            ),
            timeout=60,
        )

    def get_job_status(self, job_id: str) -> JobStatus:
        status = self._rt.get(
            self._manager.status.remote(job_id), timeout=30
        )
        if status is None:
            raise ValueError(f"no job {job_id!r}")
        return JobStatus(status)

    def get_job_info(self, job_id: str) -> dict:
        info = self._rt.get(self._manager.info.remote(job_id), timeout=30)
        if info is None:
            raise ValueError(f"no job {job_id!r}")
        return info

    def get_job_logs(self, job_id: str) -> str:
        return self._rt.get(self._manager.logs.remote(job_id), timeout=30)

    def stop_job(self, job_id: str) -> bool:
        return self._rt.get(
            self._manager.stop.remote(job_id), timeout=30
        )

    def list_jobs(self) -> List[dict]:
        return self._rt.get(self._manager.list.remote(), timeout=30)

    def wait_until_finished(
        self, job_id: str, timeout: float = 120.0
    ) -> JobStatus:
        deadline = time.time() + timeout
        while time.time() < deadline:
            status = self.get_job_status(job_id)
            if status in (
                JobStatus.SUCCEEDED,
                JobStatus.FAILED,
                JobStatus.STOPPED,
            ):
                return status
            time.sleep(0.2)
        raise TimeoutError(f"job {job_id} still {status}")
