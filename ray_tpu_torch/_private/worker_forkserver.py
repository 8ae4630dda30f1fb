# Copied from ray_tpu/_private/worker_forkserver.py (JAX-free): module names read ray_tpu_torch.
"""Warm fork-server for worker processes.

A cold worker spawn pays ~250ms of interpreter + import time
(`ray_tpu_torch` -> rpc/wire/protobuf/numpy), which caps actor-creation
throughput at a handful per second per core — far below the
many-dedicated-worker pattern the reference's worker pool serves
(reference: src/ray/raylet/worker_pool.cc starts one process per
actor, bounded only by maximum_startup_concurrency). This template
process imports the worker's full module graph ONCE, then forks a
child per spawn request: each fork costs ~10ms and shares the warm
interpreter's pages copy-on-write.

Protocol (newline-delimited JSON over the stdin/stdout pipe pair):
  request:  {"log": "<path>", "env": {"K": "v" | null, ...}}
  reply:    {"pid": N} | {"error": "..."}

`env` values of null unset the variable in the child. The template
itself must never touch accelerators or open RPC connections — forked
children would share them; it only imports modules. Children are
reaped here (they are this process's children, not the daemon's); the
daemon tracks liveness by pid signal-0 probes.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback


def _reaper() -> None:
    """Reap exited children so they never linger as zombies (the
    daemon cannot waitpid them — they are not its children)."""
    while True:
        try:
            pid, _status = os.waitpid(-1, 0)
            if pid == 0:
                time.sleep(0.2)
        except ChildProcessError:
            time.sleep(0.5)
        except InterruptedError:
            continue


def _run_child(log_path: str, env: dict) -> None:
    """Child-side setup after fork: detach from the request pipe,
    point stdout/stderr at the worker log, apply the env deltas, and
    run the normal worker entrypoint."""
    try:
        fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
        if fd > 2:
            os.close(fd)
        os.close(0)
        for key, value in env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = str(value)
        from .worker_main import main as worker_main

        worker_main()
    except BaseException:
        traceback.print_exc()
    finally:
        try:
            sys.stdout.flush()
            sys.stderr.flush()
        except Exception:
            pass
        # Skip interpreter finalization: the child inherited the
        # template's atexit/threading state, which was never meant to
        # shut down a worker.
        os._exit(0)


def _proc_starttime(pid: int):
    """Kernel start time (clock ticks since boot) of `pid`, or None if
    the process is gone. Field 22 of /proc/<pid>/stat; parse after the
    last ')' — the comm field may itself contain spaces or parens."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read().decode("ascii", "replace")
        return int(stat.rsplit(")", 1)[1].split()[19])
    except (OSError, IndexError, ValueError):
        return None


class ForkedProc:
    """Popen-shaped handle for a fork-server child. The child belongs
    to the fork-server process (which reaps it immediately), so
    waitpid is unavailable here AND a bare signal-0 probe is unsafe:
    the reaped pid can be recycled by an unrelated process, making a
    dead worker look alive (and leaking its startup-concurrency slot
    for the whole watch window). Liveness = pid exists AND its
    /proc starttime matches the one captured at fork."""

    def __init__(self, pid: int, starttime=None):
        self.pid = pid
        self._returncode = None
        # The template reports the starttime it read while the child
        # was still its un-reaped child (zombie at worst) — the only
        # point where the pid provably can't have been recycled. None
        # means the template's reaper won the race: the child is
        # already dead, and poll() reports it so without ever
        # trusting the (possibly recycled) pid.
        self._starttime = starttime

    def poll(self):
        if self._returncode is not None:
            return self._returncode
        try:
            os.kill(self.pid, 0)
        except ProcessLookupError:
            self._returncode = 0
            return 0
        except PermissionError:
            # pid reused by another user's process: ours is gone.
            self._returncode = 0
            return 0
        now = _proc_starttime(self.pid)
        if self._starttime is None or now != self._starttime:
            # Same pid, different (or vanished) start time: the pid
            # was recycled after our child exited.
            self._returncode = 0
            return 0
        return None

    def terminate(self) -> None:
        if self.poll() is not None:  # dead/recycled: never signal it
            return
        try:
            os.kill(self.pid, 15)
        except (ProcessLookupError, PermissionError):
            pass

    def kill(self) -> None:
        if self.poll() is not None:
            return
        try:
            os.kill(self.pid, 9)
        except (ProcessLookupError, PermissionError):
            pass

    def wait(self, timeout=None):
        import subprocess

        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("forked-worker", timeout)
            time.sleep(0.02)
        return self._returncode


class ForkServerClient:
    """Daemon-side handle on one fork-server template process.

    `spawn` is serialized under a lock (the pipe is a single
    request/reply stream); a dead or wedged template is restarted
    once, and a second failure surfaces as None so the caller can fall
    back to a cold subprocess spawn."""

    #: Seconds to wait for the template's import phase / a fork reply.
    READY_TIMEOUT = 30.0

    def __init__(self, base_env: dict, log_path: str):
        self._base_env = base_env
        self._log_path = log_path
        self._lock = threading.Lock()
        self._proc = None
        self._ready = False
        self._buf = b""
        # Latched after a restart-and-retry cycle also fails: the
        # environment can't run the template, so stop paying the
        # launch + timeout cost on every spawn and let callers use
        # the cold path permanently.
        self._dead = False

    def start(self) -> None:
        """Launch the template (non-blocking; the first spawn waits
        for its ready line)."""
        with self._lock:
            self._ensure_started()

    def _ensure_started(self) -> None:
        import subprocess

        if self._proc is not None and self._proc.poll() is None:
            return
        log_file = open(self._log_path, "ab")
        try:
            self._proc = subprocess.Popen(
                [sys.executable, "-m",
                 "ray_tpu_torch._private.worker_forkserver"],
                env=self._base_env,
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=log_file,
            )
        finally:
            log_file.close()
        self._ready = False
        self._buf = b""

    def _read_reply(self, timeout: float):
        """One JSON line from the template, bounded by `timeout` even
        mid-line (a wedged template that wrote a partial line must not
        block the caller — it holds the daemon's dispatch lock)."""
        import select

        fd = self._proc.stdout.fileno()
        deadline = time.monotonic() + timeout
        while b"\n" not in self._buf:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            ready, _, _ = select.select([fd], [], [], remaining)  # rt: noqa[RT203] — _lock serializes the whole request/reply conversation; this select IS the reply wait
            if not ready:
                return None
            chunk = os.read(fd, 65536)
            if not chunk:  # template EOF (crashed)
                return None
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            return None

    def spawn(self, log: str, env: dict):
        """Fork one worker; returns a ForkedProc or None on failure."""
        with self._lock:
            if self._dead:
                return None
            for _attempt in (0, 1):
                try:
                    self._ensure_started()
                    if not self._ready:
                        hello = self._read_reply(self.READY_TIMEOUT)
                        if not (hello and hello.get("ready")):
                            raise OSError("fork server never came up")
                        self._ready = True
                    req = json.dumps({"log": log, "env": env}) + "\n"
                    self._proc.stdin.write(req.encode())
                    self._proc.stdin.flush()
                    reply = self._read_reply(self.READY_TIMEOUT)
                    if reply and "pid" in reply:
                        return ForkedProc(
                            reply["pid"], reply.get("starttime")
                        )
                except (OSError, ValueError, BrokenPipeError):
                    pass
                # Template died mid-request: restart once and retry.
                self._kill_locked()
            self._dead = True
            return None

    def _kill_locked(self) -> None:
        if self._proc is not None:
            try:
                self._proc.kill()
                self._proc.wait(timeout=2)
            except Exception:
                pass
            self._proc = None
            self._ready = False

    def close(self) -> None:
        with self._lock:
            self._kill_locked()


def main() -> None:
    # Pre-import the worker's entire module graph; every fork inherits
    # the warm interpreter. worker_main pulls ray_tpu_torch -> worker ->
    # rpc/wire (protobuf) -> object_store (numpy) -> serialization.
    from . import worker_main  # noqa: F401

    # Modules the worker pulls LAZILY (first CoreWorker init / first
    # task) import here instead — measured at ~0.25s of post-fork CPU
    # per child without this (runtime_env -> zipfile/pathlib, plus the
    # native store's ctypes dlopen), which dominated actor-creation
    # throughput on small hosts. dlopen'd libraries and compiled
    # bytecode are inherited copy-on-write; loading the .so here is
    # safe (no store ATTACH — fds stay per-child).
    from . import runtime_env  # noqa: F401
    from . import accelerators  # noqa: F401

    # The RPC hub/pool layers lazily `from concurrent.futures import
    # ThreadPoolExecutor` (and the hub imports selectors) on first
    # use — post-fork in every child. This image ships NO bytecode
    # cache for them and sets PYTHONDONTWRITEBYTECODE=1, so each of N
    # workers recompiled the package from source (~30ms of pure CPU a
    # worker, the dominant cost of an actor-creation storm). Compile
    # once here; children inherit the warm modules.
    # NB: `import concurrent.futures` alone does NOT load the
    # `.thread` submodule (lazy __getattr__ in 3.12) — name the
    # class so the submodule actually compiles here.
    from concurrent.futures import ThreadPoolExecutor  # noqa: F401
    import selectors  # noqa: F401
    import http.client  # noqa: F401 — serve replicas' first import

    try:
        from .._native import load_library

        load_library()
    except Exception:
        pass  # native store disabled/unbuilt: children fall back too

    threading.Thread(target=_reaper, daemon=True).start()
    out_fd = sys.stdout.fileno()
    # Signal readiness so the daemon can distinguish "template still
    # importing" from "template wedged".
    os.write(out_fd, b'{"ready": true}\n')
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            pid = os.fork()
        except Exception as e:  # bad request or fork failure
            os.write(
                out_fd,
                (json.dumps({"error": repr(e)}) + "\n").encode(),
            )
            continue
        if pid == 0:
            _run_child(req["log"], req.get("env") or {})
            # unreachable: _run_child always os._exit()s
        # Capture the child's authoritative start time HERE, where the
        # pid cannot have been recycled yet: until the reaper thread
        # waitpid()s it, the child (even exited) holds its /proc entry
        # as our zombie. If the reaper won the race the read fails and
        # the daemon treats the handle as dead-at-creation — safe, and
        # never an impostor's starttime.
        os.write(
            out_fd,
            (
                json.dumps(
                    {"pid": pid, "starttime": _proc_starttime(pid)}
                )
                + "\n"
            ).encode(),
        )


if __name__ == "__main__":
    main()
