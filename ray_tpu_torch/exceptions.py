# Copied from ray_tpu/exceptions.py (JAX-free): module names read ray_tpu_torch.
"""User-facing exceptions (reference: python/ray/exceptions.py)."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at `get` with the remote
    traceback attached (reference: RayTaskError in
    python/ray/exceptions.py)."""

    def __init__(self, cause_repr: str, traceback_str: str = ""):
        self.cause_repr = cause_repr
        self.traceback_str = traceback_str
        super().__init__(
            f"Task failed with {cause_repr}\n"
            f"--- remote traceback ---\n{traceback_str}"
        )


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ActorDiedError(RayTpuError):
    """The actor owning the called method is dead."""


class ActorUnavailableError(RayTpuError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class ObjectLostError(RayTpuError):
    """An object was evicted/lost and could not be reconstructed."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get` exceeded its timeout."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled before/while running."""


class RuntimeEnvSetupError(RayTpuError):
    """Preparing the runtime environment for a task/actor failed."""


class ObjectStoreFullError(RayTpuError):
    """The shared-memory store could not fit the object."""


class PlacementGroupUnavailableError(RayTpuError):
    """Placement-group bundles could not be reserved."""
