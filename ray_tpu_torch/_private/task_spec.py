# Copied from ray_tpu/_private/task_spec.py (JAX-free): module names read ray_tpu_torch.
"""Task specification dicts + error payload helpers.

The reference's TaskSpecification is an immutable protobuf wrapper
(reference: src/ray/common/task/task_spec.h). Here a spec is a plain
dict built once at submit time and shipped over the socket:

    {
      "task_id": bytes, "job_id": bytes, "kind": "normal" |
      "actor_creation" | "actor_task", "name": str,
      "function_key": str,            # KV key of the pickled function
      "args": [("inline", bytes) | ("ref", oid_bytes)],
      "returns": [oid_bytes, ...],
      "resources": {"CPU": 1.0, ...},
      "max_retries": int,
      # actor fields
      "actor_id": bytes, "method": str, "handle_meta": {...},
    }

Error payloads are pickled dicts `{"kind", "detail", "traceback"}`;
`raise_from_payload` maps them back to typed exceptions at `get`
(reference: RayTaskError round-trip, python/ray/exceptions.py).
"""

from __future__ import annotations

import pickle
import traceback as _tb

from .. import exceptions as exc

_ERROR_TYPES = {
    "TaskError": exc.TaskError,
    "WorkerCrashedError": exc.WorkerCrashedError,
    "ActorDiedError": exc.ActorDiedError,
    "ActorUnavailableError": exc.ActorUnavailableError,
    "ObjectLostError": exc.ObjectLostError,
    "TaskCancelledError": exc.TaskCancelledError,
    "RuntimeEnvSetupError": exc.RuntimeEnvSetupError,
}


def make_error_payload(kind: str, detail: str, tb: str = "") -> bytes:
    return pickle.dumps({"kind": kind, "detail": detail, "traceback": tb})


def make_exception_payload(e: BaseException) -> bytes:
    """Payload for an application exception raised inside a task.

    The original exception object is pickled when possible so user
    `except SomeError:` clauses keep working across the process
    boundary; otherwise we fall back to its repr.
    """
    tb = "".join(_tb.format_exception(type(e), e, e.__traceback__))
    try:
        cause = pickle.dumps(e)
    except Exception:
        cause = None
    info = {
        "kind": "TaskError",
        "detail": repr(e),
        "traceback": tb,
        "cause": cause,
    }
    # Generator tasks annotate how many items were sealed before the
    # failure so consumers can drain them before seeing the error
    # (object_ref.ObjectRefGenerator mid-stream error protocol).
    emitted = getattr(e, "__rt_items_emitted__", None)
    if emitted is not None:
        info["items_emitted"] = emitted
    return pickle.dumps(info)


def raise_from_payload(payload: bytes) -> None:
    info = pickle.loads(payload)
    kind = info.get("kind", "TaskError")
    if kind == "TaskError":
        cause = info.get("cause")
        original = None
        if cause is not None:
            try:
                original = pickle.loads(cause)
            except Exception:
                original = None
        if isinstance(original, BaseException):
            # Re-raise the user's exception type so `except ValueError:`
            # works across the process boundary; the remote traceback
            # rides along as __cause__.
            raise original from exc.TaskError(
                info["detail"], info.get("traceback", "")
            )
        raise exc.TaskError(info["detail"], info.get("traceback", ""))
    error_cls = _ERROR_TYPES.get(kind, exc.RayTpuError)
    raise error_cls(f"{info.get('detail', '')}\n{info.get('traceback', '')}")
