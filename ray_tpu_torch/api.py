# Copied from ray_tpu/api.py (JAX-free): module names read ray_tpu_torch, and the TPU resource is the GPU.
"""Public API surface (reference: python/ray/_private/worker.py —
init:1270, get:2663, put:2799, wait:2864, get_actor:3010, kill:3045,
cancel:3076, remote:3253; exports python/ray/__init__.py:175)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

from . import exceptions as exc
from ._private.ids import ActorID
from ._private.node import Session
from ._private.worker import global_worker
from .actor import ActorClass, ActorHandle
from .object_ref import ObjectRef
from .remote_function import RemoteFunction

_session: Optional[Session] = None


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    namespace: str = "default",
    ignore_reinit_error: bool = False,
    _system_config: Optional[dict] = None,
) -> Session:
    """Start (or connect to) a cluster and register this process as a
    driver."""
    global _session
    if _session is not None:
        if ignore_reinit_error:
            return _session
        raise exc.RayTpuError(
            "ray_tpu_torch.init() already called; pass ignore_reinit_error=True "
            "or call shutdown() first."
        )
    import os as _os

    if address is None:
        # Jobs submitted to a running cluster connect via the address
        # the job manager injected (reference: RAY_ADDRESS).
        address = _os.environ.get("RT_ADDRESS") or None
    _session = Session(
        num_cpus=num_cpus,
        num_gpus=num_gpus,
        resources=resources,
        system_config=_system_config,
        address=address,
    )
    # Session-scoped namespace: the default for named-actor creation,
    # get_actor, and list_named_actors (reference: ray.init(namespace)).
    # Propagated to workers through the task/actor spec (ns_ctx in
    # _private/worker.py), so calls inside tasks/actors resolve against
    # THIS namespace too; namespace= stays available as an explicit
    # override everywhere.
    _session.worker.namespace = namespace
    return _session


def shutdown() -> None:
    global _session
    if _session is not None:
        # Stop the metrics flusher BEFORE the session dies: it gets a
        # final flush against a live worker, and the singleton reset
        # means a later re-init binds a fresh buffer (the old flusher
        # thread would otherwise outlive this session and silently
        # throw records at a dead worker forever).
        from .util.metrics import _shutdown_buffer

        _shutdown_buffer()
        _session.shutdown()
        _session = None


def is_initialized() -> bool:
    return _session is not None


def _worker():
    worker = global_worker()
    if worker is None:
        raise exc.RayTpuError("ray_tpu_torch.init() has not been called")
    return worker


def remote(*args, **options):
    """Decorator turning a function into a RemoteFunction or a class
    into an ActorClass. Supports bare `@remote` and
    `@remote(num_cpus=..., num_gpus=..., resources=..., num_returns=...,
    max_retries=..., name=..., max_restarts=...)`.

    Option keys are validated against the shared key universe
    (`_private/options.py` — the same table `ray_tpu_torch check` enforces
    statically): an unknown key raises ValueError naming the bad key
    and the valid set, instead of being silently ignored."""
    if len(args) == 1 and not options and callable(args[0]):
        return _make_remote(args[0], {})
    if args:
        raise TypeError("remote() takes keyword options only")

    def wrapper(obj):
        return _make_remote(obj, options)

    return wrapper


def _make_remote(obj, options):
    if isinstance(obj, type):
        return ActorClass(obj, options)
    return RemoteFunction(obj, options)


def put(value: Any) -> ObjectRef:
    return _worker().put(value)


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]],
    *,
    timeout: Optional[float] = None,
) -> Any:
    worker = _worker()
    if isinstance(refs, ObjectRef):
        return worker.get([refs], timeout=timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"get() expects ObjectRef or list, got {type(refs)}")
    return worker.get(list(refs), timeout=timeout)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    return _worker().wait(refs, num_returns=num_returns, timeout=timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    _worker().call(
        "kill_actor",
        actor_id=actor.actor_id.binary(),
        no_restart=no_restart,
    )


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    _worker().call("cancel_task", task_id=ref.id().task_id().binary())


def get_actor(
    name: str, namespace: Optional[str] = None
) -> ActorHandle:
    if namespace is None:
        namespace = _worker().namespace
    reply = _worker().call(
        "get_named_actor", name=name, namespace=namespace
    )
    if not reply.get("found"):
        raise ValueError(f"Actor {name!r} not found in namespace {namespace!r}")
    return ActorHandle(ActorID(reply["actor_id"]), reply["handle_meta"] or {})


def cluster_resources() -> Dict[str, float]:
    return _worker().call("cluster_resources")["resources"]


def available_resources() -> Dict[str, float]:
    return _worker().call("available_resources")["resources"]


def nodes() -> List[dict]:
    return _worker().call("list_nodes")["nodes"]


def timeline() -> List[dict]:
    """Task state-transition events (reference: GcsTaskManager ring
    buffer serving `ray.timeline` / the state API)."""
    return _worker().call("list_task_events")["events"]


def state_summary() -> dict:
    return _worker().call("state_summary")["summary"]


def diagnose(
    *,
    hung_task_s: Optional[float] = None,
    straggler_threshold: Optional[float] = None,
    capture_stacks: bool = True,
    leak_age_s: Optional[float] = None,
    locality_miss_threshold: Optional[float] = None,
) -> dict:
    """Stall doctor: one verdict over head task state, per-worker
    in-flight views, step telemetry, and flight-recorder digests —
    stragglers (worker median step time > cluster p50 × threshold),
    hung tasks (in flight past the deadline, stack auto-captured via
    the profile relay), unresponsive workers, dead nodes — plus
    `verdict.memory`: nodes near arena capacity, object-leak
    suspects held past `leak_age_s` by dead owners, and spill
    thrash — plus `verdict.locks`: observed lock-order inversion
    cycles and held-while-blocking sites from every process running
    the lock witness (`RT_lock_witness_enabled=1`; each cycle is
    also a `lock_order_inversion` problem, so the doctor's exit
    code covers deadlock risk). The CLI surface is
    `ray_tpu_torch doctor`; thresholds default
    to the cluster config (`doctor_hung_task_s`,
    `doctor_straggler_threshold`, `doctor_leak_age_s`) — plus
    `verdict.data`: the hottest cross-node flow from the transfer
    matrix, pull- vs restore-dominated classification per job, and
    misplaced-task suspects (task classes pulling most of their get
    bytes from a node that had capacity to run them;
    `doctor_locality_miss_threshold` sets the conviction bar)."""
    kwargs: Dict[str, Any] = {"capture_stacks": capture_stacks}
    if hung_task_s is not None:
        kwargs["hung_task_s"] = float(hung_task_s)
    if straggler_threshold is not None:
        kwargs["straggler_threshold"] = float(straggler_threshold)
    if leak_age_s is not None:
        kwargs["leak_age_s"] = float(leak_age_s)
    if locality_miss_threshold is not None:
        kwargs["locality_miss_threshold"] = float(
            locality_miss_threshold
        )
    # Step records may still sit in this process's metrics buffer.
    # Best-effort: a doctor run against a sick cluster must not die
    # on the flush that the verdict would have explained.
    from .util.metrics import flush_best_effort

    flush_best_effort()
    return _worker().call("diagnose", timeout=120.0, **kwargs)[
        "verdict"
    ]


def profile_gang(
    job_id: Optional[str] = None,
    *,
    duration_s: float = 2.0,
    hz: float = 100.0,
    path: Optional[str] = None,
) -> dict:
    """Coordinated gang profiling: one synchronized profiler window
    across every rank of a gang, merged — with the gang's
    step-telemetry phases — into one chrome trace on a shared clock
    (see `ray_tpu_torch.util.state.profile_gang`; CLI:
    ``ray_tpu_torch profile --job``)."""
    from .util.state import profile_gang as _profile_gang

    return _profile_gang(
        job_id, duration_s=duration_s, hz=hz, path=path
    )


class RuntimeContext:
    """Execution-context introspection (reference:
    python/ray/runtime_context.py:30 RuntimeContext — get_job_id /
    get_node_id / get_task_id / get_actor_id / get_worker_id /
    get_accelerator_ids via ray.get_runtime_context())."""

    def __init__(self, worker):
        self._worker = worker

    def get_job_id(self) -> str:
        return self._worker.job_id.hex()

    def get_node_id(self) -> str:
        return self._worker.node_id.hex()

    def get_worker_id(self) -> str:
        return self._worker.worker_id.hex()

    def get_task_id(self) -> Optional[str]:
        """Id of the task this code runs inside; None on a driver."""
        task_id = getattr(self._worker._ctx, "task_id", None)
        if task_id is None:
            # Async actor methods run on the shared event-loop thread,
            # where identity rides a (asyncio-task-local) contextvar.
            from ._private.worker import _ASYNC_TASK_ID

            task_id = _ASYNC_TASK_ID.get()
        return task_id.hex() if task_id is not None else None

    def get_actor_id(self) -> Optional[str]:
        """Id of the actor this code runs inside; None elsewhere."""
        actor_id = self._worker._actor_id
        return actor_id.hex() if actor_id is not None else None

    def get_accelerator_ids(self) -> Dict[str, List[str]]:
        """GPU ids visible to THIS worker (reference:
        RuntimeContext.get_accelerator_ids). A CPU worker runs under
        CUDA_VISIBLE_DEVICES="" and sees none; a GPU worker, like the
        driver, sees the host's cards: those CUDA_VISIBLE_DEVICES
        names where it is set, else every card the node counts
        (accelerators/nvidia_gpu.py)."""
        from ._private.accelerators import NvidiaGPUAcceleratorManager

        gpu = NvidiaGPUAcceleratorManager
        ids = gpu.get_current_process_visible_accelerator_ids()
        if ids is None:
            ids = [str(i) for i in range(gpu.get_current_node_num_accelerators())]
        return {"GPU": ids}


def get_runtime_context() -> RuntimeContext:
    """The context of the current driver/task/actor (reference:
    python/ray/runtime_context.py:520 get_runtime_context)."""
    return RuntimeContext(_worker())
