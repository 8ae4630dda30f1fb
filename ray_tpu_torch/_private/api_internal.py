# Copied from ray_tpu/_private/api_internal.py (JAX-free): module names read ray_tpu_torch, and the TPU resource is the GPU.
"""Glue between the public decorators and the CoreWorker.

Option resolution mirrors the reference's option table
(reference: python/ray/_private/ray_option_utils.py): `num_cpus`,
`num_gpus` (the cards a task takes), `resources={...}`,
`num_returns`, `max_retries`, actor `name`/`namespace`/`max_restarts`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from .. import exceptions as exc
from ..actor import ActorClass, ActorHandle
from ..remote_function import RemoteFunction
from .runtime_env import prepare_runtime_env
from .worker import CoreWorker, global_worker


def _require_worker() -> CoreWorker:
    worker = global_worker()
    if worker is None:
        raise exc.RayTpuError(
            "ray_tpu_torch.init() must be called before using the API"
        )
    return worker


def _flatten_args(args: tuple, kwargs: dict) -> Sequence[Any]:
    # Kwargs ride as a trailing marker tuple; the executor re-splits.
    if not kwargs:
        return list(args)
    return list(args) + [("__kwargs__", kwargs)]


#: Interned resource dicts: nearly every task in a big submission
#: shares one of a handful of shapes ({"CPU": 1.0}, ...), and a fresh
#: dict per task measured ~165 B/task of the driver's 1M-queue RSS.
#: Shared dicts are safe because NOTHING mutates a spec's resources
#: in the submitting process (rewrite_request copies; the daemon
#: works on its own unpickled copy). Bounded so adversarial unique
#: shapes can't grow it without limit.
_RESOURCE_INTERN: Dict[tuple, dict] = {}


def _task_resources(options: Dict[str, Any], default_cpu: float) -> dict:
    num_cpus = options.get("num_cpus")
    num_gpus = options.get("num_gpus")
    if (
        not options.get("resources")
        and num_cpus is None
        and not num_gpus
    ):
        # Fast path for the overwhelmingly common default shape: no
        # per-task dict build, no sort key (the submit hot path runs
        # this once per task at 15k+/s).
        key = ("default", default_cpu)
        cached = _RESOURCE_INTERN.get(key)
        if cached is None:
            cached = {"CPU": float(default_cpu)} if default_cpu else {}
            _RESOURCE_INTERN[key] = cached
        return cached
    resources = dict(options.get("resources") or {})
    resources["CPU"] = float(default_cpu if num_cpus is None else num_cpus)
    if num_gpus:
        resources["GPU"] = float(num_gpus)
    out = {k: v for k, v in resources.items() if v}
    key = tuple(sorted(out.items()))
    cached = _RESOURCE_INTERN.get(key)
    if cached is not None:
        return cached
    if len(_RESOURCE_INTERN) < 1024:
        _RESOURCE_INTERN[key] = out
    return out


def _export_cached(obj, cache_holder, attr: str, worker) -> str:
    """Export once per session: the cache is invalidated when the
    worker changes (shutdown()+init() starts a fresh KV). Keyed on the
    worker's generation token so a module-level @remote function doesn't
    pin a dead worker (and its RPC client) alive after shutdown()."""
    cached = getattr(cache_holder, attr)
    if cached is not None and cached[0] == worker.generation:
        return cached[1]
    key = worker.functions.export(obj)
    setattr(cache_holder, attr, (worker.generation, key))
    return key


_strategy_to_spec = None


def _strategy(options: Dict[str, Any]):
    global _strategy_to_spec
    if _strategy_to_spec is None:  # one-time import, off the hot path
        from ..util.scheduling_strategies import strategy_to_spec

        _strategy_to_spec = strategy_to_spec
    return _strategy_to_spec(options.get("scheduling_strategy"))


def _resolve_placement(
    options: Dict[str, Any], resources: dict, worker: CoreWorker
):
    """Rewrite a placement-group-targeted request onto the group's
    formatted resources (reference: BundleSpecification formatted
    resources; the scheduler then needs no PG special-casing).

    A task running inside a capturing group submits children that
    inherit the group (wildcard bundle) unless they name their own
    strategy (reference: placement_group_capture_child_tasks,
    actor.py:890). Returns (resources, strategy_spec, pg_context).
    """
    from .placement_groups import rewrite_request

    spec = _strategy(options)
    if not spec and options.get("scheduling_strategy") is None:
        inherited = worker.current_pg_context()
        if inherited is not None:
            rewritten = rewrite_request(resources, inherited["pg_id"], -1)
            return rewritten, {"type": "DEFAULT"}, inherited
    if not spec or spec.get("type") != "PLACEMENT_GROUP":
        return resources, spec, None
    rewritten = rewrite_request(
        resources, spec["pg_id"], spec.get("bundle_index", -1)
    )
    pg_context = (
        {"pg_id": spec["pg_id"]} if spec.get("capture") else None
    )
    return rewritten, {"type": "DEFAULT"}, pg_context


def submit_function(rf: RemoteFunction, args: tuple, kwargs: dict):
    worker = _require_worker()
    plan = rf._submit_plan
    if (
        plan is not None
        and plan[0] == worker.generation
        and worker.current_pg_context() is None
    ):
        # Hot path: every option was resolved ONCE for this (function,
        # session) pair — a 20k/s submit loop re-derives nothing. Only
        # an inherited placement-group capture context (dynamic,
        # per-executing-task) forces the full resolution below.
        _, func_key, name, num_returns, resources, max_retries = plan
        refs = worker.submit_task(
            func_key,
            _flatten_args(args, kwargs),
            name=name,
            num_returns=num_returns,
            resources=resources,
            max_retries=max_retries,
        )
        return refs[0] if num_returns == 1 else refs
    opts = rf.task_options
    func_key = _export_cached(rf.underlying, rf, "_exported_key", worker)
    num_returns = opts.get("num_returns", 1)
    resources = _task_resources(opts, default_cpu=1.0)
    pg_context = None
    if opts.get("_skip_pg_rewrite"):
        strategy = _strategy(opts)
    else:
        resources, strategy, pg_context = _resolve_placement(
            opts, resources, worker
        )
    _validate_num_returns(num_returns)
    name = opts.get("name") or rf.underlying.__name__
    max_retries = opts.get("max_retries", worker.config.task_max_retries)
    runtime_env = prepare_runtime_env(opts.get("runtime_env"), worker)
    if (
        not strategy
        and pg_context is None
        and runtime_env is None
        and not opts.get("_skip_pg_rewrite")
        and isinstance(num_returns, int)
    ):
        # Static options: memoize the resolved plan for this session
        # (generation-keyed like _exported_key, so a dead worker's
        # plan never outlives shutdown()+init()).
        rf._submit_plan = (
            worker.generation, func_key, name, num_returns,
            resources, max_retries,
        )
    refs = worker.submit_task(
        func_key,
        _flatten_args(args, kwargs),
        # name= is a display-name override (reference: task options
        # name); the option-key universe lives in _private/options.py.
        name=name,
        num_returns=num_returns,
        resources=resources,
        max_retries=max_retries,
        scheduling_strategy=strategy,
        pg_context=pg_context,
        runtime_env=runtime_env,
    )
    return _generator_or_refs(refs, num_returns, worker)


def _validate_num_returns(num_returns) -> None:
    if isinstance(num_returns, str):
        if num_returns not in ("dynamic", "streaming"):
            raise ValueError(
                'num_returns must be an int, "dynamic", or "streaming"'
            )
    elif not isinstance(num_returns, int) or num_returns < 1:
        raise ValueError(f"bad num_returns: {num_returns!r}")


def _generator_or_refs(refs, num_returns, worker):
    """Map declared returns to the user-facing handle (reference:
    remote_function.py:385-391 — "streaming" hands back a generator
    immediately; "dynamic" hands back one ref whose value resolves to
    the generator once the task finishes)."""
    if num_returns == "streaming":
        from ..object_ref import ObjectRefGenerator

        # The generator must keep the submit-returned primary ref
        # alive: it holds the owner-side future __next__ waits on.
        return ObjectRefGenerator(
            refs[0].id().task_id(), owner=worker, primary_ref=refs[0]
        )
    if num_returns == "dynamic":
        return refs[0]
    return refs[0] if num_returns == 1 else refs


def create_actor(ac: ActorClass, args: tuple, kwargs: dict) -> ActorHandle:
    worker = _require_worker()
    opts = ac.actor_options
    class_key = _export_cached(ac.underlying, ac, "_exported_key", worker)
    # Named concurrency groups (reference: core_worker/transport/
    # concurrency_group_manager.h): each group is an independent
    # executor of the given width; methods without a group run in the
    # default pool (width = max_concurrency).
    concurrency_groups = opts.get("concurrency_groups") or {}
    for gname, width in concurrency_groups.items():
        if not isinstance(gname, str) or not gname:
            raise ValueError(
                f"concurrency group names must be non-empty strings: "
                f"{gname!r}"
            )
        if not isinstance(width, int) or width < 1:
            raise ValueError(
                f"concurrency group {gname!r} needs a positive int "
                f"width, got {width!r}"
            )
    # @rt.method definition-time defaults, resolved once here so every
    # handle (including deserialized ones) sees them via the meta.
    method_defaults = {}
    for mname in ac.method_names():
        fn = getattr(ac.underlying, mname, None)
        mopts = getattr(fn, "__rt_method_options__", None)
        if mopts:
            group = mopts.get("concurrency_group")
            if group is not None and group not in concurrency_groups:
                raise ValueError(
                    f"method {mname!r} names unknown concurrency "
                    f"group {group!r} (declared: "
                    f"{sorted(concurrency_groups)})"
                )
            method_defaults[mname] = dict(mopts)
    meta = {
        "class_name": ac.underlying.__name__,
        "methods": ac.method_names(),
        "class_key": class_key,
        "concurrency_groups": concurrency_groups,
        "method_defaults": method_defaults,
    }
    # Default actors require 1 CPU to *schedule* but hold 0 for their
    # lifetime (reference: ray_option_utils.py actor defaults —
    # DEFAULT_ACTOR_CREATION_CPU_SIMPLE=0; the 1 CPU gates placement
    # and is released once the actor is up, so more default actors than
    # node CPUs still come up). Explicitly-specified resources are held
    # for the actor's lifetime; an EXPLICIT num_cpus=0 yields {} —
    # schedulable anywhere in any number.
    default_resources = (
        opts.get("num_cpus") is None
        and not opts.get("num_gpus")
        and not opts.get("resources")
    )
    resources, strategy, pg_context = _resolve_placement(
        opts, _task_resources(opts, default_cpu=1.0), worker
    )
    # A PG-targeted actor occupies its bundle slot for its lifetime
    # even with default resources (the rewritten bundle-scoped CPU is
    # the slot), so only non-PG default actors release after placement.
    release_after_up = default_resources and resources == {"CPU": 1.0}
    actor_id = worker.create_actor(
        class_key,
        _flatten_args(args, kwargs),
        class_name=ac.underlying.__name__,
        name=opts.get("name"),
        namespace=opts.get("namespace") or worker.namespace,
        resources=resources,
        max_restarts=opts.get("max_restarts", 0),
        max_concurrency=int(opts.get("max_concurrency", 1)),
        concurrency_groups=concurrency_groups,
        handle_meta=meta,
        scheduling_strategy=strategy,
        pg_context=pg_context,
        runtime_env=prepare_runtime_env(
            opts.get("runtime_env"), worker
        ),
        release_creation_resources=release_after_up,
    )
    return ActorHandle(actor_id, meta)


def submit_actor_method(
    handle: ActorHandle,
    method: str,
    args: tuple,
    kwargs: dict,
    num_returns=1,
    concurrency_group=None,
):
    worker = _require_worker()
    _validate_num_returns(num_returns)
    if concurrency_group is not None:
        declared = handle._meta.get("concurrency_groups")
        # Meta from older handles may lack the key; validate when the
        # declaration is known, else let the worker fall back to the
        # default pool.
        if declared is not None and concurrency_group not in declared:
            raise ValueError(
                f"unknown concurrency group {concurrency_group!r} "
                f"(actor declares: {sorted(declared)})"
            )
    refs = worker.submit_actor_task(
        handle.actor_id,
        method,
        _flatten_args(args, kwargs),
        num_returns=num_returns,
        concurrency_group=concurrency_group,
    )
    return _generator_or_refs(refs, num_returns, worker)
