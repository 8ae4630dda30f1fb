# Copied from ray_tpu/_private/options.py (JAX-free): module names read ray_tpu_torch, and the TPU resource is the GPU.
"""Single source of truth for task/actor option keys.

Reference: python/ray/_private/ray_option_utils.py — one table names
every legal ``@remote(...)`` / ``.options(...)`` key with its accepted
value shape, and both the submission path and the validators consume
it. Here the same table backs BOTH enforcement layers:

* runtime — ``validate_options()`` is called from
  ``RemoteFunction.options()`` / ``ActorClass.options()`` and the
  ``@rt.remote(...)`` decorator (``api._make_remote``), so a typo'd
  key (``num_cpu=1``) raises immediately instead of being silently
  merged and ignored by ``api_internal.submit_function``;
* static — ``ray_tpu_torch check`` (devtools/check.py, rule RT102) imports
  the same tables to flag unknown or mistyped option keys at call
  sites without running anything.

The accepted-type tuples describe *literal* values for the static
checker; the runtime validator enforces only key membership (values
may legitimately be computed objects, e.g. scheduling strategies).
A ``None`` spec means "any value" — no literal type check.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

#: Option keys consumed by api_internal.submit_function. The spec
#: tuple lists the python types a LITERAL value may take (bool is
#: deliberately absent from numeric specs: num_cpus=True is a bug).
TASK_OPTIONS: Dict[str, Optional[Tuple[type, ...]]] = {
    "num_cpus": (int, float),
    "num_gpus": (int, float),
    "resources": (dict, type(None)),
    "num_returns": (int, str),  # ints, or "dynamic"/"streaming"
    "max_retries": (int,),
    "name": (str,),
    "scheduling_strategy": None,  # str or strategy object
    "runtime_env": (dict, type(None)),
    # internal: placement_groups.py submits its marker task with the
    # PG rewrite disabled (the marker IS the group's formatted
    # resource request).
    "_skip_pg_rewrite": (bool,),
}

#: Option keys consumed by api_internal.create_actor.
ACTOR_OPTIONS: Dict[str, Optional[Tuple[type, ...]]] = {
    "num_cpus": (int, float),
    "num_gpus": (int, float),
    "resources": (dict, type(None)),
    "name": (str,),
    "namespace": (str,),
    "max_restarts": (int,),
    "max_concurrency": (int,),
    "concurrency_groups": (dict, type(None)),
    "scheduling_strategy": None,
    "runtime_env": (dict, type(None)),
}

#: String forms num_returns accepts besides ints.
NUM_RETURNS_STRINGS = ("dynamic", "streaming")


def valid_keys(kind: str) -> Tuple[str, ...]:
    """Public (non-underscore) option keys for 'task' or 'actor'."""
    table = TASK_OPTIONS if kind == "task" else ACTOR_OPTIONS
    return tuple(sorted(k for k in table if not k.startswith("_")))


def validate_options(kind: str, options: Dict[str, Any]) -> None:
    """Reject unknown option keys with an error naming the bad key and
    the valid key set. `kind` is 'task' or 'actor'."""
    table = TASK_OPTIONS if kind == "task" else ACTOR_OPTIONS
    unknown = sorted(k for k in options if k not in table)
    if unknown:
        target = "task" if kind == "task" else "actor"
        raise ValueError(
            f"unknown {target} option key(s): {', '.join(unknown)}. "
            f"Valid {target} options: {', '.join(valid_keys(kind))}"
        )
