# Copied from ray_tpu/autoscaler/sdk.py (JAX-free): module names read ray_tpu_torch.
"""Programmatic autoscaler API.

Reference: python/ray/autoscaler/sdk/__init__.py request_resources —
applications command a standing capacity target ("make sure the
cluster can hold this much") independent of any queued work; the
autoscaler scales up to satisfy it and holds the satisfying nodes
against idle scale-down until the target is replaced.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def request_resources(
    num_cpus: Optional[int] = None,
    bundles: Optional[List[Dict[str, float]]] = None,
) -> int:
    """Set (REPLACE) the cluster's standing resource target.

    `num_cpus=N` expands to N one-CPU bundles (the reference's
    semantics — aggregate CPU capacity, placeable anywhere); N must
    be a non-negative integer (integral floats like `4.0` are
    accepted; `2.5` is an error, never a silent truncation to 2, and
    `num_cpus=0` is an explicit clear). `bundles` is a list of
    resource dicts that must each fit on some node. Calling with
    neither (or `bundles=[]`) clears the target, letting idle nodes
    scale down again. Returns the number of bundles now standing.
    """
    # Argument validation happens BEFORE any cluster traffic (and
    # before the worker lookup): a bad target must never half-apply.
    if num_cpus is not None:
        if isinstance(num_cpus, bool) or not isinstance(
            num_cpus, (int, float)
        ):
            raise TypeError(
                f"num_cpus must be an integer, got "
                f"{type(num_cpus).__name__}"
            )
        if num_cpus < 0:
            raise ValueError(f"num_cpus must be >= 0, got {num_cpus}")
        if isinstance(num_cpus, float) and not num_cpus.is_integer():
            raise ValueError(
                f"num_cpus must be a whole number of CPUs, got "
                f"{num_cpus} (fractional targets are not truncated)"
            )
    from .._private.worker import global_worker

    worker = global_worker()
    if worker is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    out: List[Dict[str, float]] = []
    if num_cpus:
        out.extend({"CPU": 1.0} for _ in range(int(num_cpus)))
    for bundle in bundles or ():
        # Same contract as placement_group(): non-empty
        # {resource: amount > 0} dicts — a zero/negative amount would
        # trivially "fit" every node and pin it against scale-down
        # forever.
        if not isinstance(bundle, dict) or not bundle:
            raise ValueError(
                f"bundles must be non-empty dicts, got {bundle!r}"
            )
        clean = {}
        for name, amount in bundle.items():
            amount = float(amount)
            if amount <= 0:
                raise ValueError(
                    f"bundle amounts must be > 0, got "
                    f"{name}={amount} in {bundle!r}"
                )
            clean[name] = amount
        out.append(clean)
    return worker.call("request_resources", bundles=out)["count"]
