# Copied from ray_tpu/remote_function.py (JAX-free): module names read ray_tpu_torch.
"""@remote functions (reference: python/ray/remote_function.py —
RemoteFunction._remote:303 submits through the core worker; .options()
re-binds per-call overrides)."""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional


class RemoteFunction:
    def __init__(self, func, options: Optional[Dict[str, Any]] = None):
        from ._private.options import validate_options

        self._function = func
        self._options = dict(options or {})
        # Every construction path (decorator, .options() clone) funnels
        # here: a typo'd key raises with the valid key set instead of
        # being silently merged and ignored at submission.
        validate_options("task", self._options)
        self._exported_key: Optional[str] = None
        #: (generation, func_key, name, num_returns, resources,
        #: max_retries) — resolved-once submit plan for static options
        #: (api_internal.submit_function hot path). Never copied by
        #: .options(): a clone's options differ by construction.
        self._submit_plan = None
        functools.update_wrapper(self, func)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            "Remote functions cannot be called directly; use "
            f"{self._function.__name__}.remote()."
        )

    def options(self, **overrides) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(overrides)
        clone = RemoteFunction(self._function, merged)
        clone._exported_key = self._exported_key
        return clone

    def remote(self, *args, **kwargs):
        from ._private.api_internal import submit_function

        return submit_function(self, args, kwargs)

    def bind(self, *args, **kwargs):
        """Lazy DAG node for this task invocation (reference:
        python/ray/dag/function_node.py)."""
        from .dag.dag_node import FunctionNode

        return FunctionNode(self, args, kwargs)

    # internal
    @property
    def underlying(self):
        return self._function

    @property
    def task_options(self) -> Dict[str, Any]:
        return self._options
