# Copied from ray_tpu/_private/function_manager.py (JAX-free): module names read ray_tpu_torch.
"""Function/actor-class export through the control-plane KV.

Same protocol as the reference (reference:
python/ray/_private/function_manager.py:58 — driver pickles the
function with cloudpickle, exports it into the GCS KV under a digest
key; executing workers lazily fetch + unpickle + cache, :196 export,
:265 fetch_and_register).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Callable, Dict

import cloudpickle

_NS = "fn"


class FunctionManager:
    def __init__(self, rpc_client):
        self._client = rpc_client
        self._exported: set = set()
        self._cache: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def export(self, obj: Callable | type) -> str:
        """Pickle and upload; returns the KV key (content digest)."""
        blob = cloudpickle.dumps(obj)
        key = hashlib.sha256(blob).hexdigest()[:32]
        with self._lock:
            if key in self._exported:
                return key
        self._client.call(
            "kv_put", ns=_NS, key=key, value=blob, overwrite=False
        )
        with self._lock:
            self._exported.add(key)
            self._cache[key] = obj
        return key

    def fetch(self, key: str) -> Any:
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        reply = self._client.call("kv_get", ns=_NS, key=key)
        blob = reply.get("value")
        if blob is None:
            raise KeyError(f"function {key} not found in KV")
        obj = cloudpickle.loads(blob)
        with self._lock:
            self._cache[key] = obj
        return obj
