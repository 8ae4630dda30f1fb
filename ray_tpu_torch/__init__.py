"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper
(H100).

It mirrors `ray_tpu`'s layout: the actor runtime (`init`, `remote`,
`get`, `put`, `wait`, actors, the object store, the daemon and its
workers, `dag`, `serve`), copied, and the compute stack (`ops/`, `models/`,
`parallel/`, `train/`, `llm/`), ported. It imports `torch` and never
`jax` or anything under `ray_tpu`; what it needs from a `ray_tpu` module
it keeps as its own copy. Flash attention runs on CUDA kernels written
for sm_90a (`csrc/`), built with nvcc at first use. Entry points run on
"cuda" unless the caller passes `device="cpu"`.

Importing the package loads the runtime only, as `import ray_tpu`
does: the compute exports import torch at first use, so a CPU worker
process of the runtime starts without it.
"""

import importlib

from . import exceptions
from .actor import ActorClass, ActorHandle, method
from .api import (
    available_resources,
    cancel,
    cluster_resources,
    diagnose,
    get,
    get_actor,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    nodes,
    profile_gang,
    put,
    remote,
    shutdown,
    state_summary,
    timeline,
    wait,
)
from .object_ref import ObjectRef, ObjectRefGenerator
from .remote_function import RemoteFunction

__version__ = "0.1.0"

#: Compute exports, imported at first use: name -> (module, attribute).
_LAZY = {
    "llm": ("llm", None),
    "models": ("models", None),
    "ops": ("ops", None),
    "parallel": ("parallel", None),
    "train": ("train", None),
    "LlamaConfig": ("models", "LlamaConfig"),
    "init_params": ("models", "init_params"),
    "loss_fn": ("models", "loss_fn"),
    "flash_attention": ("ops", "flash_attention"),
    "default_optimizer": ("train", "default_optimizer"),
    "make_train_step": ("train", "make_train_step"),
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attribute = _LAZY[name]
    value = importlib.import_module(f".{module}", __name__)
    if attribute is not None:
        value = getattr(value, attribute)
    globals()[name] = value
    return value


__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "method",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "get_actor",
    "get_runtime_context",
    "nodes",
    "cluster_resources",
    "available_resources",
    "timeline",
    "state_summary",
    "diagnose",
    "profile_gang",
    "ObjectRef",
    "ObjectRefGenerator",
    "ActorClass",
    "ActorHandle",
    "RemoteFunction",
    "exceptions",
    "__version__",
    *_LAZY,
]
