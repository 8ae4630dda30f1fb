"""Shared by the port's parity tests (`tests/test_torch_*.py`)."""

import pytest
import torch

from ray_tpu._private import compile_watch, step_telemetry


@pytest.fixture(autouse=True, scope="module")
def isolated_module():
    """Keep a parity module from disturbing the tests that share its
    worker process: torch computes on one thread (the suite runs
    several workers on a few cores, beside timing-sensitive tests), and
    the JAX package's compile watch is off, since it bills every JAX
    compile as `compile_ms` to the thread's step telemetry and queues a
    metric record. On the way out the thread's step-telemetry phases
    are drained, whichever earlier module left them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(compile_watch, "_enabled", False)
            yield
    finally:
        torch.set_num_threads(threads)
        step_telemetry.take_phases()
