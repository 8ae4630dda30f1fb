"""The port's copy of the actor runtime (`ray_tpu_torch.init`, tasks,
actors, objects, direct calls), mirroring a subset of
`tests/test_core_api.py` and `tests/test_direct_calls.py` with the same
assertions, on one cluster shared by the module. Imports nothing of
`ray_tpu` (nor JAX)."""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import exceptions as exc

NUM_CPUS = 4


@pytest.fixture(scope="module", autouse=True)
def cluster():
    rt.init(num_cpus=NUM_CPUS)
    try:
        yield
    finally:
        rt.shutdown()


def _direct_manager():
    from ray_tpu_torch._private.worker import global_worker

    return global_worker()._direct


# ---- tests/test_core_api.py ---------------------------------------------

def test_simple_task():
    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get(add.remote(1, 2)) == 3


def test_task_kwargs_and_closure():
    base = 100

    @rt.remote
    def f(a, b=10):
        return a + b + base

    assert rt.get(f.remote(1)) == 111
    assert rt.get(f.remote(1, b=20)) == 121


def test_many_tasks():
    @rt.remote
    def sq(x):
        return x * x

    refs = [sq.remote(i) for i in range(50)]
    assert rt.get(refs) == [i * i for i in range(50)]


def test_put_get_roundtrip_small():
    ref = rt.put({"a": [1, 2, 3], "b": "hello"})
    assert rt.get(ref) == {"a": [1, 2, 3], "b": "hello"}


def test_put_get_large_numpy_zero_copy():
    arr = np.arange(500_000, dtype=np.float32).reshape(500, 1000)
    ref = rt.put(arr)
    out = rt.get(ref)
    np.testing.assert_array_equal(out, arr)
    # Large objects come back as views over shared memory (zero-copy).
    assert not out.flags.writeable


def test_object_ref_as_arg():
    @rt.remote
    def total(x):
        return float(x.sum())

    arr = np.ones(300_000, dtype=np.float64)
    ref = rt.put(arr)
    assert rt.get(total.remote(ref)) == 300_000.0


def test_chained_tasks():
    @rt.remote
    def inc(x):
        return x + 1

    ref = inc.remote(0)
    for _ in range(5):
        ref = inc.remote(ref)
    assert rt.get(ref) == 6


def test_num_returns():
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert rt.get([a, b, c]) == [1, 2, 3]


def test_task_error_propagates_type():
    @rt.remote
    def boom():
        raise ValueError("broken")

    with pytest.raises(ValueError, match="broken"):
        rt.get(boom.remote())


def test_error_propagates_through_dependency():
    @rt.remote
    def boom():
        raise KeyError("first")

    @rt.remote
    def use(x):
        return x

    with pytest.raises(KeyError):
        rt.get(use.remote(boom.remote()))


def test_get_timeout():
    @rt.remote
    def slow():
        time.sleep(3)

    with pytest.raises(exc.GetTimeoutError):
        rt.get(slow.remote(), timeout=0.2)


def test_wait():
    @rt.remote
    def fast(i):
        return i

    @rt.remote
    def slow():
        time.sleep(3)

    refs = [fast.remote(i) for i in range(3)] + [slow.remote()]
    ready, remaining = rt.wait(refs, num_returns=3, timeout=10)
    assert len(ready) == 3
    assert len(remaining) == 1


def test_nested_tasks():
    @rt.remote
    def inner(x):
        return x * 2

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x)) + 1

    assert rt.get(outer.remote(10)) == 21


def test_actor_basics():
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.v = start

        def inc(self, by=1):
            self.v += by
            return self.v

        def value(self):
            return self.v

    c = Counter.remote(5)
    assert rt.get(c.inc.remote()) == 6
    assert rt.get(c.inc.remote(by=4)) == 10
    assert rt.get(c.value.remote()) == 10


def test_actor_ordering():
    @rt.remote
    class Appender:
        def __init__(self):
            self.items = []

        def append(self, x):
            self.items.append(x)

        def get(self):
            return self.items

    a = Appender.remote()
    refs = [a.append.remote(i) for i in range(20)]
    rt.get(refs)
    assert rt.get(a.get.remote()) == list(range(20))


def test_named_actor():
    @rt.remote
    class Registry:
        def ping(self):
            return "pong"

    Registry.options(name="reg").remote()
    handle = rt.get_actor("reg")
    assert rt.get(handle.ping.remote()) == "pong"


def test_actor_handle_passing():
    @rt.remote
    class Store:
        def __init__(self):
            self.v = 0

        def set(self, v):
            self.v = v

        def get(self):
            return self.v

    @rt.remote
    def writer(store):
        rt.get(store.set.remote(42))
        return True

    s = Store.remote()
    rt.get(writer.remote(s))
    assert rt.get(s.get.remote()) == 42


def test_actor_error():
    @rt.remote
    class Bad:
        def fail(self):
            raise RuntimeError("actor method failed")

    b = Bad.remote()
    with pytest.raises(RuntimeError, match="actor method failed"):
        rt.get(b.fail.remote())


def test_kill_actor():
    @rt.remote
    class Victim:
        def ping(self):
            return "alive"

    v = Victim.remote()
    assert rt.get(v.ping.remote()) == "alive"
    rt.kill(v)
    with pytest.raises(
        (exc.ActorDiedError, exc.ActorUnavailableError, exc.WorkerCrashedError)
    ):
        rt.get(v.ping.remote(), timeout=10)


def test_actor_restart_keeps_creation_args_pinned():
    """Creation args survive the caller dropping its ObjectRef: the
    restart re-runs the creation task with the same args."""

    @rt.remote(max_restarts=1)
    class Holder:
        def __init__(self, payload):
            self.total = int(payload.sum())

        def value(self):
            return self.total

        def die(self):
            os._exit(1)

    arr = np.ones(300_000, dtype=np.float32)  # large -> real shm object
    ref = rt.put(arr)
    h = Holder.remote(ref)
    assert rt.get(h.value.remote(), timeout=30) == 300_000
    del ref
    with pytest.raises(
        (exc.ActorDiedError, exc.ActorUnavailableError, exc.WorkerCrashedError)
    ):
        rt.get(h.die.remote(), timeout=30)
    assert rt.get(h.value.remote(), timeout=30) == 300_000


def test_cluster_resources():
    total = rt.cluster_resources()
    assert total["CPU"] == float(NUM_CPUS)


def test_fractional_resources():
    @rt.remote(num_cpus=0.5)
    def half():
        return 1

    assert rt.get([half.remote() for _ in range(8)]) == [1] * 8


def test_task_events_recorded():
    @rt.remote
    def traced():
        return 1

    rt.get(traced.remote())
    states = []
    for _ in range(50):
        events = rt.timeline()
        states = [e["state"] for e in events if e["name"] == "traced"]
        if "FINISHED" in states:
            break
        time.sleep(0.1)
    assert "RUNNING" in states
    assert "FINISHED" in states


def test_runtime_context():
    """Job/node/task/actor identity in every execution context; the
    accelerator family is the GPU."""
    ctx = rt.get_runtime_context()
    assert len(ctx.get_job_id()) > 0
    assert len(ctx.get_node_id()) == 32
    assert ctx.get_task_id() is None  # driver
    assert ctx.get_actor_id() is None
    assert "GPU" in ctx.get_accelerator_ids()

    @rt.remote
    def inside_task():
        c = rt.get_runtime_context()
        return (c.get_task_id(), c.get_actor_id(), c.get_job_id(),
                c.get_accelerator_ids())

    task_id, actor_id, job_id, ids = rt.get(inside_task.remote(), timeout=30)
    assert task_id is not None and actor_id is None
    assert job_id == ctx.get_job_id()
    # A CPU worker sees no card.
    assert ids == {"GPU": []}

    @rt.remote
    class Inside:
        def who(self):
            c = rt.get_runtime_context()
            return (c.get_actor_id(), c.get_task_id())

    a = Inside.remote()
    actor_id, task_id = rt.get(a.who.remote(), timeout=30)
    assert actor_id is not None and task_id is not None


def test_runtime_context_async_actor():
    @rt.remote(max_concurrency=4)
    class AsyncIdent:
        async def who(self):
            import asyncio

            c = rt.get_runtime_context()
            first = c.get_task_id()
            await asyncio.sleep(0.05)  # force interleaving
            return (first, c.get_task_id())

    a = AsyncIdent.remote()
    pairs = rt.get([a.who.remote() for _ in range(4)], timeout=30)
    ids = set()
    for first, after_await in pairs:
        assert first is not None
        assert first == after_await
        ids.add(first)
    assert len(ids) == 4


def test_duplicate_actor_name_surfaces_error():
    @rt.remote
    class Named:
        def ping(self):
            return "first"

    first = Named.options(name="dup-name").remote()
    assert rt.get(first.ping.remote(), timeout=60) == "first"
    second = Named.options(name="dup-name").remote()
    with pytest.raises(Exception) as exc_info:
        rt.get(second.ping.remote(), timeout=30)
    assert "dead" in str(exc_info.value).lower() or "registration" in str(
        exc_info.value
    ).lower()
    assert rt.get(first.ping.remote(), timeout=60) == "first"


# ---- the accelerator port ------------------------------------------------

def test_cpu_workers_hide_the_cards():
    """Every worker of a task without num_gpus runs under
    CUDA_VISIBLE_DEVICES="" (the JAX runtime's TPU_VISIBLE_CHIPS="")."""

    @rt.remote
    def probe():
        import torch

        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                os.environ.get("RT_WORKER_GPU"), torch.cuda.is_available())

    assert rt.get(probe.remote(), timeout=30) == ("", "0", False)


def test_num_gpus_is_the_gpu_resource():
    from ray_tpu_torch._private.api_internal import _task_resources

    assert _task_resources({"num_gpus": 1}, 1.0) == {"CPU": 1.0, "GPU": 1.0}
    # This node has no card: a num_gpus task cannot be placed.
    assert "GPU" not in rt.cluster_resources()


# ---- tests/test_direct_calls.py -------------------------------------------

def test_direct_path_engaged():
    @rt.remote
    def f(x):
        return x * 2

    assert rt.get(f.remote(21)) == 42
    mgr = _direct_manager()
    assert mgr is not None
    assert any(ks.leases for ks in mgr._keys.values())


def test_direct_num_returns():
    @rt.remote
    def pair():
        return 1, 2

    a, b = pair.options(num_returns=2).remote()
    assert rt.get(a) == 1 and rt.get(b) == 2


def test_direct_ref_arg_chain():
    @rt.remote
    def add1(x):
        return x + 1

    ref = add1.remote(0)
    for _ in range(20):
        ref = add1.remote(ref)
    assert rt.get(ref) == 21


def test_direct_large_result_zero_copy():
    @rt.remote
    def make(n):
        return np.arange(n, dtype=np.float64)

    out = rt.get(make.remote(1_000_000))  # ~8 MB -> shm path
    assert out.shape == (1_000_000,)
    assert float(out[-1]) == 999_999.0


def test_direct_nested_ref_published():
    @rt.remote
    def produce():
        return "payload"

    @rt.remote
    def consume(box):
        return rt.get(box["ref"])

    inner = produce.remote()
    assert rt.get(consume.remote({"ref": inner})) == "payload"


def test_direct_temp_dep_ref_pinned():
    @rt.remote
    def boom():
        raise KeyError("first")

    @rt.remote
    def use(x):
        return x

    with pytest.raises(Exception, match="first"):
        rt.get(use.remote(boom.remote()), timeout=30)

    @rt.remote
    def make():
        return 7

    assert rt.get(use.remote(make.remote()), timeout=30) == 7


def test_direct_actor_roundtrip_and_latency():
    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    c = Counter.remote()
    assert rt.get(c.inc.remote()) == 1
    refs = [c.inc.remote() for _ in range(50)]
    assert rt.get(refs) == list(range(2, 52))


# ---- torch tensors through tasks ----------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64])
def test_tensor_through_a_task(dtype):
    x = torch.arange(1 << 20).to(dtype).reshape(1024, 1024)

    @rt.remote
    def twice(t):
        return t * 2, t.dtype, t.shape

    doubled, got_dtype, shape = rt.get(twice.remote(rt.put(x)), timeout=30)
    assert got_dtype == dtype and shape == x.shape
    assert torch.equal(doubled, x * 2)


def test_card_count_follows_cuda_visible_devices(monkeypatch):
    """The node's "GPU" count: CUDA_VISIBLE_DEVICES where set (empty: no
    card), else the driver's /proc entries or `nvidia-smi -L`."""
    from ray_tpu_torch._private.accelerators import (
        NvidiaGPUAcceleratorManager as gpu,
    )

    monkeypatch.delenv("RT_NUM_GPUS", raising=False)
    for visible, want in (("0,1,3", 3), ("", 0), ("2", 1)):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
        gpu.get_current_node_num_accelerators.cache_clear()
        assert gpu.get_current_node_num_accelerators() == want
    gpu.get_current_node_num_accelerators.cache_clear()


def test_runtime_env_cache_lies_in_the_temporary_directory():
    """The runtime_env cache (pip, conda, packages, files) lies under the
    process's temporary directory, under a name of the port's own, so
    neither another checkout's runs nor the JAX package's runtime share
    it."""
    import tempfile

    from ray_tpu_torch._private import runtime_env

    root = runtime_env._CACHE_ROOT
    assert os.path.dirname(root) == tempfile.gettempdir()
    assert os.path.basename(root) == "rt_torch_runtime_env_cache"
