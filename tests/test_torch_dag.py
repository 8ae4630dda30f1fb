"""The port's copy of `dag` (interpreted bind/execute graphs and
compiled actor pipelines over channels), mirroring a subset of
`tests/test_dag.py` with the same assertions, on one cluster shared by
the module. Imports nothing of `ray_tpu` (nor JAX)."""

import time

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.dag import InputNode, MultiOutputNode, experimental_compile


@pytest.fixture(scope="module", autouse=True)
def cluster():
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()


def test_interpreted_task_dag():
    @rt.remote
    def double(x):
        return 2 * x

    @rt.remote
    def add(a, b):
        return a + b

    with InputNode() as inp:
        dag = add.bind(double.bind(inp), double.bind(inp))
    assert rt.get(dag.execute(3), timeout=20) == 12
    assert rt.get(dag.execute(5), timeout=20) == 20


def test_interpreted_actor_dag():
    @rt.remote
    class Acc:
        def __init__(self):
            self.total = 0

        def add(self, x):
            self.total += x
            return self.total

    acc = Acc.remote()
    with InputNode() as inp:
        dag = acc.add.bind(inp)
    assert rt.get(dag.execute(2), timeout=20) == 2
    assert rt.get(dag.execute(3), timeout=20) == 5


def test_shm_channel_roundtrip():
    from ray_tpu_torch.dag.channels import ShmChannel

    chan = ShmChannel(1 << 16)
    try:
        chan.put(("v", [1, 2, 3]))
        chan.put(("v", "x" * 30000))  # forces wraparound next
        assert chan.get(timeout=1) == ("v", [1, 2, 3])
        chan.put(("v", "y" * 30000))
        assert chan.get(timeout=1)[1] == "x" * 30000
        assert chan.get(timeout=1)[1] == "y" * 30000
        with pytest.raises(ValueError):
            chan.put_bytes(b"z" * (1 << 17))
    finally:
        chan.close()
        chan.unlink()


def test_compiled_two_stage_pipeline():
    @rt.remote
    class Stage:
        def __init__(self, scale):
            self.scale = scale

        def apply(self, x):
            return x * self.scale

    a = Stage.remote(2)
    b = Stage.remote(10)
    with InputNode() as inp:
        dag = b.apply.bind(a.apply.bind(inp))
    compiled = dag.experimental_compile()
    try:
        refs = [compiled.execute(i) for i in range(10)]
        assert [r.get(timeout=30) for r in refs] == [
            i * 20 for i in range(10)
        ]
    finally:
        compiled.teardown()
    assert rt.get(a.apply.remote(7), timeout=20) == 14


def test_compiled_multi_output():
    @rt.remote
    class Worker:
        def __init__(self, k):
            self.k = k

        def mul(self, x):
            return x * self.k

    w1, w2 = Worker.remote(3), Worker.remote(5)
    with InputNode() as inp:
        dag = MultiOutputNode([w1.mul.bind(inp), w2.mul.bind(inp)])
    compiled = experimental_compile(dag)
    try:
        assert compiled.execute(2).get(timeout=30) == [6, 10]
        assert compiled.execute(4).get(timeout=30) == [12, 20]
    finally:
        compiled.teardown()


def test_compiled_error_propagates():
    @rt.remote
    class Flaky:
        def run(self, x):
            if x == 13:
                raise ValueError("unlucky")
            return x + 1

    @rt.remote
    class Downstream:
        def run(self, x):
            return x * 2

    f, d = Flaky.remote(), Downstream.remote()
    with InputNode() as inp:
        dag = d.run.bind(f.run.bind(inp))
    compiled = experimental_compile(dag)
    try:
        assert compiled.execute(1).get(timeout=30) == 4
        with pytest.raises(ValueError, match="unlucky"):
            compiled.execute(13).get(timeout=30)
        assert compiled.execute(2).get(timeout=30) == 6
    finally:
        compiled.teardown()


def test_compiled_throughput_beats_rpc():
    @rt.remote
    class Echo:
        def hit(self, x):
            return x

    e = Echo.remote()
    rt.get(e.hit.remote(0), timeout=20)  # warm the worker
    n = 200

    def time_rpc():
        start = time.perf_counter()
        for i in range(n):
            rt.get(e.hit.remote(i), timeout=20)
        return time.perf_counter() - start

    rpc_time = min(time_rpc(), time_rpc())
    with InputNode() as inp:
        dag = e.hit.bind(inp)
    compiled = experimental_compile(dag)
    try:

        def time_compiled():
            start = time.perf_counter()
            for i in range(n):
                compiled.execute(i).get(timeout=30)
            return time.perf_counter() - start

        compiled.execute(0).get(timeout=30)  # warm the loop
        compiled_time = min(time_compiled(), time_compiled())
    finally:
        compiled.teardown()
    assert compiled_time < 2.0 * rpc_time


def test_input_attribute_nodes():
    @rt.remote
    def double(x):
        return x * 2

    @rt.remote
    def add(a, b):
        return a + b

    with InputNode() as inp:
        dag = add.bind(double.bind(inp["a"]), inp["b"])
    assert rt.get(dag.execute({"a": 3, "b": 10}), timeout=30) == 16

    @rt.remote
    class Scale:
        def __init__(self, k):
            self.k = k

        def apply(self, x):
            return x * self.k

    @rt.remote
    class Sum:
        def add(self, a, b):
            return a + b

    s = Scale.remote(10)
    t = Sum.remote()
    with InputNode() as inp:
        cdag = t.add.bind(s.apply.bind(inp[0]), inp[1])
    compiled = cdag.experimental_compile()
    try:
        assert compiled.execute((2, 5)).get(timeout=30) == 25
        assert compiled.execute((3, 1)).get(timeout=30) == 31
        with pytest.raises(IndexError):
            compiled.execute((7,))
    finally:
        compiled.teardown()


def test_compiled_pipeline_carries_tensors():
    """A CPU tensor through a compiled two-stage pipeline's channels."""

    @rt.remote
    class Scale:
        def __init__(self, k):
            self.k = k

        def apply(self, x):
            return x * self.k

    a, b = Scale.remote(2.0), Scale.remote(3.0)
    with InputNode() as inp:
        dag = b.apply.bind(a.apply.bind(inp))
    compiled = dag.experimental_compile()
    try:
        x = torch.arange(4096, dtype=torch.float32)
        assert torch.equal(compiled.execute(x).get(timeout=30), x * 6)
    finally:
        compiled.teardown()
