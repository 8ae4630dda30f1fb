"""The port's util APIs (`ray_tpu_torch.util.{collective,actor_pool,
queue}`, copied from `ray_tpu/util/`), held to the JAX package's: the
same numpy inputs through each package's control-plane collective give
equal arrays, then `tests/test_util_apis.py`'s cases on the port's
runtime. Each package's runtime runs alone, shut down before the other
starts."""

import importlib

import numpy as np
import pytest

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)


@pytest.fixture
def port_session():
    import ray_tpu_torch as rt

    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


def _collective_round(rt, package, world=3, seed=0):
    """Every op of `package`'s util.collective on `world` task members,
    each rank's inputs drawn from `seed`. Built inside a function so
    cloudpickle sends the member by value."""

    def member(package, rank, world, seed):
        import importlib

        import numpy as np

        collective = importlib.import_module(f"{package}.util.collective")
        rng = np.random.default_rng(seed + rank)
        group = collective.init_collective_group(world, rank, "parity")
        x = rng.normal(size=(4, 3))
        out = {
            "sum": group.allreduce(x),
            "max": group.allreduce(x, op="max"),
            "gather": group.allgather(rng.integers(0, 9, size=2)),
            "bcast": group.broadcast(
                rng.normal(size=5) if rank == 1 else None, src_rank=1),
            "scatter": group.reducescatter(rng.normal(size=(world * 2,))),
        }
        if rank == 0:
            group.send(x * 2.0, dst_rank=world - 1)
        if rank == world - 1:
            out["recv"] = group.recv(src_rank=0)
        group.barrier()
        return out

    task = rt.remote(member)
    results = rt.get([task.remote(package, rank, world, seed)
                      for rank in range(world)], timeout=120)
    importlib.import_module(f"{package}.util.collective") \
        .destroy_collective_group("parity")
    return results


def test_collective_matches_the_jax_packages_on_the_same_inputs():
    import ray_tpu
    import ray_tpu_torch

    results = {}
    for rt, package in ((ray_tpu, "ray_tpu"), (ray_tpu_torch,
                                                "ray_tpu_torch")):
        rt.init(num_cpus=4)
        try:
            results[package] = _collective_round(rt, package)
        finally:
            rt.shutdown()
    jax_side, port_side = results["ray_tpu"], results["ray_tpu_torch"]
    assert len(jax_side) == len(port_side) == 3
    for a, b in zip(jax_side, port_side):
        assert sorted(a) == sorted(b)
        for key in a:
            got, want = b[key], a[key]
            if isinstance(want, list):
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_array_equal(got, want)
    # The reduction itself: the three ranks' inputs summed.
    rng = [np.random.default_rng(r) for r in range(3)]
    want = sum(g.normal(size=(4, 3)) for g in rng)
    np.testing.assert_allclose(port_side[0]["sum"], want, rtol=1e-12)


def test_collective_group_allreduce_across_tasks(port_session):
    rt = port_session

    @rt.remote
    def member(rank, world):
        import numpy as np

        from ray_tpu_torch.util.collective import init_collective_group

        group = init_collective_group(world, rank, "g1")
        reduced = group.allreduce(np.full(4, rank + 1.0))
        gathered = group.allgather(np.array([rank]))
        got = group.broadcast(
            np.array([42.0]) if rank == 0 else None, src_rank=0
        )
        shard = group.reducescatter(np.arange(4, dtype=np.float64))
        group.barrier()
        return (
            reduced.tolist(),
            [int(g[0]) for g in gathered],
            float(got[0]),
            shard.tolist(),
        )

    world = 3
    results = rt.get(
        [member.remote(rank, world) for rank in range(world)],
        timeout=120,
    )
    from ray_tpu_torch.util.collective import destroy_collective_group

    destroy_collective_group("g1")
    for reduced, gathered, got, _ in results:
        assert reduced == [6.0] * 4
        assert gathered == [0, 1, 2]
        assert got == 42.0
    flat = [v for r in results for v in r[3]]
    assert flat == [0.0, 3.0, 6.0, 9.0]


def test_collective_p2p(port_session):
    rt = port_session

    @rt.remote
    def member(rank):
        import numpy as np

        from ray_tpu_torch.util.collective import init_collective_group

        group = init_collective_group(2, rank, "p2p")
        if rank == 0:
            group.send(np.array([7.0, 8.0]), dst_rank=1)
            return None
        return group.recv(src_rank=0).tolist()

    results = rt.get([member.remote(0), member.remote(1)], timeout=120)
    from ray_tpu_torch.util.collective import destroy_collective_group

    destroy_collective_group("p2p")
    assert results[1] == [7.0, 8.0]


def test_actor_pool_ordered_and_unordered(port_session):
    rt = port_session
    from ray_tpu_torch.util.actor_pool import ActorPool

    @rt.remote
    class Worker:
        def double(self, x):
            return 2 * x

    pool = ActorPool([Worker.remote() for _ in range(2)])
    results = list(pool.map(lambda a, v: a.double.remote(v), range(6)))
    assert results == [0, 2, 4, 6, 8, 10]
    unordered = sorted(
        pool.map_unordered(lambda a, v: a.double.remote(v), range(6)))
    assert unordered == [0, 2, 4, 6, 8, 10]


def test_queue_cross_task(port_session):
    rt = port_session
    from ray_tpu_torch.util.queue import Queue

    queue = Queue(maxsize=10)

    @rt.remote
    def producer(q, n):
        for i in range(n):
            q.put(i)
        return "done"

    @rt.remote
    def consumer(q, n):
        return [q.get(timeout=30) for _ in range(n)]

    p = producer.remote(queue, 5)
    c = consumer.remote(queue, 5)
    assert rt.get(p, timeout=60) == "done"
    assert rt.get(c, timeout=60) == [0, 1, 2, 3, 4]
    assert queue.empty()
    queue.shutdown()


def test_queue_full_and_empty(port_session):
    from ray_tpu_torch.util.queue import Empty, Full, Queue

    queue = Queue(maxsize=1)
    queue.put("x")
    with pytest.raises(Full):
        queue.put("y", block=False)
    assert queue.get() == "x"
    with pytest.raises(Empty):
        queue.get(block=False)
    queue.shutdown()


def test_list_named_actors(port_session):
    rt = port_session
    from ray_tpu_torch.util import list_named_actors

    @rt.remote
    class N:
        def ping(self):
            return 1

    a = N.options(name="walter").remote()
    b = N.options(name="jesse", namespace="abq").remote()
    rt.get([a.ping.remote(), b.ping.remote()], timeout=30)

    names = list_named_actors()
    assert "walter" in names and "jesse" not in names
    rows = list_named_actors(all_namespaces=True)
    assert {"name": "jesse", "namespace": "abq"} in rows
    assert any(r["name"] == "walter" for r in rows)

    rt.kill(a)
    import time

    deadline = time.time() + 15
    while time.time() < deadline and "walter" in list_named_actors():
        time.sleep(0.2)
    assert "walter" not in list_named_actors()


def test_session_namespace_scopes_named_actors():
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import list_named_actors

    rt.init(num_cpus=2, namespace="abq")
    try:

        @rt.remote
        class N:
            def ping(self):
                return 1

        a = N.options(name="gus").remote()
        rt.get(a.ping.remote(), timeout=30)
        assert "gus" in list_named_actors()
        h = rt.get_actor("gus")
        assert rt.get(h.ping.remote(), timeout=20) == 1
        with pytest.raises(ValueError):
            rt.get_actor("gus", namespace="default")
    finally:
        rt.shutdown()
