"""The port's copy of the object plane: IDs, serialization, the
shared-memory store and resource arithmetic, mirroring a subset of
`tests/test_object_store.py` with the same assertions; then the port's
own torch-tensor reducer (CPU tensors out of band, bf16 as an int16 view,
no copy on the way back from a writable buffer, the reader's own copy of
a sealed object) through `SerializationContext` and through
`put`/`get` on one cluster shared by the module. Imports nothing of
`ray_tpu` (nor JAX)."""

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._native import load_library
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch._private.object_store import (
    ObjectStoreFullError,
    SharedMemoryStore,
)
from ray_tpu_torch._private.scheduler import ResourceSet
from ray_tpu_torch._private.serialization import SerializationContext

#: 4 MiB of payload, the size the ROADMAP measured in band before.
FOUR_MIB = 4 << 20


def _oid(i=1):
    return ObjectID.for_return(TaskID.from_random(), i)


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=2)
    try:
        yield
    finally:
        rt.shutdown()


class TestIDs:
    def test_object_id_embeds_task(self):
        t = TaskID.from_random()
        o = ObjectID.for_return(t, 3)
        assert o.task_id() == t
        assert o.index() == 3

    def test_task_id_deterministic(self):
        job = JobID.from_int(1)
        parent = TaskID.for_driver(job)
        a = TaskID.for_task(job, parent, 7)
        b = TaskID.for_task(job, parent, 7)
        c = TaskID.for_task(job, parent, 8)
        assert a == b
        assert a != c

    def test_hex_roundtrip(self):
        a = ActorID.of(JobID.from_int(9))
        assert ActorID.from_hex(a.hex()) == a
        assert a.job_id() == JobID.from_int(9)


class TestSerialization:
    def test_roundtrip_plain(self):
        ctx = SerializationContext()
        data = ctx.serialize({"x": 1, "y": [1, 2]}).to_bytes()
        assert ctx.deserialize(data) == {"x": 1, "y": [1, 2]}

    def test_numpy_out_of_band_zero_copy(self):
        ctx = SerializationContext()
        arr = np.arange(10_000, dtype=np.float64)
        serialized = ctx.serialize(arr)
        assert len(serialized.buffers) == 1
        assert serialized.buffers[0].nbytes == arr.nbytes
        out = ctx.deserialize(serialized.to_bytes())
        np.testing.assert_array_equal(out, arr)

    def test_nested_arrays(self):
        ctx = SerializationContext()
        value = {"a": np.ones(5000), "b": [np.zeros(3000), "meta"]}
        out = ctx.deserialize(ctx.serialize(value).to_bytes())
        np.testing.assert_array_equal(out["a"], value["a"])
        np.testing.assert_array_equal(out["b"][0], value["b"][0])


class TestSharedMemoryStore:
    def test_create_seal_get(self):
        store = SharedMemoryStore("feedbeef", 1 << 20)
        oid = _oid()
        buf = store.create(oid, 5)
        buf[:5] = b"hello"
        assert not store.contains(oid)
        store.seal(oid)
        assert store.contains(oid)
        assert bytes(store.get(oid)[:5]) == b"hello"
        store.shutdown()

    def test_get_blocks_until_seal(self):
        import threading

        store = SharedMemoryStore("feedbee2", 1 << 20)
        oid = _oid()

        def writer():
            import time

            time.sleep(0.1)
            buf = store.create(oid, 3)
            buf[:3] = b"abc"
            store.seal(oid)

        threading.Thread(target=writer).start()
        view = store.get(oid, timeout=5)
        assert bytes(view[:3]) == b"abc"
        store.shutdown()

    def test_capacity_and_eviction(self):
        store = SharedMemoryStore("feedbee3", 4096 * 4)
        oids = [_oid(i + 1) for i in range(4)]
        for oid in oids:
            store.put(oid, b"x" * 4096)
        store.put(_oid(99), b"y" * 4096)
        assert not store.contains(oids[0])
        store.shutdown()

    def test_pinned_objects_not_evicted(self):
        store = SharedMemoryStore("feedbee4", 4096 * 2)
        first = _oid(1)
        store.put(first, b"x" * 4096)
        store.pin(first)
        with pytest.raises(ObjectStoreFullError):
            store.put(_oid(2), b"y" * 8192)
        assert store.contains(first)
        store.shutdown()

    def test_cross_instance_open(self):
        producer = SharedMemoryStore("feedbee5", 1 << 20)
        consumer = SharedMemoryStore("feedbee5", 1 << 20)
        oid = _oid()
        producer.put(oid, b"shared-bytes")
        view = consumer.open_remote(oid, 12)
        assert bytes(view[:12]) == b"shared-bytes"
        consumer.shutdown(unlink=False)
        producer.shutdown()


class TestResourceSet:
    def test_fits_and_subtract(self):
        total = ResourceSet({"CPU": 4, "GPU": 8})
        req = ResourceSet({"CPU": 0.5, "GPU": 1})
        assert req.fits_in(total)
        left = total.subtract(req)
        assert left.get("CPU") == 3.5
        assert left.get("GPU") == 7

    def test_fractional_exact(self):
        total = ResourceSet({"CPU": 1})
        third = ResourceSet({"CPU": 0.333})
        left = total.subtract(third).subtract(third).subtract(third)
        assert left.get("CPU") == pytest.approx(0.001)

    def test_missing_resource_does_not_fit(self):
        assert not ResourceSet({"GPU": 1}).fits_in(ResourceSet({"CPU": 4}))


def test_native_arena_builds_from_the_copied_source():
    """store.cc is built by g++ at first use into the gitignored build/
    (no library ships in the package)."""
    import os

    from ray_tpu_torch import _native

    assert load_library() is not None
    path = _native.library_path()
    assert os.path.exists(path)
    assert os.sep + "build" + os.sep in path
    assert not [f for f in os.listdir(os.path.dirname(_native.__file__))
                if f.endswith(".so")]


# ---- torch tensors -------------------------------------------------------

def _tensor(dtype):
    n = FOUR_MIB // torch.tensor([], dtype=dtype).element_size()
    return torch.arange(n).to(dtype).reshape(-1, 1024)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int8, torch.bool])
def test_cpu_tensor_goes_out_of_band_and_back_without_a_copy(dtype):
    ctx = SerializationContext()
    x = _tensor(dtype)
    serialized = ctx.serialize(x)
    # One buffer holds the whole payload; the pickle stream is small.
    assert len(serialized.buffers) == 1
    assert serialized.buffers[0].nbytes == x.numel() * x.element_size()
    assert len(serialized.inband) < 1024
    data = bytearray(serialized.to_bytes())
    out = ctx.deserialize(data)
    assert out.dtype == dtype and out.shape == x.shape
    assert torch.equal(out, x)
    # A view of the serialized bytes, not a copy of them.
    base = np.frombuffer(data, dtype=np.uint8).ctypes.data
    assert base <= out.data_ptr() < base + len(data)


def test_tensor_kinds_round_trip():
    ctx = SerializationContext()
    param = torch.nn.Parameter(torch.randn(3, 4))
    value = {"p": param, "grad": torch.ones(2, requires_grad=True),
             "strided": torch.randn(8, 8)[:, ::2], "scalar": torch.tensor(7)}
    out = ctx.deserialize(ctx.serialize(value).to_bytes())
    assert isinstance(out["p"], torch.nn.Parameter) and out["p"].requires_grad
    assert torch.equal(out["p"], param)
    assert out["grad"].requires_grad
    assert torch.equal(out["strided"], value["strided"])
    assert out["scalar"].item() == 7


def test_cuda_tensor_needs_a_card_in_the_reader():
    """A CUDA tensor is restored onto "cuda" in the reader; a reader
    without a card raises rather than hand back a CPU tensor."""
    from ray_tpu_torch._private import serialization

    array = np.zeros(4, np.float32)
    if torch.cuda.is_available():
        pytest.skip("this reader has a card")
    with pytest.raises(RuntimeError, match="without a card"):
        serialization._rebuild_tensor(array, "float32", "cuda", False, False)


def test_put_get_tensor_through_the_store(cluster):
    x = _tensor(torch.bfloat16)
    out = rt.get(rt.put(x))
    assert out.dtype == torch.bfloat16 and torch.equal(out, x)


def test_a_read_only_buffer_comes_back_as_the_reader_s_own_copy():
    """A tensor cannot be read-only, so over a read-only buffer (bytes, or
    a sealed object) the reader gets a copy: writing into it leaves the
    buffer, and the next reader's tensor, unchanged. No warning of a
    non-writable array is raised or hidden."""
    import warnings

    ctx = SerializationContext()
    x = _tensor(torch.float32)
    data = ctx.serialize(x).to_bytes()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        first = ctx.deserialize(data)
    base = np.frombuffer(data, dtype=np.uint8).ctypes.data
    assert not base <= first.data_ptr() < base + len(data)
    first.add_(1)
    assert torch.equal(ctx.deserialize(data), x)


@pytest.mark.parametrize("kind", ["tensor", "bf16", "parameter"])
def test_a_write_into_a_tensor_from_get_leaves_the_object_unchanged(
        cluster, kind):
    """Sealed objects are immutable: an in-place op on a value from `get`
    (an optimizer step on a Parameter included) changes the reader's
    tensor only, and a second `get` of the same ref reads the object as
    it was put."""
    x = _tensor(torch.bfloat16 if kind == "bf16" else torch.float32)
    if kind == "parameter":
        x = torch.nn.Parameter(x)
    ref = rt.put(x)
    got = rt.get(ref)
    with torch.no_grad():
        got.add_(1)
    again = rt.get(ref)
    assert torch.equal(again, x) and not torch.equal(again, got)


def test_a_task_writing_into_its_argument_leaves_the_object_unchanged(
        cluster):
    @rt.remote
    def bump(t):
        t.add_(1)
        return float(t[0, 0])

    x = _tensor(torch.float32)
    ref = rt.put(x)
    assert rt.get(bump.remote(ref)) == 1.0
    assert rt.get(bump.remote(ref)) == 1.0
    assert torch.equal(rt.get(ref), x)
