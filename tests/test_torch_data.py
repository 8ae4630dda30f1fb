"""The port's datasets (`ray_tpu_torch.data`, copied from `ray_tpu/data`),
held to the JAX package's: the same pipelines give the same rows in
the same order (range, from_numpy, map, filter, map_batches,
random_shuffle, sort, groupby, streaming_split, read_numpy, the file
formats, iter_torch_batches), and TFRecords written by either package
are the same bytes and read back by the other. Each package's runtime
runs its pipelines alone, shut down before the other starts. Then
`tests/test_data.py`'s and `tests/test_data_sources.py`'s cases on the
port's runtime; the three of them that wait on the clock there are
held here to counters instead (constructor calls, the executor's own
in-flight bytes, results)."""

import glob
import importlib
import os

import numpy as np
import pytest
import torch

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)


def _pipelines():
    """{name: fn(data, tmp) -> rows or arrays}. Built inside a function
    so cloudpickle sends the UDFs by value (workers cannot import
    tests/)."""

    def groupby(data):
        ds = data.range(100, parallelism=4).map(
            lambda r: {"key": r["id"] % 3, "value": r["id"]})
        g = ds.groupby("key")
        return [g.count().take_all(), g.sum("value").take_all(),
                g.mean("value").take_all(), g.max("value").take_all(),
                g.min("value").take_all()]

    def repartition(data):
        # Held until its tasks are done (count() waits on them): a
        # materialized dataset dropped while its shuffle runs wedges
        # the JAX package's runtime (ROADMAP, queue 3).
        ds = data.range(100, parallelism=2).repartition(5).materialize()
        return [ds.num_blocks(), ds.count(), ds.take_all()]

    def split(data):
        its = data.range(300, parallelism=6).streaming_split(2, equal=True)
        return [[r["id"] for r in it.iter_rows()] for it in its]

    def read_numpy(data, tmp):
        return [data.read_numpy(os.path.join(tmp, "npy"),
                                column="x").take_all(),
                data.read_numpy(os.path.join(tmp, "npz")).take_all()]

    def formats(data, tmp, pkg):
        ds = data.range(24, parallelism=2).map(
            lambda r: {"id": r["id"], "name": f"row{r['id']}"})
        out = []
        for fmt in ("csv", "json", "parquet"):
            path = os.path.join(tmp, pkg, fmt)
            getattr(ds, f"write_{fmt}")(path)
            out.append(sorted(getattr(data, f"read_{fmt}")(path).take_all(),
                              key=lambda r: r["id"]))
        return out

    def torch_batches(data):
        ds = data.from_numpy({"x": np.arange(10, dtype=np.int32),
                              "y": np.linspace(0, 1, 10)})
        return [
            {k: (v.dtype, v.tolist()) for k, v in b.items()}
            for b in ds.iter_torch_batches(
                batch_size=4, dtypes={"x": torch.int64, "y": torch.float16})]

    return {
        "range": lambda data, tmp, pkg: data.range(
            100, parallelism=3).take_all(),
        "from_numpy": lambda data, tmp, pkg: data.from_numpy(
            {"x": np.arange(12), "y": np.arange(12) * 0.5}).take_all(),
        "map_filter": lambda data, tmp, pkg: data.range(
            1000, parallelism=8).map(
            lambda r: {"id": r["id"], "double": r["id"] * 2}).filter(
            lambda r: r["id"] % 10 == 0).take_all(),
        "map_batches": lambda data, tmp, pkg: data.range(
            256, parallelism=4).map_batches(
            lambda b: {"sq": b["id"] ** 2}, batch_size=64).to_numpy(),
        "flat_map_limit": lambda data, tmp, pkg: data.from_items(
            [1, 2, 3]).flat_map(
            lambda r: [{"v": r["item"]}, {"v": r["item"] * 10}]).limit(
            5).take_all(),
        "random_shuffle": lambda data, tmp, pkg: data.range(
            50, parallelism=4).random_shuffle(seed=7).take_all(),
        "sort": lambda data, tmp, pkg: [
            data.from_items([{"v": int(v)} for v in np.random.default_rng(
                0).permutation(200)], parallelism=4).sort(
                "v", descending=d).take_all() for d in (False, True)],
        "repartition": lambda data, tmp, pkg: repartition(data),
        "groupby": lambda data, tmp, pkg: groupby(data),
        "streaming_split": lambda data, tmp, pkg: split(data),
        "iter_batches": lambda data, tmp, pkg: [
            [b["id"].tolist() for b in data.range(
                100, parallelism=3).iter_batches(
                batch_size=32, drop_last=d, prefetch_batches=p)]
            for d in (False, True) for p in (0, 3)],
        "read_numpy": lambda data, tmp, pkg: read_numpy(data, tmp),
        "formats": lambda data, tmp, pkg: formats(data, tmp, pkg),
        "iter_torch_batches": lambda data, tmp, pkg: torch_batches(data),
        "columns": lambda data, tmp, pkg: data.range(6).add_column(
            "sq", lambda r: r["id"] ** 2).drop_columns(["id"]).take_all(),
        "union": lambda data, tmp, pkg: data.range(5).union(
            data.range(3)).take_all(),
    }


PIPELINES = list(_pipelines())


def _same(a, b):
    """Equal values of equal types, numpy arrays element for element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (type(a) is type(b) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


def _tfrecord_rows():
    return [{"idx": i, "score": i / 2, "tag": f"row-{i}",
             "vec": np.arange(3, dtype=np.float32) + i}
            for i in range(8)]


def _run(pkg, tmp):
    """Every pipeline, and a TFRecord write, on `pkg`'s runtime."""
    rt = importlib.import_module(pkg)
    data = importlib.import_module(pkg + ".data")
    rt.init(num_cpus=4)
    try:
        out = {name: fn(data, tmp, pkg)
               for name, fn in _pipelines().items()}
        data.from_items(_tfrecord_rows()).write_tfrecords(
            os.path.join(tmp, pkg, "tfr"))
        other = "ray_tpu" if pkg == "ray_tpu_torch" else "ray_tpu_torch"
        # The other package's files, once it has written them.
        if os.path.isdir(os.path.join(tmp, other, "tfr")):
            out["tfr_read_other"] = data.read_tfrecords(
                os.path.join(tmp, other, "tfr")).take_all()
        out["tfr_read_own"] = data.read_tfrecords(
            os.path.join(tmp, pkg, "tfr")).take_all()
    finally:
        rt.shutdown()
    return out


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("data_parity"))
    rng = np.random.default_rng(3)
    os.makedirs(os.path.join(tmp, "npy"))
    os.makedirs(os.path.join(tmp, "npz"))
    for i in range(3):
        np.save(os.path.join(tmp, "npy", f"{i}.npy"),
                rng.integers(0, 100, (4, 5)).astype(np.int32))
        np.savez(os.path.join(tmp, "npz", f"{i}.npz"),
                 a=rng.normal(size=(3, 2)), b=np.arange(3) + 3 * i)
    jax_out = _run("ray_tpu", tmp)
    port_out = _run("ray_tpu_torch", tmp)
    return {"jax": jax_out, "port": port_out, "tmp": tmp}


@pytest.mark.parametrize("name", PIPELINES)
def test_pipeline_equals_the_jax_packages(outputs, name):
    got, want = outputs["port"][name], outputs["jax"][name]
    assert _same(got, want), (got, want)


def test_tfrecords_are_the_same_bytes_and_read_across(outputs):
    tmp = outputs["tmp"]
    files = {pkg: sorted(glob.glob(os.path.join(tmp, pkg, "tfr", "*")))
             for pkg in ("ray_tpu", "ray_tpu_torch")}
    assert len(files["ray_tpu"]) == len(files["ray_tpu_torch"]) >= 1
    for a, b in zip(files["ray_tpu"], files["ray_tpu_torch"]):
        assert os.path.basename(a) == os.path.basename(b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    port, jax_out = outputs["port"], outputs["jax"]
    # Each package read the other's files as it read its own.
    assert _same(port["tfr_read_other"], port["tfr_read_own"])
    assert _same(port["tfr_read_other"], jax_out["tfr_read_own"])
    assert len(port["tfr_read_other"]) == 8
    assert port["tfr_read_other"][3]["tag"] == "row-3"


def test_tfrecord_codec_equals_the_jax_packages():
    from ray_tpu.data import tfrecords as jax_tfr
    from ray_tpu_torch.data import tfrecords as tfr

    for row in _tfrecord_rows():
        payload = tfr.encode_example(row)
        assert payload == jax_tfr.encode_example(row)
        assert _same(tfr.decode_example(payload),
                     jax_tfr.decode_example(payload))


# ---------------------------------------------------------------------
# tests/test_data.py and tests/test_data_sources.py on the port
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_rt(outputs):
    """The port's runtime, once the parity runs have shut theirs down."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=4)
    try:
        yield rt
    finally:
        rt.shutdown()


def test_range_map_filter_count(port_rt):
    """Waits on the count's results alone: no deadline."""
    from ray_tpu_torch import data

    ds = (data.range(1000, parallelism=8)
          .map(lambda row: {"id": row["id"], "double": row["id"] * 2})
          .filter(lambda row: row["id"] % 10 == 0))
    assert ds.count() == 100
    assert ds.take(3)[0] == {"id": 0, "double": 0}


def test_byte_budget_backpressure_skewed_flat_map(port_rt, monkeypatch):
    """The byte budget bounds the executor's own in-flight bytes: a
    flat_map whose blocks balloon to 4 MiB keeps the ledger's estimate
    of submitted, unconsumed bytes within the budget plus one block,
    while the same plan without a budget fills its window of 8 blocks.
    Read from the ledger (`_ByteLedger.account`), not the clock. One
    seam makes the cold start deterministic: the first block's size is
    known before the second submission (the executor otherwise learns
    it whenever a block happens to finish)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch.data import executor

    mib = 1024 * 1024
    real = executor._ByteLedger.account
    estimates = []

    def account(self, pending):
        if self.observed == 0 and pending:
            rt.wait(list(pending[:1]), num_returns=1)
        estimate = real(self, pending)
        estimates.append(estimate)
        return estimate

    monkeypatch.setattr(executor._ByteLedger, "account", account)

    def run(cap):
        estimates.clear()

        def explode(row):
            return [{"payload": np.zeros(mib, dtype=np.uint8)}
                    for _ in range(4)]

        ds = (data.range(12, parallelism=12).flat_map(explode)
              .options(window=8, inflight_bytes=cap))
        rows = 0
        for ref in ds.iter_block_refs():
            block = rt.get(ref)
            rows += len(block)
            assert all(row["payload"].nbytes == mib for row in block)
            del block, ref
        return rows, max(estimates)

    rows, uncapped = run(None)
    assert rows == 48
    rows, capped = run(8 * mib)
    assert rows == 48
    assert capped <= 8 * mib + 4 * mib + mib, capped / mib
    assert uncapped >= 8 * 4 * mib, uncapped / mib


def _make_counted_udf(directory):
    """A UDF class whose constructor (its expensive setup) leaves one
    file in `directory` per call; built here so cloudpickle sends it by
    value."""

    class CountedUdf:
        def __init__(self):
            import uuid

            open(os.path.join(directory, f"ctor-{uuid.uuid4().hex}"),
                 "w").close()

        def __call__(self, batch):
            return {"v": batch["id"] * 2,
                    "who": np.full(len(batch["id"]), id(self) % 2 ** 31)}

    return CountedUdf


def test_actor_pool_reuses_the_warm_udf(port_rt, tmp_path):
    """compute=ActorPoolStrategy builds the UDF once per pool actor and
    reuses it for every block; task-per-block pays the setup once per
    block. Counted by constructor calls, not timed."""
    from ray_tpu_torch import data
    from ray_tpu_torch.data import ActorPoolStrategy

    pool_dir, task_dir = tmp_path / "pool", tmp_path / "tasks"
    pool_dir.mkdir()
    task_dir.mkdir()
    n_blocks = 10
    pool_out = (data.range(n_blocks * 10, parallelism=n_blocks)
                .map_batches(_make_counted_udf(str(pool_dir)),
                             compute=ActorPoolStrategy(
                                 min_size=2, max_size=3,
                                 max_tasks_per_actor=2))
                .to_numpy())
    udf = _make_counted_udf(str(task_dir))

    def setup_each(batch):
        return udf()(batch)

    task_out = (data.range(n_blocks * 10, parallelism=n_blocks)
                .map_batches(setup_each).to_numpy())
    np.testing.assert_array_equal(np.sort(pool_out["v"]),
                                  np.sort(task_out["v"]))
    pool_ctors = len(os.listdir(pool_dir))
    assert 2 <= pool_ctors <= 3, pool_ctors
    assert len(set(pool_out["who"].tolist())) == pool_ctors
    assert len(os.listdir(task_dir)) == n_blocks
    with pytest.raises(ValueError, match="ActorPoolStrategy"):
        data.range(4).map_batches(_make_counted_udf(str(pool_dir)))


def test_streaming_split_through_actor_pool(port_rt, tmp_path):
    from ray_tpu_torch import data
    from ray_tpu_torch.data import ActorPoolStrategy

    ds = data.range(80, parallelism=8).map_batches(
        _make_counted_udf(str(tmp_path)),
        compute=ActorPoolStrategy(min_size=1, max_size=2))
    seen = [int(row["v"]) for it in ds.streaming_split(2)
            for row in it.iter_rows()]
    assert sorted(seen) == [2 * i for i in range(80)]


def test_repartition_and_shuffle(port_rt):
    from ray_tpu_torch import data

    ds = data.range(100, parallelism=2).repartition(5).materialize()
    assert ds.num_blocks() == 5
    assert ds.count() == 100
    assert sorted(r["id"] for r in ds.take_all()) == list(range(100))
    ids = [r["id"] for r in data.range(50, parallelism=4).random_shuffle(
        seed=7).take_all()]
    assert sorted(ids) == list(range(50)) and ids != list(range(50))


def test_a_shuffle_dropped_while_it_runs_leaves_the_runtime_free(port_rt):
    """Dropping a materialized shuffle at once drops the results of
    tasks still running, and with them the handles to their args: the
    tasks must still finish, their leases come back, and later work
    run. (The copied transport kept a pending task's args only through
    its results' handles: the split and combine tasks then waited for
    args never published, holding 7 of 8 CPU leases for good.)"""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data

    for _ in range(3):
        data.range(100, parallelism=2).repartition(5).materialize()
        ping = rt.remote(num_cpus=1)(lambda: "pong")
        assert rt.get(ping.remote(), timeout=60) == "pong"
        assert data.range(40, parallelism=4).count() == 40


def test_streaming_split_disjoint_and_complete(port_rt):
    from ray_tpu_torch import data

    seen = [{row["id"] for row in it.iter_rows()}
            for it in data.range(300, parallelism=6).streaming_split(
                3, equal=True)]
    assert set().union(*seen) == set(range(300))
    assert sum(len(s) for s in seen) == 300


def _prefetch_threads():
    import threading

    return [t for t in threading.enumerate()
            if t.name.startswith("rt-data-prefetch") and t.is_alive()]


def test_iter_batches_prefetch_zero_is_serial_path(port_rt):
    from ray_tpu_torch import data

    sizes = []
    for batch in data.range(100, parallelism=3).iter_batches(
            batch_size=32, prefetch_batches=0):
        sizes.append(len(batch["id"]))
        assert not _prefetch_threads()
    assert sizes == [32, 32, 32, 4]


def test_iter_batches_prefetch_early_break_no_leaks(port_rt):
    """Breaking out of a prefetching iterator closes it, which joins its
    producer thread before the loop goes on."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data

    seen = []
    for batch in data.range(400, parallelism=8).iter_batches(
            batch_size=16, prefetch_batches=4):
        seen.append(batch["id"][0])
        if len(seen) >= 2:
            break
    assert len(seen) == 2
    assert not _prefetch_threads()
    assert rt.get(rt.put(41)) == 41


def test_iter_batches_prefetch_propagates_udf_error(port_rt):
    from ray_tpu_torch import data

    def explode(row):
        if row["id"] == 37:
            raise ValueError("bad row 37")
        return row

    with pytest.raises(Exception, match="bad row 37"):
        for _ in data.range(64, parallelism=4).map(explode).iter_batches(
                batch_size=8, prefetch_batches=2):
            pass
    assert not _prefetch_threads()


def test_streaming_split_iterator_prefetch(port_rt):
    from ray_tpu_torch import data

    (it,) = data.range(120, parallelism=6).streaming_split(1)
    pre = list(it.iter_batches(batch_size=25, prefetch_batches=2))
    np.testing.assert_array_equal(
        np.sort(np.concatenate([b["id"] for b in pre])), np.arange(120))
    assert [len(b["id"]) for b in pre] == [25, 25, 25, 25, 20]
    assert not _prefetch_threads()


def test_iter_block_refs_pull_ahead(port_rt):
    import ray_tpu_torch as rt
    from ray_tpu_torch import data

    ds = data.range(60, parallelism=6).materialize()
    assert ([rt.get(r) for r in ds.iter_block_refs()]
            == [rt.get(r) for r in ds.iter_block_refs(prefetch=3)])
    assert not _prefetch_threads()


def test_iter_batches_bill_data_wait(port_rt):
    """A batch iterator bills the consumer's wait to step telemetry's
    `data_wait_ms`, as the reference's does."""
    from ray_tpu_torch import data
    from ray_tpu_torch._private import step_telemetry

    step_telemetry.take_phases()
    assert len(list(data.range(64, parallelism=2).iter_batches(
        batch_size=16, prefetch_batches=2))) == 4
    assert set(step_telemetry.take_phases()) == {"data_wait_ms"}


def test_tfrecords_corruption_detected(port_rt, tmp_path):
    from ray_tpu_torch import data
    from ray_tpu_torch.data.tfrecords import encode_example, write_records

    path = tmp_path / "bad.tfrecord"
    write_records(str(path), [encode_example({"x": 1})])
    raw = bytearray(path.read_bytes())
    raw[-6] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(Exception):
        data.read_tfrecords(str(path)).take_all()


def test_write_numpy_round_trip(port_rt, tmp_path):
    from ray_tpu_torch import data

    data.from_numpy({"data": np.arange(12).reshape(6, 2)}).write_numpy(
        str(tmp_path / "np"))
    back = data.read_numpy(str(tmp_path / "np")).take_all()
    np.testing.assert_array_equal(
        np.sort(np.stack([r["data"] for r in back]), axis=0),
        np.arange(12).reshape(6, 2))


def test_pandas_and_arrow_round_trips(port_rt):
    pd = pytest.importorskip("pandas")
    pa = pytest.importorskip("pyarrow")
    from ray_tpu_torch import data

    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    assert data.from_pandas(df).to_pandas().equals(df)
    table = pa.table({"a": [1, 2], "b": [0.5, 1.5]})
    assert data.from_arrow(table).to_arrow().equals(table)

    def double(t):
        assert isinstance(t, pa.Table)
        return t.set_column(0, "x", pa.array(
            [v * 2 for v in t["x"].to_pylist()]))

    out = data.from_items([{"x": i} for i in range(8)]).map_batches(
        double, batch_format="pyarrow", batch_size=4).take_all()
    assert sorted(r["x"] for r in out) == [i * 2 for i in range(8)]


def test_from_torch_and_iter_torch_batches(port_rt):
    from ray_tpu_torch import data

    class Squares(torch.utils.data.Dataset):
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return i * i

    rows = data.from_torch(Squares()).take_all()
    assert [r["item"] for r in rows] == [i * i for i in range(10)]
    batches = list(data.range(10).iter_torch_batches(
        batch_size=4, dtypes=torch.float32))
    assert [b["id"].dtype for b in batches] == [torch.float32] * 3
    assert torch.equal(torch.cat([b["id"] for b in batches]),
                       torch.arange(10, dtype=torch.float32))
