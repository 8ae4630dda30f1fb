"""The port's workflows (`ray_tpu_torch.workflow`, copied from
`ray_tpu/workflow/`), held to the JAX package's: the same DAG gives the
same output and commits the same step names on both packages; a step's
torch tensors reload in a process that sees no card (the copy's one
hunk: a tensor off the CPU is stored on the CPU beside its device);
then `tests/test_workflow.py`'s and `tests/test_workflow_dynamic.py`'s
cases on the port's runtime."""

import os
import pickle
import subprocess
import sys

import pytest
import torch

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def port_session():
    import ray_tpu_torch as rt

    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


def _parity_run(package, storage):
    """`package`'s runtime alone: a DAG with a fan-in and a durable
    continuation, run as workflow "parity". Returns (output, the
    committed file names)."""
    import importlib

    rt = importlib.import_module(package)
    workflow = importlib.import_module(f"{package}.workflow")
    InputNode = importlib.import_module(f"{package}.dag").InputNode
    rt.init(num_cpus=4)
    try:
        @rt.remote
        def double(x):
            return 2 * x

        @rt.remote
        def fact(pair):
            import importlib

            wf = importlib.import_module(f"{package}.workflow")
            n, acc = pair
            if n <= 1:
                return acc
            with InputNode() as inp:
                sub = fact.bind(inp)
            return wf.continuation(sub, (n - 1, acc * n))

        @rt.remote
        def combine(a, b):
            return (a + b, 4)

        with InputNode() as inp:
            dag = fact.bind(combine.bind(double.bind(inp), double.bind(inp)))
        out = workflow.run(dag, workflow_id="parity", input_value=1,
                           storage=storage)
        return out, sorted(os.listdir(os.path.join(storage, "parity")))
    finally:
        rt.shutdown()


def test_same_dag_same_output_and_step_names_on_both_packages(tmp_path):
    jax_out, jax_files = _parity_run("ray_tpu", str(tmp_path / "jax"))
    port_out, port_files = _parity_run("ray_tpu_torch", str(tmp_path / "port"))
    assert jax_out == port_out == 4 * 3 * 2 * 1 * 4  # 4! from acc 4
    assert port_files == jax_files
    assert any(name.count("fact") >= 2 for name in port_files), port_files


_RELOAD = (
    "import sys, pickle, torch\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "from ray_tpu_torch import workflow\n"
    "store = workflow._WorkflowStorage(sys.argv[2], sys.argv[3])\n"
    "value = store.load_step(sys.argv[4])\n"
    "assert not torch.cuda.is_available()\n"
    "sys.stdout.buffer.write(pickle.dumps(\n"
    "    {k: (str(v.device), v.dtype, v.float().tolist())\n"
    "     for k, v in value.items()}))\n"
)


def _reload_without_a_card(root, workflow_id, step_id):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _RELOAD, REPO, root, workflow_id, step_id],
        env=env, capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    return pickle.loads(proc.stdout)


def test_tensor_step_value_reloads_where_no_card_is(port_session, tmp_path):
    rt = port_session
    from ray_tpu_torch import workflow

    @rt.remote
    def step():
        import torch

        g = torch.Generator().manual_seed(0)
        return {"loss": torch.randn(3, generator=g),
                "grad": torch.randn(2, 2, generator=g).to(torch.bfloat16)}

    root = str(tmp_path)
    want = workflow.run(step.bind(), workflow_id="tensors", storage=root)
    (step_id,) = [n[len("step-"):-len(".pkl")] for n in
                  os.listdir(tmp_path / "tensors")
                  if n.startswith("step-") and "step" in n[5:]
                  and "__output__" not in n]
    got = _reload_without_a_card(root, "tensors", step_id)
    assert got == {k: ("cpu", v.dtype, v.float().tolist())
                   for k, v in want.items()}
    # A value committed from a process with a card stores each tensor
    # on the CPU beside its device (`_StepPickler`): where no card is,
    # it reloads on the CPU.
    store = workflow._WorkflowStorage(root, "from_a_card")

    class OnCard:
        def __init__(self, tensor):
            self.tensor = tensor

        def __reduce__(self):
            return workflow._on_device, (self.tensor, "cuda:0")

    loss = torch.arange(4, dtype=torch.float32)
    with open(store.step_path("001-a"), "wb") as f:
        pickle.dump({"loss": OnCard(loss)}, f)
    got = _reload_without_a_card(root, "from_a_card", "001-a")
    assert got == {"loss": ("cpu", torch.float32, loss.tolist())}
    # CPU tensors keep torch's own reduction: the hunk touches nothing
    # else.
    assert workflow._StepPickler.reducer_override(None, loss) is \
        NotImplemented


# ---------------------------------------------------------------------------
# mirrors of tests/test_workflow.py
# ---------------------------------------------------------------------------


def test_workflow_runs_dag(port_session, tmp_path):
    rt = port_session
    from ray_tpu_torch import workflow
    from ray_tpu_torch.dag import InputNode

    @rt.remote
    def double(x):
        return 2 * x

    @rt.remote
    def add(a, b):
        return a + b

    with InputNode() as inp:
        dag = add.bind(double.bind(inp), double.bind(inp))
    result = workflow.run(dag, workflow_id="wf1", input_value=5,
                          storage=str(tmp_path))
    assert result == 20
    assert workflow.get_status("wf1", storage=str(tmp_path)) == (
        workflow.STATUS_SUCCESSFUL)
    assert workflow.get_output("wf1", storage=str(tmp_path)) == 20
    assert [m["workflow_id"] for m in workflow.list_all(
        storage=str(tmp_path))] == ["wf1"]


def test_workflow_failure_and_resume(port_session, tmp_path):
    rt = port_session
    from ray_tpu_torch import workflow
    from ray_tpu_torch.dag import InputNode

    marker = str(tmp_path / "executions")
    flag = str(tmp_path / "fail.flag")
    open(flag, "w").close()

    @rt.remote
    def counted(x):
        with open(marker, "a") as f:
            f.write("A")
        return x + 1

    @rt.remote
    def flaky(x):
        if os.path.exists(flag):
            raise RuntimeError("transient failure")
        return x * 100

    with InputNode() as inp:
        dag = flaky.bind(counted.bind(inp))

    with pytest.raises(Exception, match="transient"):
        workflow.run(dag, workflow_id="wf2", input_value=1,
                     storage=str(tmp_path))
    assert workflow.get_status("wf2", storage=str(tmp_path)) == (
        workflow.STATUS_FAILED)
    assert open(marker).read() == "A"

    os.remove(flag)
    assert workflow.resume("wf2", storage=str(tmp_path)) == 200
    assert open(marker).read() == "A"
    assert workflow.get_status("wf2", storage=str(tmp_path)) == (
        workflow.STATUS_SUCCESSFUL)
    assert workflow.resume("wf2", storage=str(tmp_path)) == 200


def test_workflow_with_input_projection(port_session, tmp_path):
    rt = port_session
    from ray_tpu_torch import workflow
    from ray_tpu_torch.dag import InputNode

    @rt.remote
    def double(x):
        return x * 2

    @rt.remote
    def add(a, b):
        return a + b

    with InputNode() as inp:
        dag = add.bind(double.bind(inp["a"]), inp["b"])
    out = workflow.run(dag, input_value={"a": 4, "b": 1},
                       workflow_id="proj", storage=str(tmp_path))
    assert out == 9


# ---------------------------------------------------------------------------
# mirrors of tests/test_workflow_dynamic.py
# ---------------------------------------------------------------------------


def test_continuation_recursion_durable(port_session, tmp_path):
    rt = port_session
    from ray_tpu_torch import workflow
    from ray_tpu_torch.dag import InputNode

    @rt.remote
    def fact(pair):
        from ray_tpu_torch import workflow as wf

        n, acc = pair
        if n <= 1:
            return acc
        with InputNode() as inp:
            sub = fact.bind(inp)
        return wf.continuation(sub, (n - 1, acc * n))

    with InputNode() as inp:
        dag = fact.bind(inp)
    result = workflow.run(dag, workflow_id="wf-fact", input_value=(5, 1),
                          storage=str(tmp_path))
    assert result == 120
    files = sorted(os.listdir(tmp_path / "wf-fact"))
    nested = [f for f in files if f.count("001-fact") >= 2]
    assert nested, files


def test_continuation_resume_skips_committed_levels(port_session, tmp_path):
    rt = port_session
    from ray_tpu_torch import workflow
    from ray_tpu_torch.dag import InputNode

    marker = str(tmp_path / "runs")
    flag = str(tmp_path / "fail.flag")
    open(flag, "w").close()

    @rt.remote
    def outer(x):
        from ray_tpu_torch import workflow as wf

        with open(marker, "a") as f:
            f.write("outer\n")
        with InputNode() as inp:
            sub = inner.bind(inp)
        return wf.continuation(sub, x + 1)

    @rt.remote
    def inner(y):
        if os.path.exists(flag):
            raise RuntimeError("injected crash")
        with open(marker, "a") as f:
            f.write("inner\n")
        return y * 10

    with InputNode() as inp:
        dag = outer.bind(inp)

    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="wf-cont", input_value=3,
                     storage=str(tmp_path))
    os.remove(flag)
    assert workflow.resume("wf-cont", storage=str(tmp_path)) == 40
    with open(marker) as f:
        runs = f.read().split()
    assert runs == ["outer", "inner"]


@pytest.mark.timeout(300)
def test_continuation_depth_beyond_python_recursion_limit(
        port_session, tmp_path):
    rt = port_session
    from ray_tpu_torch import workflow
    from ray_tpu_torch.dag import InputNode

    @rt.remote
    def countdown(pair):
        from ray_tpu_torch import workflow as wf

        n, acc = pair
        if n == 0:
            return acc
        with InputNode() as inp:
            sub = countdown.bind(inp)
        return wf.continuation(sub, (n - 1, acc + n))

    with InputNode() as inp:
        dag = countdown.bind(inp)
    depth = 350
    result = workflow.run(dag, workflow_id="wf-deep",
                          input_value=(depth, 0), storage=str(tmp_path))
    assert result == depth * (depth + 1) // 2
    names = os.listdir(tmp_path / "wf-deep")
    assert max(len(n) for n in names) < 200
    assert len(names) > 2 * depth


def test_virtual_actor_state_persists_and_reattaches(port_session,
                                                     tmp_path):
    from ray_tpu_torch import workflow

    @workflow.virtual_actor
    class Counter:
        def __init__(self, start=0):
            self.value = start

        def add(self, n):
            self.value += n
            return self.value

        @workflow.virtual_actor_readonly
        def get(self):
            return self.value

    counter = Counter.get_or_create("c1", 100, storage=str(tmp_path))
    assert counter.add.run(5) == 105
    assert counter.add.run(7) == 112
    assert counter.get.run() == 112

    again = workflow.get_actor("c1", storage=str(tmp_path))
    assert again.get.run() == 112
    assert again.add.run(1) == 113
    log = again.call_log()
    assert [e["method"] for e in log] == ["add", "add", "add"]
    assert [e["result"] for e in log] == [105, 112, 113]


def test_virtual_actor_readonly_commits_nothing(port_session, tmp_path):
    from ray_tpu_torch import workflow

    @workflow.virtual_actor
    class Probe:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            return self.n

        @workflow.virtual_actor_readonly
        def peek(self):
            return self.n

    probe = Probe.get_or_create("p1", storage=str(tmp_path))
    probe.bump.run()
    files_before = sorted(os.listdir(tmp_path / "va-p1"))
    for _ in range(3):
        assert probe.peek.run() == 1
    assert sorted(os.listdir(tmp_path / "va-p1")) == files_before
