"""Hygiene of the PyTorch port: `ray_tpu_torch`, `chip_smoke.py` and
`kernel_ablation.py` import neither JAX nor anything of `ray_tpu`, its
entry points default to the card, and its parameters line up with the
JAX package's."""

import ast
import inspect
import os
import shutil
import subprocess
import sys
import tempfile
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu_torch.llm import kv_slots, serving
from ray_tpu_torch.models import generate, hf_convert, llama
from ray_tpu_torch import graft_entry
from ray_tpu_torch.ops import init_moe_params
from ray_tpu_torch.parallel import MeshSpec, pipeline_mesh
from ray_tpu_torch.rl import (
    DQNConfig,
    DQNLearner,
    LearnerGroup,
    PolicyEngineActor,
    PPOConfig,
    SingleAgentEnvRunner,
    TorchLearner,
)
from ray_tpu_torch.train import (
    MPMDPipeline,
    init_torch_distributed,
    make_train_step,
    run_local_gang,
)

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ray_tpu_torch")


def _port_sources():
    paths = [os.path.join(root, name)
             for root, _, files in os.walk(PORT)
             for name in files if name.endswith(".py")]
    return sorted(paths) + [os.path.join(REPO, "chip_smoke.py"),
                            os.path.join(REPO, "kernel_ablation.py")]


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "optax", "ray_tpu")


def test_imports_leave_jax_and_ray_tpu_out():
    """In a fresh interpreter (this one has jax loaded by conftest)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ray_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    ray_tpu_torch.__path__, 'ray_tpu_torch.')]\n"
        "for name in names:\n"
        "    if not name.endswith('.__main__'):  # it runs the CLI\n"
        "        importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'ray_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=100)
    assert proc.returncode == 0, proc.stderr
    n_modules = sum(1 for p in _port_sources() if p.startswith(PORT)) - 1
    assert int(proc.stdout.split()[-1]) == n_modules


@pytest.mark.parametrize("module", [
    "ray_tpu_torch.parallel",
    "ray_tpu_torch.train.trainer",
    "ray_tpu_torch.train.checkpoint",
    "ray_tpu_torch.graft_entry",
    "ray_tpu_torch.parallel.collective",
    "ray_tpu_torch.parallel.pipeline",
    "ray_tpu_torch.ops.moe",
    "ray_tpu_torch.ops.ring_attention",
    "ray_tpu_torch.train.pipeline_step",
    "ray_tpu_torch.parallel.schedule",
    "ray_tpu_torch.train.mpmd_pipeline",
])
def test_sharded_training_modules_leave_jax_out(module):
    """Each alone, in a fresh interpreter."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'ray_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=100)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", [
    "ray_tpu_torch._private.compile_watch",
    "ray_tpu_torch.train.telemetry",
    "ray_tpu_torch.devtools",
    "ray_tpu_torch.devtools.lint",
    "ray_tpu_torch.devtools.rules",
    "ray_tpu_torch.devtools.contracts",
    "ray_tpu_torch.devtools.check",
    "ray_tpu_torch.devtools.concurrency",
    "ray_tpu_torch.devtools.accel",
])
def test_observability_modules_leave_jax_out(module):
    """Each alone, in a fresh interpreter; the watch and the gates load
    no torch either (the train package does)."""
    torch_free = not module.startswith("ray_tpu_torch.train")
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'ray_tpu')]\n"
        "assert not bad, bad\n"
        f"assert not {torch_free} or 'torch' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=100)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", [
    "ray_tpu_torch.serve",
    "ray_tpu_torch.llm.serving",
    "ray_tpu_torch.cluster_utils",
])
def test_serving_modules_leave_jax_out(module):
    """Each alone, in a fresh interpreter."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'ray_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=100)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", [
    "ray_tpu_torch.rl",
    "ray_tpu_torch.rl.env",
    "ray_tpu_torch.rl.actor_manager",
    "ray_tpu_torch.rl.rollout_queue",
    "ray_tpu_torch.rl.weight_sync",
    "ray_tpu_torch.rl.models",
    "ray_tpu_torch.rl.learner",
    "ray_tpu_torch.rl.env_runner",
    "ray_tpu_torch.rl.learner_group",
    "ray_tpu_torch.rl.ppo",
    "ray_tpu_torch.rl.dqn",
    "ray_tpu_torch.rl.dataflow",
])
def test_rl_modules_leave_jax_out(module):
    """Each alone, in a fresh interpreter."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'ray_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=100)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", [
    "ray_tpu_torch.data",
    "ray_tpu_torch.data.block",
    "ray_tpu_torch.data.tfrecords",
    "ray_tpu_torch.data.executor",
    "ray_tpu_torch.data.dataset",
    "ray_tpu_torch.data.read_api",
    "ray_tpu_torch.tune",
    "ray_tpu_torch.tune.search",
    "ray_tpu_torch.tune.schedulers",
    "ray_tpu_torch.tune.session",
    "ray_tpu_torch.tune.tuner",
])
def test_data_and_tune_modules_leave_jax_out(module):
    """Each alone, in a fresh interpreter."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'ray_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=100)
    assert proc.returncode == 0, proc.stderr


CLUSTER_SURFACE = (
    "ray_tpu_torch.util.prometheus",
    "ray_tpu_torch.util.actor_pool",
    "ray_tpu_torch.util.queue",
    "ray_tpu_torch.util.collective",
    "ray_tpu_torch.job_submission",
    "ray_tpu_torch.dashboard",
    "ray_tpu_torch.workflow",
    "ray_tpu_torch.workflow.virtual_actor",
    "ray_tpu_torch.autoscaler.node_provider",
    "ray_tpu_torch.autoscaler.autoscaler",
    "ray_tpu_torch.autoscaler.sdk",
    "ray_tpu_torch.autoscaler.cluster",
    "ray_tpu_torch.autoscaler",
    "ray_tpu_torch.autoscaler.v2.instance",
    "ray_tpu_torch.autoscaler.v2.instance_manager",
    "ray_tpu_torch.autoscaler.v2.reconciler",
    "ray_tpu_torch.autoscaler.v2.autoscaler",
    "ray_tpu_torch.autoscaler.v2",
    "ray_tpu_torch.scripts",
    "ray_tpu_torch.scripts.cli",
    "ray_tpu_torch.__main__",
)


@pytest.mark.parametrize("module", CLUSTER_SURFACE)
def test_cluster_surface_modules_leave_jax_out(module):
    """Each alone, in a fresh interpreter, and without torch: the CLI,
    jobs, dashboard, workflow, util APIs and autoscaler are the
    runtime's. `__main__` runs the CLI: its `--help`."""
    code = (
        "import importlib, sys\n"
        "sys.argv = ['ray_tpu_torch', '--help']\n"
        "try:\n"
        f"    importlib.import_module({module!r})\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'ray_tpu', 'torch')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=100)
    assert proc.returncode == 0, proc.stderr


#: Runs `python -m ray_tpu_torch` with argv[1:] in this interpreter, with
#: JAX and the JAX package unimportable, and prints whether torch's CUDA
#: was initialized.
_BLOCKED_CLI = (
    "import importlib.abc, runpy, sys\n"
    "class Block(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu'):\n"
    "            raise ImportError(f'{name} is blocked')\n"
    "sys.meta_path.insert(0, Block())\n"
    "argv = sys.argv[1:]\n"
    "sys.argv = ['ray_tpu_torch'] + argv\n"
    "try:\n"
    "    runpy.run_module('ray_tpu_torch', run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    assert not e.code, e.code\n"
    "torch = sys.modules.get('torch')\n"
    "print('CUDA', bool(torch and torch.cuda.is_initialized()))\n"
)


def test_cli_help_and_status_run_without_jax_or_cuda(tmp_path):
    """`python -m ray_tpu_torch --help`, and `status` against a head it
    starts, with `jax` and `ray_tpu` blocked: neither imports them, and
    neither initializes torch's CUDA."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("RT_ADDRESS", None)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_CLI, "--help"],
                         env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "usage: ray_tpu_torch" in out.stdout
    assert out.stdout.strip().endswith("CUDA False")
    info = str(tmp_path / "cluster.json")
    session = tempfile.mkdtemp(prefix="rt_cli_")  # short socket paths
    head = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "--cluster-info", info,
         "start", "--head", "--num-cpus", "1", "--num-gpus", "0",
         "--session-dir", session],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 30
        while not os.path.exists(info):
            assert head.poll() is None and time.time() < deadline
            time.sleep(0.1)
        out = subprocess.run(
            [sys.executable, "-c", _BLOCKED_CLI, "--cluster-info", info,
             "status"], env=env, capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        assert "nodes: 1" in out.stdout
        assert out.stdout.strip().endswith("CUDA False")
    finally:
        head.terminate()
        head.wait(timeout=30)
        shutil.rmtree(session, ignore_errors=True)


def test_rl_runner_and_learner_actors_leave_jax_and_ray_tpu_out():
    """An env runner that sampled and a learner actor that stepped, both
    spawned by the port's runtime in a fresh interpreter: neither they
    nor the driver import JAX or anything of `ray_tpu`."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch\n"
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch.rl.env_runner import SingleAgentEnvRunner\n"
        "from ray_tpu_torch.rl.learner_group import _LearnerActor\n"
        "from ray_tpu_torch.rl.models import init_policy_params, \\\n"
        "    to_jax_policy_params\n"
        "def bad():\n"
        "    import sys\n"
        "    return sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                  ('jax', 'jaxlib', 'optax', 'ray_tpu'))\n"
        "class Runner(SingleAgentEnvRunner):\n"
        "    def bad(self):\n"
        "        return bad()\n"
        "class Learner(_LearnerActor):\n"
        "    def bad(self):\n"
        "        return bad()\n"
        "rt.init(num_cpus=3)\n"
        "w = to_jax_policy_params(init_policy_params(\n"
        "    torch.Generator().manual_seed(0), 4, 2, device='cpu'))\n"
        "runner = rt.remote(num_cpus=1)(Runner).remote('CartPole-v1', 2, 4)\n"
        "rt.get(runner.set_weights.remote(w), timeout=60)\n"
        "rows = len(rt.get(runner.sample.remote(), timeout=60)['obs'])\n"
        "learner = rt.remote(num_cpus=1)(Learner).remote(\n"
        "    {'obs_size': 4, 'num_actions': 2, 'device': 'cpu'}, 0)\n"
        "rng = np.random.default_rng(0)\n"
        "shard = {'obs': rng.normal(size=(8, 4)).astype(np.float32),\n"
        "         'actions': np.zeros(8, np.int32),\n"
        "         'logp': np.full(8, -0.7, np.float32),\n"
        "         'advantages': rng.normal(size=8).astype(np.float32),\n"
        "         'value_targets': np.ones(8, np.float32)}\n"
        "rt.get(learner.set_batch.remote(shard), timeout=60)\n"
        "rt.get(learner.start_epoch.remote(0), timeout=60)\n"
        "grads, _ = rt.get(learner.grad_step.remote(0, 8), timeout=60)\n"
        "rt.get(learner.apply_grads.remote(grads), timeout=60)\n"
        "out = {'rows': rows, 'grads': sorted(grads),\n"
        "       'runner': rt.get(runner.bad.remote(), timeout=60),\n"
        "       'learner': rt.get(learner.bad.remote(), timeout=60)}\n"
        "rt.shutdown()\n"
        "out['driver'] = bad()\n"
        "print(out)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = eval(proc.stdout.strip().splitlines()[-1])
    assert out.pop("rows") == 8
    assert out.pop("grads") == sorted(
        f"{p}.{leaf}" for p in ("layers.0", "layers.1", "pi", "vf")
        for leaf in "wb")
    assert out == {"runner": [], "learner": [], "driver": []}, out


def test_served_app_and_its_replica_leave_jax_and_ray_tpu_out():
    """`serve.run` of `build_llm_app` in a fresh interpreter: neither
    the driver nor the replica that served a request imports JAX or
    anything of `ray_tpu`."""
    code = (
        "import sys\n"
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch import serve\n"
        "from ray_tpu_torch.llm import LLMServer, build_llm_app\n"
        "class Probe(LLMServer):\n"
        "    def bad(self):\n"
        "        import sys\n"
        "        return sorted(m for m in sys.modules if m.split('.')[0]\n"
        "                      in ('jax', 'jaxlib', 'optax', 'ray_tpu'))\n"
        "rt.init(num_cpus=3)\n"
        "app = build_llm_app({'t': {'kind': 'init', 'config': {\n"
        "    'vocab_size': 32, 'dim': 16, 'n_layers': 1, 'n_heads': 2,\n"
        "    'n_kv_heads': 1, 'intermediate': 32, 'dtype': 'float32'}}},\n"
        "    engine={'slots': 1, 'max_len': 16, 'prefill_chunk': 8,\n"
        "            'max_new_tokens': 2}, device='cpu')\n"
        "app.deployment._cls = Probe\n"
        "h = serve.run(app, name='probe', route_prefix=None)\n"
        "n = len(list(h.options(stream=True).remote({'prompt': [1, 2]})))\n"
        "out = {'tokens': n, 'replica': h.bad.remote().result(timeout=60)}\n"
        "serve.shutdown()\n"
        "rt.shutdown()\n"
        "out['driver'] = sorted(m for m in sys.modules if m.split('.')[0]\n"
        "                       in ('jax', 'jaxlib', 'optax', 'ray_tpu'))\n"
        "print(out)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = eval(proc.stdout.strip().splitlines()[-1])
    assert out == {"tokens": 2, "replica": [], "driver": []}, out


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_has_no_jax_or_ray_tpu_import(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno, names)


def test_runtime_and_its_workers_leave_jax_and_ray_tpu_out():
    """`ray_tpu_torch.init()`, a task and an actor in a fresh
    interpreter: neither the driver nor the workers the runtime starts
    import JAX or anything of `ray_tpu` (a copied module name left as
    `ray_tpu.…` would start the JAX package's workers)."""
    code = (
        "import sys\n"
        "import ray_tpu_torch as rt\n"
        "def bad():\n"
        "    import sys\n"
        "    return sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                  ('jax', 'jaxlib', 'optax', 'ray_tpu'))\n"
        "rt.init(num_cpus=2)\n"
        "task = rt.remote(bad)\n"
        "@rt.remote\n"
        "class Actor:\n"
        "    def bad(self):\n"
        "        return bad()\n"
        "    def module(self):\n"
        "        import sys\n"
        "        return sys.modules['__main__'].__spec__.name\n"
        "a = Actor.remote()\n"
        "out = {'task': rt.get(task.remote(), timeout=60),\n"
        "       'actor': rt.get(a.bad.remote(), timeout=60),\n"
        "       'worker_main': rt.get(a.module.remote(), timeout=60)}\n"
        "rt.shutdown()\n"
        "out['driver'] = bad()\n"
        "print(out)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = eval(proc.stdout.strip().splitlines()[-1])
    # A worker runs the port's entry point: forked from the port's warm
    # template, or started fresh as its worker_main.
    assert out.pop("worker_main") in (
        "ray_tpu_torch._private.worker_forkserver",
        "ray_tpu_torch._private.worker_main"), out
    assert out == {"task": [], "actor": [], "driver": []}, out


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_string_names_a_ray_tpu_module(path):
    """Module names in the port's strings read `ray_tpu_torch.`: no
    string (docstrings aside) is a dotted `ray_tpu.…` module path, runs
    `-m ray_tpu.…`, imports `ray_tpu` by text, or names `ray_tpu.init()`
    (the copied runtime's daemon and fork server start workers by such
    strings). `ray_tpu.wire`, the protobuf package of the byte-identical
    `protocol_pb2.py`, is in bytes, and prose that names a JAX-package
    module as a reference is not a module name."""
    import re

    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    getattr(body[0], "value", None), ast.Constant):
                docstrings.add(id(body[0].value))
    hits = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docstrings):
            continue
        text = node.value
        if (re.fullmatch(r"\s*ray_tpu(\.\w+)+\s*", text)
                or re.search(r"(-m|import|from)\s+ray_tpu\b(?!_)", text)
                or "ray_tpu.init(" in text):
            hits.append((node.lineno, text[:80]))
    assert not hits, hits


def test_entry_points_default_to_the_card():
    assert inspect.signature(llama.Llama).parameters["device"].default == "cuda"
    assert inspect.signature(llama.init_params).parameters["device"].default == "cuda"
    assert inspect.signature(make_train_step).parameters["device"].default == "cuda"
    for entry in (generate.init_kv_cache, generate.init_block_pool,
                  hf_convert.load_hf_llama, kv_slots.PagedKVCache,
                  MeshSpec.build, graft_entry.entry, init_torch_distributed,
                  run_local_gang, pipeline_mesh, init_moe_params,
                  serving.build_model, serving.LLMServer,
                  serving.build_llm_app, MPMDPipeline, TorchLearner,
                  DQNLearner, LearnerGroup, PolicyEngineActor):
        assert inspect.signature(entry).parameters["device"].default == "cuda"
    # RL: the learners and the policy engine on the card; the runners
    # sample on the host, as the reference's do.
    assert PPOConfig().device == DQNConfig().device == "cuda"
    assert SingleAgentEnvRunner.device == "cpu"


def test_load_jax_params_round_trips_tiny():
    cfg_j = jax_llama.LlamaConfig.tiny(qk_norm=True, attn_bias=True)
    cfg = llama.LlamaConfig.tiny(qk_norm=True, attn_bias=True)
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jax.random.PRNGKey(0), cfg_j))
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(llama.load_jax_params(tree, cfg))
    back = llama.to_jax_params(model.state_dict(), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)


def test_7b_width_shapes_match_jax_without_allocating():
    cfg_j = jax_llama.LlamaConfig.llama2_7b(n_layers=4)
    cfg = llama.LlamaConfig.llama2_7b(n_layers=4)
    shapes = jax.eval_shape(lambda k: jax_llama.init_params(k, cfg_j),
                            jax.random.PRNGKey(0))
    state = llama.Llama(cfg, device="meta").state_dict()
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in state.values())
    leaves = {"embed": ("embed.weight", False), "final_norm": ("final_norm", False),
              "lm_head": ("lm_head.weight", True)}
    for leaf, (name, transpose) in leaves.items():
        want = shapes[leaf].shape[::-1] if transpose else shapes[leaf].shape
        assert tuple(state[name].shape) == want, leaf
    for leaf, spec in shapes["layers"].items():
        name, transpose = llama._LAYER_LEAVES[leaf]
        want = spec.shape[1:][::-1] if transpose else spec.shape[1:]
        for i in range(cfg.n_layers):
            assert tuple(state[f"layers.{i}.{name}"].shape) == want, (leaf, i)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert n_jax == sum(t.numel() for t in state.values()) == cfg.num_params()


def test_chip_smoke_finds_the_peak_and_what_is_alive_at_it():
    import chip_smoke

    def frame(path, line, name):
        return [{"filename": path, "line": line, "name": name}]

    trace = [
        {"action": "alloc", "addr": 1, "size": 100,
         "frames": frame("/x/ray_tpu_torch/ops/attention.py", 5, "f")},
        {"action": "alloc", "addr": 2, "size": 50, "frames": []},
        # A block allocated before the history began, freed during it.
        {"action": "free_requested", "addr": 9, "size": 30},
        {"action": "alloc", "addr": 3, "size": 60,
         "frames": frame("/t/torch/nn/functional.py", 7, "g")},
        {"action": "free_requested", "addr": 1, "size": 100},
        {"action": "alloc", "addr": 4, "size": 10, "frames": []},
    ]
    above, alive = chip_smoke.peak_allocations(trace)
    assert above == 180
    assert alive == [
        {"site": "ray_tpu_torch/ops/attention.py:5 f", "bytes": 100},
        {"site": "functional.py:7 g", "bytes": 60},
        {"site": "(no Python frame)", "bytes": 50},
    ]


def test_chip_smoke_loads_another_checkout_beside_this_one(tmp_path):
    import shutil

    import chip_smoke
    from ray_tpu_torch.ops import attention as attn

    shutil.copytree(PORT, tmp_path / "ray_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    try:
        other = chip_smoke.load_port(tmp_path)
        other_attn = other.ops.attention
        assert other_attn.__file__.startswith(str(tmp_path))
        assert other_attn.LAUNCHES is not attn.LAUNCHES
        gen = torch.Generator().manual_seed(0)
        q, k, v, do = (torch.randn(2, 64, 64, generator=gen) for _ in range(4))
        grads = []
        for tree in (other_attn, attn):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            out = tree.flash_attention_bhsd(*leaves, 0.125, True, 64, 64)
            grads.append((out,) + torch.autograd.grad(out, leaves, do))
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    finally:
        for name in [m for m in sys.modules if m.startswith("against_ray_tpu_torch")]:
            del sys.modules[name]
