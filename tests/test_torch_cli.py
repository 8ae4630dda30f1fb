"""The port's CLI (`python -m ray_tpu_torch`, copied from
`ray_tpu/scripts/cli.py`), job submission and state API, held to the JAX
package's: `tests/test_cli_jobs_state.py`'s nine tests through the
port, the two parsers' subcommands and options equal but for the
reviewed hunks (`start --num-gpus` for `--num-tpus`), the refused TPU
provider and `devtools all` over a port file, and the job-visibility
repair: a submitted entrypoint sees the host's CUDA_VISIBLE_DEVICES, not
the manager actor's empty one."""

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import pytest

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("RT_ADDRESS", None)
    env.update(extra)
    return env


def _cli(info, *argv, env=None, timeout=60, **kw):
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "--cluster-info", info,
         *argv],
        env=env or _env(), capture_output=True, text=True, timeout=timeout,
        **kw)


def _start_head(info, tmp_path, num_cpus="2", env=None):
    """A head in a session directory of its own, under the temp root as
    the CLI's default (a unix socket's path must stay under 108 bytes:
    pytest's per-test directories under xdist run past it)."""
    session = tempfile.mkdtemp(prefix="rt_cli_")
    head = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "--cluster-info", info,
         "start", "--head", "--num-cpus", num_cpus, "--num-gpus", "0",
         "--session-dir", session],
        env=env or _env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    head.session = session
    deadline = time.time() + 30
    while time.time() < deadline and not os.path.exists(info):
        assert head.poll() is None, head.stdout.read().decode()
        time.sleep(0.2)
    assert os.path.exists(info), "head never wrote cluster info"
    return head


def _stop(proc):
    if proc is not None and proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    if getattr(proc, "session", None):
        shutil.rmtree(proc.session, ignore_errors=True)


@pytest.fixture
def port_session():
    import ray_tpu_torch as rt

    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


# ---------------------------------------------------------------------------
# the parsers
# ---------------------------------------------------------------------------


def _parser(main):
    """The parser a CLI's `main` builds, caught at its parse."""
    caught = {}

    class Caught(Exception):
        pass

    def parse_args(self, args=None, namespace=None):
        caught["parser"] = self
        raise Caught

    original = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse_args
    try:
        main([])
    except Caught:
        pass
    finally:
        argparse.ArgumentParser.parse_args = original
    return caught["parser"]


def _surface(parser, prefix=""):
    """{command path: sorted (option strings or dest, nargs, default)}."""
    out = {}
    rows = []
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out.update(_surface(sub, f"{prefix} {name}".strip()))
            continue
        if isinstance(action, argparse._HelpAction):
            continue
        rows.append((tuple(action.option_strings) or (action.dest,),
                     str(action.nargs), repr(action.default)))
    out[prefix] = sorted(rows)
    return out


def test_parser_is_the_jax_packages_but_for_the_reviewed_hunks():
    from ray_tpu.scripts import cli as jax_cli
    from ray_tpu_torch.scripts import cli

    jax_surface = _surface(_parser(jax_cli.main))
    port_surface = _surface(_parser(cli.main))
    assert sorted(port_surface) == sorted(jax_surface)
    assert len(port_surface) > 30
    for command, rows in jax_surface.items():
        if command == "start":
            rows = [(("--num-gpus",), *row[1:]) if row[0] == ("--num-tpus",)
                    else row for row in rows]
        assert port_surface[command] == sorted(rows), command
    assert _parser(cli.main).prog == "ray_tpu_torch"


def test_up_refuses_the_tpu_provider(tmp_path):
    config = tmp_path / "tpu.json"
    config.write_text(json.dumps({"provider": {"type": "gcp_tpu"}}))
    out = _cli(str(tmp_path / "info.json"), "up", str(config))
    assert out.returncode != 0
    assert "TPU-only" in out.stderr and "gcp_tpu" in out.stderr


def test_devtools_all_runs_the_ports_four_passes(tmp_path):
    from ray_tpu_torch import devtools

    bad = tmp_path / "bad.py"
    bad.write_text("import ray_tpu_torch as rt\n\n"
                   "@rt.remote\ndef f(x):\n    return x\n\n"
                   "f.remote(1, 2)\n")
    out = _cli(str(tmp_path / "info.json"), "devtools", "all",
               str(bad), "--json")
    assert out.returncode == 1, out.stdout + out.stderr
    rules = {f["rule"] for f in json.loads(out.stdout)}
    assert "RT101" in rules  # check's arity rule, through the gate
    assert devtools.all_main([str(tmp_path / "missing")]) == 2


# ---------------------------------------------------------------------------
# the job's card
# ---------------------------------------------------------------------------


def test_submitted_job_sees_the_hosts_cuda_visible_devices(tmp_path):
    """The job manager is a CPU worker, whose env hides the cards
    (`CUDA_VISIBLE_DEVICES=""`); the entrypoint gets the host's value
    back, as upstream's job supervisor gives it."""
    info = str(tmp_path / "cluster.json")
    env = _env(CUDA_VISIBLE_DEVICES="rt-marker-7")
    head = _start_head(info, tmp_path, env=env)
    try:
        probe = ("import os, json; print('SEEN', json.dumps("
                 "[os.environ.get('CUDA_VISIBLE_DEVICES'), "
                 "'RT_HOST_CUDA_VISIBLE_DEVICES' in os.environ]))")
        out = _cli(info, "submit", "--", sys.executable, "-c", probe,
                   timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        seen = json.loads(out.stdout.split("SEEN", 1)[1].splitlines()[0])
        assert seen == ["rt-marker-7", False]
    finally:
        _cli(info, "stop")
        _stop(head)
    # A host that leaves the variable unset gives a job that has none.
    info = str(tmp_path / "cluster2.json")
    env = _env()
    env.pop("CUDA_VISIBLE_DEVICES", None)
    head = _start_head(info, tmp_path, env=env)
    try:
        out = _cli(info, "submit", "--", sys.executable, "-c", probe,
                   env=env, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        seen = json.loads(out.stdout.split("SEEN", 1)[1].splitlines()[0])
        assert seen == [None, False]
    finally:
        _cli(info, "stop")
        _stop(head)


# ---------------------------------------------------------------------------
# mirrors of tests/test_cli_jobs_state.py
# ---------------------------------------------------------------------------


def test_state_api_lists(port_session):
    rt = port_session
    from ray_tpu_torch.util import state

    @rt.remote
    def f():
        return 1

    @rt.remote
    class A:
        def ping(self):
            return "pong"

    rt.put(list(range(100)))
    rt.get(f.remote(), timeout=20)
    a = A.remote()
    rt.get(a.ping.remote(), timeout=20)

    nodes = state.list_nodes()
    assert len(nodes) == 1 and nodes[0]["is_head"]
    actors = state.list_actors()
    assert any(x["class_name"] == "A" for x in actors)
    tasks = state.list_tasks()
    assert any(t["name"] == "f" for t in tasks)
    objects = state.list_objects()
    assert len(objects) >= 1
    assert state.summarize()


def test_list_tasks_newest_first_under_limit(port_session):
    rt = port_session
    from ray_tpu_torch.util import state

    @rt.remote
    def tick(i):
        return i

    for i in range(6):
        rt.get(tick.remote(i), timeout=20)
    all_rows = state.list_tasks()
    times = [float(r.get("time", 0.0)) for r in all_rows]
    assert times == sorted(times, reverse=True)
    newest_two = state.list_tasks(limit=2)
    assert [r["task_id"] for r in newest_two] == [
        r["task_id"] for r in all_rows[:2]
    ]


def test_job_submission_end_to_end(port_session, tmp_path):
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

    client = JobSubmissionClient()
    script = tmp_path / "job_script.py"
    script.write_text(
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import ray_tpu_torch as rt\n"
        "rt.init()\n"
        "@rt.remote\n"
        "def f(x):\n"
        "    return x * 3\n"
        "print('job result:', rt.get(f.remote(14)))\n"
    )
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} {script}",
        metadata={"who": "test"},
    )
    status = client.wait_until_finished(job_id, timeout=120)
    logs = client.get_job_logs(job_id)
    assert status == JobStatus.SUCCEEDED, logs
    assert "job result: 42" in logs
    jobs = client.list_jobs()
    assert any(j["job_id"] == job_id for j in jobs)


def test_job_failure_status(port_session):
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

    client = JobSubmissionClient()
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'"
    )
    assert client.wait_until_finished(job_id, 60) == JobStatus.FAILED
    assert client.get_job_info(job_id)["exit_code"] == 3


def test_cli_start_status_submit_stop(tmp_path):
    """Full CLI lifecycle against a real head process."""
    info = str(tmp_path / "cluster.json")
    head = _start_head(info, tmp_path)
    try:
        out = _cli(info, "status")
        assert out.returncode == 0, out.stdout + out.stderr
        assert "nodes: 1" in out.stdout

        out = _cli(info, "submit", "--", sys.executable, "-c", "print(6*7)",
                   timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "42" in out.stdout

        _cli(info, "stop")
        assert head.wait(timeout=30) is not None
    finally:
        _stop(head)


def test_cli_state_ls_and_metrics(tmp_path):
    """`state ls` + `metrics scrape/snapshot` against a real head
    process: JSON contract, exit codes, Prometheus text."""
    info = str(tmp_path / "cluster.json")
    env = _env(RT_metrics_timeseries_interval_s="0.2")
    head = _start_head(info, tmp_path, env=env)
    try:
        def run(*argv):
            return _cli(info, *argv, env=env)

        out = run("state", "ls", "nodes", "--json")
        assert out.returncode == 0, out.stdout + out.stderr
        rows = json.loads(out.stdout)
        assert len(rows) == 1 and rows[0]["is_head"]

        out = run("state", "ls", "pgs")
        assert out.returncode == 0, out.stdout + out.stderr
        assert "no pgs" in out.stdout

        out = run("state", "ls", "tasks", "--json", "--limit", "5")
        assert out.returncode == 0, out.stdout + out.stderr
        assert isinstance(json.loads(out.stdout), list)

        out = run("state", "ls", "bogus")
        assert out.returncode == 2

        out = run("metrics", "scrape")
        assert out.returncode == 0, out.stdout + out.stderr
        assert "# TYPE rt_nodes_alive gauge" in out.stdout
        assert 'rt_nodes_alive{node="' in out.stdout

        # The snapshot ring fills at 0.2 s a tick: wait for two.
        deadline = time.time() + 30
        snaps = []
        while time.time() < deadline:
            out = run("metrics", "snapshot", "--limit", "2")
            assert out.returncode == 0, out.stdout + out.stderr
            snaps = json.loads(out.stdout)
            if len(snaps) >= 2:
                break
            time.sleep(0.3)
        assert len(snaps) == 2
        assert "metrics" in snaps[0] and "time" in snaps[0]
    finally:
        _stop(head)


def test_cli_dashboard_serves(tmp_path):
    """`python -m ray_tpu_torch dashboard` attaches to a running cluster
    and serves the SPA + API."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=1)
    try:
        address = rt.api._session.daemon.socket_path
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "dashboard",
             "--address", address, "--port", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env(),
        )
        try:
            found = {"url": None, "out": []}
            ready = threading.Event()

            def scan():
                for line in proc.stdout:
                    found["out"].append(line)
                    if "dashboard:" in line:
                        found["url"] = line.split("dashboard:")[1].strip()
                        ready.set()
                        return

            threading.Thread(target=scan, daemon=True).start()
            assert ready.wait(30), (
                f"dashboard never came up: {found['out'][-5:]}")
            nodes = json.loads(urllib.request.urlopen(
                found["url"] + "/api/nodes", timeout=10).read())
            assert len(nodes) >= 1
        finally:
            _stop(proc)
    finally:
        rt.shutdown()


def test_cli_up_down_memory_timeline(tmp_path):
    """`up` boots an autoscaling cluster from a config file, the
    state-backed commands (`memory`, `timeline`) run against it, and
    `down` stops it via the cluster-info file."""
    info = str(tmp_path / "cluster.json")
    config = tmp_path / "cluster.yaml"
    config.write_text(
        "cluster_name: cli-test\n"
        "provider:\n  type: fake\n"
        "head_resources: {CPU: 2.0}\n"
        "worker_node_types:\n"
        "  cpu-worker:\n"
        "    resources: {CPU: 2.0}\n"
        "    min_workers: 0\n"
        "    max_workers: 2\n"
    )
    up = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "--cluster-info", info,
         "up", str(config)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    try:
        deadline = time.time() + 60
        while time.time() < deadline and not os.path.exists(info):
            time.sleep(0.2)
        assert os.path.exists(info), "up never wrote cluster info"

        script = tmp_path / "job.py"
        script.write_text(
            "import ray_tpu_torch as rt\n"
            "rt.init()\n"
            "print('mem-probe', rt.get(rt.put(b'x' * 100000))[:1])\n"
        )
        out = _cli(info, "submit", "--timeout", "120", "--",
                   sys.executable, str(script), timeout=180)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "SUCCEEDED" in out.stdout

        out = _cli(info, "memory")
        assert out.returncode == 0, out.stdout + out.stderr
        assert "objects" in out.stdout

        trace_out = tmp_path / "trace.json"
        out = _cli(info, "timeline", "--out", str(trace_out))
        assert out.returncode == 0, out.stdout + out.stderr
        assert trace_out.exists()

        out = _cli(info, "down")
        assert out.returncode == 0, out.stdout + out.stderr
        assert up.wait(timeout=30) == 0
    finally:
        _stop(up)


def test_cli_serve_run_status_shutdown(tmp_path):
    """`serve run module:app` deploys and serves over HTTP; `serve
    status` reports it; `serve shutdown` tears it down."""
    info = str(tmp_path / "cluster.json")
    app_py = tmp_path / "cli_app.py"
    app_py.write_text(
        "from ray_tpu_torch import serve\n"
        "@serve.deployment\n"
        "class Hello:\n"
        "    def __call__(self, request):\n"
        "        return {'hello': request.query_params.get('q', '')}\n"
        "app = Hello.bind()\n"
    )
    head = _start_head(info, tmp_path, num_cpus="4")
    srv = None
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        srv = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "--cluster-info", info,
             "serve", "run", "cli_app:app", "--port", str(port)],
            env=_env(), cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        deadline = time.time() + 60
        body = None
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/?q=cli", timeout=5
                ) as resp:
                    body = resp.read()
                break
            except Exception:
                assert srv.poll() is None, srv.stdout.read().decode()
                time.sleep(0.5)
        assert body is not None and b"cli" in body, body

        out = _cli(info, "serve", "status")
        assert out.returncode == 0, out.stdout + out.stderr
        assert "default" in out.stdout

        out = _cli(info, "serve", "shutdown")
        assert out.returncode == 0, out.stdout + out.stderr
    finally:
        for proc in (srv, head):
            _stop(proc)
