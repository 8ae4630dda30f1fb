# Copied from ray_tpu/scripts/cli.py (JAX-free), with the port's name, `--num-gpus`, its `device_trace`, and no TPU provider:
# module names read ray_tpu_torch.
"""Cluster CLI.

Reference: python/ray/scripts/scripts.py — `ray start --head` /
`ray start --address=...` bring nodes up (:644), `ray stop`, `ray
status`, `ray job submit`, and the `ray list ...` state commands
(util/state/state_cli.py). Invoked as `python -m ray_tpu_torch <cmd>`.

The head daemon runs in the foreground of the `start` process (use
`&`, systemd, or a supervisor to daemonize); its address + pid land in
a cluster-info file (default /tmp/rt_cluster_info.json) that the other
commands read.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

DEFAULT_INFO_PATH = "/tmp/rt_cluster_info.json"


def _run_until_signal(cleanup) -> None:
    """Foreground service loop: park until SIGTERM/SIGINT, then run
    `cleanup` (shared by start/up/dashboard)."""
    stop = {"flag": False}

    def on_term(*_):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    try:
        while not stop["flag"]:
            time.sleep(0.2)
    finally:
        cleanup()


def _pid_exited(pid: int) -> bool:
    """True once the process is gone OR a zombie (exited, unreaped by
    its parent) — os.kill(pid, 0) alone treats zombies as alive."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except (OSError, IndexError):
        return True


def _resolve_address(args) -> str:
    if getattr(args, "address", None):
        return args.address
    env = os.environ.get("RT_ADDRESS")
    if env:
        return env
    try:
        with open(args.cluster_info) as f:
            info = json.load(f)
        # Same-box convenience: the head recorded its TCP auth token.
        if info.get("auth_token") and not os.environ.get("RT_AUTH_TOKEN"):
            os.environ["RT_AUTH_TOKEN"] = info["auth_token"]
        return info["address"]
    except (OSError, KeyError, json.JSONDecodeError):
        sys.exit(
            "no cluster found: pass --address, set RT_ADDRESS, or "
            f"start one with `python -m ray_tpu_torch start --head` "
            f"(looked in {args.cluster_info})"
        )


def cmd_start(args) -> None:
    import tempfile

    from .._private.accelerators import detect_accelerators
    from .._private.config import Config
    from .._private.daemon import NodeDaemon

    # TCP listeners authenticate every frame with HMAC keyed by the
    # cluster token (rpc.py). Generate one for new TCP heads so the
    # wire never runs on the well-known local key; joining nodes take
    # it from --auth-token / RT_AUTH_TOKEN / the cluster-info file.
    if getattr(args, "auth_token", None):
        os.environ["RT_AUTH_TOKEN"] = args.auth_token
    elif args.listen_host and args.head and not os.environ.get(
        "RT_AUTH_TOKEN"
    ):
        import secrets

        os.environ["RT_AUTH_TOKEN"] = secrets.token_hex(16)
        print(
            "generated cluster auth token (joining nodes need it): "
            f"RT_AUTH_TOKEN={os.environ['RT_AUTH_TOKEN']}"
        )

    config = Config.from_env(None)
    resources = json.loads(args.resources) if args.resources else {}
    resources.setdefault(
        "CPU",
        float(args.num_cpus if args.num_cpus is not None else os.cpu_count()),
    )
    detected, labels = detect_accelerators(
        {"GPU": float(args.num_gpus)} if args.num_gpus is not None else None
    )
    if getattr(args, "labels", None):
        labels.update(json.loads(args.labels))
    for name, amount in detected.items():
        resources.setdefault(name, amount)
    resources.setdefault("memory", float(2**34))
    session_dir = args.session_dir or tempfile.mkdtemp(prefix="rt_node_")
    if args.head:
        daemon = NodeDaemon(
            session_dir,
            resources,
            config,
            is_head=True,
            labels=labels,
            listen_host=args.listen_host,
            listen_port=args.listen_port,
        )
        daemon.start()
        info = {
            "address": daemon.address,
            "pid": os.getpid(),
            "session_dir": session_dir,
        }
        if args.listen_host and os.environ.get("RT_AUTH_TOKEN"):
            info["auth_token"] = os.environ["RT_AUTH_TOKEN"]
        with open(args.cluster_info, "w") as f:
            json.dump(info, f)
        print(f"head started: address={daemon.address}")
        print(
            "connect with ray_tpu_torch.init(address="
            f"{daemon.address!r}) or RT_ADDRESS={daemon.address}"
        )
    else:
        head_address = _resolve_address(args)
        daemon = NodeDaemon(
            session_dir,
            resources,
            config,
            is_head=False,
            head_address=head_address,
            labels=labels,
            listen_host=args.listen_host,
            listen_port=args.listen_port,
        )
        daemon.start()
        print(f"node started, joined head at {head_address}")

    def cleanup():
        daemon.shutdown()
        if args.head:
            try:
                os.remove(args.cluster_info)
            except OSError:
                pass

    _run_until_signal(cleanup)


def cmd_stop(args) -> None:
    try:
        with open(args.cluster_info) as f:
            info = json.load(f)
    except OSError:
        print("no running cluster found")
        return
    try:
        os.kill(info["pid"], signal.SIGTERM)
        print(f"sent SIGTERM to head (pid {info['pid']})")
    except ProcessLookupError:
        print("head process already gone")
        try:
            os.remove(args.cluster_info)
        except OSError:
            pass


def _connect(args):
    import ray_tpu_torch as rt

    rt.init(address=_resolve_address(args))
    return rt


def cmd_status(args) -> None:
    rt = _connect(args)
    nodes = rt.nodes()
    print(f"nodes: {len(nodes)}")
    for node in nodes:
        mark = " (head)" if node.get("is_head") else ""
        print(
            f"  {node['node_id'][:12]}{mark} alive={node['alive']} "
            f"resources={node['resources']}"
        )
    print("cluster totals:", rt.cluster_resources())
    print("available:    ", rt.available_resources())


def cmd_summary(args) -> None:
    rt = _connect(args)
    print(json.dumps(rt.state_summary(), indent=2, default=str))


def cmd_list(args) -> None:
    _connect(args)
    from ..util import state

    kind = args.kind
    rows = {
        "nodes": state.list_nodes,
        "actors": state.list_actors,
        "tasks": state.list_tasks,
        "objects": state.list_objects,
        "placement-groups": state.list_placement_groups,
    }[kind]()
    print(json.dumps(rows, indent=2, default=str))


def cmd_submit(args) -> None:
    from ..job_submission import JobStatus, JobSubmissionClient

    client = JobSubmissionClient(_resolve_address(args))
    runtime_env = {}
    if args.working_dir:
        runtime_env["working_dir"] = args.working_dir
    import shlex

    entrypoint = list(args.entrypoint)
    if entrypoint and entrypoint[0] == "--":
        entrypoint = entrypoint[1:]
    if not entrypoint:
        sys.exit("submit: missing entrypoint command")
    job_id = client.submit_job(
        entrypoint=" ".join(shlex.quote(t) for t in entrypoint),
        runtime_env=runtime_env or None,
    )
    print(f"submitted {job_id}")
    if args.no_wait:
        return
    status = client.wait_until_finished(job_id, timeout=args.timeout)
    print(f"status: {status.value}")
    logs = client.get_job_logs(job_id)
    if logs:
        print("--- logs ---")
        print(logs, end="")
    if status != JobStatus.SUCCEEDED:
        sys.exit(1)


def cmd_jobs(args) -> None:
    from ..job_submission import JobSubmissionClient

    client = JobSubmissionClient(_resolve_address(args))
    print(json.dumps(client.list_jobs(), indent=2, default=str))


def cmd_logs(args) -> None:
    from ..job_submission import JobSubmissionClient

    client = JobSubmissionClient(_resolve_address(args))
    try:
        client.get_job_status(args.job_id)
    except Exception:
        # Unknown ids otherwise print nothing with exit 0 — a typo'd
        # id in a scripted log fetch must fail loudly.
        sys.exit(f"no such job: {args.job_id}")
    print(client.get_job_logs(args.job_id), end="")


def _memory_problems(verdict: dict) -> list:
    """Flatten `verdict.memory` into the problem rows the exit-code
    contract counts (shared by `memory` and the doctor's summary)."""
    return (
        list(verdict.get("near_capacity") or ())
        + list(verdict.get("leak_suspects") or ())
        + list(verdict.get("spill_thrash") or ())
    )


def cmd_memory(args) -> None:
    """`ray_tpu_torch memory` — the cluster memory ledger (reference: `ray
    memory`, util/state/memory_utils.py, grown per-job): top consumers
    by job/node/owner, per-job bytes·s and chip·s, leak suspects and
    near-capacity nodes. Exit-code contract matches lint/check/doctor:
    0 healthy, 1 when `verdict.memory` has findings."""
    _connect(args)
    from ..util.state import memory_summary

    if getattr(args, "transfers", False):
        _print_transfers(args)
        return
    mem = memory_summary()
    verdict = mem.get("verdict") or {}
    problems = _memory_problems(verdict)
    if args.as_json:
        print(json.dumps(mem, indent=2, default=str))
        sys.exit(1 if problems else 0)
    if mem.get("disabled"):
        print(
            "memory ledger disabled (memory_report_interval_s=0) — "
            "no attribution, series, or verdict.memory"
        )
        return
    totals = mem.get("totals") or {}
    used = totals.get("arena_used", 0)
    capacity = totals.get("arena_capacity", 0)
    jobs = mem.get("jobs") or {}
    nodes = mem.get("nodes") or []
    n_objects = sum(n.get("tracked_objects", 0) for n in nodes)
    print(
        f"{n_objects} objects, {used / 1e6:.1f} / "
        f"{capacity / 1e6:.0f} MB arena in use across "
        f"{len(nodes)} node(s), "
        f"{totals.get('spilled_bytes', 0) / 1e6:.1f} MB spilled"
    )
    print(
        f"attributed to (job, owner) pairs: "
        f"{totals.get('attributed_bytes', 0) / 1e6:.1f} MB "
        f"({100.0 * totals.get('attribution_fraction', 0.0):.1f}% "
        "of arena-used bytes)"
    )
    for job, row in sorted(
        jobs.items(),
        key=lambda kv: kv[1].get("object_bytes", 0),
        reverse=True,
    ):
        extras = []
        if "object_byte_seconds" in row:
            extras.append(
                f"{row['object_byte_seconds'] / 1e9:.2f} GB·s"
            )
        if "chip_seconds" in row:
            extras.append(f"{row['chip_seconds']:.1f} chip·s")
        suffix = f" ({', '.join(extras)})" if extras else ""
        print(
            f"  job {job}: {row.get('object_bytes', 0) / 1e6:.1f} MB "
            f"in {row.get('objects', 0)} objects, "
            f"{row.get('pinned_objects', 0)} pinned{suffix}"
        )
    for node in nodes:
        print(
            f"  node {node.get('node', '?')[:12]}: "
            f"{node.get('arena_used', 0) / 1e6:.1f} / "
            f"{node.get('arena_capacity', 0) / 1e6:.0f} MB, "
            f"{node.get('tracked_objects', 0)} objects, "
            f"{node.get('spilled_objects', 0)} spilled"
        )
    if args.verbose:
        print("top owners:")
        for row in mem.get("owners", []):
            print(
                f"  job {row['job']} {row['owner']}: "
                f"{row['bytes'] / 1e6:.1f} MB in "
                f"{row['objects']} objects"
            )
        print("top objects:")
        for row in mem.get("top_objects", []):
            print(
                f"  {row['object_id'][:16]} {row['size'] / 1e6:.1f} MB "
                f"job={row.get('job', '')} owner={row.get('owner', '')} "
                f"age={row.get('age_s', 0):.0f}s"
                f"{' pinned' if row.get('pinned') else ''}"
                f"{' spilled' if row.get('spilled') else ''}"
            )
    if not problems:
        print("memory verdict: HEALTHY")
        return
    print(f"memory verdict: {len(problems)} finding(s)")
    for problem in problems:
        print(f"  {problem.get('detail')}")
    sys.exit(1)


def _print_transfers(args) -> None:
    """`ray_tpu_torch memory --transfers` — the cluster transfer matrix:
    who moved which job's bytes where, how long the moves took, and
    how each job's gets resolved (provenance + locality)."""
    from ..util.state import transfer_summary

    transfers = transfer_summary()
    if args.as_json:
        print(json.dumps(transfers, indent=2, default=str))
        return
    if transfers.get("disabled"):
        print(
            "transfer matrix disabled (memory_report_interval_s=0 "
            "or transfer_report_interval_s=0)"
        )
        return
    flows = transfers.get("flows") or []
    if not flows:
        print("no transfers recorded")
    else:
        print(f"{len(flows)} flow(s), bytes descending:")
        for flow in flows:
            arrow = (
                f"{(flow.get('src') or '?')[:12]} -> "
                f"{(flow.get('dst') or '?')[:12]}"
            )
            print(
                f"  job {(flow.get('job') or '-')[:8]} {arrow}: "
                f"{flow.get('bytes', 0) / 1e6:.1f} MB in "
                f"{flow.get('pulls', 0)} pull(s), "
                f"{flow.get('restores', 0)} restore(s), "
                f"{flow.get('aborted', 0)} aborted, "
                f"{flow.get('ms', 0.0):.1f} ms "
                f"({flow.get('mb_per_s', 0.0):.1f} MB/s)"
            )
    locality = transfers.get("locality") or {}
    for job, row in locality.items():
        print(
            f"  job {job[:8]} locality: {row.get('hits', 0)} hit(s) / "
            f"{row.get('misses', 0)} miss(es) "
            f"({100.0 * row.get('hit_fraction', 0.0):.1f}% local)"
        )
    if args.verbose:
        print("get provenance by job:")
        for job, provs in (transfers.get("provenance") or {}).items():
            for prov, row in provs.items():
                print(
                    f"  job {job[:8]} {prov}: {row.get('gets', 0)} "
                    f"get(s), {row.get('bytes', 0) / 1e6:.1f} MB, "
                    f"{row.get('wait_ms', 0.0):.1f} ms waited"
                )
        print("top remote-pulling task classes:")
        for row in transfers.get("tasks") or []:
            print(
                f"  {row.get('task') or 'driver'} "
                f"(job {(row.get('job') or '-')[:8]}): "
                f"{row.get('remote_bytes', 0) / 1e6:.1f} MB remote / "
                f"{row.get('local_bytes', 0) / 1e6:.1f} MB local"
            )


def cmd_timeline(args) -> None:
    """Chrome-trace export (reference: `ray timeline`)."""
    _connect(args)
    from ..util.tracing import export_timeline

    trace = export_timeline(args.out)
    print(f"wrote {len(trace)} trace events to {args.out}")


def _load_cluster_config(path: str) -> dict:
    with open(path) as f:
        if path.endswith((".yaml", ".yml")):
            import yaml

            return yaml.safe_load(f)
        return json.load(f)


def cmd_up(args) -> None:
    """Launch an autoscaling cluster from a config file (reference:
    `ray up cluster.yaml` — autoscaler/_private/commands.py). The
    head + autoscaler run in THIS process's foreground (use & or a
    supervisor to daemonize); `down` signals it via the cluster-info
    file. Provider `fake` boots in-box daemons; the JAX package's
    `gcp_tpu` provider drives TPU slices and has no counterpart here."""
    from ..autoscaler.cluster import AutoscalingCluster

    config = _load_cluster_config(args.config)
    if not isinstance(config, dict):
        sys.exit(
            f"cluster config {args.config} must be a mapping "
            f"(got {type(config).__name__}: empty file?)"
        )
    provider = (config.get("provider") or {}).get("type", "fake")
    if provider == "gcp_tpu":
        sys.exit(
            "provider type 'gcp_tpu' is TPU-only: it drives TPU slices, "
            "which the port has no counterpart of (supported: fake)"
        )
    elif provider == "fake":
        cluster = AutoscalingCluster(
            head_resources=config.get("head_resources"),
            worker_node_types=config.get("worker_node_types"),
            idle_timeout_s=float(config.get("idle_timeout_s", 3.0)),
        )
    else:
        sys.exit(
            f"unknown provider type {provider!r} (supported: fake)"
        )
    cluster.start()
    info = {
        "address": cluster.address,
        "pid": os.getpid(),
        "cluster_name": config.get("cluster_name", "rt-cluster"),
    }
    with open(args.cluster_info, "w") as f:
        json.dump(info, f)
    print(
        f"cluster up: address={cluster.address} "
        f"(info in {args.cluster_info}; `python -m ray_tpu_torch down` "
        "to stop)",
        flush=True,
    )

    def cleanup():
        cluster.shutdown()
        try:
            os.unlink(args.cluster_info)
        except OSError:
            pass

    _run_until_signal(cleanup)


def cmd_down(args) -> None:
    """Stop a cluster started with `up` (reference: `ray down`)."""
    try:
        with open(args.cluster_info) as f:
            info = json.load(f)
    except (OSError, json.JSONDecodeError):
        sys.exit(f"no cluster-info file at {args.cluster_info}")
    pid = info.get("pid")
    if not pid:
        sys.exit("cluster-info file has no pid")
    try:
        os.kill(pid, signal.SIGTERM)
    except ProcessLookupError:
        print("cluster process already gone; removing stale info file")
        try:
            os.unlink(args.cluster_info)
        except OSError:
            pass
        return
    # Wait for the `up` process to finish its graceful shutdown
    # (zombie-aware: a supervisor may reap lazily).
    for _ in range(100):
        if _pid_exited(pid):
            print("cluster stopped")
            return
        time.sleep(0.1)
    print(f"cluster pid {pid} still shutting down (SIGTERM sent)")


def cmd_serve_run(args) -> None:
    """`serve run module:app` (reference: serve/scripts.py:455 — import
    the bound Application, deploy it, serve until SIGINT/SIGTERM)."""
    import importlib

    rt = _connect(args)
    from .. import serve

    module_name, _, attr = args.import_path.partition(":")
    if not attr:
        sys.exit(
            "serve run takes module:attr (e.g. my_app:app, where "
            "`app = MyDeployment.bind(...)`)"
        )
    sys.path.insert(0, os.getcwd())
    try:
        app = getattr(importlib.import_module(module_name), attr)
    except (ImportError, AttributeError) as e:
        sys.exit(f"cannot import {args.import_path!r}: {e}")
    # start() returns the ACTUAL bound port: when proxies already
    # exist (a prior run), --port is a no-op and the live port wins.
    port = serve.start(http_port=args.port)
    serve.run(
        app, name=args.name, route_prefix=args.route_prefix
    )
    note = "" if port == args.port else " (existing proxy port kept)"
    print(
        f"serving {args.import_path} as app {args.name!r} at "
        f"http://127.0.0.1:{port}{args.route_prefix}{note}",
        flush=True,
    )
    if args.blocking:
        _run_until_signal(lambda: (serve.shutdown(), rt.shutdown()))


def cmd_serve_status(args) -> None:
    _connect(args)
    from .. import serve

    print(json.dumps(serve.status(), indent=2, default=str))


def cmd_serve_shutdown(args) -> None:
    _connect(args)
    from .. import serve

    serve.shutdown()
    print("serve shut down")


def cmd_metrics_scrape(args) -> None:
    """`ray_tpu_torch metrics scrape` — one Prometheus text-format scrape of
    the live cluster (exactly the dashboard's /metrics payload, no
    dashboard required; pipe it to a file or promtool)."""
    _connect(args)
    from ..util.metrics import metrics_summary
    from ..util.prometheus import render_prometheus

    sys.stdout.write(render_prometheus(metrics_summary()))


def cmd_metrics_snapshot(args) -> None:
    """`ray_tpu_torch metrics snapshot` — dump the head's time-series ring
    (bounded history of periodic metric snapshots) as JSON; --name /
    --since / --limit filter server-side."""
    _connect(args)
    from ..util.metrics import metrics_timeseries

    snapshots = metrics_timeseries(
        name=args.name, since=args.since, limit=args.limit
    )
    print(json.dumps(snapshots, indent=2, default=str))


#: `ray_tpu_torch state ls` kinds -> state-API callables (pgs is the short
#: alias the reference CLI uses for placement groups).
_STATE_KINDS = ("nodes", "actors", "tasks", "objects", "pgs")


def cmd_state_ls(args) -> None:
    """`ray_tpu_torch state ls {nodes,actors,tasks,objects,pgs}` — the
    state API as a CLI, following the lint/check output contract:
    `--json` emits machine-readable rows, exit code 0 on success and
    2 on usage/connection errors (argparse and _resolve_address
    already exit 2). Tasks list newest-first under --limit."""
    _connect(args)
    from ..util import state

    fetchers = {
        "nodes": state.list_nodes,
        "actors": state.list_actors,
        "tasks": lambda: state.list_tasks(limit=args.limit),
        "objects": lambda: state.list_objects(limit=args.limit),
        "pgs": state.list_placement_groups,
    }
    rows = fetchers[args.kind]()
    if args.as_json:
        print(json.dumps(rows, indent=2, default=str))
        return
    if not rows:
        print(f"no {args.kind}")
        return
    # Human table: union of keys, one row per entry, wide cells
    # JSON-ified (the SPA's table() in dashboard.py, terminal-ized).
    keys = []
    for row in rows:
        for key in row:
            if key not in keys:
                keys.append(key)

    def cell(value) -> str:
        if isinstance(value, (dict, list)):
            value = json.dumps(value, default=str)
        text = str(value if value is not None else "")
        return text if len(text) <= 40 else text[:37] + "..."

    table = [[cell(row.get(k)) for k in keys] for row in rows]
    widths = [
        max(len(keys[i]), *(len(r[i]) for r in table))
        for i in range(len(keys))
    ]
    print("  ".join(k.ljust(w) for k, w in zip(keys, widths)))
    for r in table:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)))


def cmd_doctor(args) -> None:
    """`ray_tpu_torch doctor` — the stall doctor. One verdict over head
    task state, per-worker in-flight views, step telemetry, and
    flight-recorder digests: stragglers, hung tasks (stacks
    auto-captured), unresponsive workers, dead nodes. Exit-code
    contract matches lint/check: 0 healthy, 1 when problems are
    found (connection/usage failures exit via argparse/sys.exit)."""
    rt = _connect(args)
    verdict = rt.diagnose(
        hung_task_s=args.hung_task_s,
        straggler_threshold=args.straggler_threshold,
        capture_stacks=not args.no_stacks,
        leak_age_s=args.leak_age_s,
        locality_miss_threshold=args.locality_miss_threshold,
    )
    if args.trace:
        # One chrome trace out of all three streams: task slices
        # (queue time split out), spans, per-rank step phases.
        from .._private.worker import global_worker

        from ..util.tracing import merge_chrome_trace

        worker = global_worker()
        merge_chrome_trace(
            worker.call("list_task_events", limit=10000)["events"],
            worker.call("list_spans", limit=10000)["spans"],
            worker.call("step_summary", limit=10000, records=True)[
                "records"
            ],
            args.trace,
        )
    problems = verdict.get("problems", [])
    if args.as_json:
        print(json.dumps(verdict, indent=2, default=str))
        sys.exit(1 if problems else 0)
    nodes = verdict.get("nodes", {})
    steps = verdict.get("steps", {})
    print(
        f"nodes: {nodes.get('alive', '?')}/{nodes.get('total', '?')} "
        "alive"
    )
    print(
        f"steps observed: {steps.get('steps_observed', 0)} "
        f"(workers reporting: {len(steps.get('workers', {}))}, "
        f"max gang skew: {steps.get('max_skew_ms', 0.0):g} ms)"
    )
    dag = verdict.get("dag") or {}
    if dag.get("edges"):
        print(f"dag edges instrumented: {len(dag['edges'])}")
        suspect = dag.get("suspect")
        if suspect:
            print(f"  {suspect['detail']}")
    rl = verdict.get("rl") or {}
    if rl.get("series"):
        series = rl["series"]
        depth = series.get("rl_queue_depth", 0)
        cap = series.get("rl_queue_capacity", 0)
        print(
            "rl dataflow: queue "
            f"{depth:g}/{cap:g}, env steps "
            f"{series.get('rl_env_steps_total', 0):g}, learner "
            f"updates {series.get('rl_learner_updates_total', 0):g}, "
            f"weight lag {series.get('rl_weight_lag', 0):g}"
        )
        print(
            f"  bottleneck [{rl.get('bottleneck', '?')}]: "
            f"{rl.get('detail', '')}"
        )
    comp = verdict.get("compile") or {}
    if comp.get("programs"):
        compiles = sum(
            row.get("compiles", 0)
            for row in comp["programs"].values()
        )
        print(
            f"xla: {compiles} compile(s) across "
            f"{len(comp['programs'])} program(s), "
            f"{len(comp.get('storms') or ())} recompile storm(s), "
            f"{len(comp.get('hbm_pressure') or ())} rank(s) under "
            "HBM pressure"
        )
    locks = verdict.get("locks") or {}
    if locks.get("enabled"):
        print(
            f"locks: witness on in {locks.get('procs', 0)} "
            f"process(es), {len(locks.get('cycles') or ())} order "
            f"inversion(s), {len(locks.get('held_blocking') or ())} "
            "held-while-blocking site(s)"
        )
    memory = verdict.get("memory") or {}
    if memory:
        print(
            "memory: "
            f"{100.0 * memory.get('attribution_fraction', 0.0):.0f}% "
            "of arena bytes attributed, "
            f"{len(memory.get('leak_suspects') or ())} leak "
            "suspect(s), "
            f"{len(memory.get('near_capacity') or ())} node(s) near "
            "capacity"
        )
    data = verdict.get("data") or {}
    hottest = data.get("hottest_flow")
    if hottest or data.get("misplaced_tasks"):
        jobs = data.get("jobs") or {}
        restore_jobs = sum(
            1
            for row in jobs.values()
            if row.get("classification") == "restore_dominated"
        )
        line = (
            "data plane: "
            f"{len(data.get('misplaced_tasks') or ())} misplaced "
            f"task class(es), {restore_jobs} restore-dominated "
            "job(s)"
        )
        if hottest:
            line += (
                "; hottest flow "
                f"{(hottest.get('src') or '?')[:12]} -> "
                f"{(hottest.get('dst') or '?')[:12]} "
                f"({hottest.get('bytes', 0) / 1e6:.1f} MB, job "
                f"{(hottest.get('job') or '-')[:8]})"
            )
        print(line)
    if verdict.get("healthy"):
        print("verdict: HEALTHY")
        return
    print(f"verdict: {len(problems)} problem(s)")
    for problem in problems:
        print(f"  [{problem.get('kind')}] {problem.get('detail')}")
        stack = problem.get("stack")
        if stack:
            print("    captured stack:")
            for line in str(stack).splitlines():
                print(f"      {line}")
    sys.exit(1)


def cmd_profile(args) -> None:
    """`ray_tpu_torch profile` — on-demand profiling against a live
    cluster. Default (and `--job JOB`): COORDINATED GANG PROFILING —
    one synchronized window across every step-reporting rank of the
    job, merged with the gang's step-telemetry phases into one chrome
    trace (`--out`, load in chrome://tracing / Perfetto). With
    `--pid`: the single-worker profiler (cpu/stack/memory), same as
    the dashboard's /api/profile. Exit 1 when no rank could be
    captured."""
    _connect(args)
    from ..util import state

    if args.pid is not None:
        result = state.profile_worker(
            args.pid,
            kind=args.kind,
            duration_s=args.duration_s,
            hz=args.hz,
            node_id=args.node,
        )
        print(json.dumps(result, indent=2, default=str))
        return
    reply = state.profile_gang(
        args.job,
        duration_s=args.duration_s,
        hz=args.hz,
        path=args.out,
    )
    ranks = reply.get("ranks", [])
    errors = reply.get("errors", {})
    print(
        f"job {reply.get('job')}: profiled {len(ranks)} rank(s) for "
        f"{reply.get('window', {}).get('duration_s', 0):g}s, "
        f"{len(reply.get('trace', []))} trace slice(s)"
    )
    for row in ranks:
        line = (
            f"  rank {row['rank']}: {row.get('samples', 0)} samples, "
            f"{row.get('threads', 0)} thread(s)"
        )
        if row.get("device_trace"):
            line += f", device trace: {row['device_trace']}"
        print(line)
    for rank, err in sorted(errors.items()):
        print(f"  rank {rank}: capture FAILED: {err}")
    if args.out:
        print(f"merged chrome trace: {args.out}")
    if not ranks:
        sys.exit(1)


def cmd_lint(args) -> None:
    """`ray_tpu_torch lint [paths]` — the framework-aware distributed-
    correctness linter (devtools/lint.py, rules RT001-RT010). Runs
    offline on source trees; no cluster connection."""
    from ..devtools.lint import main as lint_main

    argv = list(args.paths or [])
    if args.as_json:
        argv.append("--json")
    if args.rules:
        argv.extend(["--rules", args.rules])
    if args.list_rules:
        argv.append("--list-rules")
    sys.exit(lint_main(argv))


def cmd_check(args) -> None:
    """`ray_tpu_torch check [paths]` — the whole-program contract checker
    (devtools/check.py, rules RT101-RT106). Offline: builds a symbol
    table over the tree and cross-checks every .remote()/.options()/
    RPC call site; no cluster connection."""
    from ..devtools.check import main as check_main

    argv = list(args.paths or [])
    if args.as_json:
        argv.append("--json")
    if args.rules:
        argv.extend(["--rules", args.rules])
    if args.list_rules:
        argv.append("--list-rules")
    sys.exit(check_main(argv))


def cmd_race(args) -> None:
    """`ray_tpu_torch devtools race [paths]` — whole-program concurrency
    analysis (devtools/concurrency.py, rules RT201-RT206). Offline:
    builds the thread/lock model over the tree and judges shared-state
    access; no cluster connection."""
    from ..devtools.concurrency import main as race_main

    argv = list(args.paths or [])
    if args.as_json:
        argv.append("--json")
    if args.rules:
        argv.extend(["--rules", args.rules])
    if args.list_rules:
        argv.append("--list-rules")
    sys.exit(race_main(argv))


def cmd_accel(args) -> None:
    """`ray_tpu_torch devtools accel [paths]` — accelerator hot-path
    analysis (devtools/accel.py, rules RT301-RT306). Offline: builds
    the jit/donate wrap inventory over the tree and judges hot-loop
    usage; `--inventory` emits the machine-readable program inventory
    the compile watch's static_hint() bridge consumes."""
    from ..devtools.accel import main as accel_main

    argv = list(args.paths or [])
    if args.as_json:
        argv.append("--json")
    if args.rules:
        argv.extend(["--rules", args.rules])
    if args.list_rules:
        argv.append("--list-rules")
    if args.inventory:
        argv.append("--inventory")
    sys.exit(accel_main(argv))


def cmd_devtools_all(args) -> None:
    """`ray_tpu_torch devtools all [paths]` — lint + check + race + accel
    as one CI gate with merged findings (devtools.all_main; JSON mode
    emits one combined list)."""
    from ..devtools import all_main

    argv = list(args.paths or [])
    if args.as_json:
        argv.append("--json")
    sys.exit(all_main(argv))


def cmd_dashboard(args) -> None:
    """Serve the dashboard against a running cluster until SIGINT /
    SIGTERM (reference: the head starts ray's dashboard; here it
    attaches to any cluster as a driver)."""
    rt = _connect(args)
    from ..dashboard import start_dashboard

    dash = start_dashboard(port=args.port)
    print(f"dashboard: http://127.0.0.1:{dash.port}", flush=True)

    def cleanup():
        dash.stop()
        rt.shutdown()

    _run_until_signal(cleanup)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="ray_tpu_torch",
        description="distributed runtime CLI of the PyTorch/CUDA port"
    )
    parser.add_argument(
        "--cluster-info",
        default=DEFAULT_INFO_PATH,
        help="path of the cluster-info file (head address + pid)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_start = sub.add_parser("start", help="start a head or worker node")
    p_start.add_argument("--head", action="store_true")
    p_start.add_argument("--address", help="head address to join")
    p_start.add_argument("--num-cpus", type=float, default=None)
    p_start.add_argument("--num-gpus", type=float, default=None)
    p_start.add_argument(
        "--resources", help='extra resources as JSON, e.g. \'{"A": 2}\''
    )
    p_start.add_argument(
        "--labels",
        help="node labels as JSON (cloud startup scripts tag nodes "
        'with their provider identity, e.g. \'{"rt.io/provider-node": '
        '"my-tpu-0"}\')',
    )
    p_start.add_argument("--session-dir")
    p_start.add_argument(
        "--listen-host",
        help="bind a TCP listener on this host and advertise it "
        "cluster-wide (required for real multi-host clusters)",
    )
    p_start.add_argument("--listen-port", type=int, default=0)
    p_start.add_argument(
        "--auth-token",
        help="cluster HMAC token (defaults to RT_AUTH_TOKEN; "
        "generated for new TCP heads)",
    )
    p_start.set_defaults(fn=cmd_start)

    p_stop = sub.add_parser("stop", help="stop the head node")
    p_stop.set_defaults(fn=cmd_stop)

    for name, fn in (
        ("status", cmd_status),
        ("summary", cmd_summary),
    ):
        p = sub.add_parser(name)
        p.add_argument("--address")
        p.set_defaults(fn=fn)

    p_list = sub.add_parser("list", help="state API listings")
    p_list.add_argument(
        "kind",
        choices=[
            "nodes",
            "actors",
            "tasks",
            "objects",
            "placement-groups",
        ],
    )
    p_list.add_argument("--address")
    p_list.set_defaults(fn=cmd_list)

    p_submit = sub.add_parser("submit", help="submit a job")
    p_submit.add_argument("--address")
    p_submit.add_argument("--working-dir")
    p_submit.add_argument("--no-wait", action="store_true")
    p_submit.add_argument("--timeout", type=float, default=600.0)
    p_submit.add_argument("entrypoint", nargs=argparse.REMAINDER)
    p_submit.set_defaults(fn=cmd_submit)

    p_jobs = sub.add_parser("jobs", help="list submitted jobs")
    p_jobs.add_argument("--address")
    p_jobs.set_defaults(fn=cmd_jobs)

    p_logs = sub.add_parser("logs", help="fetch a job's logs")
    p_logs.add_argument("job_id")
    p_logs.add_argument("--address")
    p_logs.set_defaults(fn=cmd_logs)

    p_mem = sub.add_parser(
        "memory",
        help="cluster memory ledger: usage by job/node/owner, leak "
        "suspects (exit 1 on memory findings)",
    )
    p_mem.add_argument("--address")
    p_mem.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the ledger summary as JSON (CI mode; exit 1 on "
        "memory findings)",
    )
    p_mem.add_argument(
        "-v", "--verbose", action="store_true",
        help="also print the top-owner and top-object tables",
    )
    p_mem.add_argument(
        "--transfers", action="store_true",
        help="print the cluster transfer matrix instead: per-(job, "
        "src, dst) flows, get provenance, and locality hit rates",
    )
    p_mem.set_defaults(fn=cmd_memory)

    p_tl = sub.add_parser(
        "timeline", help="export a chrome trace of task events"
    )
    p_tl.add_argument("--address")
    p_tl.add_argument("--out", default="timeline.json")
    p_tl.set_defaults(fn=cmd_timeline)

    p_up = sub.add_parser(
        "up", help="launch an autoscaling cluster from a config file"
    )
    p_up.add_argument("config", help="cluster config (.yaml or .json)")
    p_up.set_defaults(fn=cmd_up)

    p_down = sub.add_parser(
        "down", help="stop a cluster started with `up`"
    )
    p_down.set_defaults(fn=cmd_down)

    p_serve = sub.add_parser("serve", help="model-serving commands")
    serve_sub = p_serve.add_subparsers(dest="serve_cmd", required=True)
    p_srun = serve_sub.add_parser(
        "run", help="deploy module:app and serve it"
    )
    p_srun.add_argument("import_path", help="module:attr of a bound app")
    p_srun.add_argument("--address")
    p_srun.add_argument("--name", default="default")
    p_srun.add_argument("--route-prefix", default="/")
    p_srun.add_argument("--port", type=int, default=8000)
    p_srun.add_argument(
        "--non-blocking", dest="blocking", action="store_false",
        help="deploy and exit instead of serving in the foreground",
    )
    p_srun.set_defaults(fn=cmd_serve_run)
    p_sstat = serve_sub.add_parser("status", help="serve app status")
    p_sstat.add_argument("--address")
    p_sstat.set_defaults(fn=cmd_serve_status)
    p_sdown = serve_sub.add_parser(
        "shutdown", help="tear down all serve apps and proxies"
    )
    p_sdown.add_argument("--address")
    p_sdown.set_defaults(fn=cmd_serve_shutdown)

    p_metrics = sub.add_parser(
        "metrics",
        help="metrics export: Prometheus scrape / history snapshot",
    )
    metrics_sub = p_metrics.add_subparsers(
        dest="metrics_cmd", required=True
    )
    p_scrape = metrics_sub.add_parser(
        "scrape",
        help="print one Prometheus text-format scrape of the cluster",
    )
    p_scrape.add_argument("--address")
    p_scrape.set_defaults(fn=cmd_metrics_scrape)
    p_snap = metrics_sub.add_parser(
        "snapshot",
        help="dump the head's bounded metrics time-series ring (JSON)",
    )
    p_snap.add_argument("--address")
    p_snap.add_argument(
        "--name", help="filter to one metric series"
    )
    p_snap.add_argument(
        "--since", type=float, default=0.0,
        help="only snapshots newer than this unix timestamp",
    )
    p_snap.add_argument(
        "--limit", type=int, default=0,
        help="keep only the newest N snapshots",
    )
    p_snap.set_defaults(fn=cmd_metrics_snapshot)

    p_state = sub.add_parser(
        "state", help="state API listings (ls subcommand)"
    )
    state_sub = p_state.add_subparsers(dest="state_cmd", required=True)
    p_sls = state_sub.add_parser(
        "ls", help="list cluster state entities"
    )
    p_sls.add_argument("kind", choices=list(_STATE_KINDS))
    p_sls.add_argument("--address")
    p_sls.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit rows as JSON (CI/scripting mode)",
    )
    p_sls.add_argument(
        "--limit", type=int, default=1000,
        help="max rows for tasks/objects (tasks are newest-first)",
    )
    p_sls.set_defaults(fn=cmd_state_ls)

    p_prof = sub.add_parser(
        "profile",
        help="profile a gang (synchronized window, merged chrome "
        "trace) or a single worker",
    )
    p_prof.add_argument("--address")
    p_prof.add_argument(
        "--job",
        help="job id (hex) to gang-profile; default: the most "
        "recently step-reporting job",
    )
    p_prof.add_argument(
        "--pid", type=int, default=None,
        help="single-worker mode: profile this worker pid instead of "
        "a gang",
    )
    p_prof.add_argument(
        "--kind", default="cpu", choices=["cpu", "stack", "memory"],
        help="single-worker profile kind (with --pid)",
    )
    p_prof.add_argument(
        "--node", help="node id (hex) owning --pid (default: head)"
    )
    p_prof.add_argument(
        "--duration-s", type=float, default=2.0, dest="duration_s",
        help="profile window length (gang windows are capped by "
        "config profile_gang_max_duration_s)",
    )
    p_prof.add_argument("--hz", type=float, default=100.0)
    p_prof.add_argument(
        "--out", metavar="TRACE.json",
        help="write the merged gang chrome trace to this path",
    )
    p_prof.set_defaults(fn=cmd_profile)

    p_doc = sub.add_parser(
        "doctor",
        help="stall doctor: stragglers, hung tasks (with stacks), "
        "dead nodes, gang-step skew",
    )
    p_doc.add_argument("--address")
    p_doc.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the verdict as JSON (CI mode; exit 1 on problems)",
    )
    p_doc.add_argument(
        "--hung-task-s", type=float, default=None,
        help="a task with no progress past this deadline counts as "
        "hung (default: cluster config doctor_hung_task_s)",
    )
    p_doc.add_argument(
        "--straggler-threshold", type=float, default=None,
        help="a worker whose median step time exceeds cluster p50 x "
        "this factor is a straggler (default: cluster config)",
    )
    p_doc.add_argument(
        "--leak-age-s", type=float, default=None,
        help="an object held past this age by a dead owner is a "
        "leak suspect (default: cluster config doctor_leak_age_s)",
    )
    p_doc.add_argument(
        "--locality-miss-threshold", type=float, default=None,
        help="convict a task class as misplaced when at least this "
        "fraction of its get bytes pulled remotely (default: cluster "
        "config doctor_locality_miss_threshold)",
    )
    p_doc.add_argument(
        "--no-stacks", action="store_true",
        help="skip auto-capturing stack dumps of hung tasks' workers",
    )
    p_doc.add_argument(
        "--trace", metavar="OUT.json",
        help="also write a merged chrome trace (task slices + spans "
        "+ per-rank step phases) to this path",
    )
    p_doc.set_defaults(fn=cmd_doctor)

    p_lint = sub.add_parser(
        "lint",
        help="distributed-correctness linter (rules RT001-RT010)",
    )
    p_lint.add_argument(
        "paths", nargs="*", help="files/dirs to lint (default: ray_tpu_torch)"
    )
    p_lint.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit findings as JSON (CI mode)",
    )
    p_lint.add_argument(
        "--rules", help="comma-separated rule ids to run"
    )
    p_lint.add_argument(
        "--list-rules", action="store_true",
        help="print the rule table and exit",
    )
    p_lint.set_defaults(fn=cmd_lint)

    p_check = sub.add_parser(
        "check",
        help="whole-program contract checker (rules RT101-RT106)",
    )
    p_check.add_argument(
        "paths",
        nargs="*",
        help="files/dirs to check as one program (default: ray_tpu_torch)",
    )
    p_check.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit findings as JSON (CI mode)",
    )
    p_check.add_argument(
        "--rules", help="comma-separated rule ids to run"
    )
    p_check.add_argument(
        "--list-rules", action="store_true",
        help="print the rule table and exit",
    )
    p_check.set_defaults(fn=cmd_check)

    p_devtools = sub.add_parser(
        "devtools", help="combined static-analysis gates"
    )
    devtools_sub = p_devtools.add_subparsers(
        dest="devtools_cmd", required=True
    )
    p_all = devtools_sub.add_parser(
        "all",
        help=(
            "run lint + check + race + accel with merged findings "
            "(single CI gate)"
        ),
    )
    p_all.add_argument(
        "paths", nargs="*", help="files/dirs (default: ray_tpu_torch)"
    )
    p_all.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit merged findings as JSON (CI mode)",
    )
    p_all.set_defaults(fn=cmd_devtools_all)

    p_race = devtools_sub.add_parser(
        "race",
        help=(
            "whole-program concurrency analysis "
            "(rules RT201-RT206)"
        ),
    )
    p_race.add_argument(
        "paths",
        nargs="*",
        help="files/dirs to analyze as one program (default: ray_tpu_torch)",
    )
    p_race.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit findings as JSON (CI mode)",
    )
    p_race.add_argument(
        "--rules", help="comma-separated rule ids to run"
    )
    p_race.add_argument(
        "--list-rules", action="store_true",
        help="print the rule table and exit",
    )
    p_race.set_defaults(fn=cmd_race)

    p_accel = devtools_sub.add_parser(
        "accel",
        help=(
            "accelerator hot-path analysis "
            "(rules RT301-RT306)"
        ),
    )
    p_accel.add_argument(
        "paths",
        nargs="*",
        help="files/dirs to analyze as one program (default: ray_tpu_torch)",
    )
    p_accel.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit findings as JSON (CI mode)",
    )
    p_accel.add_argument(
        "--rules", help="comma-separated rule ids to run"
    )
    p_accel.add_argument(
        "--list-rules", action="store_true",
        help="print the rule table and exit",
    )
    p_accel.add_argument(
        "--inventory", action="store_true",
        help=(
            "emit the machine-readable jit-program inventory "
            "(the doctor's static_hint bridge input) instead of findings"
        ),
    )
    p_accel.set_defaults(fn=cmd_accel)

    p_dash = sub.add_parser(
        "dashboard", help="serve the dashboard for a running cluster"
    )
    p_dash.add_argument("--address")
    p_dash.add_argument("--port", type=int, default=8265)
    p_dash.set_defaults(fn=cmd_dashboard)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
