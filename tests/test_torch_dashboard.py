"""The port's dashboard and Prometheus rendering (`ray_tpu_torch.dashboard`
and `ray_tpu_torch.util.prometheus`, copied from the JAX package's): the
same metric tables render to the same bytes on both packages (the
inputs of `tests/test_metrics_export.py`'s rendering tests), then the
dashboard's endpoint tests of `tests/test_observability.py` and
`tests/test_core_metrics.py` on the port's runtime."""

import json
import socket
import time
import urllib.request

import pytest

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

_HISTOGRAM = {
    "kind": "histogram",
    "description": "latency",
    "count": 9,
    "sum": 123.5,
    "buckets": {"le_1": 2, "le_5": 5, "le_25": 8, "inf": 9},
    "by_tags": {
        "app=a|deployment=d": {
            "count": 9, "sum": 123.5,
            "buckets": {"le_1": 2, "le_5": 5, "le_25": 8, "inf": 9},
        }
    },
}

#: The tables `tests/test_metrics_export.py` renders, by its tests.
TABLES = {
    "escaping_and_sanitization": {
        "legacy.dotted-name": {
            "kind": "counter",
            "description": 'has "quotes" and\nnewline \\ slash',
            "total": 3.0,
            "by_tags": {'path=/a"b\\c\nd': {"total": 3.0}},
        },
    },
    "counter_gauge_series_rules": {
        "rt_workers_alive": {
            "kind": "gauge", "description": "workers", "value": 5.0,
            "by_node": {"aa": 2.0, "bb": 3.0},
        },
        "plain_total": {"kind": "counter", "total": 2.0},
        "tagged_total": {
            "kind": "counter", "total": 7.0,
            "by_tags": {"app=x|deployment=y": {"total": 4.0},
                        "app=x|deployment=z": {"total": 3.0}},
        },
    },
    "histogram_le_monotonic_inf_sum_count": {
        "serve_request_latency_ms": _HISTOGRAM},
    "histogram_without_boundaries_gets_inf_bucket": {
        "h": {"kind": "histogram", "count": 4, "sum": 8.0}},
}


@pytest.mark.parametrize("table", sorted(TABLES))
def test_render_prometheus_is_the_jax_packages_bytes(table):
    from ray_tpu.util.prometheus import render_prometheus as jax_render
    from ray_tpu_torch.util.prometheus import render_prometheus

    text = render_prometheus(TABLES[table])
    assert text.encode() == jax_render(TABLES[table]).encode()
    assert text.endswith("\n") and "# TYPE" in text


@pytest.fixture
def port_session():
    import ray_tpu_torch as rt

    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


def test_dashboard_endpoints(port_session):
    rt = port_session
    from ray_tpu_torch.dashboard import start_dashboard

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dash = start_dashboard(port)
    try:

        @rt.remote
        class Marker:
            def ping(self):
                return 1

        marker = Marker.remote()
        rt.get(marker.ping.remote(), timeout=30)

        def fetch(path):
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30
            ) as resp:
                return resp.read()

        nodes = json.loads(fetch("/api/nodes"))
        assert len(nodes) == 1
        actors = json.loads(fetch("/api/actors"))
        assert any(a["class_name"] == "Marker" for a in actors)
        resources = json.loads(fetch("/api/resources"))
        assert "CPU" in resources["total"]
        html = fetch("/").decode()
        assert "ray_tpu_torch" in html and "/api/" in html

        from ray_tpu_torch.util.metrics import Counter, flush

        Counter("dash_metric").inc(2)
        flush()
        # The reference sleeps 0.3 s here; the head folds the flushed
        # record on its own thread, so wait for it instead.
        deadline = time.time() + 30
        prom = ""
        while time.time() < deadline and "dash_metric 2.0" not in prom:
            prom = fetch("/metrics").decode()
            time.sleep(0.05)
        assert "dash_metric 2.0" in prom
    finally:
        dash.stop()


def test_prometheus_endpoint_serves_core_series(port_session):
    rt = port_session
    from ray_tpu_torch.dashboard import start_dashboard

    @rt.remote
    def touch():
        return 1

    rt.get(touch.remote())
    dashboard = start_dashboard(port=0)
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{dashboard.port}/metrics", timeout=30
        ) as resp:
            text = resp.read().decode()
    finally:
        dashboard.stop()
    assert "# TYPE rt_tasks_finished_total counter" in text
    assert "# HELP rt_tasks_finished_total" in text
    assert 'rt_workers_alive{node="' in text
