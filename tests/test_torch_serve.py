"""The port's copy of the Serve runtime (`ray_tpu_torch.serve`),
mirroring every test of `tests/test_serve.py` and
`tests/test_router_policy.py` with the same assertions, on the port's
runtime on the CPU. Imports nothing of `ray_tpu` (nor JAX)."""

import json
import threading
import time
import urllib.request

import pytest

import ray_tpu_torch.serve.router as router
from ray_tpu_torch.serve.router import (
    DEFAULT_TOKEN_ESTIMATE,
    DeploymentHandle,
    DeploymentOverloaded,
    DeploymentResponseGenerator,
    estimate_request_tokens,
    pick_least_outstanding,
)


@pytest.fixture
def rt_session():
    """A fresh single-node session of the port's runtime per test, held
    to no worker crashing at startup (as tests/conftest.py's)."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=4, ignore_reinit_error=False)
    yield rt
    try:
        daemon = rt.api._session.daemon
        failures = daemon._spawn_crash_total
        session_dir = daemon.session_dir
    except Exception:
        failures, session_dir = 0, "?"
    rt.shutdown()
    assert failures == 0, (
        f"{failures} worker(s) crashed at startup during this test; "
        f"see {session_dir}/worker-*.out"
    )


# ---- tests/test_serve.py ------------------------------------------------

@pytest.fixture
def serve_session(rt_session):
    import ray_tpu_torch.serve as serve

    yield rt_session, serve
    serve.shutdown()


def test_deploy_and_handle_call(serve_session):
    rt, serve = serve_session

    @serve.deployment
    class Doubler:
        def __call__(self, x):
            return 2 * x

        def triple(self, x):
            return 3 * x

    handle = serve.run(Doubler.bind(), name="app1", route_prefix=None)
    assert handle.remote(21).result(timeout=30) == 42
    assert handle.triple.remote(7).result(timeout=30) == 21


def test_composition_with_downstream_handle(serve_session):
    rt, serve = serve_session

    @serve.deployment
    class Adder:
        def __init__(self, increment):
            self.increment = increment

        def __call__(self, x):
            return x + self.increment

    @serve.deployment
    class Ingress:
        def __init__(self, adder):
            self.adder = adder

        def __call__(self, x):
            partial = self.adder.remote(x).result(timeout=30)
            return partial * 10

    handle = serve.run(
        Ingress.bind(Adder.bind(5)), name="app2", route_prefix=None
    )
    assert handle.remote(1).result(timeout=30) == 60


def test_multiple_replicas_share_load(serve_session):
    rt, serve = serve_session

    @serve.deployment(num_replicas=3)
    class WhoAmI:
        def __call__(self, _):
            import os
            import time as _t

            _t.sleep(0.2)
            return os.getpid()

    handle = serve.run(WhoAmI.bind(), name="app3", route_prefix=None)
    responses = [handle.remote(i) for i in range(9)]
    pids = {r.result(timeout=60) for r in responses}
    assert len(pids) >= 2


def test_error_propagates(serve_session):
    rt, serve = serve_session

    @serve.deployment
    class Boom:
        def __call__(self, x):
            raise ValueError("kapow")

    handle = serve.run(Boom.bind(), name="app4", route_prefix=None)
    with pytest.raises(Exception, match="kapow"):
        handle.remote(1).result(timeout=30)


def test_redeploy_new_version(serve_session):
    rt, serve = serve_session

    @serve.deployment(version="1")
    class Model:
        def __call__(self, x):
            return "v1"

    h1 = serve.run(Model.bind(), name="app5", route_prefix=None)
    assert h1.remote(0).result(timeout=30) == "v1"

    @serve.deployment(name="Model", version="2")
    class Model2:
        def __call__(self, x):
            return "v2"

    h2 = serve.run(Model2.bind(), name="app5", route_prefix=None)
    deadline = time.time() + 15
    while time.time() < deadline:
        if h2.remote(0).result(timeout=30) == "v2":
            break
        time.sleep(0.2)
    assert h2.remote(0).result(timeout=30) == "v2"


def test_http_ingress(serve_session):
    rt, serve = serve_session
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    @serve.deployment
    class Api:
        def __call__(self, request):
            if request.method == "GET":
                return {
                    "path": request.path,
                    "q": request.query_params.get("q"),
                }
            data = request.json()
            return {"sum": data["a"] + data["b"]}

    serve.run(Api.bind(), name="default", route_prefix="/api")
    serve.start(http_port=port)

    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/api/hello?q=1", timeout=30
    ) as resp:
        body = json.loads(resp.read())
    assert body == {"path": "/hello", "q": "1"}

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api",
        data=json.dumps({"a": 2, "b": 3}).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert json.loads(resp.read()) == {"sum": 5}

    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/nope", timeout=30
        )


def test_batching_groups_requests(serve_session):
    rt, serve = serve_session

    @serve.deployment
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def predict(self, items):
            self.batch_sizes.append(len(items))
            return [x * 10 for x in items]

        def seen(self):
            return self.batch_sizes

    handle = serve.run(Batched.bind(), name="app6", route_prefix=None)
    responses = [handle.predict.remote(i) for i in range(8)]
    values = sorted(r.result(timeout=30) for r in responses)
    assert values == [i * 10 for i in range(8)]
    sizes = handle.seen.remote().result(timeout=30)
    assert max(sizes) > 1  # at least one real batch formed


def test_autoscaling_scales_up(serve_session):
    rt, serve = serve_session

    @serve.deployment(
        autoscaling_config={
            "min_replicas": 1,
            "max_replicas": 3,
            "target_ongoing_requests": 1.0,
            "upscale_delay_s": 0.3,
            "downscale_delay_s": 60.0,
        }
    )
    class Slow:
        def __call__(self, _):
            import time as _t

            _t.sleep(0.4)
            return 1

    handle = serve.run(Slow.bind(), name="app7", route_prefix=None)
    assert serve.status()["app7"]["deployments"]["Slow"]["replicas"] == 1

    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                handle.remote(0).result(timeout=30)
            except Exception:
                return

    threads = [threading.Thread(target=hammer) for _ in range(6)]
    for t in threads:
        t.start()
    try:
        deadline = time.time() + 20
        scaled = False
        while time.time() < deadline:
            replicas = serve.status()["app7"]["deployments"]["Slow"][
                "replicas"
            ]
            if replicas >= 2:
                scaled = True
                break
            time.sleep(0.25)
        assert scaled, "deployment never scaled past 1 replica"
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)


def test_redeploy_pushed_to_idle_handle(serve_session):
    """Long-poll push (reference: long_poll.py): an IDLE handle's
    replica cache updates when the controller reconciles a new
    version — no request needed, no TTL window. The old TTL router
    only refreshed on calls, so this distinguishes push from poll."""
    rt, serve = serve_session

    @serve.deployment(version="v1")
    class Svc:
        def __call__(self, x):
            return "v1"

    handle = serve.run(Svc.bind(), name="pushapp", route_prefix=None)
    assert handle.remote(0).result(timeout=30) == "v1"
    with handle._lock:
        old_ids = {r["id"] for r in handle._state["replicas"]}

    @serve.deployment(version="v2")
    class Svc2:
        def __call__(self, x):
            return "v2"

    serve.run(
        Svc2.options(name=Svc.name).bind(),
        name="pushapp",
        route_prefix=None,
    )
    # The handle is idle; only the push can change its cache.
    deadline = time.time() + 5
    while time.time() < deadline:
        with handle._lock:
            new_ids = {r["id"] for r in handle._state["replicas"]}
        if new_ids and not (new_ids & old_ids):
            break
        time.sleep(0.02)
    assert new_ids and not (new_ids & old_ids), (
        f"push never replaced replicas: {old_ids} -> {new_ids}"
    )
    assert handle.remote(0).result(timeout=30) == "v2"


def test_streaming_handle_and_http(serve_session):
    """Generator ingress streams: chunks arrive AS the replica yields
    (reference: serve streaming responses / LLM token output). Both
    the handle path (DeploymentResponseGenerator) and the HTTP path
    (chunked transfer-encoding) must deliver incrementally."""
    rt, serve = serve_session

    @serve.deployment
    class Tokens:
        def __call__(self, request):
            for i in range(5):
                time.sleep(0.15)
                yield f"tok{i} "

    serve.run(Tokens.bind(), name="stream", route_prefix="/gen")
    port = serve.start(http_port=0, per_node=False)

    # Handle path: first chunk must land before the generator could
    # have finished (5 x 0.15s), proving incremental delivery.
    handle = serve.get_app_handle("stream")
    t0 = time.time()
    chunks, stamps = [], []
    for chunk in handle.options(stream=True).remote(None):
        chunks.append(chunk)
        stamps.append(time.time() - t0)
    assert chunks == [f"tok{i} " for i in range(5)]
    assert stamps[0] < 0.60, f"first chunk too late: {stamps}"

    # HTTP path: chunked transfer, read incrementally.
    t0 = time.time()
    response = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/gen", timeout=30
    )
    assert response.headers.get("Transfer-Encoding") == "chunked"
    first = response.read(5)
    first_at = time.time() - t0
    rest = response.read()
    assert (first + rest).decode() == "tok0 tok1 tok2 tok3 tok4 "
    assert first_at < 0.60, f"first HTTP chunk too late: {first_at}"


def test_interleaved_streams_not_serialized(serve_session):
    """Two token streams from ONE replica must progress concurrently
    — neither may head-of-line block the other in _stream_response /
    DeploymentResponseGenerator (ISSUE 10 satellite: a batched
    continuous-batching replica serves many interleaved streams; if
    stream B's chunks only arrive after stream A finishes, batching
    is dead on arrival)."""
    rt, serve = serve_session

    @serve.deployment
    class Paced:
        def __call__(self, request):
            for i in range(6):
                time.sleep(0.2)
                yield f"t{i} "

    handle = serve.run(Paced.bind(), name="pair", route_prefix=None)
    gen_a = handle.options(stream=True).remote(None)
    gen_b = handle.options(stream=True).remote(None)
    events = []

    def consume(tag, gen):
        for _chunk in gen:
            events.append((tag, time.time()))

    threads = [
        threading.Thread(target=consume, args=("a", gen_a)),
        threading.Thread(target=consume, args=("b", gen_b)),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    a_times = [ts for tag, ts in events if tag == "a"]
    b_times = [ts for tag, ts in events if tag == "b"]
    assert len(a_times) == 6 and len(b_times) == 6
    # Interleaved, not serialized: each stream starts before the
    # other finishes.
    assert b_times[0] < a_times[-1], "stream b waited for stream a"
    assert a_times[0] < b_times[-1], "stream a waited for stream b"


def test_abandoned_stream_cancels_replica_side(serve_session):
    """Closing a DeploymentResponseGenerator mid-stream propagates a
    best-effort cancel to the replica (Replica.cancel_stream ->
    __serve_cancel_stream__), so producers that can stop do — the
    LLM engine frees the request's KV slot instead of decoding the
    whole budget for nobody."""
    rt, serve = serve_session

    @serve.deployment
    class Cancellable:
        def __init__(self):
            self.cancelled = []

        def __serve_cancel_stream__(self, request_id):
            self.cancelled.append(request_id)
            return True

        def seen_cancels(self):
            return list(self.cancelled)

        def __call__(self, request):
            from ray_tpu_torch.serve.observability import get_request_id

            rid = get_request_id()
            for i in range(200):
                if rid in self.cancelled:
                    return
                time.sleep(0.05)
                yield f"c{i} "

    handle = serve.run(Cancellable.bind(), name="cancl", route_prefix=None)
    gen = handle.options(stream=True).remote(None)
    assert next(gen)  # stream is live
    gen.close()  # abandoned mid-stream
    deadline = time.time() + 20
    seen = []
    while time.time() < deadline and not seen:
        seen = handle.seen_cancels.remote().result(timeout=30)
        time.sleep(0.1)
    assert seen, "cancel_stream never reached the replica"


def test_streaming_error_truncates_chunked_body(serve_session):
    """A replica generator that raises mid-stream must NOT produce a
    well-formed chunked body: the proxy aborts the socket without the
    terminal 0-chunk so the client sees a protocol-level truncation
    (http.client raises IncompleteRead/connection error) rather than a
    clean 200 with silently missing content (reference: ASGI proxies
    surface mid-stream failure by killing the connection — the
    response is unrecoverable once the 200 status line is out)."""
    import http.client

    rt, serve = serve_session

    @serve.deployment
    class Flaky:
        def __call__(self, request):
            yield "good "
            raise RuntimeError("replica exploded mid-stream")

    serve.run(Flaky.bind(), name="flaky", route_prefix="/flaky")
    port = serve.start(http_port=0, per_node=False)

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/flaky")
        resp = conn.getresponse()
        assert resp.status == 200  # headers were already committed
        with pytest.raises(
            (http.client.IncompleteRead, ConnectionError, OSError)
        ):
            resp.read()
    finally:
        conn.close()


def test_per_node_proxies_route_local_first():
    """serve.start places a proxy on EVERY node (reference:
    proxy_state.py), and each proxy's router prefers replicas on its
    own node (reference: pow_2 locality-aware candidates)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(head_resources={"CPU": 2.0})
    cluster.add_node(num_cpus=2.0)
    cluster.wait_for_nodes(2, timeout=60)
    rt.init(address=cluster.address)
    try:
        @serve.deployment(num_replicas=2)
        class WhereAmI:
            def __call__(self, request):
                return rt.get_runtime_context().get_node_id()

        serve.run(WhereAmI.bind(), name="local", route_prefix="/where")
        serve.start(http_port=0, per_node=True)
        ports = serve.proxy_ports()
        assert len(ports) == 2, f"expected 2 proxies: {ports}"

        # Replicas must have landed on both nodes for the locality
        # check to mean anything (2 CPUs/node, 1 CPU/replica, head
        # also hosts controller workers — verify, don't assume).
        controller = rt.get_actor("SERVE_CONTROLLER", namespace="serve")
        replicas = rt.get(
            controller.get_replicas.remote("local", "WhereAmI"),
            timeout=30,
        )
        replica_nodes = {r["node_id"] for r in replicas}
        if len(replica_nodes) == 2:
            # Each node's proxy should answer with ITS node's replica.
            for node_id, port in ports.items():
                body = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/where", timeout=30
                ).read().decode().strip('"')
                assert body == node_id, (
                    f"proxy on {node_id[:8]} answered from {body[:8]}"
                )
        else:
            # Both replicas packed one node: proxies must still serve.
            for node_id, port in ports.items():
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/where", timeout=30
                ).read()
    finally:
        serve.shutdown()
        rt.shutdown()
        cluster.shutdown()


def test_grpc_ingress_round_trip(serve_session):
    """gRPC ingress beside the HTTP proxy (reference: proxy.py:431
    gRPCProxy): a generic bytes-unary client calls
    /ray.serve.RayServeAPIService/Predict with the application in call
    metadata and gets the deployment's reply; Healthz and
    ListApplications serve the built-in API surface."""
    import json as _json

    grpc = pytest.importorskip("grpc")
    rt, serve = serve_session
    from ray_tpu_torch.serve.grpc_ingress import grpc_methods

    @serve.deployment
    class Echo:
        def __call__(self, payload: bytes):
            return b"grpc:" + payload

    serve.run(Echo.bind(), name="gapp", route_prefix="/gapp")
    serve.start(http_port=0, per_node=False, grpc_port=0)
    port = serve.local_grpc_port()
    assert port

    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    predict, healthz, list_apps = grpc_methods(channel)
    try:
        assert healthz(b"") == b"success"
        apps = _json.loads(list_apps(b""))
        assert "gapp" in apps
        reply = predict(
            b"hello", metadata=[("application", "gapp")]
        )
        assert reply == b"grpc:hello"
        with pytest.raises(grpc.RpcError):
            predict(b"x", metadata=[("application", "missing")])
    finally:
        channel.close()


def test_multiplexed_lru_and_router_warmth(serve_session):
    """@serve.multiplexed (reference: serve/multiplex.py + api.py:559):
    each replica holds at most max_num_models_per_replica models in an
    LRU; serve.get_multiplexed_model_id() exposes the request's model;
    and the router prefers replicas already holding the model (warm
    routing) once the controller pushes holder sets."""
    import time as _time

    rt, serve = serve_session

    @serve.deployment(num_replicas=2)
    class Multi:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            self.loads.append(model_id)
            return f"model-{model_id}"

        def __call__(self, request):
            model_id = serve.get_multiplexed_model_id()
            model = self.get_model(model_id)
            import os

            return {
                "model": model,
                "model_id": model_id,
                "pid": os.getpid(),
                "loads": list(self.loads),
            }

    serve.run(Multi.bind(), name="multi", route_prefix="/multi")
    handle = serve.get_app_handle("multi")

    # First call for m1 loads it somewhere.
    out = handle.options(multiplexed_model_id="m1").remote(
        None
    ).result(timeout=60)
    assert out["model"] == "model-m1"
    assert out["model_id"] == "m1"
    warm_pid = out["pid"]

    # Give the controller push a moment, then hammer m1: every call
    # should land on the warm replica (no second replica load).
    deadline = _time.time() + 10
    routed_warm = False
    while _time.time() < deadline:
        out = handle.options(multiplexed_model_id="m1").remote(
            None
        ).result(timeout=60)
        if out["pid"] == warm_pid:
            routed_warm = True
            if out["loads"].count("m1") == 1:
                break
        _time.sleep(0.1)
    assert routed_warm
    assert out["loads"].count("m1") == 1, (
        f"warm replica reloaded m1: {out['loads']}"
    )

    # LRU bound: push three models through ONE replica's cache and
    # assert the cap held (loads grow, cache doesn't).
    for model_id in ("m2", "m3", "m4"):
        res = handle.options(
            multiplexed_model_id=model_id
        ).remote(None).result(timeout=60)
        assert res["model"] == f"model-{model_id}"

    # Inspect replica-side cache sizes via the controller's view.
    controller = rt.get_actor("SERVE_CONTROLLER", namespace="serve")
    deadline = _time.time() + 10
    ok = False
    while _time.time() < deadline:
        replicas = rt.get(
            controller.get_replicas.remote("multi", "Multi"),
            timeout=30,
        )
        sizes = [len(r.get("model_ids", [])) for r in replicas]
        if any(sizes) and all(size <= 2 for size in sizes):
            ok = True
            break
        _time.sleep(0.2)
    assert ok, f"replica model sets never bounded: {sizes}"


def test_proxy_admission_control_and_keepalive():
    """Ingress hardening (VERDICT r4 weak #6): the proxy bounds
    in-flight requests (immediate 503 + Retry-After past the cap, no
    unbounded thread stacking) and connections (raw 503 before a
    handler thread spawns); keep-alive connections serve multiple
    requests. Unit-level: the Proxy is driven directly with a stubbed
    dispatch, no controller needed."""
    import http.client
    import socket as socklib
    import threading
    import time as timelib

    from ray_tpu_torch.serve.proxy import Proxy

    proxy = Proxy(0, max_concurrent_requests=2, max_connections=4)
    try:
        port = proxy.port

        # keep-alive: two sequential requests over ONE connection.
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        for _ in range(2):
            conn.request("GET", "/-/healthz")
            resp = conn.getresponse()
            assert resp.status == 200
            assert b"shed_requests" in resp.read()
        conn.close()

        # request saturation: 2 slots, 6 concurrent slow requests.
        proxy._dispatch = (
            lambda handler: (timelib.sleep(0.6), (200, b"ok", "text/plain"))[1]
        )
        statuses = []
        lock = threading.Lock()

        def hit():
            c = http.client.HTTPConnection(
                "127.0.0.1", port, timeout=10
            )
            try:
                c.request("GET", "/x")
                r = c.getresponse()
                body = r.read()
                with lock:
                    statuses.append((r.status, body))
            finally:
                c.close()

        threads = [threading.Thread(target=hit) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        codes = sorted(s for s, _ in statuses)
        assert codes.count(200) >= 2, codes
        assert codes.count(503) >= 1, codes
        assert proxy.shed_requests >= 1

        # connection cap: hold 4 idle keep-alive connections open,
        # the 5th gets an immediate raw 503 + close.
        proxy._dispatch = lambda handler: (200, b"ok", "text/plain")
        held = []
        for _ in range(4):
            c = http.client.HTTPConnection(
                "127.0.0.1", port, timeout=10
            )
            c.request("GET", "/x")
            assert c.getresponse().read() == b"ok"
            held.append(c)  # keep-alive: still counted
        extra = socklib.create_connection(("127.0.0.1", port), timeout=10)
        try:
            extra.sendall(b"GET /x HTTP/1.1\r\nHost: h\r\n\r\n")
            head = extra.recv(64)
            assert b"503" in head, head
        finally:
            extra.close()
        assert proxy.shed_connections >= 1
        for c in held:
            c.close()
    finally:
        proxy.stop()


# ---- tests/test_router_policy.py ----------------------------------------

@pytest.fixture(autouse=True)
def _fresh_config_cache():
    """The router caches Config.from_env() process-wide (hot path);
    tests that monkeypatch RT_serve_* need a fresh read, and must not
    leak their config into later tests in the same process."""
    router._reset_config_cache()
    yield
    router._reset_config_cache()


# ---------------------------------------------------------------------
# token estimation
# ---------------------------------------------------------------------

def test_estimate_from_llm_payload():
    payload = {"prompt": list(range(40)), "max_new_tokens": 16}
    assert estimate_request_tokens((payload,), {}) == 56


def test_estimate_from_request_body():
    class FakeRequest:
        def json(self):
            return {"prompt": [1, 2, 3], "max_new_tokens": 7}

    assert estimate_request_tokens((FakeRequest(),), {}) == 10


def test_estimate_prompt_without_budget_adds_default():
    payload = {"prompt": [1, 2, 3]}
    assert (
        estimate_request_tokens((payload,), {})
        == 3 + DEFAULT_TOKEN_ESTIMATE
    )


def test_estimate_falls_back_for_opaque_payloads():
    assert estimate_request_tokens((), {}) == DEFAULT_TOKEN_ESTIMATE
    assert (
        estimate_request_tokens(("not a dict",), {})
        == DEFAULT_TOKEN_ESTIMATE
    )
    assert (
        estimate_request_tokens(({"x": 1},), {})
        == DEFAULT_TOKEN_ESTIMATE
    )


# ---------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------

def test_pick_least_outstanding_prefers_min_load():
    replicas = [{"id": "a"}, {"id": "b"}, {"id": "c"}]
    outstanding = {"a": 500, "b": 20, "c": 100}
    assert pick_least_outstanding(replicas, outstanding)["id"] == "b"
    # Missing entries count as zero load.
    outstanding = {"a": 1, "c": 1}
    assert pick_least_outstanding(replicas, outstanding)["id"] == "b"


def test_pick_least_outstanding_breaks_ties_across_replicas():
    replicas = [{"id": "a"}, {"id": "b"}]
    seen = {
        pick_least_outstanding(replicas, {})["id"] for _ in range(200)
    }
    assert seen == {"a", "b"}  # idle replicas share cold traffic


def test_least_tokens_beats_round_robin_under_skewed_mix():
    """ISSUE 11 satellite: a skewed mix (long completions interleaved
    with short chats) round-robined across 2 replicas piles every
    long request onto one of them; least-outstanding-tokens balances
    assigned WORK, so the busiest replica ends up with far less of
    it (lower makespan = lower queueing delay at equal throughput)."""
    heavy, light = 200, 10
    costs = [heavy, light] * 20

    round_robin = [0, 0]
    for i, cost in enumerate(costs):
        round_robin[i % 2] += cost

    replicas = [{"id": "r0"}, {"id": "r1"}]
    least = {"r0": 0, "r1": 0}
    for cost in costs:
        pick = pick_least_outstanding(replicas, least)
        least[pick["id"]] += cost

    assert max(round_robin) == 20 * heavy  # all longs on one replica
    assert max(least.values()) < 0.6 * max(round_robin)


# ---------------------------------------------------------------------
# phantom-load regression: every exit path releases the estimate
# ---------------------------------------------------------------------

def _handle():
    return DeploymentHandle("app", "dep")


def test_stream_chunks_decay_outstanding_tokens():
    handle = _handle()
    handle._ongoing_sent("r1", 10)
    gen = DeploymentResponseGenerator(
        iter(()), handle, "r1", tokens=10
    )
    # Simulate 4 delivered chunks' worth of decay.
    for _ in range(4):
        gen._tokens_left -= 1
        handle._tokens_done("r1", 1)
    assert handle._outstanding_tokens["r1"] == 6
    gen.close()  # releases the remainder exactly once
    assert handle._outstanding_tokens.get("r1", 0) == 0
    gen.close()  # idempotent
    assert handle._outstanding_tokens.get("r1", 0) == 0


def test_abandoned_stream_releases_full_estimate():
    """The PR 10 cancel path frees the engine's KV slot mid-decode;
    the router-side outstanding-token estimate must follow (ISSUE 11
    phantom-load fix), or the replica looks loaded forever."""
    handle = _handle()
    handle._ongoing_sent("r1", 464)
    gen = DeploymentResponseGenerator(
        iter(()), handle, "r1", tokens=464
    )
    gen.close()  # client disconnected before any chunk
    assert handle._outstanding_tokens.get("r1", 0) == 0
    assert handle._ongoing.get("r1") == 0


def test_membership_prune_clears_dead_replica_load():
    """Engine/replica death: the controller pushes a membership
    without the dead id; its accounting entries must vanish so the
    replacement replica doesn't inherit phantom load."""
    handle = _handle()
    handle._ongoing_sent("dead", 500)
    handle._ongoing_sent("live", 30)
    handle._state["replicas"] = [{"id": "live"}]
    with handle._lock:
        handle._prune_gone_locked()
    assert "dead" not in handle._outstanding_tokens
    assert "dead" not in handle._ongoing
    assert handle._outstanding_tokens["live"] == 30


def test_response_result_releases_tokens_once():
    handle = _handle()
    handle._ongoing_sent("r1", 64)
    from ray_tpu_torch.serve.router import DeploymentResponse

    response = DeploymentResponse(lambda timeout: "ok", handle)
    response._replica_id = "r1"
    response._tokens = 64
    assert response.result() == "ok"
    assert handle._outstanding_tokens.get("r1", 0) == 0
    assert response.result() == "ok"  # second resolve: no double free
    assert handle._outstanding_tokens.get("r1", 0) == 0


def test_dropped_response_releases_estimate_on_gc():
    """Review-caught leak: a non-streaming response fired and DROPPED
    (never .result()-ed) must not pin its token estimate on the
    replica forever — a handful of dropped requests would otherwise
    push the least-loaded replica over the SLO threshold and 503
    everything after."""
    from ray_tpu_torch.serve.router import DeploymentResponse

    handle = _handle()
    handle._ongoing_sent("r1", 500)
    response = DeploymentResponse(lambda timeout: "ok", handle)
    response._replica_id = "r1"
    response._tokens = 500
    del response  # GC without result()
    assert handle._outstanding_tokens.get("r1", 0) == 0
    assert handle._ongoing.get("r1") == 0


# ---------------------------------------------------------------------
# SLO admission
# ---------------------------------------------------------------------

def test_slo_admission_sheds_over_threshold(monkeypatch):
    monkeypatch.setenv("RT_serve_slo_queue_threshold_tokens", "100")
    handle = _handle()
    handle._ongoing_sent("r1", 150)
    with pytest.raises(DeploymentOverloaded):
        handle._slo_admit({"id": "r1"}, 10)


def test_slo_admission_admits_under_threshold(monkeypatch):
    monkeypatch.setenv("RT_serve_slo_queue_threshold_tokens", "100")
    handle = _handle()
    handle._ongoing_sent("r1", 99)
    handle._slo_admit({"id": "r1"}, 10)  # no raise


def test_slo_admission_kill_switch(monkeypatch):
    monkeypatch.setenv("RT_serve_slo_queue_threshold_tokens", "100")
    monkeypatch.setenv("RT_serve_slo_admission_enabled", "0")
    handle = _handle()
    handle._ongoing_sent("r1", 10_000)
    handle._slo_admit({"id": "r1"}, 10)  # disabled: no raise
