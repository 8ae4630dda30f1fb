"""The port's autoscaler (`ray_tpu_torch.autoscaler`, copied from
`ray_tpu/autoscaler/` without its TPU provider and the TPU slice
cluster), held to the JAX package's: the v2 `Reconciler` and
`InstanceManager`, driven by one scripted demand and cloud sequence,
record the same transitions on both packages, and the v1 autoscaler
launches the same nodes for the same scripted loads. Then the
provider-agnostic cases of `tests/test_autoscaler.py` and
`tests/test_autoscaler_v2.py` run on the port: their bodies with the
module names rewritten (as `tests/_torch_fork.py` reads a copy) and the
slice nodes' accelerator named "GPU" (a slice node type with
`slice_hosts > 1` is a multi-host GPU node as well). The TPU REST client
and the TPU slice cluster have no counterpart; the reference's
`test_respects_max_workers`, which waits on the clock (3 s tasks, 31 s),
is held here to tasks released by a file once the cap is reached."""

import os
import re
import time

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

TESTS = os.path.dirname(os.path.abspath(__file__))
#: The reference's cases that have no provider-agnostic counterpart, or
#: that this module holds to an event instead of the clock.
NOT_MIRRORED = {
    "test_gcp_tpu_client_against_fake_service",
    "test_slice_pg_scales_up_one_tpu_node_then_down",
    "test_respects_max_workers",
}


def _mirror(name):
    """The reference test module `name`, its module names read
    `ray_tpu_torch` and its TPU resource "GPU", run as a namespace."""
    with open(os.path.join(TESTS, name), encoding="utf-8") as f:
        source = f.read()
    source = re.sub(r"\bray_tpu\b(?!_torch)", "ray_tpu_torch", source)
    source = source.replace('"TPU"', '"GPU"')
    namespace = {"__name__": f"port_mirror_{name[:-3]}"}
    exec(compile(source, name, "exec"), namespace)
    return namespace


_V1 = _mirror("test_autoscaler.py")
_V2 = _mirror("test_autoscaler_v2.py")
scaling_cluster = _V1["scaling_cluster"]
for _ns in (_V1, _V2):
    for _name, _fn in list(_ns.items()):
        if _name.startswith("test_") and _name not in NOT_MIRRORED:
            globals()[_name] = _fn
del _ns, _name, _fn


def test_the_mirrors_cover_the_reference():
    mirrored = {n for n in globals() if n.startswith("test_")}
    reference = {n for ns in (_V1, _V2) for n in ns if n.startswith("test_")}
    assert reference - mirrored == NOT_MIRRORED - {
        "test_respects_max_workers"}
    assert len(reference) == 24


# ---------------------------------------------------------------------------
# parity: one scripted sequence through both packages
# ---------------------------------------------------------------------------


def _v2_script(package):
    """The v2 state machine of `package` through one scripted sequence:
    demand, a launch error, the cloud instance, the daemon, idle, drain
    and the provider dropping it; a gang of four GPU bundles; a leaked
    cloud instance. Returns each instance's transitions, the results'
    launches and leaks, and the subscriber's events."""
    import importlib

    autoscaler = importlib.import_module(f"{package}.autoscaler.autoscaler")
    instance = importlib.import_module(f"{package}.autoscaler.v2.instance")
    manager = importlib.import_module(
        f"{package}.autoscaler.v2.instance_manager")
    reconciler = importlib.import_module(
        f"{package}.autoscaler.v2.reconciler")
    S = instance.InstanceStatus
    types = {
        "cpu": autoscaler.NodeTypeConfig(resources={"CPU": 2.0},
                                         min_workers=0, max_workers=4),
        "gpu-x4": autoscaler.NodeTypeConfig(
            resources={"CPU": 1.0, "GPU": 4.0}, min_workers=0,
            max_workers=2, slice_hosts=4),
    }
    im = manager.InstanceManager()
    events = []

    def on_update(inst, ev):
        events.append((ev.new_status.name, inst.instance_type))
        if ev.new_status == S.RAY_STOP_REQUESTED:
            im.update([manager.InstanceUpdateEvent(
                instance_id=inst.instance_id, new_status=S.RAY_STOPPING,
                details="drain acknowledged")])

    im.subscribe(on_update)
    config = reconciler.ReconcileConfig(idle_timeout_s=0.2)

    def load(nodes=(), infeasible=(), pgs=()):
        return {"nodes": list(nodes), "infeasible": list(infeasible),
                "pending_placement_groups": list(pgs)}

    results = []

    def step(cloud=None, errors=None, idle=False, **kw):
        if idle:  # past the idle timeout (the reconciler reads the clock)
            time.sleep(0.25)
        out = reconciler.Reconciler.reconcile(
            im, node_types=types, cloud_instances=cloud or {},
            load=load(**kw), config=config, provider_errors=errors)
        results.append({k: sorted(out.get(k) or []) for k in ("leaked",)})

    demand = [{"CPU": 2.0}]
    step(infeasible=demand)
    step(infeasible=demand)
    (cpu,) = im.instances()
    step(infeasible=demand, errors=[reconciler.ProviderError(
        kind="launch", instance_id=cpu.instance_id, details="quota")])
    step(infeasible=demand)
    cloud = {"c-1": reconciler.CloudInstance("c-1", "cpu", cpu.instance_id)}
    step(cloud=cloud)
    node = {"node_id": "n1", "labels": {"rt.io/provider-node": "c-1"},
            "available": {"CPU": 2.0}, "total": {"CPU": 2.0}, "queued": 0}
    step(cloud=cloud, nodes=[node])
    step(cloud=cloud, nodes=[dict(node, available={"CPU": 0.0})], idle=True)
    step(cloud=cloud, nodes=[node], idle=True)
    step(cloud=cloud, nodes=[node])
    step(cloud=cloud, nodes=[node])
    step()
    step(pgs=[{"strategy": "STRICT_SPREAD", "bundles": [{"GPU": 4.0}] * 4}])
    step(cloud={"stray": reconciler.CloudInstance("stray", "cpu")})
    return {
        "instances": [(inst.instance_type,
                       [t.status.name for t in inst.history])
                      for inst in im.instances()],
        "events": events, "results": results,
    }


def test_v2_reconciler_records_the_same_transitions_on_both_packages():
    jax_side = _v2_script("ray_tpu")
    port_side = _v2_script("ray_tpu_torch")
    assert port_side == jax_side
    cpu = jax_side["instances"][0]
    assert cpu[0] == "cpu" and cpu[1][-1] == "TERMINATED"
    assert "ALLOCATED" in cpu[1] and "RAY_RUNNING" in cpu[1]
    assert jax_side["instances"][-1][0] == "gpu-x4"
    assert jax_side["results"][-1]["leaked"] == ["stray"]


def _v1_launches(package):
    """`package`'s StandardAutoscaler over the reference's scripted
    slice loads (every join state of a booting slice, a fresh gang, a
    dead host past the launch timeout): its launches."""
    import importlib

    autoscaler = importlib.import_module(f"{package}.autoscaler.autoscaler")
    mirror = _V1 if package == "ray_tpu_torch" else _mirror_jax_v1()
    out = []
    for nodes, joined, seen_ago in ((["slice-0"], 0, None),
                                    (["slice-0"], 2, None),
                                    (["slice-0"], 3, None),
                                    ([], 0, None),
                                    (["slice-0"], 3, 999.0)):
        provider = mirror["_FakeSliceProvider"](nodes=nodes)
        scaler = autoscaler.StandardAutoscaler(
            provider, {"tpu-slice": autoscaler.NodeTypeConfig(
                resources={"CPU": 2.0, "GPU": 4.0}, max_workers=4,
                slice_hosts=4)}, idle_timeout_s=999.0)
        scaler.launch_timeout_s = 60.0
        load = mirror["_gang_load"](joined)
        if not nodes:
            load["nodes"] = load["nodes"][:1]
        scaler._load = lambda load=load: load
        if seen_ago is not None:
            scaler._first_seen["slice-0"] = time.time() - seen_ago
        out.append((len(scaler.update()["launched"]), provider.created))
    return out


def _mirror_jax_v1():
    """The reference's helpers with the GPU resource, on its own
    package."""
    with open(os.path.join(TESTS, "test_autoscaler.py"),
              encoding="utf-8") as f:
        source = f.read().replace('"TPU"', '"GPU"')
    namespace = {"__name__": "jax_v1_helpers"}
    exec(compile(source, "test_autoscaler.py", "exec"), namespace)
    return namespace


def test_v1_autoscaler_launches_the_same_nodes_on_both_packages():
    jax_side = _v1_launches("ray_tpu")
    port_side = _v1_launches("ray_tpu_torch")
    assert port_side == jax_side
    assert [n for n, _ in port_side] == [0, 0, 0, 1, 1]


# ---------------------------------------------------------------------------
# the reference's clock-driven case, held to an event
# ---------------------------------------------------------------------------


def test_respects_max_workers(scaling_cluster, tmp_path):
    """Ten 2-CPU tasks against max_workers 3: the cluster grows to its
    cap and no further while they are held, then they all finish."""
    rt, cluster = scaling_cluster
    release = str(tmp_path / "release")

    @rt.remote(num_cpus=2)
    def hold():
        import os
        import time as _t

        while not os.path.exists(release):
            _t.sleep(0.05)
        return 1

    refs = [hold.remote() for _ in range(10)]
    deadline = time.time() + 90
    peak = 0
    while time.time() < deadline and peak < 3:
        peak = max(peak, cluster.num_workers())
        time.sleep(0.1)
    assert peak == 3
    # Several more reconcile passes with seven tasks still queued.
    for _ in range(3):
        cluster.autoscaler.update()
        peak = max(peak, cluster.num_workers())
    assert peak <= 3
    open(release, "w").close()
    assert rt.get(refs, timeout=120) == [1] * 10
