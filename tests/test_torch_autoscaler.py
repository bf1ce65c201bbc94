"""The port's autoscaler and cluster launcher against the JAX package's,
on the CPU.

``StandardAutoscaler`` runs through scripted GCS replies (the node
table, the standing request) and a provider that records every launch
and termination; both packages' autoscalers take the same scripts on a
fake clock and must make the same decisions. The exception is C7 (a
request that running work already uses): the port packs requests
against each node's totals, as Ray does, and launches nothing; JAX
packs them against what is free and launches a node for them.

Then: the config schema's results and errors; each cloud provider's
calls through a recording fake transport, equal to JAX's for AWS, Azure
and Kubernetes (names ``ray-tpu-*`` read ``ray-tpu-torch-*``); the
``gcp_gpu`` provider's lifecycle and machine table; a fake-multinode
scale-up and scale-down on a port cluster (a GPU granted by index on the
launched node, its raylet and worker gone after the reap); ``up`` and
``down`` with ``fake_multinode`` under ``tmp_path``.
"""

import importlib
import json
import os
import time
import uuid

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import worker as port_worker

PACKAGES = ("ray_tpu", "ray_tpu_torch")
IDLE_S = 30.0
TIMEOUT_S = 60


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.autoscaler.{name}")


# ------------------------------------------------ scripted autoscaler


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now


class _RecordingProvider:
    """Duck-typed NodeProvider: ids ``w-0``, ``w-1``, ...; launches and
    terminations recorded in order."""

    def __init__(self):
        self.nodes = []
        self.calls = []
        self._n = 0

    def non_terminated_nodes(self):
        return list(self.nodes)

    def create_node(self, node_config, count):
        ids = [f"w-{self._n + i}" for i in range(count)]
        self._n += count
        self.nodes += ids
        self.calls.append(("create", dict(node_config["resources"]), count))
        return ids

    def terminate_node(self, node_id):
        self.nodes.remove(node_id)
        self.calls.append(("terminate", node_id))


class _World:
    """The GCS as the autoscaler reads it: alive nodes and the standing
    request."""

    def __init__(self):
        self.nodes = {}
        self.requests = []

    def node(self, nid, total, avail=None):
        self.nodes[nid] = {"node_id": nid, "alive": True,
                           "resources": dict(total),
                           "available": dict(total if avail is None
                                             else avail)}

    def gcs_call(self, method, payload):
        if method == "get_nodes":
            return [dict(n) for n in self.nodes.values()]
        if method == "kv_get":
            return {"value": json.dumps(self.requests).encode()}
        raise AssertionError(method)


def _run(pkg, node_types, script, idle_timeout_s=IDLE_S):
    """Each step of ``script`` edits the world, moves the clock, then one
    ``update()``; returns the per-tick decisions and the provider's
    calls."""
    mod = _mod(pkg, "autoscaler")
    clock, world, prov = _Clock(), _World(), _RecordingProvider()
    real_time = mod.time
    mod.time = clock
    try:
        a = mod.StandardAutoscaler(prov, json.loads(json.dumps(node_types)),
                                   world.gcs_call,
                                   idle_timeout_s=idle_timeout_s)
        ticks = []
        for step in script:
            step(world, clock, prov)
            r = a.update()
            ticks.append((len(r["launched"]), sorted(r["terminated"]),
                          r["unmet_demand"]))
        return ticks, prov.calls
    finally:
        mod.time = real_time


def _head(world, clock, prov):
    world.node("head", {"CPU": 2.0})


def _ask(*bundles):
    def step(world, clock, prov):
        world.requests = [dict(b) for b in bundles]
    return step


def _register(nid, total, avail=None):
    def step(world, clock, prov):
        world.node(nid, total, avail)
    return step


def _later(dt):
    def step(world, clock, prov):
        clock.now += dt
    return step


def _seq(*steps):
    def step(world, clock, prov):
        for s in steps:
            s(world, clock, prov)
    return step


def _noop(world, clock, prov):
    pass


W2 = {"w": {"resources": {"CPU": 2.0}, "min_workers": 0, "max_workers": 3}}
SCRIPTS = {
    "nothing_to_do": (W2, [_head, _noop, _later(IDLE_S * 2)]),
    # the head holds one bundle, two nodes for the rest; booting nodes
    # count as capacity; registered idle nodes reaped after the timeout
    "request_then_reap": (W2, [
        _seq(_head, _ask({"CPU": 2}, {"CPU": 2}, {"CPU": 2})),
        _later(1.0),
        _seq(_register("w-0", {"CPU": 2.0}), _register("w-1", {"CPU": 2.0})),
        _seq(_ask(), _later(1.0)),
        _later(IDLE_S - 1.0),
        _later(1.0)]),
    # a busy node is never idle; once free it is reaped after the timeout
    "busy_then_idle": (W2, [
        _seq(_head, _ask({"CPU": 2}, {"CPU": 2})),
        _seq(_register("w-0", {"CPU": 2.0}, {"CPU": 0.0}), _ask()),
        _later(IDLE_S * 2),
        _register("w-0", {"CPU": 2.0}),
        _later(IDLE_S),
        _later(1.0)]),
    "min_workers": (
        {"w": {"resources": {"CPU": 2.0}, "min_workers": 2,
               "max_workers": 4}},
        [_head, _seq(_register("w-0", {"CPU": 2.0}),
                     _register("w-1", {"CPU": 2.0})),
         _later(IDLE_S * 3), _later(1.0)]),
    # five bundles, two nodes allowed
    "max_workers": (
        {"w": {"resources": {"CPU": 2.0}, "min_workers": 0,
               "max_workers": 2}},
        [_seq(_head, _ask(*[{"CPU": 2}] * 6)), _noop,
         _later(200.0), _noop]),
    # the cheapest type that holds each bundle; an unplaceable bundle
    # stays unmet
    "cheapest_type": (
        {"small": {"resources": {"CPU": 2.0}, "max_workers": 4},
         "gpu": {"resources": {"CPU": 8.0, "GPU": 1.0}, "max_workers": 1}},
        [_seq(_head, _ask({"CPU": 4}, {"GPU": 1}, {"CPU": 1},
                          {"GPU": 2})),
         _noop]),
    # a launch that never registers stops counting after 180 s
    "pending_timeout": (W2, [
        _seq(_head, _ask({"CPU": 2}, {"CPU": 2})), _later(60.0),
        _later(121.0), _noop]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_autoscaler_decisions_match_jax(name):
    types, script = SCRIPTS[name]
    got = {pkg: _run(pkg, types, script) for pkg in PACKAGES}
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    assert got["ray_tpu_torch"][1] or name == "nothing_to_do"


def test_request_in_use_launches_nothing_c7():
    """C7: a standing ``{"CPU": 1, "GPU": 1}`` request that an actor on
    the launched node already uses. The port launches once; JAX launches
    again, because it packs the request against the free GPU (0)."""
    gpu = {"g": {"resources": {"CPU": 2.0, "GPU": 1.0}, "min_workers": 0,
                 "max_workers": 2}}
    script = [
        _seq(_register("head", {"CPU": 4.0}), _ask({"CPU": 1, "GPU": 1})),
        _register("w-0", {"CPU": 2.0, "GPU": 1.0},
                  {"CPU": 1.0, "GPU": 0.0}),
        _later(IDLE_S * 2), _noop]
    port_ticks, port_calls = _run("ray_tpu_torch", gpu, script)
    jax_ticks, jax_calls = _run("ray_tpu", gpu, script)
    assert [t[0] for t in port_ticks] == [1, 0, 0, 0]
    assert [c[0] for c in port_calls] == ["create"]
    assert port_ticks[1][2] == []                  # the request is met
    assert [t[0] for t in jax_ticks] == [1, 1, 0, 0]
    assert jax_ticks[1][2] == [{"CPU": 1, "GPU": 1}]


def test_monitor_counts_failed_updates():
    """JAX's loop swallows a failing tick; the port's counts it and keeps
    the exception."""
    mod = _mod("ray_tpu_torch", "autoscaler")

    class Broken:
        def update(self):
            raise RuntimeError("no GCS")

    m = mod.AutoscalerMonitor(Broken(), interval_s=0.01).start()
    deadline = time.time() + 10
    while m.failed_updates < 3 and time.time() < deadline:
        time.sleep(0.01)
    m.stop(timeout=5)
    s = m.stats()
    assert s["failed_updates"] >= 3 and s["updates"] >= s["failed_updates"]
    assert "no GCS" in s["last_error"]
    assert not m._thread.is_alive()


# ------------------------------------------------------------- config


def _base(**over):
    cfg = {"cluster_name": "c", "max_workers": 4,
           "provider": {"type": "fake_multinode"},
           "available_node_types": {"head": {"resources": {"CPU": 2}},
                                    "w": {"min_workers": 0}},
           "head_node_type": "head"}
    cfg.update(over)
    return cfg


CONFIGS = {
    "valid": _base(),
    "no_name": _base(cluster_name=""),
    "bad_provider": _base(provider={"type": "nope"}),
    "aws_no_region": _base(provider={"type": "aws"}),
    "aws": _base(provider={"type": "aws", "region": "us-east-1"}),
    "azure_no_sub": _base(provider={"type": "azure"}),
    "no_types": _base(available_node_types={}),
    "type_not_dict": _base(available_node_types={"w": 3}),
    "min_over_max": _base(available_node_types={
        "w": {"min_workers": 5, "max_workers": 2}}),
    "head_missing": _base(head_node_type="x"),
    "gcp_no_project": _base(provider={"type": "gcp_tpu",
                                      "availability_zone": "z"}),
    "gcp": _base(provider={"type": "gcp_tpu", "project_id": "p",
                           "availability_zone": "z"}),
}


def _outcome(pkg, cfg):
    config = _mod(pkg, "config")
    try:
        return ("ok", config.prepare_config(json.loads(json.dumps(cfg))))
    except config.ConfigError as e:
        return ("error", str(e))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_matches_jax(name):
    """The same results and errors; JAX's ``gcp_tpu`` reads ``gcp_gpu``
    on the port."""
    cfg = CONFIGS[name]
    port_cfg = json.loads(json.dumps(cfg).replace("gcp_tpu", "gcp_gpu"))
    want = json.loads(json.dumps(_outcome("ray_tpu", cfg))
                      .replace("gcp_tpu", "gcp_gpu"))
    got = json.loads(json.dumps(_outcome("ray_tpu_torch", port_cfg)))
    assert got == want


def test_gcp_tpu_raises_naming_gcp_gpu():
    config = _mod("ray_tpu_torch", "config")
    with pytest.raises(config.ConfigError, match="gcp_gpu"):
        config.validate_config(CONFIGS["gcp"])
    assert "gcp_tpu" not in config.PROVIDER_TYPES
    with pytest.raises(config.ConfigError, match="no provider"):
        config.make_provider({"cluster_name": "c",
                              "provider": {"type": "gcp_tpu"}})


# ---------------------------------------------------- cloud providers


class _Recorder:
    """Wraps a fake transport; every call is kept as (method, args)."""

    def __init__(self, fake):
        self._fake = fake
        self.calls = []

    def __getattr__(self, name):
        fn = getattr(self._fake, name)

        def call(*args, **kwargs):
            self.calls.append((name, args, kwargs))
            return fn(*args, **kwargs)
        return call


class _FakeEC2:
    def __init__(self):
        self.instances = {}

    def run_instances(self, **params):
        out = []
        for _ in range(params["MinCount"]):
            iid = f"i-{len(self.instances) + 1:08x}"
            self.instances[iid] = {
                "InstanceId": iid, "State": "running",
                "InstanceType": params["InstanceType"],
                "Tags": params["TagSpecifications"][0]["Tags"],
                "PublicIpAddress": f"10.0.0.{len(self.instances) + 1}"}
            out.append(self.instances[iid])
        return {"Instances": out}

    def describe_instances(self, Filters=None, InstanceIds=None):
        insts = [i for i in self.instances.values()
                 if not InstanceIds or i["InstanceId"] in InstanceIds]
        for f in Filters or ():
            if f["Name"].startswith("tag:"):
                insts = [i for i in insts if any(
                    t["Key"] == f["Name"][4:] and t["Value"] in f["Values"]
                    for t in i["Tags"])]
        return {"Reservations": [{"Instances": insts}]}

    def terminate_instances(self, InstanceIds):
        for iid in InstanceIds:
            self.instances.pop(iid, None)


class _FakeAzure:
    def __init__(self):
        self.vms = {}

    def list_vms(self, resource_group):
        return list(self.vms.values())

    def create_vm(self, resource_group, spec):
        self.vms[spec["name"]] = {**spec, "provisioning_state": "Succeeded",
                                  "public_ip": f"10.1.0.{len(self.vms)}"}

    def delete_vm(self, resource_group, name):
        self.vms.pop(name, None)


class _FakeK8s:
    def __init__(self):
        self.pods = {}

    def list_pods(self, namespace):
        return list(self.pods.values())

    def create_pod(self, namespace, pod):
        self.pods[pod["name"]] = {**pod, "phase": "Running"}

    def delete_pod(self, namespace, name):
        self.pods.pop(name, None)


def _aws(pkg, rec):
    p = _mod(pkg, "aws").AWSNodeProvider(
        {"region": "us-west-2", "cluster_name": "c1"}, ec2_client=rec)
    ids = p.create_node({"InstanceType": "m5.4xlarge", "KeyName": "k",
                         "node_kind": "worker"}, 2)
    out = [sorted(p.non_terminated_nodes()), p.node_resources(ids[0]),
           p.external_ip(ids[0])]
    p.terminate_node(ids[0])
    return out + [p.non_terminated_nodes()]


def _azure(pkg, rec):
    p = _mod(pkg, "azure").AzureNodeProvider(
        {"subscription_id": "s", "resource_group": "g",
         "cluster_name": "c1"}, compute_client=rec)
    ids = p.create_node({"vm_size": "Standard_D8s_v3"}, 2)
    out = [sorted(p.non_terminated_nodes()), p.node_resources(ids[0]),
           p.external_ip(ids[0])]
    p.terminate_node(ids[0])
    return out + [p.non_terminated_nodes()]


def _k8s(pkg, rec):
    m = _mod(pkg, "kubernetes")
    p = m.KubernetesNodeProvider({"namespace": "ns", "cluster_name": "c1"},
                                 k8s_client=rec)
    op = m.RayClusterOperator(p)
    spec = {"head": {"image": "img", "resources": {"CPU": 4}},
            "worker_groups": [
                {"name": "cpu", "replicas": 2, "resources": {"CPU": 2}},
                {"name": "gpu", "replicas": 1,
                 "resources": {"CPU": 8, "GPU": 1}}]}
    out = [op.reconcile(spec), op.reconcile(spec)]
    spec["worker_groups"][0]["replicas"] = 1
    spec["worker_groups"].pop(1)
    out.append(op.reconcile(spec))
    return out + [sorted(p.non_terminated_nodes())]


PROVIDERS = {"aws": (_aws, _FakeEC2), "azure": (_azure, _FakeAzure),
             "kubernetes": (_k8s, _FakeK8s)}


@pytest.mark.parametrize("name", sorted(PROVIDERS))
def test_cloud_provider_calls_match_jax(name, monkeypatch):
    run, fake = PROVIDERS[name]
    got = {}
    for pkg in PACKAGES:
        seq = iter(range(1000))
        monkeypatch.setattr(uuid, "uuid4",
                            lambda: uuid.UUID(int=(next(seq) + 1) << 96))
        rec = _Recorder(fake())
        result = run(pkg, rec)
        got[pkg] = json.loads(json.dumps([result, rec.calls]))
    want = json.loads(json.dumps(got["ray_tpu"]).replace(
        "ray-tpu", "ray-tpu-torch").replace("ray_tpu", "ray_tpu_torch"))
    assert got["ray_tpu_torch"] == want
    assert got["ray_tpu_torch"][1]


class _FakeCompute:
    """Compute Engine v1 ``instances`` over a dict."""

    def __init__(self):
        self.instances = {}
        self.calls = []

    def request(self, method, path, body=None):
        self.calls.append((method, path))
        if method == "POST" and path == "instances":
            self.instances[body["name"]] = {**body, "status": "RUNNING"}
            return {"kind": "compute#operation"}
        if method == "GET" and path.startswith("instances?filter="):
            label, want = path.split("=", 1)[1].split("%3D")
            key = label.split(".", 1)[1]
            return {"items": [i for i in self.instances.values()
                              if i["labels"].get(key) == want]}
        name = path.split("/", 1)[1]
        if method == "GET":
            inst = self.instances[name]
            return {**inst, "machineType":
                    f"https://compute/v1/{inst['machineType']}"}
        if method == "DELETE":
            self.instances.pop(name)
            return {}
        raise AssertionError((method, path))


def test_gcp_gpu_provider_lifecycle():
    from ray_tpu_torch.autoscaler import gcp_gpu
    api = _FakeCompute()
    cfg = {"project_id": "p", "availability_zone": "us-central1-a",
           "cluster_name": "c1"}
    p = gcp_gpu.GCPGPUNodeProvider(cfg, api_client=api)
    ids = p.create_node({"machineType": "a3-highgpu-8g", "spot": True}, 2)
    assert all(i.startswith("c1-") for i in ids)
    assert sorted(p.non_terminated_nodes()) == sorted(ids)
    body = api.instances[ids[0]]
    assert body["machineType"] == ("zones/us-central1-a/machineTypes/"
                                   "a3-highgpu-8g")
    assert body["labels"]["ray-tpu-torch-cluster"] == "c1"
    assert body["scheduling"]["onHostMaintenance"] == "TERMINATE"
    assert body["scheduling"]["provisioningModel"] == "SPOT"
    assert p.node_resources(ids[0]) == {"GPU": 8.0, "CPU": 208.0}
    # a fresh provider recovers the machine type from the API
    fresh = gcp_gpu.GCPGPUNodeProvider(cfg, api_client=api)
    assert fresh.node_resources(ids[1]) == {"GPU": 8.0, "CPU": 208.0}
    # another cluster's and stopped instances are not its nodes
    other = gcp_gpu.GCPGPUNodeProvider({**cfg, "cluster_name": "c2"},
                                       api_client=api)
    assert other.non_terminated_nodes() == []
    api.instances[ids[1]]["status"] = "TERMINATED"
    assert p.non_terminated_nodes() == [ids[0]]
    assert p.node_state(ids[1]) == "TERMINATED"
    p.terminate_node(ids[0])
    assert ids[0] not in api.instances
    assert ("DELETE", f"instances/{ids[0]}") in api.calls


@pytest.mark.parametrize("machine,want", [
    ("a3-highgpu-8g", {"GPU": 8.0, "CPU": 208.0}),
    ("a3-highgpu-1g", {"GPU": 1.0, "CPU": 26.0}),
    ("a2-highgpu-1g", {"GPU": 1.0, "CPU": 12.0}),
    ("a2-megagpu-16g", {"GPU": 16.0, "CPU": 96.0}),
    ("n2-standard-8", {"GPU": 0.0}),
    ("a9-unknown-4g", {"GPU": 0.0}),
])
def test_gcp_gpu_machine_resources(machine, want):
    from ray_tpu_torch.autoscaler import gcp_gpu
    assert gcp_gpu.machine_resources(machine) == want
    for name in gcp_gpu.MACHINE_VCPUS:
        assert gcp_gpu.machine_resources(name)["GPU"] >= 1


def test_gcp_gpu_up_and_down(tmp_path, monkeypatch):
    from ray_tpu_torch.autoscaler import commands
    monkeypatch.setattr(commands, "STATE_DIR", str(tmp_path))
    api = _FakeCompute()
    cfg = _base(cluster_name="g1",
                provider={"type": "gcp_gpu", "project_id": "p",
                          "availability_zone": "z"},
                available_node_types={
                    "head": {"node_config": {"machineType":
                                             "a3-highgpu-1g"}},
                    "w": {"min_workers": 2, "node_config": {
                        "machineType": "a3-highgpu-8g"}}})
    state = commands.create_or_update_cluster(cfg, api_client=api)
    assert sorted(s["type"] for s in state["nodes"].values()) == \
        ["head", "w", "w"]
    again = commands.create_or_update_cluster(cfg, api_client=api)
    assert again["nodes"] == state["nodes"]            # idempotent
    assert commands.teardown_cluster(cfg, api_client=api) == 3
    assert api.instances == {}
    assert commands._load_state("g1") is None


# ----------------------------------------------- on a port cluster


def _children(pid):
    kids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            kids.append(int(d))
    return kids


def _running(pid):
    from ray_tpu_torch.autoscaler import commands
    return commands._running(pid)


def _descendants(pid):
    out, todo = [], [pid]
    while todo:
        kids = _children(todo.pop())
        out += kids
        todo += kids
    return out


def test_up_down_fake_multinode(tmp_path, monkeypatch):
    """``up`` starts a detached head (``--num-gpus 0``) and one worker
    raylet; a driver joins and runs a task on the worker node; ``down``
    leaves none of those processes running. First in the module: the
    port cluster of the tests below is not up yet."""
    from ray_tpu_torch.autoscaler import commands
    monkeypatch.setattr(commands, "STATE_DIR", str(tmp_path))
    cfg = _base(cluster_name="fakeup", available_node_types={
        "head": {"resources": {"CPU": 1}},
        "w": {"min_workers": 1, "resources": {"CPU": 1, "side": 1}}})
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    state = commands.create_or_update_cluster(cfg)
    pids = [state["head"]["pid"]] + [
        s["pid"] for s in state["nodes"].values()]
    procs = pids + [d for p in pids for d in _descendants(p)]
    try:
        assert len(state["nodes"]) == 1
        ray_tpu_torch.init(address=state["head"]["gcs_address"])
        deadline = time.time() + TIMEOUT_S
        while (len([n for n in ray_tpu_torch.nodes() if n["alive"]]) < 2
               and time.time() < deadline):
            time.sleep(0.2)
        heads = [n for n in ray_tpu_torch.nodes() if n["is_head"]]
        assert "GPU" not in heads[0]["resources"]

        @ray_tpu_torch.remote(resources={"side": 1})
        def where():
            return os.getpid()

        wpid = ray_tpu_torch.get(where.remote(), timeout=TIMEOUT_S)
        procs.append(wpid)
        ray_tpu_torch.shutdown()
    finally:
        n = commands.teardown_cluster(cfg)
    assert n == 2
    assert commands._load_state("fakeup") is None
    assert [p for p in set(procs) if _running(p)] == []


@pytest.fixture(scope="module")
def port_cluster():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ctx = ray_tpu_torch.init(num_cpus=1, num_gpus=0)
    try:
        yield ctx
    finally:
        ray_tpu_torch.shutdown()


def test_fake_multinode_scale_up_and_down(port_cluster):
    """A GPU request launches one ``{"CPU": 1, "GPU": 1}`` node through
    ``FakeMultiNodeProvider`` (a fake card on this box, granted by
    index), a ``num_gpus=1`` task runs there with ``CUDA_VISIBLE_DEVICES``
    ``0``; with the request dropped the idle node is reaped, and neither
    its raylet nor the worker that ran the task is left."""
    from ray_tpu_torch.autoscaler import (FakeMultiNodeProvider,
                                          StandardAutoscaler,
                                          request_resources)
    from ray_tpu_torch.experimental.state import api as state
    w = port_worker.global_worker()

    def gcs_call(method, payload):
        return w.call_sync(w.gcs, method, payload, timeout=30)

    provider = FakeMultiNodeProvider({"session_dir": w.session_dir,
                                      "gcs_address": w.gcs_address})
    a = StandardAutoscaler(
        provider, {"gpu_worker": {"resources": {"CPU": 1, "GPU": 1},
                                  "min_workers": 0, "max_workers": 1}},
        gcs_call, idle_timeout_s=0.5)
    assert a.update()["launched"] == []
    request_resources([{"CPU": 1, "GPU": 1}])
    (nid,) = a.update()["launched"]
    raylet_pid = provider.node_pid(nid)
    deadline = time.time() + TIMEOUT_S
    while not any(n["node_id"] == nid and n["alive"]
                  for n in state.list_nodes()) and time.time() < deadline:
        time.sleep(0.1)
    assert provider.node_resources(nid) == {"GPU": 1, "CPU": 1}

    @ray_tpu_torch.remote(num_gpus=1)
    def card():
        return (os.getpid(), os.environ["CUDA_VISIBLE_DEVICES"],
                ray_tpu_torch.get_runtime_context().get_node_id())

    wpid, visible, node = ray_tpu_torch.get(card.remote(),
                                            timeout=TIMEOUT_S)
    assert (visible, node) == ("0", nid)
    assert a.update()["launched"] == []            # the request is met
    request_resources([])
    terminated = []
    deadline = time.time() + TIMEOUT_S
    while not terminated and time.time() < deadline:
        time.sleep(0.25)
        terminated = a.update()["terminated"]
    assert terminated == [nid]
    assert provider.non_terminated_nodes() == []
    assert not _running(raylet_pid) and not _running(wpid)
    deadline = time.time() + TIMEOUT_S
    while time.time() < deadline and any(
            n["node_id"] == nid and n["alive"] for n in state.list_nodes()):
        time.sleep(0.2)
    assert not [n for n in state.list_nodes()
                if n["node_id"] == nid and n["alive"]]
