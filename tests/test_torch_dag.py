"""The port's DAGs (``.bind()``, ``execute``, ``compile``) and channels
against the JAX package's, on the CPU.

The cases of ``tests/test_compiled_dag.py`` run on both packages with
the same actors and inputs, and their results are compared result for
result: a three-stage round trip (dynamic and compiled), pipelined
``execute_async``, an application error that leaves the graph compiled,
``MultiOutputNode``, a class node that creates its actor once, a graph
of a plain function that degrades to the dynamic path, ring slots
reused with the store's usage flat, a compile failure that degrades and
then recompiles, and a stage whose worker dies mid-graph, which falls
back exactly once (the sink sees every input once). The JAX side runs
on one node (``init(num_cpus=4)``); the port's on a two-node
``Cluster``, where a stage on the added raylet takes and gives payloads
over the inline limit through ring slots in the other raylet's store
(the JAX reader looks only in its own store and fails there, so that
case is held to JAX's dynamic result). The port's degrade is read from
``CompiledDAG.stats()``. Last, a two-stage scorer over a 2-layer narrow
GPT-2 (params crossed with ``params_from_flax``) against JAX's same DAG
over the flax model: per-row mean NLL within ``tests/test_torch_gpt2.py``'s
forward tolerance, rtol = atol = 1e-4.

Classes the workers run are made inside functions (cloudpickle ships
them by value) and reach only their own package. Every ``get`` and
``execute`` has a time limit.
"""

import concurrent.futures
import importlib
import os
import time
from unittest import mock

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

PACKAGES = ("ray_tpu", "ray_tpu_torch")
STORE = 256 * 1024 * 1024
T = 30                                      # seconds for a get or execute
GPT2_TOL = dict(rtol=1e-4, atol=1e-4)       # tests/test_torch_gpt2.py's TOL


def _within(fn, *args, timeout=90):
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        return pool.submit(fn, *args).result(timeout=timeout)
    finally:
        pool.shutdown(wait=False)


def _each(fn, args_of, timeout=90):
    """{pkg: fn(*args_of(pkg))}, both packages at once (each has its own
    driver; most of the time is their workers' starts)."""
    pool = concurrent.futures.ThreadPoolExecutor(len(PACKAGES))
    try:
        futs = {pkg: pool.submit(fn, *args_of(pkg)) for pkg in PACKAGES}
        return {pkg: f.result(timeout=timeout) for pkg, f in futs.items()}
    finally:
        pool.shutdown(wait=False)


@pytest.fixture(scope="module")
def clusters():
    from ray_tpu_torch._private.cluster_utils import Cluster
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    with mock.patch.dict(os.environ, {"RTT_PRESTART_WORKERS": "0",
                                      "RTPU_PRESTART_WORKERS": "0"}):
        made = {}

        def start(pkg):
            if pkg == "ray_tpu":
                ray_tpu.init(num_cpus=4, object_store_memory=STORE)
                return None
            c = made[pkg] = Cluster(head_node_args={
                "num_cpus": 4, "num_gpus": 0, "resources": {"head": 1},
                "object_store_memory": STORE})
            node = c.add_node(num_cpus=2, num_gpus=0,
                              resources={"node2": 1},
                              object_store_memory=STORE)
            c.connect()
            c.wait_for_nodes()
            return node["node_id"]

        try:
            node2 = _each(start, lambda pkg: (pkg,))["ray_tpu_torch"]
            yield {"ray_tpu": _kit("ray_tpu"),
                   "ray_tpu_torch": _kit("ray_tpu_torch"),
                   "node2": node2}
        finally:
            for c in made.values():
                c.shutdown()
            ray_tpu.shutdown()


def _kit(pkg):
    rt = importlib.import_module(pkg)
    dag = importlib.import_module(pkg + ".dag")
    cd = importlib.import_module(pkg + ".dag.compiled_dag")

    class AddK:
        def __init__(self, k):
            self.k = k

        def add(self, x):
            return x + self.k

        def boom(self, x):
            raise ValueError(f"boom on {x}")

        def pid(self, x):
            import os as _os
            return _os.getpid()

        def node(self, x):
            return rt.get_runtime_context().get_node_id()

        def counts(self, x):
            from ray_tpu_torch.dag import channel
            return channel.ring_counts()

    return {"rt": rt, "dag": dag, "cd": cd, "AddK": rt.remote(AddK)}


def _pipeline(kit):
    AddK, dag = kit["AddK"], kit["dag"]
    with dag.InputNode() as inp:
        a, b, c = AddK.bind(1), AddK.bind(10), AddK.bind(100)
        d = c.add.bind(b.add.bind(a.add.bind(inp)))
    return d, (a, b, c)


def _kill(kit, *nodes):
    for n in nodes:
        if n._cached_actor is not None:
            kit["rt"].kill(n._cached_actor)


@pytest.fixture(scope="module")
def pipelines(clusters):
    """One three-stage pipeline per package (AddK 1, 10, 100), shared by
    the cases that do not kill its actors."""
    out = {pkg: _pipeline(clusters[pkg]) for pkg in PACKAGES}
    yield out
    for pkg, (_, nodes) in out.items():
        _kill(clusters[pkg], *nodes)


def _both(fn, clusters, pipelines=None):
    return _each(fn, lambda pkg: (clusters[pkg],) + (
        (pipelines[pkg],) if pipelines else ()))


def _roundtrip(kit, pipe):
    d, _ = pipe
    dynamic = [kit["rt"].get(d.execute(i), timeout=T) for i in range(3)]
    cdag = d.compile()
    try:
        state = (cdag._compiled, cdag._fallback_only)
        compiled = [cdag.execute(i, timeout=T) for i in range(23)]
        stats = cdag.stats() if hasattr(cdag, "stats") else None
        return dynamic, compiled, state, stats
    finally:
        cdag.teardown()


def test_compile_execute_roundtrip_equivalence(clusters, pipelines):
    got = _both(_roundtrip, clusters, pipelines)
    want = ([111 + i for i in range(3)], [111 + i for i in range(23)],
            (True, False))
    assert got["ray_tpu"][:3] == want
    assert got["ray_tpu_torch"][:3] == want
    stats = got["ray_tpu_torch"][3]
    assert (stats["compiles"], stats["compiled_executions"],
            stats["dynamic_executions"], stats["dynamic_reruns"]) == \
        (1, 23, 0, 0)


def _pipelined(kit, pipe):
    cdag = pipe[0].compile()
    try:
        futs = [cdag.execute_async(i, timeout=T) for i in range(50)]
        return cdag._compiled, [f.result(T) for f in futs]
    finally:
        cdag.teardown()


def test_compiled_pipelined_async(clusters, pipelines):
    got = _both(_pipelined, clusters, pipelines)
    assert got["ray_tpu"] == got["ray_tpu_torch"] == \
        (True, [111 + i for i in range(50)])


def _app_error(kit, pipe):
    a, b, _ = pipe[1]
    with kit["dag"].InputNode() as inp:
        d = b.add.bind(a.boom.bind(inp))
    cdag = d.compile()
    out = []
    try:
        for x in (7, 8):
            try:
                cdag.execute(x, timeout=T)
                out.append("no error")
            except kit["rt"].exceptions.RayTpuError as e:
                out.append(("boom on %d" % x) in str(e))
            out.append(cdag._compiled)
        return out
    finally:
        cdag.teardown()


def test_app_error_propagates_without_teardown(clusters, pipelines):
    got = _both(_app_error, clusters, pipelines)
    assert got["ray_tpu"] == got["ray_tpu_torch"] == [True] * 4


def _multi_output(kit, pipe):
    a, b, c = pipe[1]
    rt, dag = kit["rt"], kit["dag"]
    with dag.InputNode() as inp:
        mid = a.add.bind(inp)
        d = dag.MultiOutputNode([b.add.bind(mid), c.add.bind(mid)])
    refs = d.execute(5)
    dynamic = (isinstance(refs, list), rt.get(refs, timeout=T))
    cdag = d.compile()
    try:
        return dynamic, cdag._compiled, [cdag.execute(x, timeout=T)
                                         for x in (5, 0)]
    finally:
        cdag.teardown()


def test_multi_output_node_dynamic_and_compiled(clusters, pipelines):
    got = _both(_multi_output, clusters, pipelines)
    assert got["ray_tpu"] == got["ray_tpu_torch"] == \
        ((True, [16, 106]), True, [[16, 106], [11, 101]])


def _cached_actor(kit):
    rt, dag = kit["rt"], kit["dag"]
    node = kit["AddK"].bind(0)
    with dag.InputNode() as inp:
        d = node.pid.bind(inp)
    try:
        pids, handles = [], []
        for i in range(3):
            pids.append(rt.get(d.execute(i), timeout=T))
            handles.append(node._cached_actor._id_hex)
        return len(set(pids)), len(set(handles)), os.getpid() in pids
    finally:
        _kill(kit, node)


def test_class_node_caches_actor_across_executions(clusters):
    got = _both(_cached_actor, clusters)
    assert got["ray_tpu"] == got["ray_tpu_torch"] == (1, 1, False)


def _uncompilable(kit):
    rt, dag = kit["rt"], kit["dag"]

    @rt.remote
    def double(x):
        return x * 2

    with dag.InputNode() as inp:
        d = double.bind(inp)
    cdag = d.compile()
    state = (cdag._fallback_only, cdag._compiled)
    out = cdag.execute(21, timeout=T)
    stats = cdag.stats() if hasattr(cdag, "stats") else None
    return state, out, stats


def test_uncompilable_graph_degrades_to_dynamic(clusters):
    got = _both(_uncompilable, clusters)
    assert got["ray_tpu"][:2] == got["ray_tpu_torch"][:2] == \
        ((True, False), 42)
    stats = got["ray_tpu_torch"][2]
    assert stats["fallback_only"] and not stats["compiled"]
    assert "actor-method" in stats["uncompilable_reason"]
    assert (stats["compiles"], stats["dynamic_executions"],
            stats["compiled_executions"]) == (0, 1, 0)


def _ring_flat(kit, pipe):
    w = importlib.import_module(kit["rt"].__name__ +
                                "._private.worker")._global_worker
    cdag = pipe[0].compile()
    try:
        arr = np.zeros(32 * 1024, dtype=np.float64)   # 256 KB > inline
        for _ in range(4):          # >= ring depth: lazy slots exist
            cdag.execute(arr, timeout=T)
        s0 = w.plasma.stats()
        outs = [cdag.execute(arr, timeout=T) for _ in range(100)]
        s1 = w.plasma.stats()
        return (cdag._compiled, all(np.array_equal(o, arr + 111.0)
                                    for o in outs),
                s1["used_bytes"] == s0["used_bytes"],
                s1["num_created"] == s0["num_created"])
    finally:
        cdag.teardown()


def test_ring_buffer_reuse_stays_flat(clusters, pipelines):
    from ray_tpu_torch.dag import channel
    before = channel.ring_counts()
    got = _both(_ring_flat, clusters, pipelines)
    assert got["ray_tpu"] == got["ray_tpu_torch"] == (True, True, True,
                                                      True)
    # the driver's trigger payloads rode its own ring (JAX: inline)
    after = channel.ring_counts()
    assert after["ring_writes"] - before["ring_writes"] == 104


def _recompile(kit, pipe, monkeypatch):
    CompiledDAG, CompileError = kit["cd"].CompiledDAG, kit["cd"].CompileError
    broken = {"on": True}
    real = CompiledDAG._compile

    def flaky(self):
        if broken["on"]:
            raise CompileError("injected: channel refused")
        return real(self)

    monkeypatch.setattr(CompiledDAG, "_compile", flaky)
    cdag = pipe[0].compile()
    try:
        out = [(cdag._compiled, cdag._fallback_only),
               cdag.execute(1, timeout=T)]
        broken["on"] = False
        time.sleep(CompiledDAG._COMPILE_RETRY_S + 0.1)
        out += [cdag.execute(2, timeout=T), cdag._compiled]
        stats = cdag.stats() if hasattr(cdag, "stats") else None
        return out, stats
    finally:
        cdag.teardown()


def test_compile_failure_degrades_then_recompiles(clusters, pipelines,
                                                  monkeypatch):
    got = _each(_recompile, lambda pkg: (clusters[pkg], pipelines[pkg],
                                         monkeypatch))
    assert got["ray_tpu"][0] == got["ray_tpu_torch"][0] == \
        [(False, False), 112, 113, True]
    stats = got["ray_tpu_torch"][1]
    assert (stats["compile_failures"], stats["compiles"],
            stats["dynamic_executions"], stats["compiled_executions"],
            stats["dynamic_reruns"]) == (1, 1, 1, 1, 0)


def _stage_kill(kit, flag):
    rt, dag = kit["rt"], kit["dag"]

    class CountingStage:
        def __init__(self, k, flag):
            self.k = k
            self.flag = flag
            self.seen = {}

        def f(self, x):
            import os as _os
            if self.k == 10 and x == 2 and not _os.path.exists(self.flag):
                open(self.flag, "w").close()
                _os._exit(1)        # the middle stage dies mid-graph
            self.seen[x] = self.seen.get(x, 0) + 1
            return x + self.k

        def seen_counts(self):
            return dict(self.seen)

    Stage = rt.remote(CountingStage)
    with dag.InputNode() as inp:
        a, b, c = Stage.bind(1, flag), Stage.bind(10, flag), \
            Stage.bind(100, flag)
        d = c.f.bind(b.f.bind(a.f.bind(inp)))
    cdag = d.compile(execute_timeout_s=15.0)
    try:
        compiled = cdag._compiled
        out = [cdag.execute(i, timeout=15.0) for i in range(6)]
        counts = rt.get(c._cached_actor.seen_counts.remote(), timeout=T)
        stats = cdag.stats() if hasattr(cdag, "stats") else None
        return compiled, out, counts, os.path.exists(flag), stats
    finally:
        cdag.teardown()
        _kill(kit, a, b, c)


def test_stage_kill_falls_back_exactly_once(clusters, tmp_path):
    got = _each(_stage_kill, lambda pkg: (clusters[pkg],
                                          str(tmp_path / f"{pkg}.died")))
    want = (True, [111 + i for i in range(6)],
            {11 + i: 1 for i in range(6)}, True)
    assert got["ray_tpu"][:4] == want
    assert got["ray_tpu_torch"][:4] == want
    stats = got["ray_tpu_torch"][4]
    assert stats["dynamic_reruns"] == 1
    assert stats["compiled_executions"] + stats["dynamic_reruns"] >= 6


def _across_nodes(kit, node2):
    rt, dag, AddK = kit["rt"], kit["dag"], kit["AddK"]
    with dag.InputNode() as inp:
        a = AddK.options(resources={"head": 1}).bind(1.0)
        b = AddK.options(resources={"node2": 1}).bind(10.0)
        d = b.add.bind(a.add.bind(inp))
    arr = np.arange(32 * 1024, dtype=np.float64)     # 256 KB > inline
    try:
        dynamic = rt.get(d.execute(arr), timeout=T)
        cdag = d.compile()
        try:
            compiled = [cdag.execute(arr * i, timeout=T) for i in range(3)]
            where = rt.get([a._cached_actor.node.remote(0),
                            b._cached_actor.node.remote(0)], timeout=T)
            counts = rt.get([a._cached_actor.counts.remote(0),
                             b._cached_actor.counts.remote(0)], timeout=T)
            return dynamic, compiled, where, counts, cdag.stats()
        finally:
            cdag.teardown()
    finally:
        _kill(kit, a, b)


def _jax_dynamic(kit, arrays):
    rt, dag, AddK = kit["rt"], kit["dag"], kit["AddK"]
    with dag.InputNode() as inp:
        a, b = AddK.bind(1.0), AddK.bind(10.0)
        d = b.add.bind(a.add.bind(inp))
    try:
        return [rt.get(d.execute(x), timeout=T) for x in arrays]
    finally:
        _kill(kit, a, b)


def test_stage_on_added_raylet_rides_ring_slots(clusters):
    from ray_tpu_torch.dag import channel
    before = channel.ring_counts()
    dynamic, compiled, where, counts, stats = _within(
        _across_nodes, clusters["ray_tpu_torch"], clusters["node2"])
    after = channel.ring_counts()
    arr = np.arange(32 * 1024, dtype=np.float64)
    want = _within(_jax_dynamic, clusters["ray_tpu"],
                   [arr] + [arr * i for i in range(3)])
    assert np.array_equal(dynamic, want[0])
    assert all(np.array_equal(g, w) for g, w in zip(compiled, want[1:]))
    assert where[1] == clusters["node2"] and where[0] != where[1]
    assert where[0] == ray_tpu_torch.get_runtime_context().get_node_id()
    assert stats["compiled_executions"] == 3 and \
        stats["dynamic_executions"] == 0
    # the head stage read the driver's slots in its own store and wrote
    # its own; the added raylet's stage read those from the head's store
    # and wrote its result to a slot that the driver read from there
    head, added = counts
    assert head["ring_writes"] >= 3 and head["ring_reads"] >= 3
    assert added["foreign_ring_reads"] >= 3 and added["ring_writes"] >= 3
    assert after["foreign_ring_reads"] - before["foreign_ring_reads"] == 3
    assert after["ring_writes"] - before["ring_writes"] == 3


def _gpt2_kit():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as JG
    from ray_tpu_torch.models import gpt2 as TG
    # params drawn with numpy on eval_shape's shapes: flax's eager init
    # compiles op by op (seconds)
    mj = JG.GPT2(JG.GPT2Config.tiny())
    shapes = jax.eval_shape(mj.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(0)
    host = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.05).astype(a.dtype),
        shapes)
    sd = {k: v.numpy() for k, v in TG.params_from_flax(host).items()}
    tokens = np.random.default_rng(1).integers(0, 512, (8, 17)).astype(
        np.int64)
    return host, sd, tokens


def _gpt2_scorer(kit, params, tokens):
    """Prep splits a batch of rows into inputs and next-token labels;
    the scorer returns each row's mean NLL (f32)."""
    rt, dag = kit["rt"], kit["dag"]
    pkg = rt.__name__

    class Prep:
        def split(self, batch):
            return batch[:, :-1], batch[:, 1:]

    class Scorer:
        def __init__(self, params):
            self.params = params
            self.fn = None

        def score(self, xy):
            x, y = xy
            if pkg == "ray_tpu":
                import jax
                import jax.numpy as jnp

                from ray_tpu.models import gpt2 as JG
                if self.fn is None:
                    mj = JG.GPT2(JG.GPT2Config.tiny())
                    self.fn = jax.jit(mj.apply)
                logits = self.fn(self.params, jnp.asarray(x, jnp.int32)
                                 ).astype(jnp.float32)
                lse = jax.nn.logsumexp(logits, axis=-1)
                picked = jnp.take_along_axis(
                    logits, jnp.asarray(y)[..., None], -1)[..., 0]
                return np.asarray((lse - picked).mean(-1), np.float32)
            import torch
            import torch.nn.functional as F

            from ray_tpu_torch.models import gpt2 as TG
            torch.set_num_threads(2)
            if self.fn is None:
                model = TG.GPT2(TG.GPT2Config.tiny())
                model.load_state_dict({k: torch.from_numpy(np.array(v))
                                       for k, v in self.params.items()})
                self.fn = model.eval()
            with torch.inference_mode():
                logits = self.fn(torch.from_numpy(np.array(x))).float()
                nll = F.cross_entropy(logits.transpose(1, 2),
                                      torch.from_numpy(np.array(y)),
                                      reduction="none").mean(-1)
            return nll.numpy().astype(np.float32)

    P, S = rt.remote(Prep), rt.remote(Scorer)
    with dag.InputNode() as inp:
        prep, scorer = P.bind(), S.bind(params)
        d = scorer.score.bind(prep.split.bind(inp))
    cdag = d.compile()
    try:
        return cdag._compiled, np.concatenate(
            [cdag.execute(tokens[s:s + 4], timeout=T)
             for s in range(0, len(tokens), 4)])
    finally:
        cdag.teardown()
        _kill(kit, prep, scorer)


def test_gpt2_scorer_stage_matches_jax(clusters):
    host, sd, tokens = _gpt2_kit()
    # both graphs at once: most of their time is their workers' imports
    pool = concurrent.futures.ThreadPoolExecutor(2)
    try:
        fw = pool.submit(_gpt2_scorer, clusters["ray_tpu"], host, tokens)
        fg = pool.submit(_gpt2_scorer, clusters["ray_tpu_torch"], sd,
                         tokens)
        want, got = fw.result(timeout=90), fg.result(timeout=90)
    finally:
        pool.shutdown(wait=False)
    assert want[0] and got[0]
    assert got[1].shape == (8,) and np.isfinite(got[1]).all()
    np.testing.assert_allclose(got[1], want[1], **GPT2_TOL)
