"""The port's LLM server on its serve control plane, on the CPU.

One port cluster (``init(num_cpus=4, num_gpus=1)``: a fake GPU count,
as ``tests/test_torch_runtime_gpus.py`` uses) holds every deployment of
this file:

- toy ``LLMServer`` deployments (``tests/test_llm_serving.py``'s
  scenarios): a handle stream equals the unary result; SSE through the
  HTTP proxy delivers its first event before ``[DONE]`` and a unary
  POST gives the stream's tokens; a rolling update lands mid-stream and
  every stream finishes whole on the draining replicas, whose token
  ledgers can be read back through ``gameday/store``;
- GPT-2 at 2 layers, width 64, f32, in ``device="cpu"`` replicas whose
  params come from the JAX model: the unified replica's greedy tokens
  for 4 prompts equal the JAX ``LLMServer``'s, run in this process on
  the same params; with ``llm_roles={"prefill": 1, "decode": 2}`` the
  router's two-hop admission ships every prompt's KV on the ``plasmax``
  lane (frames of 72-120 KB, past the inline limit), the streams equal
  the unified ones and no replica keeps a page
  (``tests/test_llm_fleet.py:517``); with the ``llm.kv_ship`` chaos
  site dropping, corrupting and resetting handoffs on the decode
  replicas, each faulted admission re-prefills to the same tokens
  (``tests/test_llm_fleet.py:538``);
- an ``LLMServer`` on ``cuda`` in a replica without a GPU grant raises
  at construction, naming the grant.

Every ``get`` and stream read carries a timeout.
"""

import http.client
import json
import os
import time
import urllib.request
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.serve.llm import LLMServer as JLLMServer

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.actor import get_actor_by_id
from ray_tpu_torch.gameday import store
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.serve.llm import LLMServer

TOY_ENGINE = {"num_blocks": 128, "block_size": 8, "max_seq_len": 256}
GPT2_ENGINE = {"num_blocks": 128, "block_size": 8, "max_seq_len": 256,
               "max_running": 4}
NEW_TOKENS = 8
# 2 layers x (k, v) x 64 f32 = 1 KB of KV a token: every prompt's frame
# is past the shipper's 64 KB inline limit and inside an 8 MB slot
PROMPT_LENS = (72, 90, 105, 120)


@pytest.fixture(scope="module")
def cluster():
    if rt.is_initialized():
        rt.shutdown()
    # replicas inherit the raylet's environment: two torch threads each
    env = {"RTT_PRESTART_WORKERS": "0", "OMP_NUM_THREADS": "2"}
    with mock.patch.dict(os.environ, env):
        rt.init(num_cpus=4, num_gpus=1,
                object_store_memory=256 * 1024 * 1024)
    try:
        yield
    finally:
        serve.shutdown()
        rt.shutdown()


def _deploy(cls, name, args, http_port=None, **kw):
    dep = serve.deployment(name=name, **kw)(cls)
    return serve.run(dep.bind(*args), name=name, route_prefix=f"/{name}",
                     http_port=http_port, _blocking_timeout=120.0)


def _stream_tokens(h, payload, **kw):
    return [t for ch in h.stream(payload, **kw) for t in ch["tokens"]]


def _proxy_port():
    return rt.get(rt.get_actor("SERVE_PROXY").get_port.remote(),
                  timeout=30)


def _replicas(name):
    ctrl = rt.get_actor("SERVE_CONTROLLER")
    _, table = rt.get(ctrl.get_route_table.remote(), timeout=30)
    return table[name]


def _call(replica_hex, method, *args):
    return rt.get(get_actor_by_id(replica_hex).handle_request.remote(
        method, args, {}), timeout=60)


# ------------------------------------------------------------ toy model

def test_toy_stream_equals_unary_and_sse(cluster):
    """test_llm_serving.py:321 and :343."""
    h = _deploy(LLMServer, "llmsse", ("toy", {"per_seq_delay_s": 0.02},
                                      TOY_ENGINE),
                http_port=8917, num_replicas=1, max_concurrent_queries=16)
    payload = {"prompt": "the quick brown fox", "max_new_tokens": 10}
    unary = rt.get(h.remote(payload), timeout=60)
    assert unary["n_tokens"] == 10
    chunks, stamps = [], []
    for ch in h.stream(payload):
        chunks.append(ch)
        stamps.append(time.time())
    assert [t for c in chunks for t in c["tokens"]] == unary["tokens"]
    assert chunks[-1]["done"] and chunks[-1]["finish_reason"] == "length"
    assert len(chunks) >= 3 and stamps[0] < stamps[-1] - 0.05

    port = _proxy_port()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/llmsse", json.dumps({**payload, "stream": True}),
                 {"Content-Type": "application/json",
                  "X-Request-Id": "sse-1"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    assert resp.getheader("X-Request-Id") == "sse-1"
    events, times, done_at = [], [], None
    while True:
        line = resp.fp.readline()
        if not line:
            break
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        if line[6:] == b"[DONE]":
            done_at = time.time()
            break
        events.append(json.loads(line[6:]))
        times.append(time.time())
    conn.close()
    toks = [t for e in events for t in e.get("tokens", [])]
    assert toks == unary["tokens"]
    assert events[-1].get("done") and not events[-1].get("error")
    assert done_at is not None and len(events) >= 3
    assert times[0] < done_at - 0.05
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/llmsse", json.dumps(payload).encode(),
        {"Content-Type": "application/json"})
    assert json.loads(urllib.request.urlopen(req, timeout=60).read())[
        "tokens"] == toks
    serve.delete_application("llmsse")


def test_rolling_update_drains_kv_and_flushes_ledger(cluster):
    """test_llm_serving.py:398: streams in flight when a rolling update
    lands finish whole on the draining replicas; those replicas flush
    their token ledgers (``__serve_prepare_shutdown__``) where
    ``gameday/store`` reads them back."""
    import threading
    name = "llmroll"
    args = ("toy", {"per_seq_delay_s": 0.03}, TOY_ENGINE)
    kw = dict(num_replicas=2, max_concurrent_queries=32,
              graceful_shutdown_timeout_s=60.0)
    h = _deploy(LLMServer, name, args, user_config={"v": 1}, **kw)
    n_tok = 60
    streams = [h.stream({"tokens": [i + 1, i + 2, i + 3],
                         "max_new_tokens": n_tok},
                        request_id=f"roll-{i}") for i in range(4)]
    results, errors = {}, []

    def consume(i, st):
        try:
            results[i] = ([t for ch in st for t in ch["tokens"]],
                          st.finish_reason)
        except Exception as e:  # noqa: BLE001 - the assertion target
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=consume, args=(i, st))
               for i, st in enumerate(streams)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    _deploy(LLMServer, name, args, user_config={"v": 2}, **kw)
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert sorted(results) == [0, 1, 2, 3]
    assert all(len(toks) == n_tok and reason == "length"
               for toks, reason in results.values()), results
    out = rt.get(h.remote({"tokens": [9, 9], "max_new_tokens": 2}),
                 timeout=60)
    assert out["n_tokens"] == 2
    # the retired replicas' ledgers: one row a stream, every token
    deadline, rows = time.time() + 60, {}
    while time.time() < deadline:
        rows = {r[0]: r for led in store.load_flushed_llm_ledgers()
                for r in led["records"] if str(r[0]).startswith("roll-")}
        if len(rows) == 4:
            break
        time.sleep(0.5)
    assert sorted(rows) == [f"roll-{i}" for i in range(4)], rows
    assert all(r[1] == n_tok and r[2] == "length" for r in rows.values())
    serve.delete_application(name)


# -------------------------------------------------- GPT-2 from JAX params

JCFG = jgpt2.GPT2Config(vocab_size=512, n_positions=256, n_embd=64,
                        n_layer=2, n_head=4, dtype=jnp.float32,
                        attention_backend="reference")
TCFG = tgpt2.GPT2Config(vocab_size=512, n_positions=256, n_embd=64,
                        n_layer=2, n_head=4,
                        dtype=torch.float32,
                        attention_backend="reference")


def _recording_server():
    """An ``LLMServer`` that records each handoff's lane and outcome and
    can arm the chaos plane in its own process. Defined in a function
    so it travels to the replicas by value (they cannot import this
    module)."""
    class Recording(LLMServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.handoffs = []

        def __llm_adopt__(self, handoff=None, __rtpu_request_id__=None):
            out = super().__llm_adopt__(
                handoff, __rtpu_request_id__=__rtpu_request_id__)
            kv = (handoff or {}).get("kv") or {}
            self.handoffs.append((kv.get("lane"), out["adopted"]))
            return out

        def recorded(self):
            from ray_tpu_torch._private import chaos
            eng = chaos.engine()
            return {"handoffs": list(self.handoffs),
                    "fired": [f["op"] for f in eng.fired] if eng else [],
                    "pages": self.engine.metrics()["kv_blocks_used"],
                    "reasons": sorted({r[2] for r in
                                       self.engine.token_ledger()})}

        def arm_chaos(self, schedule):
            from ray_tpu_torch._private import chaos
            chaos.configure(seed=31, schedule=schedule)
            self.handoffs = []
            return "ok"

    return Recording


@pytest.fixture(scope="module")
def gpt2_fleet(cluster):
    """JAX params for the 2-layer width-64 GPT-2, the JAX server's
    greedy tokens for each prompt alone (in this process), and two
    deployments on those params: ``u`` (one unified replica) and ``d``
    (three replicas, ``llm_roles={"prefill": 1, "decode": 2}``)."""
    model = jgpt2.GPT2(JCFG)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, JCFG.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    jserver = JLLMServer("gpt2", {"config": JCFG, "params": params},
                         GPT2_ENGINE)
    try:
        want = [jserver({"tokens": p, "max_new_tokens": NEW_TOKENS})[
            "tokens"] for p in prompts]
    finally:
        jserver.engine.stop()
    mcfg = {"config": TCFG, "params": params, "device": "cpu"}
    rec = _recording_server()
    hu = _deploy(LLMServer, "u", ("gpt2", mcfg, GPT2_ENGINE),
                 num_replicas=1, max_concurrent_queries=16)
    hd = _deploy(rec, "d", ("gpt2", mcfg, GPT2_ENGINE), num_replicas=3,
                 llm_roles={"prefill": 1, "decode": 2},
                 max_concurrent_queries=16)
    yield {"prompts": prompts, "jax_tokens": want, "u": hu, "d": hd}
    serve.delete_application("u")
    serve.delete_application("d")


def _payload(p):
    return {"tokens": p, "max_new_tokens": NEW_TOKENS}


def test_gpt2_replica_matches_jax_server(gpt2_fleet):
    """The slice end to end: GPT-2 in a ``device="cpu"`` replica on the
    JAX model's params gives the JAX ``LLMServer``'s greedy tokens for
    each prompt, unary and streamed (exact: f32, one row a step on both
    sides)."""
    f = gpt2_fleet
    got = [rt.get(f["u"].remote(_payload(p)), timeout=120)["tokens"]
           for p in f["prompts"]]
    assert got == f["jax_tokens"]
    assert [_stream_tokens(f["u"], _payload(p)) for p in f["prompts"]] \
        == f["jax_tokens"]


def test_two_hop_on_plasmax_matches_unified(gpt2_fleet):
    """test_llm_fleet.py:517: roles in the route table, every admission
    prefill -> decode with its KV on the plasmax ring, streams equal to
    the unified deployment's, 0 pages used anywhere afterwards."""
    f = gpt2_fleet
    info = _replicas("d")
    roles = info.get("replica_roles") or {}
    assert sorted(roles.values()) == ["decode", "decode", "prefill"]
    for hx in roles:
        _call(hx, "arm_chaos", [])
    got = [_stream_tokens(f["d"], _payload(p), request_id=f"r{i}")
           for i, p in enumerate(f["prompts"])]
    assert got == [_stream_tokens(f["u"], _payload(p))
                   for p in f["prompts"]] == f["jax_tokens"]
    rec = {role + ":" + hx: _call(hx, "recorded")
           for hx, role in roles.items()}
    handoffs = [h for k, r in rec.items() if k.startswith("decode")
                for h in r["handoffs"]]
    assert handoffs == [("plasmax", True)] * len(f["prompts"]), rec
    assert all(r["pages"] == 0 for r in rec.values()), rec
    assert any("handoff" in r["reasons"] for k, r in rec.items()
               if k.startswith("prefill")), rec
    assert _call(_replicas("u")["replicas"][0], "__llm_metrics__")[
        "kv_blocks_used"] == 0


def test_kv_ship_chaos_falls_back_to_reprefill(gpt2_fleet):
    """test_llm_fleet.py:538: on each decode replica the first three
    handoffs it receives are dropped, corrupted and reset mid-flight;
    each of those re-prefills on the decode replica to the same tokens,
    and no page leaks."""
    f = gpt2_fleet
    roles = _replicas("d")["replica_roles"]
    schedule = [{"site": "llm.kv_ship", "op": op, "at": 1}
                for op in ("drop", "corrupt", "reset")]
    for hx, role in roles.items():
        _call(hx, "arm_chaos", schedule if role == "decode" else [])
    prompts = f["prompts"] + f["prompts"][:2]   # 6 handoffs on 2 replicas
    want = f["jax_tokens"] + f["jax_tokens"][:2]
    got = [_stream_tokens(f["d"], _payload(p), request_id=f"c{i}")
           for i, p in enumerate(prompts)]
    assert got == want
    rec = [_call(hx, "recorded") for hx in roles]
    fired = [op for r in rec for op in r["fired"]]
    handoffs = [h for r in rec for h in r["handoffs"]]
    assert set(fired) == {"drop", "corrupt", "reset"}, rec
    assert len(handoffs) == len(prompts)
    assert sum(not adopted for _, adopted in handoffs) == len(fired), rec
    assert all(r["pages"] == 0 for r in rec), rec
    for hx in roles:
        _call(hx, "arm_chaos", [])


# ------------------------------------------------------------ GPU grant

@pytest.mark.parametrize("num_gpus, match", [
    (0, "no GPU grant"), (1, "CUDA is not available")],
    ids=["no_grant", "granted_without_cuda"])
def test_cuda_server_needs_a_gpu_grant(cluster, num_gpus, match):
    """A replica built with ``device`` cuda raises at construction: with
    no grant (``CUDA_VISIBLE_DEVICES=""``) naming the grant; with one
    (the fake count's index 0) only because this box has no CUDA."""
    import cloudpickle
    from ray_tpu_torch.serve._private.replica import ReplicaActor
    actor = rt.remote(num_gpus=num_gpus)(ReplicaActor).remote(
        "grant", cloudpickle.dumps(LLMServer),
        ("gpt2", {"config": TCFG, "seed": 0}), {})
    try:
        with pytest.raises(Exception, match=match):
            rt.get(actor.check_health.remote(), timeout=120)
    finally:
        rt.kill(actor)
