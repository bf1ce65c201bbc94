"""Control-plane microbenchmarks: tasks/s, actor calls/s, put/get throughput.

Role-equivalent to the reference's microbenchmark suite
(reference: python/ray/_private/ray_perf.py:93 and
ray_microbenchmark_helpers.py timeit) — the numbers that justify (or refute)
running the L1 runtime as Python asyncio processes instead of C++ on a GPU
host. A GPU host runs O(1-8) model workers whose step time is 10-100 ms;
the control plane only has to stay far off the critical path at that scale.

Run: ``python -m ray_tpu_torch._private.ray_perf [--json out.json]``

``--breakdown`` reports per-roundtrip PHASE attribution for the unary
sync path instead of one throughput number: each round trip is split
into wire / dispatch / execute / reply using the task-event phase
timestamps the state engine records (docs/OBSERVABILITY.md,
docs/TRACING.md) plus client-side clocks.  This is how a change to the
RPC plane (e.g. the native frame pump) is graded as a histogram, not a
single mean.

Copied from the JAX package's ``ray_tpu/_private/ray_perf.py`` (imports
renamed to ``ray_tpu_torch``). Differences: ``main`` and ``breakdown``
shut down only a cluster they started themselves (JAX's always shut the
driver's down), so they can run inside a driver's session; the
breakdown's ``native_rpc`` says whether the port's native frame pump is
loaded (the port has no switch for it: it falls back to the Python pump
only when ``g++`` cannot build the library).
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


def timeit(name: str, fn: Callable[[], None], multiplier: float = 1,
           reps: int = 3, window_s: float = 1.0,
           ) -> Tuple[str, float, float]:
    """Measure fn() calls/s over `reps` windows; returns (name, mean, sd)."""
    # warmup: run for ~0.3 s
    start = time.perf_counter()
    while time.perf_counter() - start < 0.3:
        fn()
    rates: List[float] = []
    for _ in range(reps):
        count = 0
        start = time.perf_counter()
        while time.perf_counter() - start < window_s:
            fn()
            count += 1
        rates.append(multiplier * count / (time.perf_counter() - start))
    mean = statistics.fmean(rates)
    sd = statistics.pstdev(rates)
    print(f"{name}: {mean:,.1f} /s (+- {sd:,.1f})")
    return (name, mean, sd)


def main(json_path: Optional[str] = None) -> Dict[str, float]:
    import ray_tpu_torch

    started = not ray_tpu_torch.is_initialized()
    ray_tpu_torch.init(ignore_reinit_error=True)
    results: List[Tuple[str, float, float]] = []

    # ------------------------------------------------------- object plane
    value = ray_tpu_torch.put(0)

    results.append(timeit("get small (inline)",
                          lambda: ray_tpu_torch.get(value)))
    results.append(timeit("put small (inline)", lambda: ray_tpu_torch.put(0)))

    arr = np.zeros(100 * 1024 * 1024, dtype=np.int64)  # 800 MB

    def put_large():
        ref = ray_tpu_torch.put(arr)
        del ref

    gb = arr.nbytes / 1e9
    results.append(timeit("put gigabytes (plasma GB/s)", put_large,
                          multiplier=gb, reps=2))
    big = ray_tpu_torch.put(arr)

    def get_large():
        v = ray_tpu_torch.get(big)
        del v

    results.append(timeit("get 800MB zero-copy (gets/s)", get_large, reps=2))

    # -------------------------------------------------------------- tasks
    @ray_tpu_torch.remote
    def small_value():
        return b"ok"

    results.append(timeit(
        "tasks sync (round-trips/s)",
        lambda: ray_tpu_torch.get(small_value.remote())))

    def task_batch():
        ray_tpu_torch.get([small_value.remote() for _ in range(200)])

    results.append(timeit("tasks async (tasks/s)", task_batch,
                          multiplier=200, reps=2, window_s=2.0))

    # ------------------------------------------------------------- actors
    @ray_tpu_torch.remote
    class Responder:
        def ping(self):
            return b"ok"

    a = Responder.remote()
    ray_tpu_torch.get(a.ping.remote())  # wait for creation

    results.append(timeit(
        "actor calls sync (round-trips/s)",
        lambda: ray_tpu_torch.get(a.ping.remote())))

    def actor_batch():
        ray_tpu_torch.get([a.ping.remote() for _ in range(200)])

    results.append(timeit("actor calls async (calls/s)", actor_batch,
                          multiplier=200, reps=2, window_s=2.0))

    c = Responder.options(max_concurrency=16).remote()
    ray_tpu_torch.get(c.ping.remote())

    def actor_concurrent():
        ray_tpu_torch.get([c.ping.remote() for _ in range(200)])

    results.append(timeit("actor calls concurrent (calls/s)",
                          actor_concurrent, multiplier=200, reps=2,
                          window_s=2.0))

    # --------------------------------------------------------------- wait
    refs = [small_value.remote() for _ in range(100)]
    ray_tpu_torch.get(refs)

    results.append(timeit(
        "wait on 100 ready refs (waits/s)",
        lambda: ray_tpu_torch.wait(refs, num_returns=100, timeout=10)))

    # ------------------------------------------------- compiled actor DAGs
    # 3-stage pipeline, compiled vs dynamic (amortized dispatch for
    # static topologies; docs/COMPILED_DAGS.md)
    @ray_tpu_torch.remote
    class Stage:
        def step(self, x):
            return x

    from ray_tpu_torch.dag import InputNode
    with InputNode() as inp:
        s1, s2, s3 = Stage.bind(), Stage.bind(), Stage.bind()
        pipe = s3.step.bind(s2.step.bind(s1.step.bind(inp)))

    ray_tpu_torch.get(pipe.execute(0))  # create the actors before timing

    results.append(timeit(
        "3-stage pipeline dynamic (execs/s)",
        lambda: ray_tpu_torch.get(pipe.execute(0))))

    cpipe = pipe.compile()
    if cpipe._compiled:
        results.append(timeit(
            "3-stage pipeline compiled (execs/s)",
            lambda: cpipe.execute(0)))

        def pipelined_batch():
            futs = [cpipe.execute_async(0) for _ in range(100)]
            for f in futs:
                f.result(30)

        results.append(timeit(
            "3-stage pipeline compiled pipelined (execs/s)",
            pipelined_batch, multiplier=100, reps=2, window_s=2.0))
    cpipe.teardown()

    if started:
        ray_tpu_torch.shutdown()

    summary = {name: mean for name, mean, _ in results}
    if json_path:
        with open(json_path, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


def breakdown(n: int = 400, json_path: Optional[str] = None
              ) -> Dict[str, Dict[str, float]]:
    """Per-roundtrip phase attribution for unary sync tasks.

    Phases (wall-clock, one host — client clocks and the task table's
    per-state stamps share a clock):

    - ``wire``:     client submit entry -> PENDING_SCHEDULING stamp
                    (owner-side submit bookkeeping: serialize + spec)
    - ``dispatch``: PENDING_SCHEDULING -> RUNNING (frame encode, the
                    send/recv path, worker wakeup + decode)
    - ``execute``:  RUNNING -> FINISHED (user fn + return shipping)
    - ``reply``:    FINISHED -> client get() return (reply frame,
                    owner-side result store, getter wakeup +
                    deserialize)
    """
    import ray_tpu_torch
    from ray_tpu_torch.experimental.state import api as state_api

    started = not ray_tpu_torch.is_initialized()
    ray_tpu_torch.init(ignore_reinit_error=True)

    @ray_tpu_torch.remote
    def small_value():
        return b"ok"

    for _ in range(100):  # warm the lease/lane + function cache
        ray_tpu_torch.get(small_value.remote())

    samples = []
    for _ in range(n):
        t0 = time.time()
        ref = small_value.remote()
        ray_tpu_torch.get(ref)
        t1 = time.time()
        samples.append((ref.id().task_id().hex(), t0, t1))
    time.sleep(1.5)  # let the task-event flush tick ship the stamps

    recs = {r["task_id"]: r for r in state_api.list_tasks(limit=10 * n)}
    phases: Dict[str, List[float]] = {
        "wire": [], "dispatch": [], "execute": [], "reply": [],
        "total": []}
    missing = 0
    for tid, t0, t1 in samples:
        st = (recs.get(tid) or {}).get("state_ts") or {}
        if not all(k in st for k in ("PENDING_SCHEDULING", "RUNNING",
                                     "FINISHED")):
            missing += 1
            continue
        phases["wire"].append(st["PENDING_SCHEDULING"] - t0)
        phases["dispatch"].append(st["RUNNING"] - st["PENDING_SCHEDULING"])
        phases["execute"].append(st["FINISHED"] - st["RUNNING"])
        phases["reply"].append(t1 - st["FINISHED"])
        phases["total"].append(t1 - t0)
    if started:
        ray_tpu_torch.shutdown()

    def _q(v: List[float], q: float) -> float:
        s = sorted(v)
        return s[min(len(s) - 1, int(q * len(s)))]

    out: Dict[str, Dict[str, float]] = {}
    from ray_tpu_torch._private import rpccore
    native = rpccore.available()
    print(f"unary sync phase breakdown ({len(phases['total'])} samples, "
          f"{missing} missing stamps, native_rpc={'on' if native else 'off'})")
    print(f"{'phase':10s} {'p50':>9s} {'p90':>9s} {'p99':>9s} {'mean':>9s}")
    for k, v in phases.items():
        if not v:
            continue
        row = {"p50_us": _q(v, 0.5) * 1e6, "p90_us": _q(v, 0.9) * 1e6,
               "p99_us": _q(v, 0.99) * 1e6,
               "mean_us": statistics.fmean(v) * 1e6}
        out[k] = {kk: round(vv, 1) for kk, vv in row.items()}
        print(f"{k:10s} {row['p50_us']:8.0f}u {row['p90_us']:8.0f}u "
              f"{row['p99_us']:8.0f}u {row['mean_us']:8.0f}u")
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    out = None
    if "--json" in sys.argv:
        out = sys.argv[sys.argv.index("--json") + 1]
    if "--breakdown" in sys.argv:
        n = 400
        if "--n" in sys.argv:
            n = int(sys.argv[sys.argv.index("--n") + 1])
        breakdown(n, out)
    else:
        main(out)
