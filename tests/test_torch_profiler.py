"""The port's device profiler (``util/gpu_profiler.py``) and
``tracing.export_chrome`` against the JAX package's ``util/tpu_profiler.py``
and ``export_chrome``, on the CPU.

The same synthetic captures go through both: loading nested captures,
the rebase to wall-clock, the duration floor and the cap, the per-(host,
process) rows and their crc32 pids above the base (``1 << 24`` on both),
the process-name rows; ``export_chrome`` over the same spans and device
events. The records must be equal. Then the port's own path:
``trace(device="cpu")`` around a matmul writes a ``.pt.trace.json.gz``
and merges its events into this process's timeline, and a task of a
port cluster that traces reaches the driver's ``timeline_dump``;
torch.profiler's rows named by strings keep the merge whole;
``device="cuda"`` raises without CUDA and ``serve`` raises.
"""

import gzip
import json
import os
import time
from unittest import mock

import pytest
import torch

import ray_tpu_torch
from ray_tpu.util import timeline as j_timeline
from ray_tpu.util import tpu_profiler as jp
from ray_tpu._private import tracing as j_tracing
from ray_tpu_torch.util import gpu_profiler as tp
from ray_tpu_torch.util import timeline as t_timeline
from ray_tpu_torch._private import tracing as t_tracing

NODE = "abcdef0123456789"
TIMEOUT_S = 60


def _write_capture(log_dir, rel_path, events):
    path = os.path.join(log_dir, rel_path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _merged(merge, timeline, events, **kw):
    """The records ``merge`` adds to ``timeline``'s buffer: the newest,
    counted by the module's record counter (the buffer is a ring of
    10,000, full when earlier tests in this process recorded tasks)."""
    before = timeline._total_recorded
    n = merge(events, **kw)
    added = timeline._total_recorded - before
    records = timeline.collect()
    return n, records[len(records) - added:]


@pytest.fixture
def same_node():
    with mock.patch.dict(os.environ, {"RTPU_NODE_ID": NODE,
                                      "RTT_NODE_ID": NODE}):
        yield


def test_pid_base_matches_jax():
    assert tp._DEVICE_PID_BASE == jp._XLA_PID_BASE == 1 << 24


def test_load_chrome_events_matches_jax(tmp_path):
    _write_capture(str(tmp_path), "plugins/profile/run1/h1.trace.json.gz",
                   [{"name": "a", "ph": "X", "ts": 10.0, "dur": 5.0,
                     "pid": 1, "tid": 0}])
    _write_capture(str(tmp_path), "h2.1234.pt.trace.json.gz",
                   [{"name": "b", "ph": "X", "ts": 20.0, "dur": 7.0,
                     "pid": 2, "tid": 0}])
    (tmp_path / "notes.json").write_text("{}")
    got = tp.load_chrome_events(str(tmp_path))
    assert got == jp.load_chrome_events(str(tmp_path))
    assert {e["name"] for e in got} == {"a", "b"}
    assert tp.load_chrome_events(str(tmp_path / "empty")) == []


CAPTURES = {
    "rebase_and_floor": ([
        {"name": "big", "ph": "X", "ts": 1000.0, "dur": 100.0, "pid": 7,
         "tid": 3},
        {"name": "later", "ph": "X", "ts": 1500.0, "dur": 50.0, "pid": 7,
         "tid": 3, "args": {"k": 1}},
        {"name": "tiny", "ph": "X", "ts": 1200.0, "dur": 0.5, "pid": 7,
         "tid": 3},
        {"name": "meta", "ph": "M", "ts": 0.0, "pid": 7}],
        dict(wall_start_us=1_700_000_000 * 1e6, label="unit",
             min_dur_us=5.0)),
    "cap_keeps_longest": (
        [{"name": f"s{i}", "ph": "X", "ts": float(i), "dur": float(i + 1),
          "pid": 1, "tid": 0} for i in range(50)],
        dict(wall_start_us=1e15, label="cap", max_events=10,
             min_dur_us=0.0)),
    "rows_per_process": (
        [{"name": "x", "ph": "X", "ts": 1.0, "dur": 10.0, "pid": 11,
          "tid": 2_000_003},
         {"name": "y", "ph": "X", "ts": 2.0, "dur": 10.0, "pid": 22,
          "tid": 0}],
        dict(wall_start_us=0.0, label="rows", min_dur_us=0.0)),
}


@pytest.mark.parametrize("name", sorted(CAPTURES))
def test_merge_into_timeline_matches_jax(same_node, name):
    events, kw = CAPTURES[name]
    n_t, got = _merged(tp.merge_into_timeline, t_timeline, events, **kw)
    n_j, want = _merged(jp.merge_into_timeline, j_timeline, events, **kw)
    assert n_t == n_j and got == want
    assert all(e["pid"] >= tp._DEVICE_PID_BASE for e in got)
    # restart-stable rows: a second merge lands on the same pids
    _, again = _merged(tp.merge_into_timeline, t_timeline, events, **kw)
    assert [e["pid"] for e in again] == [e["pid"] for e in got]


def test_merge_keeps_rows_named_by_strings(same_node):
    """torch.profiler names some rows with strings (its own "Spans"
    process); the merge numbers them by crc32 instead of dropping the
    whole capture."""
    events = [{"name": "PyTorch Profiler (0)", "ph": "X", "ts": 0.0,
               "dur": 50.0, "pid": "Spans", "tid": "PyTorch Profiler"},
              {"name": "aten::mm", "ph": "X", "ts": 5.0, "dur": 20.0,
               "pid": 42, "tid": 42}]
    n, got = _merged(tp.merge_into_timeline, t_timeline, events,
                     wall_start_us=1e15, label="strings", min_dur_us=0.0)
    spans = {e["name"]: e for e in got if e["ph"] == "X"}
    assert n == 2 and set(spans) == {"PyTorch Profiler (0)", "aten::mm"}
    assert spans["PyTorch Profiler (0)"]["pid"] != spans["aten::mm"]["pid"]


def _spans():
    return [{"trace_id": "t1", "span_id": "s1", "name": "predict",
             "kind": "task", "phase": "execute", "start_ts": 100.0,
             "end_ts": 101.0, "pid": 5, "status": "ok"},
            {"trace_id": "t1", "span_id": "s2", "parent_span_id": "s1",
             "name": "batch", "kind": "task", "phase": "execute",
             "start_ts": 100.2, "end_ts": 100.4, "pid": 5,
             "status": "error"}]


def _device_events():
    base = 1 << 24
    return [{"name": "process_name", "ph": "M", "ts": 0, "pid": base + 9,
             "args": {"name": "cuda n p1"}},
            {"name": "whole_fwd_wgmma", "ph": "X", "ts": 100.5e6,
             "dur": 130.0, "pid": base + 9, "tid": 7, "cat": "predict"},
            {"name": "outside", "ph": "X", "ts": 200e6, "dur": 1.0,
             "pid": base + 9, "tid": 7},
            {"name": "task span", "ph": "X", "ts": 100.5e6, "dur": 1.0,
             "pid": 5, "tid": 0},
            {"name": "string pid", "ph": "X", "ts": 100.5e6, "dur": 1.0,
             "pid": "x", "tid": 0}]


def test_export_chrome_matches_jax():
    got = t_tracing.export_chrome(_spans(), _device_events())
    assert got == j_tracing.export_chrome(_spans(), _device_events())
    assert [e["name"] for e in got] == ["predict", "batch", "process_name",
                                        "whole_fwd_wgmma"]
    assert t_tracing.export_chrome([], _device_events()) == []


def test_trace_cpu_writes_and_merges_locally():
    with tp.trace(label="torch-cpu-test", device="cpu") as d:
        x = torch.ones(128, 128)
        for _ in range(3):
            x = x @ x
    assert any(n.endswith(".pt.trace.json.gz")
               for _, _, names in os.walk(d) for n in names)
    assert tp.load_chrome_events(d)
    evs = t_timeline.collect()
    merged = [e for e in evs if e.get("cat") == "torch-cpu-test"]
    assert any(e["name"] == "aten::mm" for e in merged), merged
    assert any(e.get("name") == "process_name"
               and "torch-cpu-test" in str(e.get("args")) for e in evs)
    now_us = time.time() * 1e6
    assert all(abs(e["ts"] - now_us) < 3600e6 for e in merged)
    assert all(e["pid"] >= tp._DEVICE_PID_BASE for e in merged)


def test_trace_cuda_without_cuda_and_serve_raise():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the cuda trace does not raise")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with tp.trace(device="cuda"):
            pass
    with pytest.raises(NotImplementedError, match="trace"):
        tp.serve(9012)


def test_task_trace_reaches_driver_timeline_dump():
    for rt in (ray_tpu_torch,):
        if rt.is_initialized():
            rt.shutdown()
    with mock.patch.dict(os.environ, {"RTT_PRESTART_WORKERS": "0"}):
        ray_tpu_torch.init(num_cpus=2, object_store_memory=64 << 20)
    try:
        @ray_tpu_torch.remote
        def traced_work():
            import torch as th

            from ray_tpu_torch.util import gpu_profiler
            th.set_num_threads(1)
            with gpu_profiler.trace(label="torch-task", device="cpu"):
                float((th.ones(64, 64) @ th.ones(64, 64)).sum())
            return os.getpid()

        pid = ray_tpu_torch.get(traced_work.remote(), timeout=TIMEOUT_S)
        deadline = time.time() + 15
        merged = []
        while time.time() < deadline:
            merged = [e for e in ray_tpu_torch.timeline()
                      if e.get("cat") == "torch-task"]
            if merged:
                break
            time.sleep(0.5)
        assert merged, "the task's capture did not reach the merged dump"
        assert any(e["name"] == "aten::mm" for e in merged)
        names = [e for e in ray_tpu_torch.timeline()
                 if e.get("name") == "process_name"
                 and f"p{pid}" in str(e.get("args"))]
        assert names, "the task's process row is not labelled"
    finally:
        ray_tpu_torch.shutdown()
        t_timeline.stop_flusher()
