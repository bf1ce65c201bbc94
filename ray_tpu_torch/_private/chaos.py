"""Chaos engine: seeded, deterministic fault injection for the control plane.

The recovery machinery (task retries, lineage reconstruction, liveness
beats, gang restart from committed checkpoints) is only as trustworthy as
the faults it has been exercised against.  This module is the single
place faults come from: every injection point in the runtime asks
``chaos.hit(site, ...)`` on its hot path (a no-op attribute check when
chaos is off) and the engine decides — deterministically — whether a
fault fires there.

Two trigger modes, combinable:

* **Schedules** — explicit fault specs that fire on the N-th matching
  hit of a site (optionally: only after ``after_s`` seconds, every
  ``every`` hits, at most ``max_fires`` times).  This is the replayable
  mode: the same schedule against the same workload fires the same
  faults at the same points.
* **Probabilities** — per-``site[.op]`` firing probabilities drawn from
  a ``random.Random`` seeded per (seed, site, op).  The *decision
  sequence* per site is a pure function of the seed: the k-th hit of a
  site always gets the same draw for a given seed (soak mode).

Configuration reaches every process through the ``RTT_CHAOS`` env var
(inherited by the GCS, raylets and workers at spawn): either a bare
integer seed, or JSON::

    RTT_CHAOS='{"seed": 7,
                 "schedule": [{"site": "raylet.dispatch", "op": "kill_worker",
                               "at": 3, "proc": "raylet", "head": false}],
                 "p": {"protocol.send.delay": 0.01},
                 "delay_s": 0.05}'

Spec filters: ``proc`` (role: driver/worker/raylet/gcs), ``head``
(raylet head-ness), ``method`` (the site's method/context string).
The sites wired through the runtime are *declared* in :data:`SITES`
below — the one authoritative table (rtpulint RTPU004 rejects any
``chaos.hit(...)`` whose site isn't in it, the registry round-trip in
``tests/test_static_analysis.py`` requires every declared site to be
exercised by the test tree, and ``python -m ray_tpu_torch.analysis
--gen-docs`` renders it into docs/FAULT_TOLERANCE.md).

Every fired fault is appended to the chaos log (``RTT_CHAOS_LOG`` path;
JSONL of ``{n, site, op, method, seq, ts}`` — everything except ``ts``
is deterministic, so two runs of the same seed+schedule compare equal
once ``ts`` is projected away; ``ts`` is written synchronously even for
self-kill ops, which is what benches compute detect latency from) and
shipped to the GCS event ring as a ``CHAOS_INJECT`` structured event
when the host process installed a notifier, so fault→detect→recover
latency is measurable from one event stream.
"""

from __future__ import annotations

import json
import os
import random
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# ops the engine executes itself (process-generic); everything else is
# returned to the caller, which owns the op's semantics at that site
_SELF_KILL_OPS = ("kill",)

# The declared injection-site registry: site -> {"ops": [...],
# "where": one-line description of the code path that calls
# ``chaos.hit(site)`` and what each op does there}. Adding a
# ``chaos.hit`` call REQUIRES a row here (rtpulint RTPU004), and every
# row must be exercised by tests/ (the RTPU004 round-trip) — an
# undeclared site is a typo that silently never fires; an unexercised
# one is a fault path that ships untested. docs/FAULT_TOLERANCE.md's
# site table is rendered from this dict, never hand-edited.
SITES: Dict[str, Dict[str, Any]] = {
    "protocol.send": {
        "ops": ["drop", "delay", "dup", "reset"],
        "where": ("every framed message, BOTH wire implementations — "
                  "the asyncio `Connection` loops (protocol.py) and "
                  "the native frame pump's direct-execution lane "
                  "(direct.py) hit the site at the frame boundary with "
                  "identical semantics, so one seeded schedule replays "
                  "against either (`method` filter available)"),
    },
    "protocol.recv": {
        "ops": ["drop", "delay", "dup", "reset"],
        "where": ("receive side of the same frame boundary, both wire "
                  "implementations (`method` filter available)"),
    },
    "rpc.request": {
        "ops": ["kill"],
        "where": ("every served request, any process — SIGKILL self "
                  "before the handler runs"),
    },
    "worker.execute": {
        "ops": ["kill"],
        "where": ("the N-th task a worker starts executing (`method` "
                  "filter = function name)"),
    },
    "raylet.dispatch": {
        "ops": ["kill_worker", "kill", "preempt"],
        "where": ("the N-th task a raylet dispatches: `kill_worker` "
                  "SIGKILLs the target worker, `kill` the raylet "
                  "itself, `preempt` starts a graceful drain "
                  "(`grace_s`)"),
    },
    "object.pull": {
        "ops": ["evict", "corrupt"],
        "where": ("a pull about to be served: `evict` drops the "
                  "primary copy + directory entry, `corrupt` flips "
                  "bytes (caught by the pull crc)"),
    },
    "serve.controller.tick": {
        "ops": ["kill"],
        "where": ("the N-th serve control-loop tick — SIGKILL the "
                  "controller; the GCS restarts it and it recovers "
                  "from the journal (docs/SERVE_HA.md)"),
    },
    "serve.replica.request": {
        "ops": ["kill"],
        "where": ("the N-th request a serve replica accepts (`method` "
                  "filter = deployment name)"),
    },
    "dag.channel": {
        "ops": ["kill", "reset", "drop", "delay"],
        "where": ("compiled-DAG channel frames (dag/channel.py): "
                  "`kill` SIGKILLs the stage worker mid-graph, "
                  "`reset` severs the peer channel, `drop`/`delay` "
                  "lose/stall one frame (`method` filter = frame "
                  "method, dag_exec / dag_result)"),
    },
    "dag.stage": {
        "ops": ["kill"],
        "where": ("the worker hosting one specific compiled-DAG stage "
                  "at its N-th execution (`method` filter = the stage "
                  "id as a string)"),
    },
    "net.partition": {
        "ops": ["partition"],
        "where": ("every cross-node frame send — the netx "
                  "client/server lanes, the direct-execution lane and "
                  "the asyncio "
                  "`Connection` writer all consult the site before "
                  "writing: while a spec matches, frames from this "
                  "node toward the target host are dropped and the "
                  "connection severed (ONE direction of the pair; the "
                  "reverse stays up). `method` filter = "
                  "`<src_ip>><dst_ip>` so a schedule names the "
                  "direction; combine with `until_s` for a partition "
                  "that heals after a window, exercising "
                  "reconnect/backoff + fallback with no lost or "
                  "duplicated invocation"),
    },
    "llm.kv_ship": {
        "ops": ["drop", "delay", "reset", "corrupt"],
        "where": ("disaggregated LLM serving's prefill→decode KV "
                  "handoff (serve/llm/disagg.py), receive side "
                  "mid-handoff: `drop` loses the frame, `corrupt` "
                  "flips a byte so the CRC rejects it, `reset` raises "
                  "KVShipError — every op degrades to a decode-side "
                  "re-prefill with no leaked KV pages (`method` "
                  "filter = __llm_adopt__)"),
    },
}


class FaultSpec:
    """One schedule entry. Owns its own hit counter so two entries on
    the same site (e.g. different method filters) count independently —
    entry order in the schedule never changes what fires."""

    __slots__ = ("site", "op", "at", "every", "max_fires", "proc", "head",
                 "method", "args", "n", "fires")

    def __init__(self, spec: Dict[str, Any]):
        self.site = spec["site"]
        self.op = spec["op"]
        self.at = int(spec.get("at", 1))
        self.every = int(spec.get("every", 0))
        self.max_fires = int(spec.get("max_fires", 1))
        self.proc = spec.get("proc")
        self.head = spec.get("head")
        self.method = spec.get("method")
        self.args = {k: v for k, v in spec.items()
                     if k not in ("site", "op", "at", "every", "max_fires",
                                  "proc", "head", "method")}
        self.n = 0       # matching hits seen
        self.fires = 0   # times fired

    def matches(self, role: str, is_head: Optional[bool],
                method: Optional[str]) -> bool:
        if self.proc is not None and self.proc != role:
            return False
        if self.head is not None and is_head is not None \
                and bool(self.head) != bool(is_head):
            return False
        if self.method is not None and method != self.method:
            return False
        return True

    def should_fire(self, elapsed_s: float) -> bool:
        if self.max_fires and self.fires >= self.max_fires:
            return False
        after = self.args.get("after_s")
        if after is not None and elapsed_s < float(after):
            return False
        # a sustained fault with `until_s` heals itself: past the
        # window the spec stops firing even with max_fires=0 — how a
        # partition "ends" without any process coordinating the repair
        until = self.args.get("until_s")
        if until is not None and elapsed_s >= float(until):
            return False
        if self.n == self.at:
            return True
        if self.every > 0 and self.n > self.at \
                and (self.n - self.at) % self.every == 0:
            return True
        return False


class ChaosEngine:
    def __init__(self, seed: int = 0,
                 schedule: Optional[List[Dict[str, Any]]] = None,
                 probs: Optional[Dict[str, float]] = None,
                 role: str = "driver", is_head: Optional[bool] = None,
                 log_path: Optional[str] = None,
                 delay_s: float = 0.05):
        self.seed = int(seed)
        self.schedule = [FaultSpec(s) for s in (schedule or [])]
        self.probs = dict(probs or {})
        self.role = role
        self.is_head = is_head
        self.log_path = log_path
        self.delay_s = float(delay_s)  # default for delay ops without args
        self.start = time.monotonic()
        self.fired: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._rngs: Dict[str, random.Random] = {}
        self._prob_hits: Dict[str, int] = {}
        self._notifier: Optional[Callable[[Dict[str, Any]], None]] = None
        self._fire_seq = 0

    # ----------------------------------------------------------- decisions

    def _rng(self, key: str) -> random.Random:
        rng = self._rngs.get(key)
        if rng is None:
            # derive per-(seed, key) so one site's draw count never
            # perturbs another site's sequence
            rng = random.Random(f"{self.seed}:{key}")
            self._rngs[key] = rng
        return rng

    def hit(self, site: str, method: Optional[str] = None
            ) -> Optional[Dict[str, Any]]:
        """Record one hit of ``site``; return the action to inject (an
        op + args dict) or None. At most one action per hit."""
        with self._lock:
            elapsed = time.monotonic() - self.start
            for spec in self.schedule:
                if spec.site != site or \
                        not spec.matches(self.role, self.is_head, method):
                    continue
                spec.n += 1
                if spec.should_fire(elapsed):
                    spec.fires += 1
                    action = {"op": spec.op, "site": site,
                              "method": method, **spec.args}
                    self._record(action, spec.n)
                    return self._execute_generic(action)
            # probabilistic mode: keys "site.op" or "site.method.op"
            for key, p in self.probs.items():
                ksite, _, kop = key.rpartition(".")
                if ksite != site and not (
                        method is not None
                        and ksite == f"{site}.{method}"):
                    continue
                n = self._prob_hits.get(key, 0) + 1
                self._prob_hits[key] = n
                if self._rng(key).random() < float(p):
                    action = {"op": kop, "site": site, "method": method}
                    self._record(action, n)
                    return self._execute_generic(action)
        return None

    # ------------------------------------------------------------ plumbing

    def _record(self, action: Dict[str, Any], n: int):
        self._fire_seq += 1
        rec = {"n": n, "site": action["site"], "op": action["op"],
               "method": action.get("method"), "seq": self._fire_seq}
        self.fired.append(rec)
        if self.log_path:
            try:
                with open(self.log_path, "a") as f:
                    # ts is the ONE non-deterministic field (benches
                    # compute detect latency from it — the synchronous
                    # append survives even a self-SIGKILL op); replay
                    # comparisons project it away
                    json.dump({**rec, "ts": time.time()}, f,
                              sort_keys=True)
                    f.write("\n")
            except OSError:
                pass
        notifier = self._notifier
        if notifier is not None:
            try:
                from ray_tpu_torch.util import events as ev
                notifier(ev.make_event(
                    "WARNING", "CHAOS_INJECT",
                    f"chaos fault {action['op']} at {action['site']} "
                    f"(hit {n})", **{k: v for k, v in rec.items()
                                     if v is not None}))
            except Exception:
                pass

    def _execute_generic(self, action: Dict[str, Any]
                         ) -> Optional[Dict[str, Any]]:
        """Execute process-generic ops inline; return site-specific ones
        to the caller."""
        if action["op"] in _SELF_KILL_OPS:
            # SIGKILL self: the realistic process-death fault (no atexit,
            # no cleanup) — exactly what a preempted/OOM-killed process
            # looks like to the rest of the cluster
            os.kill(os.getpid(), signal.SIGKILL)
            return None  # unreachable
        return action

    def set_notifier(self, fn: Optional[Callable[[Dict[str, Any]], None]]):
        self._notifier = fn


# -------------------------------------------------------------- module API

_ENGINE: Optional[ChaosEngine] = None


def enabled() -> bool:
    return _ENGINE is not None


def engine() -> Optional[ChaosEngine]:
    return _ENGINE


def hit(site: str, method: Optional[str] = None) -> Optional[Dict[str, Any]]:
    eng = _ENGINE
    if eng is None:
        return None
    return eng.hit(site, method)


def configure(seed: int = 0, schedule: Optional[List[Dict[str, Any]]] = None,
              probs: Optional[Dict[str, float]] = None,
              role: str = "driver", is_head: Optional[bool] = None,
              log_path: Optional[str] = None,
              delay_s: float = 0.05) -> ChaosEngine:
    """Programmatic setup (tests). Replaces any existing engine."""
    global _ENGINE
    _ENGINE = ChaosEngine(seed=seed, schedule=schedule, probs=probs,
                          role=role, is_head=is_head, log_path=log_path,
                          delay_s=delay_s)
    return _ENGINE


def clear():
    global _ENGINE
    _ENGINE = None


def parse_env(raw: str) -> Dict[str, Any]:
    """RTT_CHAOS value → config dict. A bare integer means seed-only
    (soak probabilities/schedules come programmatically or via JSON)."""
    raw = raw.strip()
    if not raw:
        return {}
    try:
        return {"seed": int(raw)}
    except ValueError:
        pass
    cfg = json.loads(raw)
    if not isinstance(cfg, dict):
        raise ValueError(f"RTT_CHAOS must be an int seed or a JSON "
                         f"object, got: {type(cfg).__name__}")
    return cfg


def init_from_env(role: str, is_head: Optional[bool] = None
                  ) -> Optional[ChaosEngine]:
    """Per-process setup from ``RTT_CHAOS`` (no-op when unset). Called
    by every process entrypoint with its role so spec ``proc`` filters
    resolve; the env rides process spawn, so one export at the driver
    covers the whole cluster."""
    global _ENGINE
    raw = os.environ.get("RTT_CHAOS")
    if not raw:
        return None
    try:
        cfg = parse_env(raw)
    except (ValueError, json.JSONDecodeError) as e:
        # a typo in a debug knob must not kill every process at startup
        import logging
        logging.getLogger(__name__).warning(
            "ignoring malformed RTT_CHAOS=%r: %s", raw, e)
        return None
    if not cfg:
        return None
    _ENGINE = ChaosEngine(
        seed=cfg.get("seed", 0), schedule=cfg.get("schedule"),
        probs=cfg.get("p"), role=role, is_head=is_head,
        log_path=os.environ.get("RTT_CHAOS_LOG"),
        delay_s=float(cfg.get("delay_s", 0.05)))
    return _ENGINE


def read_log(path: str) -> List[Dict[str, Any]]:
    """Parse a chaos log file into fired-fault records (replay
    comparison helper; entries carry no timestamps by design)."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
    except OSError:
        pass
    return out
