"""The direct-execution lane: leased unary tasks over the native pump.

Closes the unary-task gap left after the round-5 lease work (PERF.md
"The unary task path"): the residual ~420 µs/round-trip was Python
asyncio handler work plus two thread handoffs inside the worker
(io loop -> exec thread -> io loop).  This module removes both:

* **DirectServer** (worker side): a second listening socket served by
  the native frame pump (src/rpccore/).  ONE thread runs
  recv -> decode -> execute -> reply; the user function's return value
  is msgpack-framed and written by the native sender without another
  thread or the event loop touching it.  Non-leased work (pushed tasks,
  actor calls, async handlers) keeps the asyncio path untouched.
* **DirectClient** (driver side): a native lease pool beside the asyncio
  one.  Submissions are sent from the CALLER's thread (no io-loop
  handoff); replies land on one delivery thread that stores results and
  wakes getters directly (``Worker._apply_task_result``) — asyncio never
  runs on the steady-state round trip.

Wire bytes are identical to the asyncio implementation
(docs/WIRE_PROTOCOL.md "Implementations"): the same ``leased_task``
REQUEST/REPLY frames, the same ``__hello__`` negotiation, the same
``cancel_task`` notify.  Chaos frame-fault sites (``protocol.send`` /
``protocol.recv``; docs/FAULT_TOLERANCE.md) are applied at the frame
boundary on both sides with the same semantics as
``protocol.Connection``, so a seeded fault schedule replays identically
against either implementation.

Failure contract (matches ``Worker._leased_call``): any transport
failure — send to a dead peer, connection close with calls in flight,
an ERROR reply — drops the lease and resubmits the task through the
batched raylet path (at-least-once, the task-retry contract).

Selection: a failed library build/load disables this module entirely; workers then skip the direct listener,
drivers fall back to the asyncio lease pool, and — mixed clusters — a
lease grant whose worker reports no ``direct_address`` permanently
reverts the driver to the asyncio pool.
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import logging
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import msgpack

from ray_tpu_torch._private import chaos, protocol, rpccore, schema

logger = logging.getLogger(__name__)

_REQUEST, _REPLY, _ERROR, _NOTIFY = (protocol.REQUEST, protocol.REPLY,
                                     protocol.ERROR, protocol.NOTIFY)


def _pack(body) -> bytes:
    return msgpack.packb(body, use_bin_type=True)


def _chaos_send(pump: rpccore.Pump, cid: int, method: str,
                data: bytes, peer_host: str = "") -> bool:
    """Send one frame through the outbound chaos sites (same semantics
    as protocol.Connection._send: net.partition when the peer is
    off-box, then drop/delay/dup/reset).  Returns False when the
    connection is gone (incl. a chaos reset/partition)."""
    eng = chaos._ENGINE
    if eng is not None and peer_host:
        from ray_tpu_torch._private import netx
        if netx.partitioned(peer_host):
            pump.close_conn(cid)  # an unplugged cable, not a FIN
            return False
    if eng is not None:
        act = eng.hit("protocol.send", method)
        if act is not None:
            op = act["op"]
            if op == "drop":
                return True  # frame lost on the wire; peer never sees it
            if op == "delay":
                time.sleep(float(act.get("delay_s", eng.delay_s)))
            elif op == "reset":
                pump.close_conn(cid)
                return False
            elif op == "dup":
                pump.send(cid, data)
    return pump.send(cid, data)


# --------------------------------------------------------------------------
# Worker side


class DirectServer:
    """The worker's direct-call lane: one thread, zero handoffs.

    Serves ``leased_task`` (execute inline, reply inline), ``__hello__``,
    ``ping`` and ``cancel_task`` on a dedicated unix socket owned by the
    native pump.  Anything else arriving here is bridged onto the
    worker's asyncio handler table (rare — owners only dial this socket
    for the leased fast path)."""

    def __init__(self, worker, path: str,
                 tcp_host: Optional[str] = None):
        self.worker = worker
        self.pump = rpccore.Pump()
        self.pump.listen(path)
        self.address = "unix:" + path
        # 1.8: the lane's host:port twin — same pump, same frames, so
        # an off-box owner pushes leased tasks and actor calls with
        # identical semantics (advertised via worker_register)
        self.tcp_address = ""
        if tcp_host:
            try:
                port = self.pump.listen_tcp(tcp_host, 0)
                self.tcp_address = f"{tcp_host}:{port}"
            except OSError:
                logger.warning("direct lane: TCP listener on %s failed; "
                               "lane stays unix-only", tcp_host)
        self.executed = 0  # direct tasks run (tests/bench introspection)
        self._stats_delta = 0
        self._stats_last = time.monotonic()
        self._validate = schema.validation_enabled()
        self._thread = threading.Thread(
            target=self._serve, name="rtpu-direct-exec", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- lane loop

    def _serve(self):
        import os as _os
        prof = None
        prof_dir = _os.environ.get("RTT_CPROFILE_DIR")
        if prof_dir and "direct" in _os.environ.get(
                "RTT_CPROFILE_PROCS", ""):
            # perf-debug aid (cProfile is per-thread — the worker
            # main-thread profiler can't see the lane)
            import cProfile
            prof = cProfile.Profile()
            prof.enable()
        try:
            self._serve_loop(prof, prof_dir)
        finally:
            if prof is not None:
                prof.disable()
                prof.dump_stats(_os.path.join(
                    prof_dir, f"direct_{_os.getpid()}.pstats"))

    def _serve_loop(self, prof=None, prof_dir=None):
        import os as _os
        last_dump = time.monotonic()
        while True:
            if prof is not None and time.monotonic() - last_dump > 3.0:
                # workers die via os._exit: flush the profile mid-run
                last_dump = time.monotonic()
                prof.dump_stats(_os.path.join(
                    prof_dir, f"direct_{_os.getpid()}.pstats"))
            try:
                evs = self.pump.next_batch(500)
            except Exception:
                return  # pump destroyed under us (disconnect)
            if evs is None:
                return  # shutdown
            for cid, kind, body in evs:
                if kind != rpccore.KIND_FRAME:
                    continue
                try:
                    self._on_frame(cid, body)
                except Exception:
                    logger.exception("direct lane: frame handling failed")
            self._flush_stats()

    def _on_frame(self, cid: int, body: bytes):
        try:
            frame = msgpack.unpackb(body, raw=False)
            mtype, seq, method, payload = frame
        except Exception:
            self.pump.close_conn(cid)  # garbage on the wire: drop peer
            return
        eng = chaos._ENGINE
        if eng is not None and mtype in (_REQUEST, _NOTIFY):
            # inbound chaos site at the frame boundary — identical
            # semantics to Connection._read_loop (replies are exempt:
            # reply loss is modeled on the sender side)
            act = eng.hit("protocol.recv", method)
            if act is not None:
                op = act["op"]
                if op == "drop":
                    return
                if op == "delay":
                    time.sleep(float(act.get("delay_s", eng.delay_s)))
                elif op == "reset":
                    self.pump.close_conn(cid)
                    return
                elif op == "dup":
                    self._dispatch(cid, mtype, seq, method, payload)
        self._dispatch(cid, mtype, seq, method, payload)

    def _dispatch(self, cid, mtype, seq, method, payload):
        from ray_tpu_torch._private import worker as worker_mod
        w = self.worker
        if chaos._ENGINE is not None:
            # server-side kill site, parity with protocol.Server._handle
            chaos.hit("rpc.request", method)
        if method == "leased_task":
            try:
                if self._validate:
                    errors = schema.validate(method, payload)
                    if errors:
                        raise protocol.RpcError(
                            "wire schema violation: " + "; ".join(errors))
                result = w._execute_task(payload["spec"], [],
                                         reply=worker_mod.DIRECT_REPLY)
            except Exception as e:  # noqa: BLE001 — errors cross the wire
                self._reply(cid, seq, method,
                            f"{type(e).__name__}: {e}", error=True)
                return
            self.executed += 1
            self._stats_delta += 1
            self._reply(cid, seq, method, result)
        elif method == "__hello__":
            err = schema.check_hello(payload or {})
            if err:
                self._reply(cid, seq, method,
                            f"RpcError: protocol negotiation failed: {err}",
                            error=True)
            else:
                self._reply(cid, seq, method, schema.hello_payload())
        elif method == "ping":
            self._reply(cid, seq, method,
                        {"worker_id": w.worker_id.hex(), "mode": w.mode})
        elif method == "cancel_task":
            w._cancelled_tasks.add(payload["task_id"])
            if seq is not None and mtype == _REQUEST:
                self._reply(cid, seq, method, {})
        else:
            # bridge: run it on the asyncio handler table; the reply (if
            # requested) is sent from the future's callback — the lane
            # never blocks on slow-path work
            fut = asyncio.run_coroutine_threadsafe(
                w._handle_request(method, payload, None), w.io.loop)
            if mtype == _REQUEST and seq is not None:
                def _done(f, cid=cid, seq=seq, method=method):
                    try:
                        self._reply(cid, seq, method, f.result())
                    except Exception as e:  # noqa: BLE001
                        self._reply(cid, seq, method,
                                    f"{type(e).__name__}: {e}", error=True)
                fut.add_done_callback(_done)

    def _reply(self, cid, seq, method, result, error: bool = False):
        if seq is None:
            return
        body = _pack([_ERROR if error else _REPLY, seq, method, result])
        _chaos_send(self.pump, cid, method, body)

    def _flush_stats(self):
        """Leased workers bypass the raylet; keep its dispatch gauge
        truthful with one coalesced task_stats notify per 0.3 s of
        activity (same contract as _flush_leased_stats)."""
        if not self._stats_delta or self.worker.raylet is None:
            return
        now = time.monotonic()
        if now - self._stats_last < 0.3:
            return
        delta, self._stats_delta = self._stats_delta, 0
        self._stats_last = now
        try:
            self.worker.io.run_async(self.worker.raylet.notify(
                "task_stats", {"executed": delta}))
        except Exception:
            pass

    def close(self):
        self.pump.shutdown()
        self._thread.join(timeout=2)
        if not self._thread.is_alive():
            self.pump.destroy()


# --------------------------------------------------------------------------
# Driver side


class _DLease:
    __slots__ = ("key", "lease_id", "cid", "addr", "peer_host",
                 "inflight", "last_used", "acquiring", "revoked",
                 "released")

    def __init__(self, key):
        self.key = key
        self.lease_id: Optional[str] = None
        self.cid: Optional[int] = None
        self.addr: Optional[str] = None
        self.peer_host = ""  # '' = on-box (unix) lane
        self.inflight = 0
        self.last_used = 0.0
        self.acquiring = True
        self.revoked = False
        self.released = False


class DirectClient:
    """Owner-side lease pool over the native pump.

    All state lives behind one ``threading.Lock`` (NOT confined to the
    io thread like the asyncio pool — that confinement is exactly the
    handoff this lane removes).  Sends happen on whatever thread submits
    or delivers; the raylet RPCs (lease acquire/release) still ride the
    io loop, off the hot path."""

    MAX_INFLIGHT = 8           # mirrors _LeaseState.MAX_INFLIGHT
    POOL_MAX = 16
    MAX_WAITERS = 512
    IDLE_RELEASE_S = 2.0
    RETRY_COOLDOWN_S = 5.0

    def __init__(self, worker):
        self.worker = worker
        self.pump = rpccore.Pump()
        self.lock = threading.Lock()
        self.pools: Dict[Tuple, List[_DLease]] = {}
        self.parked: Dict[Tuple, Deque] = {}
        self.pending: Dict[Tuple[int, int], Tuple[dict, Any, _DLease]] = {}
        self.by_cid: Dict[int, _DLease] = {}
        self.fail_at: Dict[Tuple, float] = {}
        self.unsupported = False  # cluster's workers predate the lane
        self.submitted = 0        # tasks sent down the direct lane
        self._seq = itertools.count(1)
        self._closed = False
        self._idle_last = time.monotonic()
        # reactor handover: whoever holds _pump_lock runs the reactor.
        # A getter blocked on a direct task's result takes it over
        # (reap_result) so the reply is decoded ON the getter's thread —
        # no delivery-thread hop on the sync path; the background thread
        # parks on _no_getters while any getter is pumping.
        self._pump_lock = threading.Lock()
        self._getter_lock = threading.Lock()
        self._getters = 0
        self._last_getter = 0.0
        self._delivery_in_reactor = False
        self._no_getters = threading.Event()
        self._no_getters.set()
        self._thread = threading.Thread(
            target=self._deliver, name="rtpu-direct-recv", daemon=True)
        self._thread.start()

    def usable(self) -> bool:
        return not (self._closed or self.unsupported)

    # ------------------------------------------------------------- submit

    def submit(self, spec, state) -> bool:
        """Route a qualifying task down the direct lane.  True = this
        lane owns the task now (sent or parked); False = caller should
        use the asyncio lease pool / batched path."""
        if not self.usable():
            return False
        key = tuple(sorted((spec.get("resources") or {}).items()))
        now = time.monotonic()
        actions: List = []
        fast = None
        with self.lock:
            pool = self.pools.setdefault(key, [])
            # hot fast path: one live lease with capacity and nothing
            # parked — a single dict insert instead of the deque/drain
            # machinery (this is the steady state of a sync-unary loop)
            if len(pool) == 1 and not self.parked:
                L = pool[0]
                if L.cid is not None and not L.revoked \
                        and L.inflight < self.MAX_INFLIGHT:
                    seq = next(self._seq)
                    L.inflight += 1
                    L.last_used = now
                    self.pending[(L.cid, seq)] = (spec, state, L)
                    fast = (L, L.cid, seq)
            if fast is None:
                ready = [x for x in pool
                         if x.cid is not None and not x.revoked]
                acquiring = any(x.acquiring for x in pool)
                if not ready and not acquiring and \
                        now - self.fail_at.get(key, 0.0) <= \
                        self.RETRY_COOLDOWN_S:
                    return False  # leasing recently denied: normal path
                q = self.parked.setdefault(key, collections.deque())
                if len(q) >= self.MAX_WAITERS:
                    return False  # overflow: batched path absorbs bursts
                q.append((spec, state))
                # grow when empty or saturated (grow-until-denied sizes
                # the pool to node capacity, same policy as
                # _park_lease_waiter)
                if (not ready or min(x.inflight for x in ready) >= 2) \
                        and len(pool) < self.POOL_MAX and not acquiring \
                        and now - self.fail_at.get(key, 0.0) > \
                        self.RETRY_COOLDOWN_S:
                    L = _DLease(key)
                    pool.append(L)
                    self.worker.io.run_async(self._acquire(L))
                self._drain_locked(key, now, actions)
        if fast is not None:
            self._send_task(fast[0], fast[1], fast[2], spec, state)
        else:
            self._run_actions(actions)
        return True

    def _drain_locked(self, key, now, actions: List):
        """Feed parked tasks to ready leases (lock held).  Appends
        ("send", ...) / ("flush", items) work items for the caller to
        run after releasing the lock."""
        q = self.parked.get(key)
        if not q:
            self.parked.pop(key, None)
            return
        pool = self.pools.get(key) or []
        ready = [x for x in pool if x.cid is not None and not x.revoked]
        if not ready:
            if any(x.acquiring for x in pool):
                return  # stay parked; the acquisition settles the drain
            self.parked.pop(key, None)
            actions.append(("flush", list(q)))
            return
        while q:
            L = min(ready, key=lambda x: x.inflight)
            if L.inflight >= self.MAX_INFLIGHT:
                break  # completions re-drain
            spec, state = q.popleft()
            seq = next(self._seq)
            L.inflight += 1
            L.last_used = now
            self.pending[(L.cid, seq)] = (spec, state, L)
            actions.append(("send", L, L.cid, seq, spec, state))
        if not q:
            self.parked.pop(key, None)

    def _run_actions(self, actions: List):
        for item in actions:
            if item[0] == "send":
                _, L, cid, seq, spec, state = item
                self._send_task(L, cid, seq, spec, state)
            else:  # flush to the batched submission path
                for spec, state in item[1]:
                    state.worker_address = None
                    self.worker._enqueue_submit(spec, state)

    def _send_task(self, L: _DLease, cid: int, seq: int, spec, state):
        state.worker_address = L.addr
        state.direct = True
        self.submitted += 1
        data = _pack([_REQUEST, seq, "leased_task", {"spec": spec}])
        if not _chaos_send(self.pump, cid, "leased_task", data,
                           L.peer_host):
            self._fail_pending(cid, seq, spec, state)

    def _fail_pending(self, cid, seq, spec, state):
        """A send found the connection dead: resubmit through the
        batched path (once — the close event skips entries we popped)."""
        with self.lock:
            ent = self.pending.pop((cid, seq), None)
            if ent is not None:
                ent[2].inflight -= 1
        if ent is not None:
            state.worker_address = None
            state.direct = False
            self.worker._enqueue_submit(spec, state)

    # ----------------------------------------------------------- acquire

    async def _acquire(self, L: _DLease):
        """io thread: lease a worker, dial its direct socket."""
        w = self.worker
        try:
            r = await w.raylet.call("lease_worker",
                                    {"resources": dict(L.key)})
        except Exception as e:  # noqa: BLE001
            r = {"error": "LEASE_RPC_FAILED", "message": str(e)}
        now = time.monotonic()
        direct_addr = ""
        peer_host = ""
        if not r.get("error"):
            # 1.8: the lease reply advertises both lane endpoints; dial
            # unix when the worker is on this box, TCP otherwise
            from ray_tpu_torch._private import netx
            direct_addr = netx.pick(r.get("direct_address"),
                                    r.get("direct_tcp_address"))
            peer_host = netx.host_of(direct_addr)
        cid = None
        if direct_addr:
            try:
                cid = self.pump.dial(direct_addr)
            except Exception:
                cid = None
        if cid is None:
            # denied, unreachable, or a worker without the direct lane
            if not r.get("error"):
                if not direct_addr:
                    # mixed cluster: this raylet's workers predate the
                    # lane — stop burning lease grants on probes and
                    # leave leasing to the asyncio pool
                    self.unsupported = True
                try:
                    await w.raylet.call(
                        "release_lease", {"lease_id": r["lease_id"]})
                except Exception:
                    pass
            actions: List = []
            with self.lock:
                if r.get("error"):
                    self.fail_at[L.key] = now
                L.acquiring = False
                pool = self.pools.get(L.key)
                if pool and L in pool:
                    pool.remove(L)
                self._drain_locked(L.key, now, actions)
            self._run_actions(actions)
            return
        # negotiation on the direct link (reply is discarded — seq 0 is
        # never a pending entry; an incompatible-major worker cannot
        # exist inside one session, the hello is for wire parity)
        _chaos_send(self.pump, cid, "__hello__",
                    _pack([_REQUEST, 0, "__hello__", schema.hello_payload()]),
                    peer_host)
        actions = []
        with self.lock:
            L.acquiring = False
            L.lease_id = r["lease_id"]
            L.addr = r["worker_address"]
            L.peer_host = peer_host
            L.cid = cid
            L.last_used = now
            self.by_cid[cid] = L
            self._drain_locked(L.key, now, actions)
        self._run_actions(actions)

    # ---------------------------------------------------------- delivery

    _GETTER_GRACE_S = 0.02

    def _deliver(self):
        while not self._closed:
            # park while a getter owns the reactor (it does our job)
            if not self._no_getters.wait(timeout=0.5):
                continue
            # resume grace: in a sync get loop the next getter arrives
            # within microseconds — re-entering the reactor here would
            # force a wake/bounce handover on EVERY round trip
            left = self._GETTER_GRACE_S - \
                (time.monotonic() - self._last_getter)
            if left > 0:
                time.sleep(left)
                continue
            if not self._pump_lock.acquire(timeout=0.2):
                continue
            try:
                self._delivery_in_reactor = True
                evs = self.pump.next_batch(500)
            except Exception:
                return  # pump destroyed under us
            finally:
                self._delivery_in_reactor = False
                self._pump_lock.release()
            if evs is None:
                return
            self._process_events(evs)
            self._idle_scan()

    def _process_events(self, evs) -> None:
        for cid, kind, body in evs:
            if kind == rpccore.KIND_CLOSED:
                self._on_closed(cid)
            elif kind == rpccore.KIND_FRAME:
                try:
                    self._on_frame(cid, body)
                except Exception:
                    logger.exception("direct delivery: frame failed")
            # KIND_WAKE: reactor-handover nudge, nothing to process

    def reap_result(self, state, timeout: float) -> bool:
        """Pump the reactor from the GETTER's thread until ``state`` is
        done (True) or ``timeout`` elapses (False).  Decoding the reply
        on the thread that wants it removes the delivery-thread hop —
        with the worker's one-thread lane, a sync round trip is then
        caller-thread → worker lane → caller-thread.  Concurrent getters
        contend on the pump lock; losers fall back to short event waits
        (the winner completes their tasks too)."""
        deadline = time.monotonic() + timeout
        with self._getter_lock:
            self._getters += 1
            self._no_getters.clear()
        try:
            if self._delivery_in_reactor:
                # bounce the delivery thread out of its epoll; when it is
                # already parked (steady sync loop) the wake — and the
                # synthetic event the getter would then have to drain —
                # is skipped entirely
                self.pump.wake()
            while not state.done:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                if self._pump_lock.acquire(timeout=min(left, 0.05)):
                    try:
                        if state.done:
                            return True
                        try:
                            evs = self.pump.next_batch(
                                int(min(left, 0.2) * 1000) or 1)
                        except Exception:
                            return state.result_event.wait(left)
                        if evs is None:  # pump shut down mid-get
                            return state.result_event.wait(left)
                        self._process_events(evs)
                    finally:
                        self._pump_lock.release()
                else:
                    # another getter is pumping; it processes all
                    # inbound replies, ours included
                    if state.result_event.wait(0.005):
                        return True
            return True
        finally:
            with self._getter_lock:
                self._getters -= 1
                self._last_getter = time.monotonic()
                if self._getters == 0:
                    self._no_getters.set()

    def _on_frame(self, cid: int, body: bytes):
        try:
            frame = msgpack.unpackb(body, raw=False)
            mtype, seq, _method, payload = frame
        except Exception:
            self.pump.close_conn(cid)
            return
        if mtype not in (_REPLY, _ERROR):
            return  # workers never initiate requests on this lane
        now = time.monotonic()
        actions: List = []
        with self.lock:
            ent = self.pending.pop((cid, seq), None)
            if ent is None:
                return  # __hello__ reply, dup, or already failed over
            spec, state, L = ent
            L.inflight -= 1
            L.last_used = now
            ack = L.revoked and L.inflight == 0
            if self.parked:
                self._drain_locked(L.key, now, actions)
        if actions:
            self._run_actions(actions)
        if ack:
            self._release(L, inflight0=True)
        if mtype == _REPLY:
            # result delivery runs HERE, on the delivery thread —
            # stores returns and wakes the getter without the io loop
            self.worker._apply_task_result(payload)
        else:
            # ERROR reply = transport-level failure (parity with
            # _leased_call's except branch): drop the lease, resubmit
            self._drop_lease(L, release=True)
            state.worker_address = None
            state.direct = False
            self.worker._enqueue_submit(spec, state)

    def _on_closed(self, cid: int):
        resubmit = []
        actions: List = []
        with self.lock:
            L = self.by_cid.pop(cid, None)
            for k in [k for k in self.pending if k[0] == cid]:
                spec, state, _L = self.pending.pop(k)
                resubmit.append((spec, state))
            if L is not None:
                L.cid = None
                if L.inflight:
                    L.inflight = 0
                pool = self.pools.get(L.key)
                if pool and L in pool:
                    pool.remove(L)
                self._drain_locked(L.key, time.monotonic(), actions)
        for spec, state in resubmit:
            state.worker_address = None
            state.direct = False
            self.worker._enqueue_submit(spec, state)
        self._run_actions(actions)
        if L is not None:
            self._release(L)  # idempotent raylet-side; reclaims capacity

    def _idle_scan(self):
        now = time.monotonic()
        if now - self._idle_last < 0.5:
            return
        self._idle_last = now
        drops: List[_DLease] = []
        with self.lock:
            for pool in self.pools.values():
                for L in pool:
                    if L.cid is not None and not L.revoked \
                            and L.inflight == 0 \
                            and now - L.last_used > self.IDLE_RELEASE_S:
                        drops.append(L)
        for L in drops:
            self._drop_lease(L, release=True)

    # ------------------------------------------------- revoke/cancel/drop

    def on_revoke(self, lease_id: str) -> bool:
        """io thread (revoke_lease handler): stop routing through this
        lease; ack the drain (release inflight=0) once in-flight calls
        complete — the raylet defers re-idling until then."""
        actions: List = []
        with self.lock:
            L = None
            for pool in self.pools.values():
                for x in pool:
                    if x.lease_id == lease_id:
                        L = x
                        break
                if L is not None:
                    break
            if L is None:
                return False
            L.revoked = True
            self.fail_at[L.key] = time.monotonic()
            pool = self.pools.get(L.key)
            if pool and L in pool:
                pool.remove(L)
            ack = L.inflight == 0
            self._drain_locked(L.key, time.monotonic(), actions)
        self._run_actions(actions)
        if ack:
            self._release(L, inflight0=True)
        return True

    def cancel(self, task_id: str, state) -> bool:
        """Cancel a task this lane owns: unpark it (resolving the refs
        cancelled), or notify the executing worker."""
        target_cid = None
        unparked = False
        with self.lock:
            for q in self.parked.values():
                for item in q:
                    if item[0]["task_id"] == task_id:
                        q.remove(item)
                        unparked = True
                        break
                if unparked:
                    break
            target_host = ""
            if not unparked:
                for (cid, _seq), (spec, _st, _L) in self.pending.items():
                    if spec["task_id"] == task_id:
                        target_cid = cid
                        target_host = _L.peer_host
                        break
        if unparked:
            # outside the lock: resolving fires result-event callbacks
            # (e.g. serve router slot release) that may re-enter submit
            self.worker._resolve_cancelled(task_id, state)
            return True
        if target_cid is not None:
            _chaos_send(self.pump, target_cid, "cancel_task",
                        _pack([_NOTIFY, None, "cancel_task",
                               {"task_id": task_id}]), target_host)
            return True
        return False

    def _drop_lease(self, L: _DLease, release: bool = False):
        actions: List = []
        with self.lock:
            pool = self.pools.get(L.key)
            if pool and L in pool:
                pool.remove(L)
            cid, L.cid = L.cid, None
            if cid is not None:
                self.by_cid.pop(cid, None)
            self._drain_locked(L.key, time.monotonic(), actions)
        if cid is not None:
            self.pump.close_conn(cid)
        self._run_actions(actions)
        if release:
            self._release(L)

    def _release(self, L: _DLease, inflight0: bool = False):
        with self.lock:
            if L.released or L.lease_id is None:
                return
            L.released = True
            lease_id = L.lease_id
        payload = {"lease_id": lease_id}
        if inflight0:
            payload["inflight"] = 0

        async def _rel():
            try:
                await self.worker.raylet.call("release_lease", payload)
            except Exception:
                pass  # raylet-side conn cleanup is the backstop
        try:
            self.worker.io.run_async(_rel())
        except Exception:
            pass

    # ------------------------------------------------------------- close

    def close(self):
        self._closed = True
        flush = []
        with self.lock:
            for q in self.parked.values():
                flush.extend(q)
            self.parked.clear()
        for spec, state in flush:
            state.worker_address = None
            self.worker._enqueue_submit(spec, state)
        self.pump.shutdown()
        self._thread.join(timeout=2)
        if not self._thread.is_alive():
            self.pump.destroy()
