"""Scheduling ledger: resource accounting + per-class pending queues +
the dispatch poll, behind one interface with two implementations.

Copied from the JAX package's ``ray_tpu/_private/sched.py``. The
resource scheduled by index is ``"GPU"`` where JAX's is ``"TPU"``: a
task or bundle demanding ``num_gpus=k`` is granted k concrete device
indices, under the same whole-device rule (``int(demand)``, so a
fractional demand below 1 takes no index, exactly as a fractional
``num_tpus`` does in JAX). The native ledger takes that resource's
index through ``scx_set_tpu_res``, so ``csrc/schedcore.cc`` is the JAX
package's source unchanged.

``NativeLedger`` drives ``csrc/schedcore.cc`` — the dispatch
hot loop in C++ (reference analogue: raylet/scheduling's fixed-point
``ClusterResourceData`` + ``LocalTaskManager``'s per-SchedulingClass
queues and ``DispatchScheduledTasksToWorkers``,
local_task_manager.cc:99).  ``PyLedger`` is the pure-Python fallback
(used only when the C++ library does not build or load; the JAX
package's switch that forces it is not carried over) with identical ACCOUNTING semantics — same
feasibility, acquisition atomicity, bundle lifecycle, and FIFO order
within a scheduling class; the relative order in which DIFFERENT
classes win contended resources is unspecified and may differ between
the two (both are valid schedules; tests assert accounting invariants,
not cross-class interleavings).

The split of responsibilities: the ledger owns MECHANISM — atomic
feasibility/acquire over the node pool, per-bundle pools and concrete
GPU index sets, and the head-of-class scan that turns freed capacity
into a batch of dispatch decisions.  The raylet above owns POLICY —
spillback of stuck classes, worker-pool choice, and all RPC plumbing.
Chip IDs are concrete (two committed bundles own disjoint chip sets;
reference: placement_group_resource_manager.cc converts bundle
resources into node-local instances).
"""

from __future__ import annotations

import ctypes
import logging
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import native

_LIB = None
_LIB_FAILED = False

POLL_MAX = 1024
# per-poll chip buffer; also the max GPU demand of a single dispatchable
# task under the native ledger (a head demanding more is reported
# blocked for spillback, never dispatched — real GPU hosts top out at
# 8 chips, so the bound is three orders of magnitude of headroom)
POLL_MAXCHIPS = 4096
POLL_MAXBLOCKED = 512

_u64p = ctypes.POINTER(ctypes.c_uint64)
_i32p = ctypes.POINTER(ctypes.c_int32)

logger = logging.getLogger(__name__)
_f64p = ctypes.POINTER(ctypes.c_double)


def _lib():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    try:
        src, path = native.paths("schedcore.cc", "libschedcore.so")
        if native.stale(src, path):
            native.build(src, path)
        lib = ctypes.CDLL(path)
        lib.scx_create.restype = ctypes.c_void_p
        lib.scx_destroy.argtypes = [ctypes.c_void_p]
        lib.scx_set_tpu_res.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.scx_node_add.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_double]
        lib.scx_node_get.restype = ctypes.c_double
        lib.scx_node_get.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.scx_node_chips_add.argtypes = [ctypes.c_void_p, _i32p,
                                           ctypes.c_int]
        lib.scx_node_chips.restype = ctypes.c_int
        lib.scx_node_chips.argtypes = [ctypes.c_void_p, _i32p, ctypes.c_int]
        lib.scx_class.restype = ctypes.c_int
        lib.scx_class.argtypes = [ctypes.c_void_p, _i32p, _f64p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_longlong]
        lib.scx_push.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_uint64]
        lib.scx_push_front.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_uint64]
        lib.scx_remove.restype = ctypes.c_int
        lib.scx_remove.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_uint64]
        lib.scx_head.restype = ctypes.c_uint64
        lib.scx_head.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.scx_pop_head.restype = ctypes.c_uint64
        lib.scx_pop_head.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.scx_pending.restype = ctypes.c_longlong
        lib.scx_pending.argtypes = [ctypes.c_void_p]
        lib.scx_feasible.restype = ctypes.c_int
        lib.scx_feasible.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.scx_acquire.restype = ctypes.c_int
        lib.scx_acquire.argtypes = [ctypes.c_void_p, ctypes.c_int, _i32p,
                                    ctypes.c_int]
        lib.scx_gc.restype = ctypes.c_int
        lib.scx_gc.argtypes = [ctypes.c_void_p, _i32p, ctypes.c_int]
        lib.scx_release.argtypes = [ctypes.c_void_p, ctypes.c_int, _i32p,
                                    ctypes.c_int]
        lib.scx_prepare.restype = ctypes.c_int
        lib.scx_prepare.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                    _i32p, _f64p, ctypes.c_int, ctypes.c_int]
        for name in ("scx_commit", "scx_cancel_bundle", "scx_return_bundle",
                     "scx_has_bundle"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        lib.scx_drain_bundle.restype = ctypes.c_int
        lib.scx_drain_bundle.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                         _u64p, ctypes.c_int]
        lib.scx_poll.restype = ctypes.c_int
        lib.scx_poll.argtypes = [
            ctypes.c_void_p, _u64p, _i32p, _i32p, _i32p, _i32p,
            ctypes.c_int, ctypes.c_int, _u64p, _i32p,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        _LIB = lib
    except Exception:
        _LIB_FAILED = True
        _LIB = None
    return _LIB


class PendingTask:
    __slots__ = ("spec", "reply_fut", "demand", "gpu_demand", "submitted_at",
                 "sched_class", "tag")

    def __init__(self, spec, reply_fut):
        self.spec = spec
        self.reply_fut = reply_fut
        self.demand: Dict[str, float] = dict(spec.get("resources", {}))
        self.gpu_demand = int(self.demand.get("GPU", 0))
        self.submitted_at = time.monotonic()
        self.tag = 0
        # scheduling class: tasks in one class are interchangeable for
        # feasibility (same demand, same PG bundle), so the dispatch loop
        # can skip a whole class once its head is blocked (reference:
        # cluster_task_manager's per-SchedulingClass queues).  Spilled-in
        # tasks get their own class: they must not block the spillback
        # drain of plain tasks queued behind them.
        pg = spec.get("placement_group") or None
        bundle = (pg["pg_id"], pg.get("bundle_index", 0)) if pg else None
        self.sched_class = (tuple(sorted(self.demand.items())), bundle,
                            bool(spec.get("spilled_from")))


def bundle_key_of(spec) -> Optional[Tuple[str, int]]:
    pg = spec.get("placement_group")
    if not pg:
        return None
    return (pg["pg_id"], pg.get("bundle_index", 0))


class PyLedger:
    """Pure-Python ledger (the pre-schedcore raylet logic, verbatim)."""

    native = False

    def __init__(self, totals: Dict[str, float], chips: List[int]):
        self.available = dict(totals)
        self.free_chips = list(chips)
        self.prepared_bundles: Dict[Tuple[str, int], Dict[str, float]] = {}
        self.committed_bundles: Dict[Tuple[str, int], Dict[str, float]] = {}
        self.pg_available: Dict[Tuple[str, int], Dict[str, float]] = {}
        self.prepared_bundle_chips: Dict[Tuple[str, int], List[int]] = {}
        self.pg_chips: Dict[Tuple[str, int], List[int]] = {}
        self._classes: Dict[tuple, deque] = {}
        self._count = 0

    # ------------------------------------------------------------- queue

    def append(self, ptask: PendingTask):
        q = self._classes.get(ptask.sched_class)
        if q is None:
            q = self._classes[ptask.sched_class] = deque()
        q.append(ptask)
        self._count += 1

    def remove(self, ptask: PendingTask) -> bool:
        q = self._classes.get(ptask.sched_class)
        if q is None:
            return False
        try:
            q.remove(ptask)
        except ValueError:
            return False
        self._count -= 1
        return True

    def requeue_front(self, ptask: PendingTask):
        q = self._classes.get(ptask.sched_class)
        if q is None:
            q = self._classes[ptask.sched_class] = deque()
        q.appendleft(ptask)
        self._count += 1

    def head(self, sched_class) -> Optional[PendingTask]:
        q = self._classes.get(sched_class)
        return q[0] if q else None

    def pop_head(self, sched_class) -> Optional[PendingTask]:
        q = self._classes.get(sched_class)
        if not q:
            return None
        self._count -= 1
        return q.popleft()

    def pending_count(self) -> int:
        return self._count

    def pending_tasks(self) -> List[PendingTask]:
        return [pt for q in self._classes.values() for pt in q]

    def poll(self):
        """Scan class heads; atomically acquire + emit every dispatchable
        task.  Returns (dispatches, blocked_heads, more)."""
        dispatches: List[Tuple[PendingTask, Tuple[int, ...]]] = []
        blocked: List[PendingTask] = []
        dead = [c for c, q in self._classes.items() if not q]
        for c in dead:
            del self._classes[c]
        for cls, q in list(self._classes.items()):
            while q:
                head = q[0]
                chips = self.acquire(head)
                if chips is None:
                    blocked.append(head)
                    break
                q.popleft()
                self._count -= 1
                dispatches.append((head, chips))
        return dispatches, blocked, False

    # --------------------------------------------------------- resources

    def feasible(self, ptask: PendingTask) -> bool:
        key = bundle_key_of(ptask.spec)
        if key is not None:
            pool = self.pg_available.get(key)
            if pool is None:
                return False
            return all(pool.get(k, 0) + 1e-9 >= v
                       for k, v in ptask.demand.items() if k != "GPU") and \
                len(self.pg_chips.get(key, ())) >= ptask.gpu_demand
        for k, v in ptask.demand.items():
            if self.available.get(k, 0) + 1e-9 < v:
                return False
        # invariant: available["GPU"] == len(free_chips); check both so
        # feasibility can never say yes while the concrete chip pool is
        # short (the round-2 PG race)
        return len(self.free_chips) >= ptask.gpu_demand

    def acquire(self, ptask: PendingTask) -> Optional[Tuple[int, ...]]:
        key = bundle_key_of(ptask.spec)
        if key is not None:
            pool = self.pg_available.get(key)
            if pool is None:  # bundle returned while the task waited
                return None
            chip_src = self.pg_chips.setdefault(key, [])
        else:
            pool = self.available
            chip_src = self.free_chips
        if len(chip_src) < ptask.gpu_demand:
            return None
        for k, v in ptask.demand.items():
            if pool.get(k, 0) + 1e-9 < v:
                return None
        for k, v in ptask.demand.items():
            pool[k] = pool.get(k, 0) - v
        chips = tuple(chip_src[:ptask.gpu_demand])
        del chip_src[:ptask.gpu_demand]
        return chips

    def release(self, ptask: PendingTask, chips: Tuple[int, ...] = ()):
        key = bundle_key_of(ptask.spec)
        if key is not None:
            pool = self.pg_available.get(key)
            if pool is not None:
                for k, v in ptask.demand.items():
                    pool[k] = pool.get(k, 0) + v
                chip_dst = self.pg_chips.setdefault(key, [])
                chip_dst.extend(chips)
                chip_dst.sort()
            else:
                # bundle already returned: chips rejoin the NODE pool, and
                # the node's GPU count must follow them here
                self.free_chips.extend(chips)
                self.free_chips.sort()
                self.available["GPU"] = \
                    self.available.get("GPU", 0) + len(chips)
            return
        for k, v in ptask.demand.items():
            self.available[k] = self.available.get(k, 0) + v
        self.free_chips.extend(chips)
        self.free_chips.sort()

    # ----------------------------------------------------------- bundles

    def prepare_bundle(self, key, res: Dict[str, float]) -> bool:
        if key in self.prepared_bundles or key in self.committed_bundles:
            return True  # idempotent under GCS-restart retries
        n_gpu = int(res.get("GPU", 0))
        for k, v in res.items():
            if self.available.get(k, 0) + 1e-9 < v:
                return False
        if len(self.free_chips) < n_gpu:
            return False
        for k, v in res.items():
            self.available[k] = self.available.get(k, 0) - v
        self.prepared_bundle_chips[key] = self.free_chips[:n_gpu]
        del self.free_chips[:n_gpu]
        self.prepared_bundles[key] = res
        return True

    def commit_bundle(self, key) -> bool:
        if key in self.committed_bundles:
            return True  # idempotent retry
        res = self.prepared_bundles.pop(key, None)
        if res is None:
            return False
        self.committed_bundles[key] = res
        self.pg_available[key] = dict(res)
        self.pg_chips[key] = self.prepared_bundle_chips.pop(key, [])
        return True

    def cancel_bundle(self, key) -> bool:
        res = self.prepared_bundles.pop(key, None)
        if res is None:
            return False
        for k, v in res.items():
            self.available[k] = self.available.get(k, 0) + v
        self.free_chips.extend(self.prepared_bundle_chips.pop(key, []))
        self.free_chips.sort()
        return True

    def return_bundle(self, key) -> bool:
        res = self.committed_bundles.pop(key, None)
        self.pg_available.pop(key, None)
        if res is None:
            return False
        returned = self.pg_chips.pop(key, [])
        for k, v in res.items():
            if k == "GPU":
                continue
            self.available[k] = self.available.get(k, 0) + v
        # only chips physically back in hand rejoin the node pool (and
        # its GPU count) now; chips held by a still-running task of this
        # PG come back via release() when that task finishes
        self.free_chips.extend(returned)
        self.free_chips.sort()
        if "GPU" in res:
            self.available["GPU"] = \
                self.available.get("GPU", 0) + len(returned)
        return True

    def drain_bundle(self, key) -> List[PendingTask]:
        """Pop every queued task bound to this bundle (the PG is gone;
        they can never run)."""
        out: List[PendingTask] = []
        for cls, q in list(self._classes.items()):
            if cls[1] != key:
                continue
            out.extend(q)
            self._count -= len(q)
            del self._classes[cls]
        return out

    def drain_pg(self, pg_id: str) -> List[PendingTask]:
        """Drain every bundle of a placement group, including bundles
        this node never hosted (tasks can queue before prepare)."""
        out: List[PendingTask] = []
        for cls, q in list(self._classes.items()):
            if cls[1] is not None and cls[1][0] == pg_id:
                out.extend(q)
                self._count -= len(q)
                del self._classes[cls]
        return out

    def has_bundle(self, key) -> bool:
        return key in self.prepared_bundles or key in self.committed_bundles

    # ----------------------------------------------------- introspection

    def snapshot(self) -> Dict[str, float]:
        return dict(self.available)

    def avail_get(self, name: str) -> float:
        return self.available.get(name, 0.0)

    def node_chips_count(self) -> int:
        return len(self.free_chips)


class NativeLedger:
    """ctypes facade over the C++ schedcore.  Python retains only the
    tag→PendingTask map and the name/bundle interning tables; all
    accounting and queueing state lives in native memory."""

    native = True

    def __init__(self, totals: Dict[str, float], chips: List[int]):
        lib = _lib()
        assert lib is not None
        self._lib = lib
        self._h = lib.scx_create()
        self._res_ids: Dict[str, int] = {}
        self._res_names: List[str] = []
        self._report_keys = list(totals)
        self._bundle_ids: Dict[Tuple[str, int], int] = {}
        self._next_bundle = 0
        self._cls_ids: Dict[tuple, int] = {}
        self._cls_rev: Dict[int, tuple] = {}
        self._tags: Dict[int, PendingTask] = {}
        self._next_tag = 1
        # reusable poll buffers
        self._b_tags = (ctypes.c_uint64 * POLL_MAX)()
        self._b_cls = (ctypes.c_int32 * POLL_MAX)()
        self._b_off = (ctypes.c_int32 * POLL_MAX)()
        self._b_cnt = (ctypes.c_int32 * POLL_MAX)()
        self._b_chips = (ctypes.c_int32 * POLL_MAXCHIPS)()
        self._b_btags = (ctypes.c_uint64 * POLL_MAXBLOCKED)()
        self._b_bcls = (ctypes.c_int32 * POLL_MAXBLOCKED)()
        # sized for the node's whole chip pool: scx_acquire bounds its
        # write by this capacity, never past it
        self._chipbuf = (ctypes.c_int32 * max(4096, len(chips) + 8))()
        lib.scx_set_tpu_res(self._h, self._res("GPU"))
        for k, v in totals.items():
            lib.scx_node_add(self._h, self._res(k), float(v))
        if chips:
            arr = (ctypes.c_int32 * len(chips))(*chips)
            lib.scx_node_chips_add(self._h, arr, len(chips))

    def __del__(self):
        try:
            self._lib.scx_destroy(self._h)
        except Exception:
            pass

    def _res(self, name: str) -> int:
        rid = self._res_ids.get(name)
        if rid is None:
            rid = len(self._res_names)
            self._res_ids[name] = rid
            self._res_names.append(name)
        return rid

    def _bundle(self, key: Tuple[str, int]) -> int:
        bid = self._bundle_ids.get(key)
        if bid is None:
            bid = self._next_bundle
            self._next_bundle += 1
            self._bundle_ids[key] = bid
        return bid

    _GC_THRESHOLD = 512

    def _cls(self, ptask: PendingTask) -> int:
        cid = self._cls_ids.get(ptask.sched_class)
        if cid is None:
            if len(self._cls_ids) >= self._GC_THRESHOLD:
                self._gc_classes()
            names = list(ptask.demand)
            n = len(names)
            res = (ctypes.c_int32 * n)(*[self._res(k) for k in names])
            amt = (ctypes.c_double * n)(*[float(ptask.demand[k])
                                          for k in names])
            key = bundle_key_of(ptask.spec)
            bid = self._bundle(key) if key is not None else -1
            cid = self._lib.scx_class(self._h, res, amt, n,
                                      ptask.gpu_demand, bid)
            self._cls_ids[ptask.sched_class] = cid
            self._cls_rev[cid] = ptask.sched_class
        return cid

    def _gc_classes(self):
        """Tombstone empty native classes + drop the interning entries
        (a long-lived raylet seeing many distinct demand vectors must
        not grow state without bound).  Safe for in-flight tasks: a
        later release() re-interns an identical class by demand."""
        maxn = len(self._cls_ids)
        buf = (ctypes.c_int32 * maxn)()
        n = self._lib.scx_gc(self._h, buf, maxn)
        for i in range(n):
            sc = self._cls_rev.pop(buf[i], None)
            if sc is not None:
                self._cls_ids.pop(sc, None)

    def _res_arrays(self, res: Dict[str, float]):
        names = list(res)
        n = len(names)
        ids = (ctypes.c_int32 * n)(*[self._res(k) for k in names])
        amt = (ctypes.c_double * n)(*[float(res[k]) for k in names])
        return ids, amt, n

    # ------------------------------------------------------------- queue

    def append(self, ptask: PendingTask):
        cid = self._cls(ptask)
        tag = self._next_tag
        self._next_tag += 1
        ptask.tag = tag
        self._tags[tag] = ptask
        self._lib.scx_push(self._h, cid, tag)

    def remove(self, ptask: PendingTask) -> bool:
        tag = ptask.tag
        if tag not in self._tags:
            return False
        ok = self._lib.scx_remove(self._h, self._cls(ptask), tag)
        if ok:
            del self._tags[tag]
        return bool(ok)

    def requeue_front(self, ptask: PendingTask):
        cid = self._cls(ptask)
        if ptask.tag == 0 or ptask.tag not in self._tags:
            tag = self._next_tag
            self._next_tag += 1
            ptask.tag = tag
            self._tags[tag] = ptask
        self._lib.scx_push_front(self._h, cid, ptask.tag)

    def head(self, sched_class) -> Optional[PendingTask]:
        cid = self._cls_ids.get(sched_class)
        if cid is None:
            return None
        tag = self._lib.scx_head(self._h, cid)
        return self._tags.get(tag) if tag else None

    def pop_head(self, sched_class) -> Optional[PendingTask]:
        cid = self._cls_ids.get(sched_class)
        if cid is None:
            return None
        tag = self._lib.scx_pop_head(self._h, cid)
        if not tag:
            return None
        return self._tags.pop(tag, None)

    def pending_count(self) -> int:
        return int(self._lib.scx_pending(self._h))

    def pending_tasks(self) -> List[PendingTask]:
        return list(self._tags.values())

    def poll(self):
        lib = self._lib
        nblocked = ctypes.c_int(0)
        more = ctypes.c_int(0)
        n = lib.scx_poll(self._h, self._b_tags, self._b_cls, self._b_off,
                         self._b_cnt, self._b_chips, POLL_MAX,
                         POLL_MAXCHIPS, self._b_btags, self._b_bcls,
                         ctypes.byref(nblocked), POLL_MAXBLOCKED,
                         ctypes.byref(more))
        dispatches = []
        tags = self._tags
        for i in range(n):
            pt = tags.pop(self._b_tags[i], None)
            off, cnt = self._b_off[i], self._b_cnt[i]
            if pt is None:
                # Tag-map desync: the C++ ledger already deducted resources
                # and chips for this head.  Refund the orphaned acquire so
                # capacity is not leaked, and log the desync.
                chips = (ctypes.c_int32 * cnt)(*self._b_chips[off:off + cnt]) \
                    if cnt else ctypes.cast(None, _i32p)
                lib.scx_release(self._h, self._b_cls[i], chips, cnt)
                logger.warning("NativeLedger.poll: unknown tag %r from "
                               "scx_poll; refunded class %d (%d chips)",
                               self._b_tags[i], self._b_cls[i], cnt)
                continue
            dispatches.append((pt, tuple(self._b_chips[off:off + cnt])))
        blocked = []
        for i in range(nblocked.value):
            pt = tags.get(self._b_btags[i])
            if pt is not None:
                blocked.append(pt)
        return dispatches, blocked, bool(more.value)

    # --------------------------------------------------------- resources

    def feasible(self, ptask: PendingTask) -> bool:
        return bool(self._lib.scx_feasible(self._h, self._cls(ptask)))

    def acquire(self, ptask: PendingTask) -> Optional[Tuple[int, ...]]:
        got = self._lib.scx_acquire(self._h, self._cls(ptask),
                                    self._chipbuf, len(self._chipbuf))
        if got < 0:
            return None
        return tuple(self._chipbuf[:got])

    def release(self, ptask: PendingTask, chips: Tuple[int, ...] = ()):
        n = len(chips)
        arr = (ctypes.c_int32 * n)(*chips) if n else \
            ctypes.cast(None, _i32p)
        self._lib.scx_release(self._h, self._cls(ptask), arr, n)

    # ----------------------------------------------------------- bundles

    def prepare_bundle(self, key, res: Dict[str, float]) -> bool:
        ids, amt, n = self._res_arrays(res)
        return bool(self._lib.scx_prepare(
            self._h, self._bundle(key), ids, amt, n,
            int(res.get("GPU", 0))))

    def commit_bundle(self, key) -> bool:
        return bool(self._lib.scx_commit(self._h, self._bundle(key)))

    def cancel_bundle(self, key) -> bool:
        return bool(self._lib.scx_cancel_bundle(self._h, self._bundle(key)))

    def return_bundle(self, key) -> bool:
        return bool(self._lib.scx_return_bundle(self._h, self._bundle(key)))

    def drain_bundle(self, key) -> List[PendingTask]:
        """Pop every queued task bound to this bundle AND free the
        bundle's scheduling classes + interning entries (a PG-churning
        raylet must not accumulate dead classes — native Class structs
        are tombstoned, the id is never reused)."""
        bid = self._bundle_ids.get(key)
        if bid is None:
            return []
        maxn = max(16, self.pending_count())
        buf = (ctypes.c_uint64 * maxn)()
        n = self._lib.scx_drain_bundle(self._h, bid, buf, maxn)
        out = []
        for i in range(n):
            pt = self._tags.pop(buf[i], None)
            if pt is not None:
                out.append(pt)
        # drop interning entries for the dead classes; a later task for
        # the same (pg, bundle) re-interns cleanly
        for sc in [sc for sc, cid in self._cls_ids.items()
                   if sc[1] == key]:
            self._cls_rev.pop(self._cls_ids.pop(sc), None)
        # the bundle id must SURVIVE while native state (a committed
        # pool or a prepared reservation) still exists — drain_pg dooms
        # sibling-bundle tasks before those bundles' own return_bundle
        # arrives, and dropping the id here would orphan the pool (its
        # return would re-intern a fresh id, find no pool, and leak the
        # bundle's resources and chips permanently)
        if not self._lib.scx_has_bundle(self._h, bid):
            del self._bundle_ids[key]
        return out

    def drain_pg(self, pg_id: str) -> List[PendingTask]:
        """Drain EVERY bundle of a placement group — including bundles
        this node never hosted: tasks may queue against a bundle before
        its prepare lands, and a removed PG's return_bundle only arrives
        for bundles assigned here (the sibling-bundle hang)."""
        out: List[PendingTask] = []
        for key in [k for k in self._bundle_ids if k[0] == pg_id]:
            out.extend(self.drain_bundle(key))
        return out

    def has_bundle(self, key) -> bool:
        return bool(self._lib.scx_has_bundle(self._h, self._bundle(key)))

    # ----------------------------------------------------- introspection

    def snapshot(self) -> Dict[str, float]:
        g = self._lib.scx_node_get
        h = self._h
        out = {k: g(h, self._res_ids[k]) for k in self._report_keys}
        # custom resources that appeared after init (dynamic demands)
        for k, rid in self._res_ids.items():
            if k not in out and k != "GPU":
                v = g(h, rid)
                if v:
                    out[k] = v
        return out

    def avail_get(self, name: str) -> float:
        rid = self._res_ids.get(name)
        if rid is None:
            return 0.0
        return float(self._lib.scx_node_get(self._h, rid))

    def node_chips_count(self) -> int:
        return int(self._lib.scx_node_chips(
            self._h, ctypes.cast(None, _i32p), 0))


def make_ledger(totals: Dict[str, float], chips: List[int]):
    if _lib() is not None:
        try:
            return NativeLedger(totals, chips)
        except Exception:
            pass
    return PyLedger(totals, chips)
