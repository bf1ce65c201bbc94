"""Asynchronous learner thread: decouples device updates from sampling.

Reference analogue: rllib/execution/learner_thread.py:15 (and the
multi_gpu variant) — the defining IMPALA structure: actors keep sampling
while the learner drains a bounded in-memory queue. The port's copy of
``ray_tpu/rllib/execution/learner_thread.py`` (no JAX), kept whole: one
dedicated thread owns every ``policy.learn_on_batch`` call (launched on
the device the policy names, with its index, so nothing rests on the
thread's current device), and weight reads for broadcast take the same
lock (``get_weights`` copies to the host, which waits for the queued
update). An error the learner raises, a CUDA error included, is kept
and re-raised by ``check_error`` (and ``put``), never swallowed.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Optional


class LearnerThread(threading.Thread):
    def __init__(self, policy, max_queue_size: int = 16):
        super().__init__(daemon=True, name="rllib-learner")
        self.policy = policy
        self.inqueue: "queue.Queue" = queue.Queue(maxsize=max_queue_size)
        self.weights_lock = threading.Lock()
        self.stopped = False
        self.num_steps = 0
        self.num_samples_trained = 0
        self.learn_time_total = 0.0
        self.queue_wait_total = 0.0
        self.stats: Dict[str, Any] = {}
        self._error: Optional[BaseException] = None

    def run(self):
        while not self.stopped:
            try:
                t0 = time.perf_counter()
                batch = self.inqueue.get(timeout=0.2)
                self.queue_wait_total += time.perf_counter() - t0
            except queue.Empty:
                continue
            if batch is None:
                break
            try:
                t1 = time.perf_counter()
                with self.weights_lock:
                    self.stats = self.policy.learn_on_batch(batch)
                self.learn_time_total += time.perf_counter() - t1
                self.num_steps += 1
                self.num_samples_trained += batch.count
            except BaseException as e:  # surfaced by training_step
                self._error = e
                self.stopped = True

    # ---- caller-side API ----

    def put(self, batch, timeout: float = 60.0) -> bool:
        """Enqueue a batch; False if the learner is saturated (caller
        should apply backpressure by not relaunching that sampler yet)."""
        self.check_error()
        try:
            self.inqueue.put(batch, timeout=timeout)
            return True
        except queue.Full:
            return False

    def get_weights(self):
        with self.weights_lock:
            return self.policy.get_weights()

    def check_error(self):
        if self._error is not None:
            raise RuntimeError("learner thread died") from self._error

    def stop(self):
        self.stopped = True
        try:
            self.inqueue.put_nowait(None)
        except queue.Full:
            pass

    def metrics(self) -> Dict[str, Any]:
        return {
            "learner_queue_size": self.inqueue.qsize(),
            "num_learner_steps": self.num_steps,
            "num_samples_trained": self.num_samples_trained,
            "learn_time_total_s": self.learn_time_total,
            "learner_queue_wait_total_s": self.queue_wait_total,
        }
