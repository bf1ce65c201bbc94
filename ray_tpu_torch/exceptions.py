"""Public exception hierarchy.

Role-equivalent to the reference's python/ray/exceptions.py: errors raised in a
remote task/actor are captured with their traceback, shipped through the object
plane, and re-raised at ``get()`` wrapped in ``TaskError``/``ActorError``.
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A remote task raised; re-raised at get() with the remote traceback."""

    def __init__(self, function_name: str, cause: Exception | None = None,
                 remote_traceback: str = ""):
        self.function_name = function_name
        self.cause = cause
        self.remote_traceback = remote_traceback
        super().__init__(self._format())

    def _format(self):
        msg = f"Task {self.function_name!r} failed"
        if self.cause is not None:
            msg += f": {type(self.cause).__name__}: {self.cause}"
        if self.remote_traceback:
            msg += "\n\nRemote traceback:\n" + self.remote_traceback
        return msg

    @classmethod
    def capture(cls, function_name: str, exc: Exception) -> "TaskError":
        return cls(function_name, exc, traceback.format_exc())


class ActorError(TaskError):
    """An actor method raised, or the actor is unreachable."""


class ActorDiedError(RayTpuError):
    def __init__(self, actor_id=None, reason: str = "actor died"):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(f"Actor {actor_id} died: {reason}")


class ActorUnavailableError(RayTpuError):
    pass


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ObjectLostError(RayTpuError):
    """Object's copies are gone and lineage reconstruction failed/disabled."""

    def __init__(self, object_id=None, reason: str = ""):
        self.object_id = object_id
        super().__init__(f"Object {object_id} lost. {reason}")


class ObjectStoreFullError(RayTpuError):
    pass


class OutOfMemoryError(RayTpuError):
    """Task killed by the node memory monitor."""


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"Task {task_id} was cancelled")


class TaskUnschedulableError(RayTpuError):
    """No node can ever satisfy the task's resource demand."""


class PlacementGroupUnschedulableError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class NodeDiedError(RayTpuError):
    pass


class SliceDownError(RayTpuError):
    """A TPU slice lost a host: all gang members on that slice are failed
    together (ICI collectives are gang-fatal; see SURVEY.md §5.3 TPU note)."""


class CrossLanguageError(RayTpuError):
    pass
