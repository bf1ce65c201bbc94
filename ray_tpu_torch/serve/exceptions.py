"""Serve exceptions the port's LLM engine raises.

Counterpart of ``ray_tpu/serve/exceptions.py`` (only what the engine
raises). Picklable with its args intact, so it can travel to a caller
and be type-checked there.
"""

from __future__ import annotations


class ReplicaOverloadedError(Exception):
    """A replica's bounded ingress queue was full and the request was
    shed. Retriable: the caller should try another replica."""

    def __init__(self, deployment_name: str = "", queue_len: int = 0,
                 limit: int = 0):
        self.deployment_name = deployment_name
        self.queue_len = queue_len
        self.limit = limit
        super().__init__(
            f"replica of deployment {deployment_name!r} overloaded: "
            f"{queue_len} requests in flight >= limit {limit}; retriable")

    def __reduce__(self):
        return (ReplicaOverloadedError,
                (self.deployment_name, self.queue_len, self.limit))
