"""Serve-specific exceptions.

Copy of ``ray_tpu/serve/exceptions.py``. Reference analogue:
serve/exceptions.py (BackPressureError). These must
be picklable with their args intact — they travel through the object
plane as the ``cause`` of an ``ActorError`` and are type-checked on the
caller side (router retry, proxy 503 mapping).
"""

from __future__ import annotations


class ReplicaOverloadedError(Exception):
    """A replica's bounded ingress queue was full and the request was
    shed. Retriable: the caller should try another replica (the Router
    and HTTP proxy do this automatically; the proxy maps exhaustion to
    HTTP 503)."""

    def __init__(self, deployment_name: str = "", queue_len: int = 0,
                 limit: int = 0):
        self.deployment_name = deployment_name
        self.queue_len = queue_len
        self.limit = limit
        super().__init__(
            f"replica of deployment {deployment_name!r} overloaded: "
            f"{queue_len} requests in flight >= limit {limit} "
            f"(max_concurrent_queries + max_queued_requests); retriable")

    def __reduce__(self):
        return (ReplicaOverloadedError,
                (self.deployment_name, self.queue_len, self.limit))


class BatchSubmitTimeoutError(TimeoutError):
    """A @serve.batch submit waited longer than ``submit_timeout_s`` for
    the batch fn to produce a result (wedged or very slow batch fn)."""


class StreamBrokenError(Exception):
    """A token stream's replica died (or its stream state was lost)
    mid-generation. The partial output is attached so the caller can
    decide to retry the whole request or surface a CLEAN failure —
    never a silent truncation (docs/LLM_SERVING.md).
    """

    def __init__(self, deployment_name: str = "",
                 tokens_so_far: int = 0, cause: str = ""):
        self.deployment_name = deployment_name
        self.tokens_so_far = tokens_so_far
        self.cause = cause
        super().__init__(
            f"token stream of deployment {deployment_name!r} broke "
            f"after {tokens_so_far} tokens: {cause or 'replica died'}")

    def __reduce__(self):
        return (StreamBrokenError,
                (self.deployment_name, self.tokens_so_far, self.cause))
