"""Custom reducer plumbing for ObjectRefs/ActorHandles.

Reference semantics: ObjectRefs and ActorHandles have custom reducers that
carry owner addresses; when a ref is deserialized in another process that
process registers as a *borrower* with the owner (SURVEY.md §8.1, reference:
core_worker/reference_count.h AddBorrowedObject). Serialization of a value
collects every contained ref so the envelope can list them (the owner then
adds submitted-task/borrower references before the value leaves the process).
"""

from __future__ import annotations

import contextlib
import threading
from typing import List

_tls = threading.local()


@contextlib.contextmanager
def collecting_refs(sink: List):
    """While active, ObjectRef reducers append (hex_id, owner_addr) to sink."""
    prev = getattr(_tls, "sink", None)
    _tls.sink = sink
    try:
        yield sink
    finally:
        _tls.sink = prev


def record_ref(ref_info):
    sink = getattr(_tls, "sink", None)
    if sink is not None:
        sink.append(ref_info)
