"""Serializability inspector.

Reference analogue: python/ray/util/check_serialize.py
(inspect_serializability) — recursively locate the members of an object
that fail cloudpickle, instead of one opaque PicklingError.

The port's copy of ``ray_tpu/util/check_serialize.py`` (imports renamed to
``ray_tpu_torch``).
"""

from __future__ import annotations

import inspect
from typing import Any, Set, Tuple

import cloudpickle


class FailureTuple:
    def __init__(self, obj: Any, name: str, parent: Any):
        self.obj = obj
        self.name = name
        self.parent = parent

    def __repr__(self):
        return f"FailureTuple({self.name!r} from {self.parent!r})"


def _check(obj: Any) -> bool:
    try:
        cloudpickle.dumps(obj)
        return True
    except Exception:
        return False


def inspect_serializability(
        obj: Any, name: str = "object", depth: int = 3,
        _parent: Any = None,
        _failures: Set[int] = None,
        _out: list = None) -> Tuple[bool, list]:
    """Return (serializable, [FailureTuple...]): the deepest members that
    fail pickling."""
    if _out is None:
        _out = []
    if _failures is None:
        _failures = set()
    if _check(obj):
        return True, _out
    found_deeper = False
    if depth > 0:
        members: list = []
        if inspect.isfunction(obj):
            closure = inspect.getclosurevars(obj)
            members = list(closure.nonlocals.items()) + \
                list(closure.globals.items())
        elif hasattr(obj, "__dict__") and isinstance(obj.__dict__, dict):
            members = list(obj.__dict__.items())
        elif isinstance(obj, dict):
            members = list(obj.items())
        elif isinstance(obj, (list, tuple, set)):
            members = [(f"[{i}]", v) for i, v in enumerate(obj)]
        for mname, member in members:
            # the recursive call re-checks the member itself, so no
            # pre-filter pickle here (would double the diagnostic cost)
            ok, _ = inspect_serializability(
                member, name=str(mname), depth=depth - 1,
                _parent=obj, _failures=_failures, _out=_out)
            if not ok:
                found_deeper = True
    if not found_deeper and id(obj) not in _failures:
        _failures.add(id(obj))
        _out.append(FailureTuple(obj, name, _parent))
    return False, _out
