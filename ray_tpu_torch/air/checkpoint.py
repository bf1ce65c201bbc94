"""AIR Checkpoint, dict form.

Reference semantics: python/ray/air/checkpoint.py:60. The port's copy of
the dict half of ``ray_tpu/air/checkpoint.py`` (:21-62): ``from_dict`` /
``to_dict``, what ``tune.Trainable.save``/``restore`` use. The directory
and object-ref forms and ``ShardedCheckpoint`` wait for ROADMAP.md's A6a
and A1.
"""

from __future__ import annotations

from typing import Any, Dict


class Checkpoint:
    def __init__(self, data: Dict[str, Any]):
        if data is None:
            raise ValueError("provide a data dict")
        self._data = data

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=dict(data))

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._data)
