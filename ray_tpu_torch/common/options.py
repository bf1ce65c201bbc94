"""Central validation of every ``@remote``/``.options()`` argument.

Copied from the JAX package's ``ray_tpu/common/options.py``
(role-equivalent to the reference's single-source-of-truth option table,
python/ray/_private/ray_option_utils.py). The accelerator option is
``num_gpus``: the raylet grants GPUs by index, as JAX grants TPU chips.
``num_tpus`` and ``tpu_topology`` are refused with a ``ValueError`` that
names ``num_gpus``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass
class _Option:
    types: tuple
    validator: Optional[Callable[[Any], Optional[str]]] = None
    default: Any = None


def _nonneg(v):
    if v is not None and v < 0:
        return "must be >= 0"


def _pos(v):
    if v is not None and v <= 0:
        return "must be > 0"


def _retries(v):
    if v is not None and v < -1:
        return "must be >= -1 (-1 means infinite)"


def _resources_dict(v):
    if v is None:
        return None
    if not isinstance(v, dict):
        return "must be a dict"
    for k, val in v.items():
        if not isinstance(k, str):
            return f"resource name {k!r} must be a string"
        if k in ("CPU", "GPU", "TPU", "memory"):
            return f"use num_cpus/num_gpus/memory instead of resources[{k!r}]"
        if not isinstance(val, (int, float)) or val < 0:
            return f"resource {k!r} quantity must be a non-negative number"


_NUM = (int, float, type(None))

COMMON_OPTIONS: Dict[str, _Option] = {
    "num_cpus": _Option(_NUM, _nonneg),
    "num_gpus": _Option(_NUM, _nonneg),
    "memory": _Option(_NUM, _pos),
    "object_store_memory": _Option(_NUM, _pos),
    "resources": _Option((dict, type(None)), _resources_dict),
    "accelerator_type": _Option((str, type(None))),
    "scheduling_strategy": _Option((str, object, type(None))),
    "runtime_env": _Option((dict, object, type(None))),
    "max_retries": _Option(_NUM, _retries),
    "retry_exceptions": _Option((bool, list, tuple, type(None))),
    "name": _Option((str, type(None))),
    "namespace": _Option((str, type(None))),
    "lifetime": _Option((str, type(None)),
                        lambda v: None if v in (None, "detached", "non_detached")
                        else "must be None, 'detached' or 'non_detached'"),
    "_metadata": _Option((dict, type(None))),
    "label_selector": _Option((dict, type(None))),
}

TASK_ONLY_OPTIONS: Dict[str, _Option] = {
    "num_returns": _Option(_NUM, lambda v: None if v is None or v >= 0 else "must be >= 0"),
    "max_calls": _Option(_NUM, _nonneg),
}

ACTOR_ONLY_OPTIONS: Dict[str, _Option] = {
    "max_restarts": _Option(_NUM, _retries),
    "max_task_retries": _Option(_NUM, _retries),
    "max_concurrency": _Option(_NUM, _pos),
    "max_pending_calls": _Option(_NUM, _retries),
    "get_if_exists": _Option((bool, type(None))),
    "concurrency_groups": _Option((dict, list, type(None))),
}

# TPU options of the JAX package, refused by name
_TPU_OPTIONS = ("num_tpus", "tpu_topology")

TASK_OPTIONS = {**COMMON_OPTIONS, **TASK_ONLY_OPTIONS}
ACTOR_OPTIONS = {**COMMON_OPTIONS, **ACTOR_ONLY_OPTIONS}


def validate_options(opts: Optional[Dict[str, Any]], is_actor: bool) -> Dict[str, Any]:
    if opts is None:
        return {}
    table = ACTOR_OPTIONS if is_actor else TASK_OPTIONS
    out = {}
    for k, v in opts.items():
        if k in _TPU_OPTIONS:
            raise ValueError(
                f"Option {k!r} is not supported: ray_tpu_torch schedules "
                f"GPUs, request them with num_gpus")
        if k not in table:
            kind = "actors" if is_actor else "tasks"
            raise ValueError(f"Invalid option {k!r} for {kind}. Valid: {sorted(table)}")
        spec = table[k]
        if not isinstance(v, spec.types) and v is not None:
            raise TypeError(f"Option {k!r} must be of type {spec.types}, got {type(v)}")
        if spec.validator is not None:
            err = spec.validator(v)
            if err:
                raise ValueError(f"Option {k!r} {err}")
        out[k] = v
    return out


def resource_dict_from_options(opts: Dict[str, Any], is_actor: bool) -> Dict[str, float]:
    """Flatten options into the scheduler's resource demand map."""
    res: Dict[str, float] = {}
    num_cpus = opts.get("num_cpus")
    if num_cpus is None:
        # Reference semantics: tasks default to 1 CPU; actors require 1 CPU
        # for placement but hold 0 while running, so long-lived actors don't
        # starve the node (python/ray/_private/ray_option_utils.py defaults).
        num_cpus = 0 if is_actor else 1
    if num_cpus:
        res["CPU"] = float(num_cpus)
    for key, name in (("num_gpus", "GPU"), ("memory", "memory")):
        v = opts.get(key)
        if v:
            res[name] = float(v)
    for k, v in (opts.get("resources") or {}).items():
        if v:
            res[k] = float(v)
    return res
