"""Built-in rtpulint checkers. Importing this package registers every
checker with the core registry — ``core.registry()`` does it lazily.

| code    | name                        | invariant                     |
|---------|-----------------------------|-------------------------------|
| RTPU001 | blocking-call-in-async      | no blocking calls on a loop   |
| RTPU002 | lock-across-await           | thread locks don't span await |
| RTPU003 | unpaired-acquire-release    | incref/span/thread pairing    |
| RTPU004 | undeclared-chaos-site       | chaos.hit sites are declared  |
| RTPU005 | unregistered-env-var        | RTT_* reads are registered    |
| RTPU006 | unguarded-versioned-field   | wire minors gate their fields |
| RTPU007 | silent-swallow-in-loop      | control loops log swallows    |

The port's copy of ``ray_tpu/analysis/checkers/__init__.py``.
"""

from ray_tpu_torch.analysis.checkers import (  # noqa: F401
    blocking,
    chaos_sites,
    env_registry,
    excepts,
    locks,
    resources,
    wire_versions,
)
