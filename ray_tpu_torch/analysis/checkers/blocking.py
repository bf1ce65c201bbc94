"""RTPU001 — blocking call inside ``async def``.

Every event loop in the substrate (the GCS server, raylet dispatch,
serve router/replica, the LLM engine step loop) multiplexes hundreds
of connections on one thread; a single ``time.sleep`` or sync
``subprocess`` call inside a coroutine stalls all of them — exactly
the class of stall ``RTT_LOOP_STALL_S`` exists to catch at runtime.
This checker catches it at lint time.

Nested *sync* ``def``s inside a coroutine are not flagged (they run
wherever they're called — typically an executor); ``await
loop.run_in_executor(None, time.sleep, ...)`` passes the callable, not
a call, so it's naturally fine.

The port's copy of ``ray_tpu/analysis/checkers/blocking.py``.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from ray_tpu_torch.analysis.core import (Checker, Finding, ModuleContext,
                                         call_name, register,
                                         walk_no_nested_defs)

# dotted call names that block the calling thread. ``config`` key
# ``blocking_calls`` extends/overrides this set per run.
BLOCKING_CALLS = {
    "time.sleep",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "os.system", "os.waitpid", "os.wait",
    "socket.create_connection", "socket.getaddrinfo",
    "urllib.request.urlopen",
    "requests.get", "requests.post", "requests.put", "requests.request",
    "shutil.copytree", "shutil.rmtree",
}

# method names that block when called on anything (sync socket/file
# drains and queue waits); attribute-only matches, so false positives
# stay possible on unrelated objects — suppress with a pragma when the
# receiver is genuinely non-blocking.
BLOCKING_METHODS = {
    "recv_into",  # sync socket drain
}


@register
class BlockingCallChecker(Checker):
    code = "RTPU001"
    name = "blocking-call-in-async"
    description = ("blocking call (time.sleep, sync subprocess/socket/"
                   "urllib) inside async def stalls the event loop")

    def check_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        blocking = set(BLOCKING_CALLS)
        blocking |= set(ctx.config.get("blocking_calls", ()))
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            for sub in walk_no_nested_defs(node):
                if not isinstance(sub, ast.Call):
                    continue
                name = call_name(sub)
                if name is None:
                    continue
                leaf = name.rsplit(".", 1)[-1]
                if name in blocking or (
                        # match `x.time.sleep`-style rebinds too:
                        # compare the trailing two components
                        "." in name and
                        ".".join(name.rsplit(".", 2)[-2:]) in blocking):
                    out.append(ctx.finding(
                        self.code, sub,
                        f"blocking call `{name}(...)` inside "
                        f"`async def {node.name}` — stalls the event "
                        f"loop; await an async equivalent or move it "
                        f"to an executor"))
                elif leaf in BLOCKING_METHODS and "." in name:
                    out.append(ctx.finding(
                        self.code, sub,
                        f"`{name}(...)` blocks the calling thread "
                        f"inside `async def {node.name}`"))
        return out
