"""The port's rtpulint (``ray_tpu_torch/analysis``) against the JAX
package's, and the port's own lint gate, on the CPU.

1. **fixture matrix** — tests/test_static_analysis.py's fixtures go
   through both analyzers, and each gives the codes that test expects
   with the same (code, line, scope, fingerprint). The RTPU005
   fixtures name ``RTT_*`` knobs on the port's side; its messages are
   compared with those names read back as ``RTPU_*`` and its docs path
   (``docs/torch/``) as JAX's.
2. **the tree** — over ``ray_tpu_torch/`` the port's RTPU001/002/003/007
   find exactly what JAX's analyzer finds there; RTPU004/005/006 read
   the port's own registries (its chaos sites, ``RTT_*`` knobs and wire
   schema), which the round trips hold in both directions.
3. **the gate** — ``ray_tpu_torch/`` lints clean against
   ``.rtpulint-torch-baseline`` (fewer than 15 entries, each with its
   reason, none stale), ``ray-tpu-torch lint`` exits 0, and the
   generated ``docs/torch/`` files are fresh.
"""

import ast
import dataclasses
import glob
import json
import os
import subprocess
import sys
import textwrap

import pytest

import ray_tpu.analysis as JA
import ray_tpu_torch.analysis as TA
from ray_tpu.analysis.checkers.env_registry import env_reads as jax_env_reads
from ray_tpu_torch.analysis import baseline as bl
from ray_tpu_torch.analysis import docs_gen
from ray_tpu_torch.analysis.cli import DEFAULT_EXCLUDES
from ray_tpu_torch.analysis.core import analyze_file, iter_py_files

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO_ROOT, "ray_tpu_torch")
ALL_CODES = {"RTPU001", "RTPU002", "RTPU003", "RTPU004", "RTPU005",
             "RTPU006", "RTPU007"}
# the codes whose checkers read nothing of either package's tree
TREE_FREE = ["RTPU001", "RTPU002", "RTPU003", "RTPU007"]
# declared chaos sites that no tests/test_torch_*.py file names (ROADMAP
# Queue C, C11): the list may only shrink
UNEXERCISED_SITES = [
    "protocol.send", "protocol.recv", "rpc.request", "worker.execute",
    "raylet.dispatch", "object.pull", "serve.controller.tick",
    "serve.replica.request", "dag.channel", "dag.stage", "net.partition"]

_SITES = {"chaos_sites": ["raylet.dispatch", "protocol.send"]}
_ENV = {"env_registry": ["RTPU_TRACE_SAMPLE", "RTPU_CHAOS"]}
_FV = {"field_versions": {("dag_exec", "tc"): (1, 6),
                          ("worker_register", "direct_address"): (1, 7),
                          ("release_lease", "inflight"): (1, 2)}}
_CTRL = "serve/controller.py"

# (id, source, select, config, relpath, pragmas, the codes JAX's test
# expects): tests/test_static_analysis.py's fixtures
FIXTURES = [
    ("blocking_in_async", """
        import time
        async def f():
            time.sleep(1)
    """, ["RTPU001"], None, None, True, ["RTPU001"]),
    ("blocking_in_sync_ok", """
        import time
        def f():
            time.sleep(1)
    """, ["RTPU001"], None, None, True, []),
    ("await_sleep_ok", """
        import asyncio
        async def f():
            await asyncio.sleep(1)
    """, ["RTPU001"], None, None, True, []),
    ("nested_sync_def_ok", """
        import time
        async def f(loop):
            def worker():
                time.sleep(1)
            await loop.run_in_executor(None, worker)
    """, ["RTPU001"], None, None, True, []),
    ("blocking_pragma", """
        import time
        async def f():
            time.sleep(0)  # rtpulint: ignore[RTPU001]
    """, ["RTPU001"], None, None, True, []),
    ("blocking_pragma_off", """
        import time
        async def f():
            time.sleep(0)  # rtpulint: ignore[RTPU001]
    """, ["RTPU001"], None, None, False, ["RTPU001"]),
    ("config_blocking_calls", """
        async def f():
            heavy_io()
    """, ["RTPU001"], {"blocking_calls": ["heavy_io"]}, None, True,
     ["RTPU001"]),
    ("lock_across_await", """
        async def f(self):
            with self._lock:
                await self.flush()
    """, ["RTPU002"], None, None, True, ["RTPU002"]),
    ("lock_without_await_ok", """
        async def f(self):
            with self._lock:
                self.n += 1
    """, ["RTPU002"], None, None, True, []),
    ("async_lock_ok", """
        async def f(self):
            async with self._lock:
                await self.flush()
    """, ["RTPU002"], None, None, True, []),
    ("daemon_thread_no_stop", """
        import threading
        class Flusher:
            def start(self):
                self._t = threading.Thread(target=self._run, daemon=True)
                self._t.start()
    """, ["RTPU003"], None, None, True, ["RTPU003"]),
    ("daemon_thread_with_stop_ok", """
        import threading
        class Flusher:
            def start(self):
                self._t = threading.Thread(target=self._run, daemon=True)
                self._t.start()
            def stop(self):
                self._stop = True
                self._t.join()
    """, ["RTPU003"], None, None, True, []),
    ("incref_no_decref", """
        class Pages:
            def grab(self, pool, pid):
                pool.incref(pid)
    """, ["RTPU003"], None, None, True, ["RTPU003"]),
    ("incref_decref_ok", """
        class Pages:
            def grab(self, pool, pid):
                pool.incref(pid)
            def drop(self, pool, pid):
                pool.decref(pid)
    """, ["RTPU003"], None, None, True, []),
    ("error_path_leak", """
        def ship(pool, pid, conn):
            pool.incref(pid)
            conn.send(pid)
            pool.decref(pid)
    """, ["RTPU003"], None, None, True, ["RTPU003"]),
    ("error_path_finally_ok", """
        def ship(pool, pid, conn):
            pool.incref(pid)
            try:
                conn.send(pid)
            finally:
                pool.decref(pid)
    """, ["RTPU003"], None, None, True, []),
    ("undeclared_site", """
        from ray_tpu._private import chaos
        def f():
            chaos.hit("raylet.dispach", None)
    """, ["RTPU004"], _SITES, None, True, ["RTPU004"]),
    ("declared_site_ok", """
        from ray_tpu._private import chaos
        def f():
            chaos.hit("raylet.dispatch", None)
    """, ["RTPU004"], _SITES, None, True, []),
    ("site_constant_ok", """
        from ray_tpu._private import chaos
        CHAOS_SITE = "protocol.send"
        def f():
            chaos.hit(CHAOS_SITE, None)
    """, ["RTPU004"], _SITES, None, True, []),
    ("site_unresolvable", """
        from ray_tpu._private import chaos
        def f(site):
            chaos.hit(site, None)
    """, ["RTPU004"], _SITES, None, True, ["RTPU004"]),
    ("unregistered_env", """
        import os
        v = os.environ.get("RTPU_BRAND_NEW_KNOB")
    """, ["RTPU005"], _ENV, None, True, ["RTPU005"]),
    ("env_typo", """
        import os
        v = os.environ.get("RTPU_TRACE_SAMPEL")
    """, ["RTPU005"], _ENV, None, True, ["RTPU005"]),
    ("env_all_idioms_ok", """
        import os
        a = os.environ.get("RTPU_CHAOS")
        b = os.getenv("RTPU_TRACE_SAMPLE")
        c = os.environ["RTPU_CHAOS"]
        d = "RTPU_CHAOS" in os.environ
        e = os.environ.setdefault("RTPU_TRACE_SAMPLE", "1.0")
    """, ["RTPU005"], _ENV, None, True, []),
    ("env_other_ok", """
        import os
        v = os.environ.get("HOME")
    """, ["RTPU005"], _ENV, None, True, []),
    ("unguarded_read", """
        def handle(payload):
            return payload["tc"]
    """, ["RTPU006"], _FV, None, True, ["RTPU006"]),
    ("get_read_ok", """
        def handle(payload):
            tc = payload.get("tc")
            if tc:
                attach(tc)
    """, ["RTPU006"], _FV, None, True, []),
    ("tuple_guard_ok", """
        def handle(self, payload, conn):
            ver = conn.meta.get("peer_protocol_version") or (1, 0)
            if tuple(ver[:2]) >= (1, 2):
                return payload["inflight"]
            return 0
    """, ["RTPU006"], _FV, None, True, []),
    ("flag_guard_ok", """
        def recv(self, payload):
            if self._trace_peers:
                span(payload["tc"])
    """, ["RTPU006"], _FV, None, True, []),
    ("min_peer_guard_ok", """
        def register(self, payload, min_peer):
            if min_peer >= (1, 7):
                return payload["direct_address"]
    """, ["RTPU006"], _FV, None, True, []),
    ("field_write_ok", """
        def build(payload, ctx):
            payload["tc"] = ctx
    """, ["RTPU006"], _FV, None, True, []),
    ("ungated_read_ok", """
        def handle(payload):
            return payload["method"]
    """, ["RTPU006"], _FV, None, True, []),
    ("inert_swallow", """
        def tick(self):
            while True:
                try:
                    self.step()
                except Exception:
                    pass
    """, ["RTPU007"], None, _CTRL, True, ["RTPU007"]),
    ("swallow_logs_ok", """
        def tick(self):
            while True:
                try:
                    self.step()
                except Exception:
                    logger.exception("tick failed")
    """, ["RTPU007"], None, _CTRL, True, []),
    ("swallow_records_ok", """
        def tick(self):
            while True:
                try:
                    self.step()
                except Exception as e:
                    self._last_error = e
    """, ["RTPU007"], None, _CTRL, True, []),
    ("swallow_outside_loop_ok", """
        def once(self):
            try:
                self.step()
            except Exception:
                pass
    """, ["RTPU007"], None, _CTRL, True, []),
    ("swallow_outside_control_plane_ok", """
        def tick(self):
            while True:
                try:
                    self.step()
                except Exception:
                    pass
    """, ["RTPU007"], None, "util/helpers.py", True, []),
    ("swallow_pragma", """
        def tick(self):
            while True:
                try:
                    self.step()
                except Exception:  # rtpulint: ignore[RTPU007]
                    pass
    """, ["RTPU007"], None, _CTRL, True, []),
    ("bare_pragma_all_codes", """
        import time
        async def f():
            time.sleep(1)  # rtpulint: ignore
    """, None, None, None, True, []),
    ("own_line_pragma", """
        import time
        async def f():
            # rtpulint: ignore[RTPU001]
            time.sleep(1)
    """, ["RTPU001"], None, None, True, []),
    ("pragma_wrong_code", """
        import time
        async def f():
            time.sleep(1)  # rtpulint: ignore[RTPU002]
    """, ["RTPU001"], None, None, True, ["RTPU001"]),
]


def _to_port(obj):
    """A fixture's RTPU_* knob names as the port's RTT_* names."""
    if isinstance(obj, str):
        return obj.replace("RTPU_", "RTT_")
    if isinstance(obj, dict):
        return {k: _to_port(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_port(v) for v in obj]
    return obj


def _key(f, port=False):
    """(code, line, scope, fingerprint); a port finding's fingerprint is
    taken with its message in JAX's words (knob names, docs path)."""
    if port:
        f = dataclasses.replace(f, message=f.message.replace(
            "RTT_", "RTPU_").replace("docs/torch/", "docs/"))
    return (f.code, f.line, f.scope, f.fingerprint())


@pytest.mark.parametrize("fid, src, select, config, relpath, pragmas, want",
                         FIXTURES, ids=[f[0] for f in FIXTURES])
def test_fixture_matrix_matches_jax(fid, src, select, config, relpath,
                                    pragmas, want):
    src = textwrap.dedent(src)
    jax = JA.analyze_source(src, relpath=relpath, config=config,
                            select=select, respect_pragmas=pragmas)
    env = select == ["RTPU005"]
    port = TA.analyze_source(_to_port(src) if env else src,
                             relpath=relpath,
                             config=_to_port(config) if env else config,
                             select=select, respect_pragmas=pragmas)
    assert sorted(f.code for f in jax) == want
    assert [_key(f, port=env) for f in port] == [_key(f) for f in jax]


def test_fixture_messages_name_the_port():
    """The typo hint names the port's knob, and the did-you-mean hint a
    declared site."""
    fs = TA.analyze_source(
        'import os\nv = os.environ.get("RTT_TRACE_SAMPEL")\n',
        select=["RTPU005"], config=_to_port(_ENV))
    assert "`RTT_TRACE_SAMPLE`" in fs[0].message and "typo" in fs[0].message
    assert TA.analyze_source(
        'import os\nv = os.environ.get("RTPU_BRAND_NEW_KNOB")\n',
        select=["RTPU005"], config=_to_port(_ENV)) == []
    fs = TA.analyze_source('chaos.hit("raylet.dispach", None)\n',
                           select=["RTPU004"], config=_SITES)
    assert "raylet.dispatch" in fs[0].message


def test_registry_matches_jax():
    jax, port = JA.registry(), TA.registry()
    assert set(port) == set(jax) == ALL_CODES
    for code, cls in port.items():
        assert cls.name == jax[code].name
        assert _to_port(jax[code].description).replace(
            "docs/", "docs/torch/") == cls.description


# ------------------------------------------------------------- baseline


def _one_finding(src="import time\nasync def f():\n    time.sleep(1)\n"):
    fs = TA.analyze_source(src, select=["RTPU001"], relpath="pkg/mod.py")
    assert len(fs) == 1
    return fs[0]


def test_baseline_round_trip_and_rules(tmp_path):
    f = _one_finding()
    p = tmp_path / "bl"
    bl.save(str(p), [f])
    entries = bl.load(str(p))
    assert [(e.code, e.fingerprint) for e in entries] == [
        ("RTPU001", f.fingerprint())]
    assert bl.apply([f], entries) == ([], [f], [])
    p.write_text(f"{f.code} {f.relpath} {f.scope} {f.fingerprint()}\n")
    with pytest.raises(ValueError, match="justification"):
        bl.load(str(p))
    p.write_text("what even is this\n")
    with pytest.raises(ValueError, match="malformed"):
        bl.load(str(p))
    p.write_text(f"RTPU001 {f.relpath} {f.scope} {'0' * 12}  # fixed\n")
    un, based, stale = bl.apply([f], bl.load(str(p)))
    assert un == [f] and based == [] and len(stale) == 1


def test_fingerprint_stable_across_line_moves():
    a = _one_finding()
    b = _one_finding("\n\n\nimport time\nasync def f():\n    time.sleep(1)\n")
    assert a.line != b.line and a.fingerprint() == b.fingerprint()


def test_baseline_is_the_ports_own_file():
    from ray_tpu.analysis import baseline as jax_bl
    assert bl.DEFAULT_BASENAME == ".rtpulint-torch-baseline"
    assert jax_bl.DEFAULT_BASENAME == ".rtpulint-baseline"
    assert bl.default_path(PKG) == os.path.join(REPO_ROOT,
                                                bl.DEFAULT_BASENAME)


def test_syntax_error_reported_as_rtpu000(tmp_path):
    p = tmp_path / "bad.py"
    p.write_text("def f(:\n")
    assert [f.code for f in analyze_file(str(p), root=str(tmp_path))] == \
        ["RTPU000"]


# ------------------------------------------------------------- the tree


def _tree_keys(analyze_paths, select):
    return [(f.relpath, *_key(f)) for f in analyze_paths(
        [PKG], root=PKG, exclude=DEFAULT_EXCLUDES, select=select)]


def test_tree_findings_match_jax():
    """Over ray_tpu_torch/, the checkers that read no registry find with
    the port's analyzer exactly what JAX's finds (pragmas honoured on
    both sides)."""
    port = _tree_keys(TA.analyze_paths, TREE_FREE)
    assert port == _tree_keys(JA.analyze_paths, TREE_FREE)
    assert {k[1] for k in port} == {"RTPU003"}   # the baselined two


def test_live_tree_version_gate_idioms_pass():
    for rel in ("dag/channel.py", "_private/direct.py"):
        fs = analyze_file(os.path.join(PKG, rel), root=PKG,
                          select=["RTPU006"])
        assert fs == [], f"{rel}: {[f.render() for f in fs]}"


def _hit_sites(paths):
    from ray_tpu_torch.analysis.core import (call_name, const_str,
                                             module_constants)
    sites = {}
    for fp in iter_py_files(paths):
        if fp.replace(os.sep, "/").endswith("_private/chaos.py"):
            continue
        with open(fp, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        consts = module_constants(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            name = call_name(node)
            if name is None or not (name.rsplit(".", 1)[-1] == "hit"
                                    or name == "chaos_hit"):
                continue
            site = const_str(node.args[0])
            if site is None and isinstance(node.args[0], ast.Name):
                site = consts.get(node.args[0].id)
            if site:
                sites.setdefault(site, []).append(fp)
    return sites


def test_chaos_registry_round_trip():
    """Every site the port hits is declared in its chaos.SITES, and every
    declared site is hit somewhere in ray_tpu_torch/. Of the declared
    sites, those no port test names are exactly UNEXERCISED_SITES."""
    from ray_tpu_torch._private.chaos import SITES
    used = _hit_sites([PKG])
    assert set(used) == set(SITES)
    corpus = "".join(open(fp, encoding="utf-8").read() for fp in
                     glob.glob(os.path.join(REPO_ROOT, "tests",
                                            "test_torch_*.py"))
                     if not fp.endswith("test_torch_analysis.py"))
    assert [s for s in SITES if s not in corpus] == UNEXERCISED_SITES


def test_env_registry_round_trip():
    """Every RTT_* read of the package, its tests and chip_smoke.py is
    registered, and every hand-written entry is mentioned by one of
    them (the registry itself does not count)."""
    from ray_tpu_torch.analysis.config_registry import (CONFIG_VARS,
                                                        STATIC_VARS)
    paths = docs_gen.scan_paths(REPO_ROOT)
    reads = docs_gen.scan_env_reads(paths, REPO_ROOT)
    assert sorted(n for n in reads if n not in CONFIG_VARS) == []
    assert all(n.startswith("RTT_") for n in CONFIG_VARS)
    corpus = "".join(open(fp, encoding="utf-8").read()
                     for fp in iter_py_files(paths, exclude=[
                         "ray_tpu_torch/analysis/"]))
    assert sorted(n for n in STATIC_VARS if n not in corpus) == []


def test_no_port_test_reads_an_rtpu_variable():
    """The JAX package's round trip scans all of tests/: a port test
    must read no RTPU_* knob."""
    hits = []
    for fp in glob.glob(os.path.join(REPO_ROOT, "tests", "test_torch_*.py")):
        with open(fp, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        hits += [(os.path.basename(fp), n) for n, _ in jax_env_reads(tree)
                 if n.startswith("RTPU_")]
    assert hits == []


# ------------------------------------------------------------- the gate


def test_ray_tpu_torch_tree_lints_clean():
    """THE gate: zero unsuppressed findings over ray_tpu_torch/ and no
    stale entry in the port's baseline, which stays small and gives
    each entry its reason."""
    findings = TA.analyze_paths([PKG], root=PKG, exclude=DEFAULT_EXCLUDES)
    entries = bl.load(os.path.join(REPO_ROOT, bl.DEFAULT_BASENAME))
    assert len(entries) < 15, "baseline must stay small — fix, don't park"
    assert all(e.comment for e in entries)
    unsuppressed, _based, stale = bl.apply(findings, entries)
    assert unsuppressed == [], "\n".join(f.render() for f in unsuppressed)
    assert stale == [], [e.key() for e in stale]


def test_generated_docs_are_fresh():
    """docs/torch/CONFIGURATION.md and the chaos table of
    docs/torch/FAULT_TOLERANCE.md match a regeneration byte for byte
    (``python -m ray_tpu_torch.analysis --gen-docs``); nothing outside
    docs/torch/ is generated."""
    results = docs_gen.generate_all(REPO_ROOT, write=False)
    assert sorted(os.path.relpath(p, REPO_ROOT) for p in results) == [
        "docs/torch/CONFIGURATION.md", "docs/torch/FAULT_TOLERANCE.md"]
    stale = [p for p, (_c, changed) in results.items() if changed]
    assert stale == [], f"stale generated docs: {stale}"


def test_cli_lint_json_and_check_docs():
    """``ray-tpu-torch lint --json`` and ``python -m
    ray_tpu_torch.analysis --check-docs`` end to end, each in a fresh
    process from the repo root, with no path given (the default is the
    port's package)."""
    env = {**os.environ, "PYTHONPATH": REPO_ROOT}
    code = ("import sys\nfrom ray_tpu_torch.scripts.cli import main\n"
            "try:\n    main(['lint', '--json'])\n"
            "except SystemExit as e:\n    sys.exit(e.code)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO_ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["findings"] == [] and doc["stale_baseline"] == []
    assert len(doc["baselined"]) == 2 and set(doc["checkers"]) == ALL_CODES
    assert doc["files_scanned"] == len(list(iter_py_files(
        [PKG], exclude=DEFAULT_EXCLUDES)))
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch.analysis",
                           "--check-docs"], capture_output=True, text=True,
                          cwd=REPO_ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("up to date") == 2
