"""Single-file dashboard frontend (reference: the dashboard/client React
app, scaled to a dependency-free page served by the same process). Polls
the REST endpoints: cluster status, nodes, serve metrics, tasks (paged +
state filter), actors, jobs, events, logs, and renders the task
timeline from the merged chrome-trace events.

Copied from the JAX package's ``ray_tpu/dashboard/frontend.py``; the
node table shows a GPU column where JAX's shows a TPU one.
"""

INDEX_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>ray_tpu_torch dashboard</title>
<style>
  :root { color-scheme: light dark; }
  body { font: 13px/1.45 system-ui, sans-serif; margin: 0;
         background: Canvas; color: CanvasText; }
  header { padding: 10px 16px; border-bottom: 1px solid color-mix(in srgb,
           CanvasText 18%, transparent); display: flex; gap: 16px;
           align-items: baseline; }
  header h1 { font-size: 15px; margin: 0; }
  header .muted { opacity: .65; }
  main { padding: 12px 16px; display: grid; gap: 14px; }
  section h2 { font-size: 13px; margin: 0 0 6px;
               text-transform: uppercase; letter-spacing: .06em;
               opacity: .75; }
  .tiles { display: flex; gap: 10px; flex-wrap: wrap; }
  .tile { border: 1px solid color-mix(in srgb, CanvasText 18%,
          transparent); border-radius: 8px; padding: 8px 14px;
          min-width: 110px; }
  .tile b { display: block; font-size: 20px; }
  table { border-collapse: collapse; width: 100%; }
  th, td { text-align: left; padding: 3px 10px 3px 0; border-bottom:
           1px solid color-mix(in srgb, CanvasText 10%, transparent);
           font-variant-numeric: tabular-nums; white-space: nowrap; }
  th { opacity: .7; font-weight: 600; }
  td.msg { white-space: normal; }
  .sev-ERROR, .sev-FATAL, .st-FAILED { color: #c62828; font-weight: 600; }
  .sev-WARNING { color: #b26a00; font-weight: 600; }
  .st-FINISHED { color: #2e7d32; }
  .st-RUNNING { color: #1565c0; font-weight: 600; }
  pre { background: color-mix(in srgb, CanvasText 6%, transparent);
        padding: 8px; border-radius: 6px; max-height: 320px;
        overflow: auto; }
  a { color: inherit; }
  select, button { font: inherit; }
  .bar-row { display: flex; align-items: center; height: 14px; }
  .bar-label { width: 180px; flex: none; overflow: hidden;
               text-overflow: ellipsis; opacity: .7; font-size: 11px; }
  .bar-lane { position: relative; flex: 1; height: 12px; }
  .bar { position: absolute; height: 10px; top: 1px; border-radius: 2px;
         background: #1565c0; min-width: 2px; opacity: .85; }
  .bar.failed { background: #c62828; }
  #timeline { max-height: 420px; overflow: auto; border: 1px solid
              color-mix(in srgb, CanvasText 12%, transparent);
              border-radius: 6px; padding: 6px; }
  .muted { opacity: .65; }
</style>
</head>
<body>
<header>
  <h1>ray_tpu_torch</h1>
  <span class="muted" id="updated"></span>
</header>
<main>
  <section><h2>Cluster</h2><div class="tiles" id="tiles"></div></section>
  <section><h2>Serve</h2><table id="serve"></table>
    <div class="muted" id="serve-empty"></div></section>
  <section><h2>Game day</h2>
    <div class="tiles" id="gd-tiles"></div>
    <table id="gameday"></table>
    <div class="muted" id="gd-empty"></div></section>
  <section><h2>Nodes</h2><table id="nodes"></table></section>
  <section>
    <h2>Tasks</h2>
    <div style="margin-bottom:6px">
      state: <select id="taskstate">
        <option value="">(all)</option>
        <option>PENDING_SCHEDULING</option>
        <option>PENDING_NODE_ASSIGNMENT</option>
        <option>RUNNING</option>
        <option>FINISHED</option>
        <option>FAILED</option>
      </select>
      <span class="muted" id="taskmeta"></span>
    </div>
    <table id="tasks"></table>
  </section>
  <section>
    <h2>Task timeline</h2>
    <button id="tl-load">load timeline</button>
    <span class="muted" id="tl-meta"></span>
    <div id="timeline"></div>
  </section>
  <section>
    <h2>Traces</h2>
    <div style="margin-bottom:6px">
      <button id="tr-load">load traces</button>
      <input id="tr-id" placeholder="trace id" size="20">
      <button id="tr-show">waterfall</button>
      <span class="muted" id="tr-meta"></span>
    </div>
    <table id="traces"></table>
    <div class="muted" id="tr-cp"></div>
    <div id="waterfall"></div>
  </section>
  <section><h2>Actors</h2><table id="actors"></table></section>
  <section><h2>Jobs</h2><table id="jobs"></table></section>
  <section><h2>Events</h2><table id="events"></table></section>
  <section>
    <h2>Logs</h2>
    <select id="logsel"></select>
    <pre id="logview">(select a log)</pre>
  </section>
</main>
<script>
const get = async p => (await fetch(p)).json();
const esc = s => String(s).replace(/[&<>]/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;"}[c]));
const row = cells => "<tr>" + cells.map(c => "<td" +
  (c && c.cls ? ` class="${c.cls}"` : "") + ">" +
  esc(c && c.v !== undefined ? c.v : c) + "</td>").join("") + "</tr>";
const head = cols => "<tr>" + cols.map(c => `<th>${c}</th>`).join("")
  + "</tr>";
const ms = s => s == null ? "-" : (s * 1000).toFixed(1) + "ms";

async function refresh() {
  try {
    const s = await get("/api/cluster_status");
    const res = s.cluster_resources || {};
    const t = s.tasks || {};
    const by = t.by_state || {};
    document.getElementById("tiles").innerHTML = [
      ["nodes alive", s.nodes_alive + "/" + s.nodes_total],
      ["actors alive", s.actors_alive + "/" + s.actors_total],
      ["CPU", res.CPU ?? 0], ["GPU", res.GPU ?? 0],
      ["tasks running", by.RUNNING ?? 0],
      ["tasks finished", by.FINISHED ?? 0],
      ["tasks failed", by.FAILED ?? 0],
    ].map(([k, v]) => `<div class="tile"><b>${esc(v)}</b>${esc(k)}
      </div>`).join("");

    const serve = (await get("/api/serve/metrics")).deployments || {};
    const deps = Object.entries(serve);
    document.getElementById("serve-empty").textContent =
      deps.length ? "" : "(no serve deployments)";
    document.getElementById("serve").innerHTML = !deps.length ? "" :
      head(["deployment", "status", "replicas", "queue depth",
            "shed total", "shed/s", "requests", "p99", "ewma"]) +
      deps.map(([n, m]) => row([n, m.status,
        (m.replicas ?? 0) + "/" + (m.target_replicas ?? 0),
        m.queue_len ?? 0, m.shed_total ?? 0, m.shed_rate_per_s ?? 0,
        m.requests_total ?? 0, ms(m.p99_s), ms(m.ewma_s)])).join("");

    // last published game-day report: client-side SLO truth (open-loop
    // p50/p99/p99.9 per phase, ledger counts, budget burn) + the
    // reconciliation verdict against the server-side records
    const gd = (await get("/api/gameday")).report;
    document.getElementById("gd-empty").textContent =
      gd ? "" : "(no game day has run)";
    if (gd) {
      const recon = gd.reconciliation || {};
      const slo = gd.slo || {};
      const o = gd.overall || {};
      document.getElementById("gd-tiles").innerHTML = [
        ["scenario", gd.scenario + " @ seed " + gd.seed],
        ["verdict", gd.passed ? "PASSED" : "FAILED"],
        ["reconciled", recon.ok ? "yes" : "NO"],
        ["failed requests", o.failed ?? "-"],
        ["shed", o.shed ?? "-"],
        ["budget burn", (slo.availability_burn ?? 0).toFixed(3)],
      ].map(([k, v]) => `<div class="tile"><b>${esc(v)}</b>${esc(k)}
        </div>`).join("");
      const phases = Object.entries(gd.phases || {});
      document.getElementById("gameday").innerHTML = !phases.length ? "" :
        head(["phase", "total", "admitted", "shed", "failed", "p50",
              "p99", "p99.9", "max"]) +
        phases.map(([n, p]) => row([n, p.total, p.admitted, p.shed,
          {v: p.failed, cls: p.failed ? "st-FAILED" : ""},
          p.p50_ms + "ms", p.p99_ms + "ms", p.p999_ms + "ms",
          p.max_ms + "ms"])).join("");
    } else {
      document.getElementById("gd-tiles").innerHTML = "";
      document.getElementById("gameday").innerHTML = "";
    }

    const nodes = (await get("/api/nodes")).nodes || [];
    const stats = (await get("/api/nodes/stats")).nodes || [];
    const byId = Object.fromEntries(stats.map(s => [s.node_id, s]));
    const gb = b => (b / 1e9).toFixed(1) + "G";
    document.getElementById("nodes").innerHTML =
      head(["node", "alive", "cpu%", "mem free", "store used",
            "tasks p/r", "workers", "spilled", "resources"]) +
      nodes.map(n => { const s = byId[n.node_id] || {};
        const p = s.physical || {}, sc = s.scheduler || {},
              os_ = s.object_store || {};
        return row([n.node_id.slice(0, 12), n.alive,
          p.cpu_percent != null ? p.cpu_percent.toFixed(0) : "-",
          p.mem_available_bytes != null ? gb(p.mem_available_bytes) : "-",
          os_.used_bytes != null ?
            gb(os_.used_bytes) + "/" + gb(os_.capacity) : "-",
          (sc.tasks_pending ?? "-") + "/" + (sc.tasks_running ?? "-"),
          sc.workers_alive ?? "-",
          os_.spilled_objects ?? "-",
          JSON.stringify(n.resources)]); }).join("");

    const st = document.getElementById("taskstate").value;
    const td = await get("/api/tasks?limit=100" +
                         (st ? "&state=" + st : ""));
    const tasks = td.tasks || [];
    document.getElementById("taskmeta").textContent =
      `${tasks.length} of ${td.total ?? "?"} shown` +
      (td.dropped ? ` · ${td.dropped} evicted (table cap)` : "");
    document.getElementById("tasks").innerHTML =
      head(["task", "name", "state", "attempt", "node", "pid",
            "duration", "error"]) +
      tasks.map(x => row([x.task_id.slice(0, 12), x.name || "-",
        {v: x.state, cls: "st-" + x.state}, x.attempt || 0,
        (x.node_id || "").slice(0, 8) || "-", x.worker_pid ?? "-",
        x.duration_s != null ? ms(x.duration_s) : "-",
        {v: x.error || "", cls: "msg"}])).join("");

    const actors = (await get("/api/actors")).actors || [];
    document.getElementById("actors").innerHTML =
      head(["actor", "class", "state", "restarts"]) +
      actors.map(a => row([(a.actor_id || "").slice(0, 12),
        a.class_name, a.state, a.num_restarts || 0])).join("");

    const jobs = (await get("/api/jobs")).jobs || [];
    document.getElementById("jobs").innerHTML =
      head(["job", "status", "entrypoint"]) +
      jobs.map(j => row([j.job_id, j.status,
        (j.entrypoint || "").slice(0, 90)])).join("");

    const events = (await get("/api/events?limit=50")).events || [];
    document.getElementById("events").innerHTML =
      head(["time", "severity", "source", "label", "message"]) +
      events.slice().reverse().map(e => row([
        new Date(e.timestamp * 1000).toLocaleTimeString(),
        {v: e.severity, cls: "sev-" + e.severity}, e.source, e.label,
        {v: e.message, cls: "msg"}])).join("");

    const sel = document.getElementById("logsel");
    if (!sel.dataset.loaded) {
      const logs = (await get("/api/logs")).logs || [];
      sel.innerHTML = "<option value=''>(select a log)</option>" +
        logs.map(l => `<option>${esc(l)}</option>`).join("");
      sel.dataset.loaded = "1";
      sel.onchange = async () => {
        if (!sel.value) return;
        const r = await fetch("/api/logs/" +
                              encodeURIComponent(sel.value));
        document.getElementById("logview").textContent = await r.text();
      };
    }
    document.getElementById("updated").textContent =
      "updated " + new Date().toLocaleTimeString();
  } catch (e) {
    document.getElementById("updated").textContent = "error: " + e;
  }
}

// Task timeline: the merged chrome-trace ('X' complete events, one
// lane per pid:tid), rendered as proportional bars. On demand — the
// trace merge walks every process's buffer.
async function loadTimeline() {
  const box = document.getElementById("timeline");
  box.innerHTML = "loading…";
  try {
    const evs = ((await get("/api/timeline")).events || [])
      .filter(e => e.ph === "X" && e.dur != null);
    if (!evs.length) { box.innerHTML = "(no task events yet)"; return; }
    evs.sort((a, b) => a.ts - b.ts);
    const shown = evs.slice(-1000);
    const t0 = Math.min(...shown.map(e => e.ts));
    const t1 = Math.max(...shown.map(e => e.ts + e.dur));
    const span = Math.max(t1 - t0, 1);
    document.getElementById("tl-meta").textContent =
      `${shown.length}${evs.length > shown.length ? " (latest) of " +
        evs.length : ""} tasks · ${(span / 1e6).toFixed(2)}s window`;
    const lanes = new Map();
    for (const e of shown) {
      const key = `pid ${e.pid} · tid ${e.tid}`;
      if (!lanes.has(key)) lanes.set(key, []);
      lanes.get(key).push(e);
    }
    box.innerHTML = [...lanes.entries()].map(([key, es]) =>
      `<div class="bar-row"><div class="bar-label">${esc(key)}</div>` +
      `<div class="bar-lane">` + es.map(e =>
        `<div class="bar${e.cname === "terrible" ? " failed" : ""}"` +
        ` style="left:${(100 * (e.ts - t0) / span).toFixed(3)}%;` +
        `width:${(100 * e.dur / span).toFixed(3)}%"` +
        ` title="${esc(e.name)} ${(e.dur / 1000).toFixed(2)}ms"></div>`
      ).join("") + `</div></div>`).join("");
  } catch (e) { box.innerHTML = "error: " + esc(e); }
}
document.getElementById("tl-load").onclick = loadTimeline;

// Distributed traces: summaries table + per-trace waterfall (one row
// per span, indented by tree depth, colored by attributed phase) with
// the critical-path phase table from /api/trace/<id>.
const PHASE_COLORS = {queue: "#b26a00", schedule: "#6a1b9a",
  dispatch: "#00838f", transfer: "#546e7a", execute: "#1565c0",
  deserialize: "#2e7d32", submit: "#9e9d24", other: "#757575"};
async function loadTraces() {
  const meta = document.getElementById("tr-meta");
  try {
    const d = await get("/api/traces?limit=50");
    const traces = (d.traces || []).sort(
      (a, b) => (b.start_ts || 0) - (a.start_ts || 0));
    meta.textContent = `${traces.length} of ${d.total ?? "?"} shown` +
      (d.dropped ? ` · ${d.dropped} spans evicted` : "");
    document.getElementById("traces").innerHTML =
      head(["trace", "root", "spans", "start", "duration", "status"]) +
      traces.map(t => row([t.trace_id, t.root || "-", t.spans,
        t.start_ts ? new Date(t.start_ts * 1000).toLocaleTimeString()
                   : "-",
        t.duration_s != null ? ms(t.duration_s) : "-",
        {v: t.status, cls: t.status === "error" ? "st-FAILED" : ""}
      ])).join("");
    document.getElementById("traces").onclick = e => {
      const tr = e.target.closest("tr");
      if (tr && tr.cells.length && tr.cells[0].textContent !== "trace") {
        document.getElementById("tr-id").value =
          tr.cells[0].textContent;
        showWaterfall();
      }
    };
  } catch (e) { meta.textContent = "error: " + e; }
}
async function showWaterfall() {
  const id = document.getElementById("tr-id").value.trim();
  const box = document.getElementById("waterfall");
  const cpBox = document.getElementById("tr-cp");
  if (!id) { box.innerHTML = "(enter a trace id)"; return; }
  box.innerHTML = "loading…";
  try {
    const doc = await get("/api/trace/" + encodeURIComponent(id));
    const spans = (doc.spans || []).filter(
      s => s.start_ts != null && s.end_ts != null);
    if (!spans.length) { box.innerHTML = "(no spans)"; return; }
    const cp = doc.critical_path || {};
    cpBox.textContent = `critical path: ` +
      Object.entries(cp.phases || {}).map(([k, v]) =>
        `${k} ${(v * 1e3).toFixed(1)}ms`).join(" · ") +
      ` — ${((cp.attributed_frac || 0) * 100).toFixed(1)}% attributed` +
      (doc.complete ? "" : ` · INCOMPLETE: ${doc.complete_detail}`);
    const ids = new Set(spans.map(s => s.span_id));
    const depth = s => { let d = 0, cur = s;
      const byId = Object.fromEntries(spans.map(x => [x.span_id, x]));
      while (cur && ids.has(cur.parent_span_id) && d < 32) {
        cur = byId[cur.parent_span_id]; d++; } return d; };
    const t0 = Math.min(...spans.map(s => s.start_ts));
    const t1 = Math.max(...spans.map(s => s.end_ts));
    const span = Math.max(t1 - t0, 1e-6);
    box.innerHTML = spans.slice().sort((a, b) =>
      a.start_ts - b.start_ts || depth(a) - depth(b)).map(s => {
      const d = depth(s);
      return `<div class="bar-row">` +
        `<div class="bar-label" style="padding-left:${d * 10}px"` +
        ` title="${esc(s.name)}">${esc(s.name)}</div>` +
        `<div class="bar-lane"><div class="bar` +
        `${s.status === "error" ? " failed" : ""}"` +
        ` style="left:${(100 * (s.start_ts - t0) / span).toFixed(3)}%;` +
        `width:${Math.max(100 * (s.end_ts - s.start_ts) / span, .15)
          .toFixed(3)}%;` +
        `background:${PHASE_COLORS[s.phase] || PHASE_COLORS.other}"` +
        ` title="${esc(s.name)} ${((s.end_ts - s.start_ts) * 1e3)
          .toFixed(2)}ms (${esc(s.phase || "?")})"></div></div></div>`;
    }).join("");
  } catch (e) { box.innerHTML = "error: " + esc(e); }
}
document.getElementById("tr-load").onclick = loadTraces;
document.getElementById("tr-show").onclick = showWaterfall;
document.getElementById("taskstate").onchange = refresh;
refresh();
setInterval(refresh, 4000);
</script>
</body>
</html>
"""
