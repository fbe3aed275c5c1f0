"""Minimal KPI dashboard for the Multi-SPIN gateway (one static page).

``GET /`` serves this page; it polls ``GET /v1/stats`` once a second and
renders the four serving KPIs the ROADMAP follow-up asked for — goodput
(both views), draft acceptance, page-pool occupancy, and a TTFT p50
sparkline over the poll history — with zero build step, zero external
assets, and zero new endpoints (everything it shows already rides on
``/v1/stats``).

The page follows the repo's dataviz conventions: stat tiles for single
headline numbers (a number's job is not a chart), one 2px single-hue
sparkline with a nearest-point hover tooltip (single series — no legend;
the title names it), text in text tokens rather than series colors, and a
collapsible table of the raw samples as the accessible fallback.  Light and
dark are both first-class via CSS custom properties.
"""

from __future__ import annotations

DASHBOARD_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>Multi-SPIN gateway</title>
<style>
  .viz-root {
    color-scheme: light;
    --surface-1: #fcfcfb; --surface-2: #f1f0ee;
    --text-primary: #0b0b0b; --text-secondary: #52514e;
    --grid: #d8d7d3; --series-1: #2a78d6;
    --warn: #eda100; --critical: #e34948;
  }
  @media (prefers-color-scheme: dark) {
    :root:where(:not([data-theme="light"])) .viz-root {
      color-scheme: dark;
      --surface-1: #1a1a19; --surface-2: #242423;
      --text-primary: #ffffff; --text-secondary: #c3c2b7;
      --grid: #3a3a38; --series-1: #3987e5;
      --warn: #c98500; --critical: #e66767;
    }
  }
  :root[data-theme="dark"] .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --surface-2: #242423;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --grid: #3a3a38; --series-1: #3987e5;
    --warn: #c98500; --critical: #e66767;
  }
  body { margin: 0; }
  .viz-root {
    font: 14px/1.45 system-ui, sans-serif;
    background: var(--surface-1); color: var(--text-primary);
    min-height: 100vh; padding: 24px;
  }
  h1 { font-size: 16px; font-weight: 600; margin: 0 0 2px; }
  .sub { color: var(--text-secondary); margin: 0 0 20px; font-size: 12px; }
  .tiles { display: grid; gap: 12px;
           grid-template-columns: repeat(auto-fit, minmax(170px, 1fr)); }
  .tile { background: var(--surface-2); border-radius: 8px; padding: 12px 14px; }
  .tile .label { color: var(--text-secondary); font-size: 12px; }
  .tile .value { font-size: 26px; font-weight: 600; font-variant-numeric: tabular-nums; }
  .tile .unit { font-size: 13px; color: var(--text-secondary); font-weight: 400; }
  .tile .detail { color: var(--text-secondary); font-size: 12px; }
  .meter { height: 4px; border-radius: 2px; background: var(--grid);
           margin-top: 8px; overflow: hidden; }
  .meter > div { height: 100%; border-radius: 2px; background: var(--series-1);
                 width: 0%; transition: width .3s; }
  .panel { margin-top: 20px; background: var(--surface-2);
           border-radius: 8px; padding: 12px 14px; }
  .panel h2 { font-size: 13px; font-weight: 600; margin: 0; }
  .panel .sub { margin: 0 0 8px; }
  svg text { fill: var(--text-secondary); font-size: 11px;
             font-variant-numeric: tabular-nums; }
  #tip { position: fixed; pointer-events: none; display: none;
         background: var(--surface-1); color: var(--text-primary);
         border: 1px solid var(--grid); border-radius: 6px;
         padding: 4px 8px; font-size: 12px; }
  details { margin-top: 16px; color: var(--text-secondary); font-size: 12px; }
  table { border-collapse: collapse; margin-top: 8px; }
  td, th { padding: 2px 10px 2px 0; text-align: right;
           font-variant-numeric: tabular-nums; }
  th { color: var(--text-secondary); font-weight: 500; }
  .err { color: var(--critical); }
</style>
</head>
<body>
<div class="viz-root">
  <h1>Multi-SPIN gateway</h1>
  <p class="sub" id="meta">connecting&#8230;</p>
  <div class="tiles">
    <div class="tile"><div class="label">Goodput (committed)</div>
      <div class="value" id="k-good">&#8211;<span class="unit"> tok/s</span></div>
      <div class="detail" id="k-good2">capped &#8211;</div></div>
    <div class="tile"><div class="label">Acceptance (window)</div>
      <div class="value" id="k-acc">&#8211;<span class="unit"> %</span></div>
      <div class="detail" id="k-acc2">total &#8211;</div></div>
    <div class="tile"><div class="label">Page-pool occupancy</div>
      <div class="value" id="k-pool">&#8211;<span class="unit"> %</span></div>
      <div class="meter"><div id="k-pool-bar"></div></div></div>
    <div class="tile"><div class="label">Streams</div>
      <div class="value" id="k-streams">&#8211;</div>
      <div class="detail" id="k-streams2">queued &#8211; &#183; done &#8211;</div></div>
  </div>
  <div class="panel">
    <h2>TTFT p50 (simulated seconds)</h2>
    <p class="sub">last <span id="spark-n">0</span> polls &#183; 1 Hz</p>
    <svg id="spark" width="100%" height="72" viewBox="0 0 600 72"
         preserveAspectRatio="none" role="img"
         aria-label="TTFT p50 sparkline"></svg>
  </div>
  <details><summary>Samples (table view)</summary>
    <table id="tbl"><thead><tr><th>t</th><th>ttft p50 s</th>
      <th>goodput tok/s</th><th>accept %</th></tr></thead>
      <tbody></tbody></table>
  </details>
  <div id="tip"></div>
</div>
<script>
"use strict";
const S = [];                       // poll samples, bounded
const MAXN = 120;
const $ = id => document.getElementById(id);
const fmt = (x, d=1) => (x == null || !isFinite(x)) ? "\\u2013"
  : Number(x).toFixed(d);

function draw() {
  const svg = $("spark"), W = 600, H = 72, P = 4;
  const pts = S.map(s => s.ttft).filter(v => v != null);
  $("spark-n").textContent = S.length;
  if (pts.length < 2) { svg.innerHTML = ""; return; }
  const vals = S.map(s => s.ttft ?? 0);
  const lo = Math.min(...pts), hi = Math.max(...pts), span = (hi - lo) || 1;
  const x = i => P + i * (W - 2 * P) / (S.length - 1);
  const y = v => H - P - (v - lo) * (H - 2 * P) / span;
  const d = vals.map((v, i) => (i ? "L" : "M") + x(i).toFixed(1)
                               + " " + y(v).toFixed(1)).join(" ");
  const last = vals[vals.length - 1];
  svg.innerHTML =
    `<line x1="0" y1="${y(lo)}" x2="${W}" y2="${y(lo)}"` +
    ` stroke="var(--grid)" stroke-width="1"/>` +
    `<path d="${d}" fill="none" stroke="var(--series-1)"` +
    ` stroke-width="2" vector-effect="non-scaling-stroke"/>` +
    `<circle cx="${x(S.length - 1)}" cy="${y(last)}" r="3"` +
    ` fill="var(--series-1)" stroke="var(--surface-2)" stroke-width="2"/>` +
    `<text x="${W - P}" y="12" text-anchor="end">${fmt(last, 3)}s</text>`;
}

$("spark").addEventListener("mousemove", ev => {
  if (S.length < 2) return;
  const r = ev.currentTarget.getBoundingClientRect();
  const i = Math.max(0, Math.min(S.length - 1,
    Math.round((ev.clientX - r.left) / r.width * (S.length - 1))));
  const s = S[i], tip = $("tip");
  tip.style.display = "block";
  tip.style.left = (ev.clientX + 12) + "px";
  tip.style.top = (ev.clientY - 10) + "px";
  tip.textContent = `poll ${i - S.length + 1}: ttft ${fmt(s.ttft, 3)}s, ` +
                    `goodput ${fmt(s.good)} tok/s`;
});
$("spark").addEventListener("mouseleave",
  () => { $("tip").style.display = "none"; });

function table() {
  const tb = $("tbl").tBodies[0];
  tb.innerHTML = S.slice(-12).map((s, i) =>
    `<tr><td>${i - Math.min(S.length, 12) + 1}</td>` +
    `<td>${fmt(s.ttft, 3)}</td><td>${fmt(s.good)}</td>` +
    `<td>${fmt(s.acc * 100)}</td></tr>`).join("");
}

async function poll() {
  try {
    const st = await (await fetch("/v1/stats")).json();
    const last = st.last_round || {};
    const occ = last.pool_occupancy ?? 0;
    const good = last.goodput_committed ?? 0;
    $("meta").textContent =
      `rounds ${st.rounds_total} \\u00b7 tokens ` +
      `${st.tokens_committed_total} \\u00b7 sim ` +
      `${fmt(st.sim_seconds_total, 1)}s`;
    $("k-good").innerHTML =
      `${fmt(good)}<span class="unit"> tok/s</span>`;
    $("k-good2").textContent = `capped ${fmt(last.goodput_capped)}`;
    $("k-acc").innerHTML =
      `${fmt((st.acceptance_window ?? 0) * 100)}<span class="unit"> %</span>`;
    $("k-acc2").textContent =
      `total ${fmt((st.acceptance_total ?? 0) * 100)} %`;
    $("k-pool").innerHTML =
      `${fmt(occ * 100)}<span class="unit"> %</span>`;
    const bar = $("k-pool-bar");
    bar.style.width = `${Math.min(100, occ * 100)}%`;
    bar.style.background = occ > 0.95 ? "var(--critical)"
      : occ > 0.8 ? "var(--warn)" : "var(--series-1)";
    const sch = st.scheduler || {};
    $("k-streams").textContent = sch.active ?? 0;
    $("k-streams2").textContent =
      `queued ${sch.queue_depth ?? 0} \\u00b7 done ${sch.completed ?? 0}`;
    S.push({ttft: st.ttft_sim_s ? st.ttft_sim_s.p50 : null,
            good: good, acc: st.acceptance_window ?? 0});
    if (S.length > MAXN) S.shift();
    draw(); table();
  } catch (e) {
    $("meta").innerHTML = `<span class="err">stats poll failed: ${e}</span>`;
  }
}
poll();
setInterval(poll, 1000);
</script>
</body>
</html>
"""
