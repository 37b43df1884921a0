"""The web demo page: a browsable UI over the JSON API.

The port's copy of ``ncf_tpu/api/demo_page.py`` (the page is the same,
byte for byte): customer picker, top-k slider, hour-of-day toggle and
the model intelligence dashboard (normalized score chart, attention-head
importance, confidence histogram, component importance).  Served by the
stdlib HTTP server at GET /demo as one self-contained page: inline
CSS/JS/SVG and no external asset.
"""

DEMO_HTML = r"""<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>NCF-TPU — Model Intelligence Demo</title>
<style>
  .viz-root {
    color-scheme: light;
    --surface-1: #fcfcfb;
    --surface-2: #f1f0ee;
    --text-primary: #0b0b0b;
    --text-secondary: #52514e;
    --grid: #e3e2df;
    --series-1: #2a78d6;
  }
  @media (prefers-color-scheme: dark) {
    :root:where(:not([data-theme="light"])) .viz-root {
      color-scheme: dark;
      --surface-1: #1a1a19;
      --surface-2: #262624;
      --text-primary: #ffffff;
      --text-secondary: #c3c2b7;
      --grid: #3a3936;
      --series-1: #3987e5;
    }
  }
  body { margin: 0; font: 14px/1.45 system-ui, sans-serif; }
  .viz-root { background: var(--surface-1); color: var(--text-primary);
              min-height: 100vh; padding: 24px; box-sizing: border-box; }
  h1 { font-size: 20px; margin: 0 0 4px; }
  .sub { color: var(--text-secondary); margin: 0 0 20px; }
  .controls { display: flex; gap: 20px; flex-wrap: wrap; align-items: end;
              background: var(--surface-2); border-radius: 10px;
              padding: 12px 16px; margin-bottom: 20px; }
  .controls label { display: block; font-size: 12px;
                    color: var(--text-secondary); margin-bottom: 4px; }
  .controls input[type=number] { width: 90px; }
  .controls .val { font-variant-numeric: tabular-nums; }
  .grid2 { display: grid; grid-template-columns: repeat(auto-fit, minmax(340px, 1fr));
           gap: 20px; }
  .card { background: var(--surface-2); border-radius: 10px; padding: 14px 16px; }
  .card h2 { font-size: 14px; margin: 0 0 2px; }
  .card .note { font-size: 12px; color: var(--text-secondary); margin: 0 0 8px; }
  svg text { fill: var(--text-primary); font: 11px system-ui, sans-serif; }
  svg .axis text { fill: var(--text-secondary); }
  svg .gridline { stroke: var(--grid); stroke-width: 1; }
  svg .bar { fill: var(--series-1); }
  #tooltip { position: fixed; pointer-events: none; display: none;
             background: var(--surface-1); color: var(--text-primary);
             border: 1px solid var(--grid); border-radius: 6px;
             padding: 6px 9px; font-size: 12px; z-index: 10;
             box-shadow: 0 2px 8px rgba(0,0,0,.18); }
  details { margin-top: 10px; }
  summary { cursor: pointer; color: var(--text-secondary); font-size: 12px; }
  table { border-collapse: collapse; margin-top: 8px; width: 100%;
          font-variant-numeric: tabular-nums; }
  th, td { text-align: left; padding: 3px 10px 3px 0; font-size: 12px;
           border-bottom: 1px solid var(--grid); }
  th { color: var(--text-secondary); font-weight: 500; }
  .err { color: #e34948; margin: 8px 0; }
</style>
</head>
<body>
<div class="viz-root">
  <h1>NCF-TPU Model Intelligence</h1>
  <p class="sub">Exact on-chip retrieval + dashboard over the live model
     (reference demo/app.py parity, served by the stdlib API).</p>

  <div class="controls">
    <div><label for="cust">Customer id</label>
         <input id="cust" type="number" min="0" value="0"></div>
    <div><label for="topk">Top-k: <span id="topkv" class="val">10</span></label>
         <input id="topk" type="range" min="1" max="20" value="10"></div>
    <div><label for="useHour">
           <input id="useHour" type="checkbox"> hour-of-day scoring</label>
         <label for="hour">Hour: <span id="hourv" class="val">12</span>:00</label>
         <input id="hour" type="range" min="0" max="23" value="12" disabled></div>
    <div><button id="go">Recommend</button></div>
  </div>

  <div id="error" class="err" hidden></div>

  <div class="grid2">
    <div class="card">
      <h2>Top-k recommendation scores</h2>
      <p class="note">Sigmoid scores per retrieved product (exact full-model
         logits).</p>
      <svg id="scores" width="100%" height="300" role="img"
           aria-label="Top-k recommendation scores bar chart"></svg>
      <details><summary>Table view</summary>
        <table id="scoresTable"></table></details>
    </div>
    <div class="card">
      <h2>Attention-head importance</h2>
      <p class="note">Score-pattern std per head over sampled users
         (reference app.py:140-205).</p>
      <svg id="heads" width="100%" height="220" role="img"
           aria-label="Attention head importance column chart"></svg>
    </div>
    <div class="card">
      <h2>Confidence histogram</h2>
      <p class="note">Distribution of the returned scores.</p>
      <svg id="conf" width="100%" height="220" role="img"
           aria-label="Confidence histogram"></svg>
    </div>
    <div class="card">
      <h2>Component importance</h2>
      <p class="note">|fusion weight| per path from the final layer
         (reference app.py:224-248).</p>
      <svg id="comp" width="100%" height="140" role="img"
           aria-label="Component importance bar chart"></svg>
    </div>
  </div>
</div>
<div id="tooltip"></div>
<script>
"use strict";
const $ = id => document.getElementById(id);
const tip = $("tooltip");
const fmt = x => (Math.round(x * 1000) / 1000).toString();

function showTip(evt, html) {
  tip.innerHTML = html;
  tip.style.display = "block";
  tip.style.left = (evt.clientX + 12) + "px";
  tip.style.top = (evt.clientY - 10) + "px";
}
function hideTip() { tip.style.display = "none"; }

function clear(svg) { while (svg.firstChild) svg.removeChild(svg.firstChild); }
function el(name, attrs, parent) {
  const n = document.createElementNS("http://www.w3.org/2000/svg", name);
  for (const k in attrs) n.setAttribute(k, attrs[k]);
  if (parent) parent.appendChild(n);
  return n;
}
// rounded data-end (4px), square at the baseline
function hbarPath(x0, y, w, h) {
  const r = Math.min(4, w, h / 2);
  return `M${x0},${y} h${w - r} a${r},${r} 0 0 1 ${r},${r} v${h - 2 * r}
          a${r},${r} 0 0 1 ${-r},${r} h${-(w - r)} z`;
}
function vbarPath(x, yTop, w, hgt) {
  const r = Math.min(4, hgt, w / 2);
  return `M${x},${yTop + hgt} v${-(hgt - r)} a${r},${r} 0 0 1 ${r},${-r}
          h${w - 2 * r} a${r},${r} 0 0 1 ${r},${r} v${hgt - r} z`;
}

// horizontal bars: labels left, value at the tip, per-mark tooltip
function hbarChart(svg, rows, valueMax) {
  clear(svg);
  const W = svg.clientWidth || 360, pad = { l: 90, r: 46, t: 6, b: 6 };
  const bh = Math.min(24, Math.max(10,
      (svg.clientHeight - pad.t - pad.b) / rows.length - 6));
  const H = pad.t + pad.b + rows.length * (bh + 6);
  svg.setAttribute("height", H);
  const span = W - pad.l - pad.r;
  const vmax = valueMax || Math.max(...rows.map(r => r.value), 1e-9);
  rows.forEach((r, i) => {
    const y = pad.t + i * (bh + 6);
    const w = Math.max(1, span * r.value / vmax);
    el("text", { x: pad.l - 8, y: y + bh / 2 + 4, "text-anchor": "end",
                 class: "axis" }, svg).textContent = r.label;
    const p = el("path", { d: hbarPath(pad.l, y, w, bh), class: "bar" }, svg);
    el("text", { x: pad.l + w + 6, y: y + bh / 2 + 4 }, svg)
      .textContent = fmt(r.value);
    p.addEventListener("mousemove",
      e => showTip(e, `<b>${r.label}</b><br>${r.tip || fmt(r.value)}`));
    p.addEventListener("mouseleave", hideTip);
  });
}

// columns: value on the cap, hairline baseline grid, per-mark tooltip
function columnChart(svg, rows) {
  clear(svg);
  const W = svg.clientWidth || 360,
        H = +svg.getAttribute("height"),
        pad = { l: 10, r: 10, t: 18, b: 22 };
  const span = W - pad.l - pad.r;
  const bw = Math.min(24, span / rows.length - 8);
  const vmax = Math.max(...rows.map(r => r.value), 1e-9);
  el("line", { x1: pad.l, x2: W - pad.r, y1: H - pad.b, y2: H - pad.b,
               class: "gridline" }, svg);
  rows.forEach((r, i) => {
    const cx = pad.l + (i + 0.5) * span / rows.length;
    const hgt = Math.max(1, (H - pad.t - pad.b) * r.value / vmax);
    const yTop = H - pad.b - hgt;
    const p = el("path",
      { d: vbarPath(cx - bw / 2, yTop, bw, hgt), class: "bar" }, svg);
    el("text", { x: cx, y: yTop - 5, "text-anchor": "middle" }, svg)
      .textContent = fmt(r.value);
    el("text", { x: cx, y: H - pad.b + 14, "text-anchor": "middle",
                 class: "axis" }, svg).textContent = r.label;
    p.addEventListener("mousemove",
      e => showTip(e, `<b>${r.label}</b><br>${r.tip || fmt(r.value)}`));
    p.addEventListener("mouseleave", hideTip);
  });
}

function renderTable(tbl, header, rows) {
  tbl.innerHTML = "";
  const tr = tbl.insertRow();
  header.forEach(h => {
    const th = document.createElement("th");
    th.textContent = h; tr.appendChild(th);
  });
  rows.forEach(r => {
    const row = tbl.insertRow();
    r.forEach(c => { row.insertCell().textContent = c; });
  });
}

async function refresh() {
  $("error").hidden = true;
  const body = {
    customer_id: String($("cust").value),
    num_recommendations: +$("topk").value,
  };
  if ($("useHour").checked) body.hour = +$("hour").value;
  let data;
  try {
    const resp = await fetch("/api/v1/intelligence", {
      method: "POST", headers: { "Content-Type": "application/json" },
      body: JSON.stringify(body) });
    data = await resp.json();
    if (!resp.ok) throw new Error(data.detail || data.error || resp.status);
  } catch (e) {
    $("error").textContent = "Request failed: " + e.message;
    $("error").hidden = false;
    return;
  }
  const recs = data.recommendations;
  hbarChart($("scores"), recs.map(r => ({
    label: "product " + r.product_id, value: r.score,
    tip: `score ${fmt(r.score)} · rank ${r.rank}` })), 1.0);
  renderTable($("scoresTable"), ["Rank", "Product", "Score"],
    recs.map(r => [r.rank, r.product_id, fmt(r.score)]));
  const intel = data.intelligence;
  columnChart($("heads"), intel.attention_head_importance.map((v, i) => ({
    label: "head " + (i + 1), value: v })));
  const conf = intel.confidence;
  columnChart($("conf"), conf.counts.map((c, i) => ({
    label: fmt(conf.edges[i]), value: c,
    tip: `${c} of ${recs.length} scores` })));
  hbarChart($("comp"), Object.entries(intel.component_importance).map(
    ([k, v]) => ({ label: k, value: v })));
}

$("useHour").addEventListener("change",
  () => { $("hour").disabled = !$("useHour").checked; });
$("hour").addEventListener("input", () => { $("hourv").textContent = $("hour").value; });
$("topk").addEventListener("input", () => { $("topkv").textContent = $("topk").value; });
$("go").addEventListener("click", refresh);
refresh();
</script>
</body>
</html>
"""
