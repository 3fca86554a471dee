/* Foremast dashboard — rendering only.
 *
 * Role parity with the reference UI (foremast-browser/src/App.js): poll
 * every 15 s per panel, chart base / upper / lower / anomaly with anomaly
 * dots on the measured curve, a crosshair synchronized across all panels
 * (App.js:44-78) plus a scatter chart. No chart library: plain SVG.
 * Data shaping (series fetch, scaling, anomaly-event join — reference
 * App.js:231-260) happens server-side in ui/join.py via /api/v1/panel so
 * the logic is testable in Python; this file only draws the payload.
 */
"use strict";

const CFG = window.FOREMAST_CONFIG;
const PAD = { l: 44, r: 10, t: 8, b: 18 };
const panels = []; // {cfg, el, data, svg}
let tableMode = false;

/* ---------------- data ---------------- */

async function fetchPanel(p) {
  // the UI server fetches the panel's four series, scales them, and joins
  // anomaly events onto the base curve (ui/join.py — tested in Python;
  // reference semantics: App.js:231-260). This client only renders.
  try {
    const u = new URL("/api/v1/panel", location.origin);
    u.searchParams.set("i", p.idx);
    // the range presets mutate these; the server honors them per request
    u.searchParams.set("window", CFG.windowSeconds);
    u.searchParams.set("step", CFG.stepSeconds);
    const r = await fetch(u);
    if (!r.ok) throw new Error(`panel ${r.status}`);
    p.data = await r.json();
  } catch (e) {
    p.data = {};
  }
}

/* ---------------- scales / svg helpers ---------------- */

function svgEl(tag, attrs) {
  const el = document.createElementNS("http://www.w3.org/2000/svg", tag);
  for (const [k, v] of Object.entries(attrs || {})) el.setAttribute(k, v);
  return el;
}

function extent(seriesList, pick) {
  let lo = Infinity, hi = -Infinity;
  for (const s of seriesList)
    for (const d of s) {
      const x = pick(d);
      if (Number.isFinite(x)) { if (x < lo) lo = x; if (x > hi) hi = x; }
    }
  return lo <= hi ? [lo, hi] : null;
}

function niceTicks(lo, hi, n) {
  const span = hi - lo || 1;
  const step = Math.pow(10, Math.floor(Math.log10(span / n)));
  const err = span / n / step;
  const mult = err >= 7.5 ? 10 : err >= 3.5 ? 5 : err >= 1.5 ? 2 : 1;
  const s = step * mult;
  const ticks = [];
  for (let v = Math.ceil(lo / s) * s; v <= hi + 1e-9; v += s) ticks.push(v);
  return ticks;
}

/* Pure render-path geometry — every function below is PORTED to Python
 * and pinned in tests/test_ui_js.py (the executed spec): domain
 * computation, pixel scales, polyline/polygon point strings, anomaly-dot
 * placement, tick layout, nearest-point lookup. Rendering proper is
 * reduced to DOM calls over these outputs. */

function makeDomain(base, upper, lower) {
  // time domain from the measured curve; value domain over curve + band,
  // +-8% headroom; degenerate (flat) spans widen by 1 so Y never /0
  const tExt = extent([base], (x) => x.t);
  const vExt = extent([base, upper, lower], (x) => x.v);
  if (!tExt || !vExt) return null;
  const t0 = tExt[0], t1 = tExt[1];
  let v0 = vExt[0], v1 = vExt[1];
  if (v0 === v1) { v0 -= 1; v1 += 1; }
  const padV = (v1 - v0) * 0.08;
  return { t0, t1, v0: v0 - padV, v1: v1 + padV };
}

function xPix(t, dom, W) {
  return PAD.l + ((t - dom.t0) / (dom.t1 - dom.t0 || 1)) * (W - PAD.l - PAD.r);
}

function yPix(v, dom, H) {
  return H - PAD.b - ((v - dom.v0) / (dom.v1 - dom.v0)) * (H - PAD.t - PAD.b);
}

function pathPoints(series, dom, W, H) {
  return series.map((x) => `${xPix(x.t, dom, W)},${yPix(x.v, dom, H)}`).join(" ");
}

function bandPolygon(upper, lower, dom, W, H) {
  // fill between the band edges over their COMMON timestamps: forward
  // along upper, back along lower (reversed) closes the polygon
  const loByT = new Map(lower.map((x) => [x.t, x.v]));
  const pts = upper.filter((x) => loByT.has(x.t));
  if (!pts.length) return null;
  const fwd = pts.map((x) => `${xPix(x.t, dom, W)},${yPix(x.v, dom, H)}`);
  const back = pts.slice().reverse()
    .map((x) => `${xPix(x.t, dom, W)},${yPix(loByT.get(x.t), dom, H)}`);
  return fwd.concat(back).join(" ");
}

function anomalyDots(anoms, dom, W, H) {
  return anoms.map((a) => ({ cx: xPix(a.t, dom, W), cy: yPix(a.v, dom, H) }));
}

function tickLayout(dom, W, H) {
  const yTicks = niceTicks(dom.v0, dom.v1, 4)
    .map((v) => ({ v, y: yPix(v, dom, H) }));
  const nT = Math.max(2, Math.floor(W / 140));
  const xTicks = niceTicks(dom.t0, dom.t1, nT)
    .map((t) => ({ t, x: xPix(t, dom, W) }));
  return { yTicks, xTicks };
}

const fmtV = (v) =>
  Math.abs(v) >= 1e6 ? (v / 1e6).toFixed(1) + "M"
  : Math.abs(v) >= 1e3 ? (v / 1e3).toFixed(1) + "k"
  : Math.abs(v) >= 100 ? v.toFixed(0)
  : Math.abs(v) >= 1 ? v.toFixed(1) : v.toPrecision(2);
const fmtT = (t) => {
  const d = new Date(t * 1000);
  return `${String(d.getHours()).padStart(2, "0")}:${String(d.getMinutes()).padStart(2, "0")}`;
};

/* ---------------- panel rendering ---------------- */

function renderPanel(p) {
  const box = p.el.querySelector(".chartbox");
  box.innerHTML = "";
  const d = p.data || {};
  const base = d.base || [];
  if (!base.length) {
    const e = document.createElement("div");
    e.className = "empty";
    e.textContent = "no data";
    box.appendChild(e);
    return;
  }
  if (tableMode) return renderTable(p, box);

  const W = box.clientWidth || 440, H = 180;
  const svg = svgEl("svg", { viewBox: `0 0 ${W} ${H}` });
  const up = d.upper || [], lo = d.lower || [];
  const dom = makeDomain(base, up, lo);
  if (!dom) {  // all-NaN series (e.g. PromQL 0/0) — treat as empty
    const e = document.createElement("div");
    e.className = "empty";
    e.textContent = "no data";
    box.appendChild(e);
    return;
  }
  const X = (t) => xPix(t, dom, W);
  const Y = (v) => yPix(v, dom, H);
  p.X = X; p.Y = Y; p.t0 = dom.t0; p.t1 = dom.t1; p.W = W; p.H = H;

  const ticks = tickLayout(dom, W, H);
  for (const g of ticks.yTicks) {
    svg.appendChild(svgEl("line", { class: "gridline", x1: PAD.l, x2: W - PAD.r, y1: g.y, y2: g.y }));
    const txt = svgEl("text", { x: PAD.l - 6, y: g.y + 3, "text-anchor": "end" });
    txt.textContent = fmtV(g.v);
    svg.appendChild(txt);
  }
  for (const g of ticks.xTicks) {
    const txt = svgEl("text", { x: g.x, y: H - 4, "text-anchor": "middle" });
    txt.textContent = fmtT(g.t);
    svg.appendChild(txt);
  }
  svg.appendChild(svgEl("line", { class: "axisline", x1: PAD.l, x2: W - PAD.r, y1: H - PAD.b, y2: H - PAD.b }));

  // model band: fill between upper and lower where both exist
  if (up.length && lo.length) {
    const poly = bandPolygon(up, lo, dom, W, H);
    if (poly !== null)
      svg.appendChild(svgEl("polygon", { class: "band-area", points: poly }));
    for (const edge of [up, lo])
      svg.appendChild(svgEl("polyline", { class: "band-edge", points: pathPoints(edge, dom, W, H) }));
  }

  svg.appendChild(svgEl("polyline", { class: "baseline-path", points: pathPoints(base, dom, W, H) }));

  for (const a of anomalyDots(d.anomalyJoined || [], dom, W, H))
    svg.appendChild(svgEl("circle", { class: "anom", cx: a.cx, cy: a.cy, r: 4.5 }));

  // crosshair layer (populated by the shared hover handler)
  p.xhair = svgEl("line", { class: "xhair", y1: PAD.t, y2: H - PAD.b, visibility: "hidden" });
  p.hoverdot = svgEl("circle", { class: "hoverdot", r: 4, visibility: "hidden" });
  svg.appendChild(p.xhair);
  svg.appendChild(p.hoverdot);

  svg.addEventListener("mousemove", (ev) => {
    const rect = svg.getBoundingClientRect();
    const frac = (ev.clientX - rect.left) / rect.width;
    const t = dom.t0 + Math.max(0, Math.min(1, (frac * W - PAD.l) / (W - PAD.l - PAD.r))) * (dom.t1 - dom.t0);
    syncCrosshair(t, ev);
  });
  svg.addEventListener("mouseleave", () => syncCrosshair(null));
  p.svg = svg;
  box.appendChild(svg);
}

function renderTable(p, box) {
  const d = p.data;
  const wrap = document.createElement("div");
  wrap.className = "tablebox";
  const anomT = new Set((d.anomalyJoined || []).map((a) => a.t));
  const upByT = new Map((d.upper || []).map((x) => [x.t, x.v]));
  const loByT = new Map((d.lower || []).map((x) => [x.t, x.v]));
  const rows = d.base
    .map((x) =>
      `<tr><td>${new Date(x.t * 1000).toLocaleTimeString()}</td>` +
      `<td>${fmtV(x.v)}</td>` +
      `<td>${upByT.has(x.t) ? fmtV(upByT.get(x.t)) : ""}</td>` +
      `<td>${loByT.has(x.t) ? fmtV(loByT.get(x.t)) : ""}</td>` +
      `<td>${anomT.has(x.t) ? "⚠ anomaly" : ""}</td></tr>`
    )
    .join("");
  wrap.innerHTML = `<table class="data"><thead><tr><th>time</th><th>value</th><th>upper</th><th>lower</th><th>state</th></tr></thead><tbody>${rows}</tbody></table>`;
  box.appendChild(wrap);
}

/* ---------------- synchronized crosshair + tooltip ---------------- */

const tooltip = document.createElement("div");
tooltip.className = "tooltip";
document.body.appendChild(tooltip);

function nearest(series, t) {
  let best = null, bd = Infinity;
  for (const d of series) {
    const dd = Math.abs(d.t - t);
    if (dd < bd) { bd = dd; best = d; }
  }
  return best;
}

function syncCrosshair(t, ev) {
  let tipRows = [];
  for (const p of panels) {
    if (!p.svg || !p.X) continue;
    if (t == null) {
      p.xhair.setAttribute("visibility", "hidden");
      p.hoverdot.setAttribute("visibility", "hidden");
      continue;
    }
    const pt = nearest(p.data.base, t);
    if (!pt) continue;
    const x = p.X(pt.t);
    p.xhair.setAttribute("x1", x);
    p.xhair.setAttribute("x2", x);
    p.xhair.setAttribute("visibility", "visible");
    p.hoverdot.setAttribute("cx", x);
    p.hoverdot.setAttribute("cy", p.Y(pt.v));
    p.hoverdot.setAttribute("visibility", "visible");
    const isAnom = (p.data.anomalyJoined || []).some((a) => a.t === pt.t);
    tipRows.push(
      `<div class="row"><span>${p.cfg.commonName}</span>` +
      `<span class="v">${fmtV(pt.v)} ${p.cfg.unit}${isAnom ? ' <span class="anom-flag">⚠</span>' : ""}</span></div>`
    );
  }
  if (t == null || !ev || !tipRows.length) {
    tooltip.style.display = "none";
    return;
  }
  tooltip.innerHTML = `<div class="t">${new Date(t * 1000).toLocaleTimeString()}</div>` + tipRows.join("");
  tooltip.style.display = "block";
  const tw = tooltip.offsetWidth, th = tooltip.offsetHeight;
  let tx = ev.clientX + 14, ty = ev.clientY + 12;
  if (tx + tw > innerWidth - 8) tx = ev.clientX - tw - 14;
  if (ty + th > innerHeight - 8) ty = ev.clientY - th - 12;
  tooltip.style.left = tx + "px";
  tooltip.style.top = ty + "px";
}

/* ---------------- scatter (first two panels, joined on time) ---------------- */

function renderScatter() {
  const wrap = document.getElementById("scatterWrap");
  wrap.innerHTML = "";
  const [pa, pb] = panels;
  if (!pa?.data?.base?.length || !pb?.data?.base?.length) return;
  const bByT = new Map(pb.data.base.map((d) => [d.t, d.v]));
  const pts = pa.data.base.filter((d) => bByT.has(d.t)).map((d) => ({ x: d.v, y: bByT.get(d.t) }));
  if (!pts.length) return;

  const div = document.createElement("div");
  div.className = "panel";
  div.innerHTML = `<h2>${pa.cfg.commonName} vs ${pb.cfg.commonName}</h2>`;
  const W = 520, H = 220;
  const svg = svgEl("svg", { viewBox: `0 0 ${W} ${H}`, style: "height:220px" });
  const xExt = extent([pts], (d) => d.x);
  const yExt = extent([pts], (d) => d.y);
  if (!xExt || !yExt) return;
  let [x0, x1] = xExt;
  let [y0, y1] = yExt;
  if (x0 === x1) { x0 -= 1; x1 += 1; }
  if (y0 === y1) { y0 -= 1; y1 += 1; }
  const X = (v) => PAD.l + ((v - x0) / (x1 - x0)) * (W - PAD.l - PAD.r);
  const Y = (v) => H - PAD.b - ((v - y0) / (y1 - y0)) * (H - PAD.t - PAD.b);
  for (const v of niceTicks(y0, y1, 4)) {
    svg.appendChild(svgEl("line", { class: "gridline", x1: PAD.l, x2: W - PAD.r, y1: Y(v), y2: Y(v) }));
    const txt = svgEl("text", { x: PAD.l - 6, y: Y(v) + 3, "text-anchor": "end" });
    txt.textContent = fmtV(v);
    svg.appendChild(txt);
  }
  for (const v of niceTicks(x0, x1, 5)) {
    const txt = svgEl("text", { x: X(v), y: H - 4, "text-anchor": "middle" });
    txt.textContent = fmtV(v);
    svg.appendChild(txt);
  }
  for (const d of pts)
    svg.appendChild(svgEl("circle", { class: "scatter-dot", cx: X(d.x), cy: Y(d.y), r: 3.5 }));
  div.appendChild(svg);
  wrap.appendChild(div);
}

/* ---------------- bootstrap ---------------- */

function buildPanels() {
  const root = document.getElementById("panels");
  CFG.panels.forEach((cfg, idx) => {
    const el = document.createElement("div");
    el.className = "panel";
    el.innerHTML =
      `<h2>${cfg.commonName} <span style="font-weight:400;color:var(--text-muted)">(${cfg.unit})</span></h2>` +
      `<div class="legend">` +
      `<span><span class="key base"></span>measured</span>` +
      `<span><span class="key band"></span>model band</span>` +
      `<span><span class="dot"></span>anomaly</span>` +
      `</div><div class="chartbox"></div>`;
    root.appendChild(el);
    panels.push({ cfg, idx, el, data: null });
  });
}

async function refresh() {
  await Promise.all(panels.map(fetchPanel));
  for (const p of panels) renderPanel(p);
  renderScatter();
  document.getElementById("updated").textContent =
    "updated " + new Date().toLocaleTimeString();
}

/* ---------------- time-range presets ---------------- */

const RANGES = [
  { label: "1h", seconds: 3600, step: 15 },
  { label: "6h", seconds: 6 * 3600, step: 60 },
  { label: "24h", seconds: 24 * 3600, step: 300 },
];

function buildRanges() {
  const nav = document.getElementById("ranges");
  for (const r of RANGES) {
    const b = document.createElement("button");
    b.textContent = r.label;
    b.setAttribute(
      "aria-pressed", String(r.seconds === CFG.windowSeconds)
    );
    b.addEventListener("click", () => {
      CFG.windowSeconds = r.seconds;
      CFG.stepSeconds = r.step; // coarser step keeps point counts bounded
      for (const other of nav.children)
        other.setAttribute("aria-pressed", String(other === b));
      refresh();
    });
    nav.appendChild(b);
  }
}

document.getElementById("scope").textContent = `${CFG.namespace} / ${CFG.app}`;
document.getElementById("tableToggle").addEventListener("change", (e) => {
  tableMode = e.target.checked;
  for (const p of panels) renderPanel(p);
});
addEventListener("resize", () => { for (const p of panels) renderPanel(p); });

buildPanels();
buildRanges();
refresh();
setInterval(refresh, CFG.pollSeconds * 1000);
