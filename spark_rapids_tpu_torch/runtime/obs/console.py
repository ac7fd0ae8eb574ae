"""Live engine console: self-contained auto-refreshing HTML
(counterpart of ``spark_rapids_tpu/runtime/obs/console.py``).

Rendered server-side by the obs HTTP endpoint at ``/console`` (a
``<meta http-equiv=refresh>`` page: no JS required to watch a query
run). Everything is inline CSS + inline SVG sparklines, so the output
needs no assets.

Content: the running-query table (id, state, elapsed, %-complete bar,
ETA, digest), per-exec progress of each running query, the
last-completed query, the last audited query's roofline table
(analysis/kernel_audit.py), and one sparkline per sampler series
(runtime/obs/sampler.py rings). The JAX package's serving section waits
for the serving layer (ROADMAP A11f).
"""
from __future__ import annotations

import html
import time
from typing import List, Optional

_CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 1.5em auto; max-width: 1100px; color: #1a1a2e; }
table { border-collapse: collapse; width: 100%; margin: 0.6em 0; }
th, td { border: 1px solid #d0d0e0; padding: 3px 8px; text-align: left;
         font-size: 13px; }
th { background: #f0f0f8; }
.num { text-align: right; font-variant-numeric: tabular-nums; }
.state-executing { color: #0a7a2f; font-weight: 600; }
.state-finishing { color: #b06f00; }
.state-planning, .state-queued { color: #666; }
.state-cancelled { color: #8a3ab9; }
.pbar { background: #e8e8f2; border-radius: 3px; width: 140px;
        height: 12px; display: inline-block; vertical-align: middle; }
.pbar span { background: #3949ab; height: 100%; display: block;
             border-radius: 3px; }
.spark { display: inline-block; margin: 0 1em 0.6em 0; }
.spark .lbl { font-size: 11px; color: #555; display: block; }
small.digest { font-family: monospace; color: #666; }
h1, h2 { font-weight: 600; } h2 { font-size: 17px; }
.muted { color: #888; font-size: 12px; }
"""


def _esc(x) -> str:
    return html.escape(str(x))


def sparkline_svg(points: List[float], width: int = 180, height: int = 36,
                  color: str = "#3949ab") -> str:
    """Inline SVG polyline sparkline (no axes; min/max labels ride in
    the title attribute)."""
    if not points:
        return "<svg width='%d' height='%d'></svg>" % (width, height)
    lo, hi = min(points), max(points)
    span = (hi - lo) or 1.0
    n = len(points)
    step = width / max(1, n - 1)
    coords = []
    for i, v in enumerate(points):
        x = i * step if n > 1 else width / 2
        y = height - 2 - (v - lo) / span * (height - 4)
        coords.append(f"{x:.1f},{y:.1f}")
    return (f"<svg width='{width}' height='{height}'>"
            f"<title>min {lo:g} max {hi:g} last {points[-1]:g}</title>"
            f"<polyline fill='none' stroke='{color}' stroke-width='1.5' "
            f"points='{' '.join(coords)}'/></svg>")


def _progress_cell(doc: dict) -> str:
    pct = doc.get("percent_complete")
    if pct is None:
        return f"<td class='num'>{doc.get('scan_rows', 0)} rows</td>"
    eta = doc.get("eta_seconds")
    eta_s = f" · eta {eta:.1f}s" if eta else ""
    return (f"<td><span class='pbar'><span style='width:{pct:.0f}%'>"
            f"</span></span> <span class='num'>{pct:.1f}%{eta_s}</span>"
            f"</td>")


def _query_rows(docs: List[dict]) -> List[str]:
    rows = []
    for d in docs:
        st = d.get("state", "?")
        rows.append(
            f"<tr><td>{_esc(d.get('query_id'))}</td>"
            f"<td class='state-{_esc(st)}'>{_esc(st)}</td>"
            f"<td class='num'>{d.get('elapsed_seconds', 0):.2f}s</td>"
            + _progress_cell(d)
            + f"<td><small class='digest'>{_esc(d.get('plan_digest'))}"
            f"</small></td><td>{_esc(d.get('thread', ''))}</td></tr>")
    return rows


def render_console(queries_doc: dict,
                   sampler_snapshot: Optional[dict] = None,
                   refresh_seconds: int = 2,
                   title: str = "spark-rapids-tpu-torch live console",
                   roofline: Optional[dict] = None) -> str:
    """The /console page. `queries_doc` is live.queries_doc();
    `sampler_snapshot` is ResourceSampler.snapshot() (or None when the
    sampler is off); `roofline` is the last audited query's roofline
    doc (None when the audit is off)."""
    running = queries_doc.get("running") or []
    last = queries_doc.get("last_completed")
    body = [f"<p class='muted'>auto-refresh {refresh_seconds}s · rendered "
            f"{time.strftime('%H:%M:%S')}</p>",
            f"<h2>Running queries ({len(running)})</h2>"]
    if running:
        body.append("<table><tr><th>id</th><th>state</th>"
                    "<th class='num'>elapsed</th><th>progress</th>"
                    "<th>digest</th><th>thread</th></tr>")
        body.extend(_query_rows(running))
        body.append("</table>")
        for d in running:
            execs = d.get("execs") or []
            if not execs:
                continue
            body.append(f"<details><summary>query "
                        f"{_esc(d.get('query_id'))} per-exec progress "
                        f"({len(execs)} execs)</summary><table>"
                        f"<tr><th>exec</th><th class='num'>rows</th>"
                        f"<th class='num'>batches</th></tr>")
            for e in execs:
                body.append(f"<tr><td>{_esc(e['exec'])}</td>"
                            f"<td class='num'>{e['rows']}</td>"
                            f"<td class='num'>{e['batches']}</td></tr>")
            body.append("</table></details>")
    else:
        body.append("<p class='muted'>idle — no query in flight</p>")
    if last:
        body.append("<h2>Last completed</h2><table><tr><th>id</th>"
                    "<th>state</th><th class='num'>elapsed</th>"
                    "<th>progress</th><th>digest</th>"
                    "<th>thread</th></tr>")
        body.extend(_query_rows([last]))
        body.append("</table>")
    if roofline and roofline.get("groups"):
        body.append(
            "<h2>Roofline — last audited query</h2>"
            f"<p class='muted'>peaks {roofline.get('peak_gbps', 0):g} "
            f"GB/s · {roofline.get('peak_gflops', 0):g} GFLOP/s "
            f"(spark.rapids.obs.audit.*)</p>"
            "<table><tr><th>group</th><th class='num'>device s</th>"
            "<th class='num'>GB/s</th><th class='num'>% roofline</th>"
            "<th class='num'>GFLOP/s</th><th>bound</th>"
            "<th class='num'>padding waste &le;</th></tr>")
        for gname in sorted(roofline["groups"]):
            g = roofline["groups"][gname]
            pct = g.get("roofline_pct_bw") or 0.0
            body.append(
                f"<tr><td>{_esc(gname)}</td>"
                f"<td class='num'>{g.get('seconds', 0):.3f}</td>"
                f"<td class='num'>{g.get('achieved_gbps', 0):.2f}</td>"
                f"<td class='num'><span class='pbar'><span "
                f"style='width:{min(pct, 100):.1f}%'></span></span> "
                f"{pct:.3f}%</td>"
                f"<td class='num'>{g.get('achieved_gflops', 0):.2f}</td>"
                f"<td>{_esc(g.get('bound', ''))}</td>"
                f"<td class='num'>"
                f"{(g.get('padding_waste_ratio') or 0) * 100:.0f}%</td>"
                f"</tr>")
        body.append("</table>")
    # A11f: the serving layer's intake and result-cache table
    if sampler_snapshot:
        body.append("<h2>Resource time-series</h2><div>")
        for name in sorted(sampler_snapshot):
            pts = [s[1] for s in sampler_snapshot[name]]
            body.append(f"<span class='spark'><span class='lbl'>"
                        f"{_esc(name)}"
                        + (f" ({pts[-1]:g})" if pts else "")
                        + f"</span>{sparkline_svg(pts)}</span>")
        body.append("</div>")
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<meta http-equiv='refresh' content='{refresh_seconds}'>"
            f"<title>{_esc(title)}</title><style>{_CSS}</style></head>"
            f"<body><h1>{_esc(title)}</h1>{''.join(body)}</body></html>")


def render_live() -> str:
    """Convenience entry the endpoint calls: current registry +
    installed sampler + the last audited query's roofline."""
    from spark_rapids_tpu_torch.runtime import obs as _obs
    from spark_rapids_tpu_torch.runtime.obs import live, sampler as SMP
    s = SMP.sampler()
    st = _obs.state()
    return render_console(live.queries_doc(),
                          s.snapshot() if s is not None else None,
                          roofline=getattr(st, "last_roofline", None)
                          if st is not None else None)
