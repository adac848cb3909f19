"""Zero-dependency live dashboard: one self-contained HTML document.

Counterpart of ``sparknet_tpu/telemetry/dash.py`` (stdlib only,
copied). ``serve/server.py`` mounts it on ``GET /dash``: each request
renders the page from the live registry snapshot, the cluster aggregate
and the anomaly board, and the page refreshes itself; no script, no
external assets.

Sections, top to bottom: stat tiles (requests, throughput, queue depth,
uptime), serving-latency SLO tiles (p50/p95/p99 against
``SPARKNET_SLO_P99_MS``), per-rank phase-share bars from the cluster
aggregate (or this process's own timeline when no cluster data exists)
with their table, and the anomaly feed. The JAX page's router,
deployment, session, slow-request and storage sections read subsystems
the port does not have yet (the router, the session cache, request
tracing, the storage-fault counters) and are not ported.

Visual rules: phases wear a fixed categorical palette in a fixed order;
anomaly severities wear the status palette with an icon and a text
label, never color alone; stacked segments keep a 2px gap; dark mode
has its own color steps.
"""

from __future__ import annotations

import html
import json
import os
import time
from typing import Any, Dict, List, Optional

from . import timeline

# fixed phase -> categorical slot assignment (light, dark) — stable
# across requests and across ranks, never cycled or re-ranked
_PHASE_COLORS = {
    "input_wait": ("#2a78d6", "#3987e5"),
    "device_put": ("#eb6834", "#d95926"),
    "multihost_sync": ("#1baf7a", "#199e70"),
    "compiled_step": ("#eda100", "#c98500"),
    "grad_allreduce": ("#e87ba4", "#d55181"),
    "eval": ("#008300", "#008300"),
    "snapshot": ("#4a3aa7", "#9085e9"),
}
_OTHER_COLOR = ("#e34948", "#e66767")  # everything non-canonical folds here

# reserved status palette: state, never series identity
_STATUS = {
    "good": "#0ca30c",
    "warning": "#fab219",
    "serious": "#ec835a",
    "critical": "#d03b3b",
}
_SEVERITY_ICON = {"warning": "△", "serious": "▲", "critical": "✕"}


def slo_p99_ms() -> float:
    raw = os.environ.get("SPARKNET_SLO_P99_MS", "").strip()
    try:
        return float(raw) if raw else 250.0
    except ValueError:
        return 250.0


def _esc(v) -> str:
    return html.escape(str(v), quote=True)


def _phase_css(name: str, dark: bool) -> str:
    return _PHASE_COLORS.get(name, _OTHER_COLOR)[1 if dark else 0]


def _rank_shares(cluster: Optional[dict]) -> Dict[str, Dict[str, float]]:
    """{rank_label: {phase: share}} from the cluster source snapshot,
    falling back to this process's own timeline."""
    out: Dict[str, Dict[str, float]] = {}
    for r, e in ((cluster or {}).get("ranks") or {}).items():
        wall = e.get("wall_s") or 0.0
        if wall <= 0:
            continue
        out[f"rank {r}"] = {
            name: p.get("total_s", 0.0) / wall
            for name, p in (e.get("phases") or {}).items()
        }
    if not out:
        tl = timeline.current()
        snap = tl.snapshot() if tl.enabled else {}
        wall = snap.get("wall_s") or 0.0
        if wall > 0:
            out["this process"] = {
                name: p["total_s"] / wall
                for name, p in snap.get("phases", {}).items()
            }
    return out


def _ordered_phases(shares: Dict[str, Dict[str, float]]) -> List[str]:
    names: List[str] = []
    for d in shares.values():
        for n in d:
            if n not in names:
                names.append(n)
    return [p for p in timeline.PHASES if p in names] + sorted(
        n for n in names if n not in timeline.PHASES
    )


def _tile(label: str, value: str, sub: str = "") -> str:
    sub_html = f'<div class="sub">{_esc(sub)}</div>' if sub else ""
    return (
        f'<div class="tile"><div class="label">{_esc(label)}</div>'
        f'<div class="value">{_esc(value)}</div>{sub_html}</div>'
    )


def _slo_tile(name: str, ms: Optional[float], budget_ms: float) -> str:
    if ms is None:
        return _tile(name, "—", "no samples")
    ok = ms <= budget_ms
    status = "good" if ok else "critical"
    icon = "●" if ok else "✕"
    return (
        f'<div class="tile"><div class="label">{_esc(name)}</div>'
        f'<div class="value">{ms:.1f} ms</div>'
        f'<div class="sub status-{status}">{icon} '
        f'{"within" if ok else "over"} {budget_ms:g} ms budget</div></div>'
    )


def _bars(shares, phases) -> str:
    rows = []
    for rank in sorted(shares):
        segs = []
        for p in phases:
            v = shares[rank].get(p, 0.0)
            if v <= 0:
                continue
            segs.append(
                f'<div class="seg" data-phase="{_esc(p)}" '
                f'style="width:{max(v * 100, 0.4):.2f}%" '
                f'title="{_esc(p)}: {v:.1%}"></div>'
            )
        rows.append(
            f'<div class="barrow"><div class="rank">{_esc(rank)}</div>'
            f'<div class="bar">{"".join(segs)}</div></div>'
        )
    legend = "".join(
        f'<span class="key"><span class="swatch" '
        f'data-phase="{_esc(p)}"></span>{_esc(p)}</span>'
        for p in phases
    )
    return (
        f'<div class="bars">{"".join(rows)}</div>'
        f'<div class="legend">{legend}</div>'
    )


def _share_table(shares, phases) -> str:
    if not shares:
        return ""
    head = "".join(f"<th>{_esc(p)}</th>" for p in phases)
    body = "".join(
        "<tr><td>{}</td>{}</tr>".format(
            _esc(rank),
            "".join(
                f"<td>{shares[rank].get(p, 0.0):.1%}</td>" for p in phases
            ),
        )
        for rank in sorted(shares)
    )
    return (
        f'<table class="data"><thead><tr><th>rank</th>{head}</tr></thead>'
        f"<tbody>{body}</tbody></table>"
    )


def _anomaly_feed(events: List[dict]) -> str:
    if not events:
        return '<p class="muted">no anomalies recorded</p>'
    items = []
    for e in reversed(events[-20:]):
        sev = e.get("severity", "warning")
        sev = sev if sev in _STATUS else "warning"
        icon = _SEVERITY_ICON.get(sev, "△")
        detail = {
            k: v for k, v in e.items()
            if k not in ("kind", "severity", "t")
        }
        when = time.strftime("%H:%M:%S", time.localtime(e.get("t", 0)))
        items.append(
            f'<li><span class="status-{sev}">{icon} {_esc(sev)}</span> '
            f"<strong>{_esc(e.get('kind', '?'))}</strong> "
            f'<span class="muted">{_esc(when)}</span> '
            f"{_esc(json.dumps(detail, default=str))}</li>"
        )
    return f'<ul class="feed">{"".join(items)}</ul>'


def _phase_style_rules() -> str:
    light, dark = [], []
    for name, (lc, dc) in list(_PHASE_COLORS.items()) + [
        ("__other__", _OTHER_COLOR)
    ]:
        sel = f'[data-phase="{name}"]' if name != "__other__" else ".seg,.swatch"
        light.append(f"{sel}{{background:{lc}}}")
        dark.append(f"{sel}{{background:{dc}}}")
    # the catch-all comes FIRST so named phases override it
    light_css = light[-1] + "".join(light[:-1])
    dark_css = dark[-1] + "".join(dark[:-1])
    return (
        light_css
        + "@media (prefers-color-scheme: dark){" + dark_css + "}"
    )


def render_html(
    registry_snapshot: Dict[str, Any],
    serve_metrics: Optional[dict] = None,
    cluster: Optional[dict] = None,
    anomalies: Optional[List[dict]] = None,
    model_name: str = "net",
    refresh_s: int = 2,
) -> str:
    """The whole dashboard as one HTML string, rendered server-side
    from snapshots (the route passes live ones)."""
    cluster = cluster if cluster is not None else registry_snapshot.get(
        "cluster"
    )
    serve = serve_metrics if serve_metrics is not None else (
        registry_snapshot.get("serve") or {}
    )
    shares = _rank_shares(cluster)
    phases = _ordered_phases(shares)
    lat = serve.get("request_latency") or {}
    budget = slo_p99_ms()

    tiles = [
        _tile("requests", str(serve.get("requests", 0)),
              f"{serve.get('errors', 0)} errors"),
        _tile("req/s (window)",
              str(serve.get("window_requests_per_sec", 0.0))),
        _tile("queue depth", str(serve.get("queue_depth", 0)),
              f"max {serve.get('queue_depth_max', 0)}"),
        _tile("uptime", f"{registry_snapshot.get('uptime_s', 0):.0f} s"),
    ]
    slo_tiles = [
        _slo_tile("p50", lat.get("p50_ms"), budget / 4),
        _slo_tile("p95", lat.get("p95_ms"), budget / 2),
        _slo_tile("p99", lat.get("p99_ms"), budget),
    ]
    active_anoms = anomalies or []
    health = serve.get("health", "ok")
    degraded = health != "ok" or any(
        a.get("severity") in ("serious", "critical") for a in active_anoms
    )
    status = "serious" if degraded else "good"
    status_label = "degraded" if degraded else "healthy"

    from . import anomaly as _anomaly

    body = f"""
<header>
  <h1>sparknet — {_esc(model_name)}</h1>
  <span class="status-{status} pill">{'▲' if degraded else '●'} {status_label}</span>
  <span class="muted">rendered {time.strftime('%H:%M:%S')}, refreshes every {refresh_s}s</span>
</header>
<section><h2>Serving</h2><div class="tiles">{''.join(tiles)}</div></section>
<section><h2>Latency SLO <span class="muted">(p99 budget {budget:g} ms)</span></h2>
<div class="tiles">{''.join(slo_tiles)}</div></section>
<section><h2>Step-phase share per rank</h2>
{_bars(shares, phases) if shares else '<p class="muted">no phase data (enable the timeline with --trace or SPARKNET_TIMELINE=1)</p>'}
{_share_table(shares, phases)}</section>
<section><h2>Anomalies <span class="muted">({len(active_anoms)} active)</span></h2>
{_anomaly_feed(_anomaly.recent())}</section>
"""
    css = f"""
:root {{ color-scheme: light dark; }}
body {{ margin: 0; padding: 16px 20px; font: 13px/1.5 system-ui, sans-serif;
       background: #fcfcfa; color: #141413; }}
h1 {{ font-size: 16px; margin: 0 12px 0 0; display: inline-block; }}
h2 {{ font-size: 13px; margin: 18px 0 8px; }}
section {{ margin-bottom: 8px; }}
.muted {{ color: #6e6d66; font-weight: normal; font-size: 12px; }}
.pill {{ font-weight: 600; margin-right: 10px; }}
.tiles {{ display: flex; gap: 10px; flex-wrap: wrap; }}
.tile {{ border: 1px solid #e3e2da; border-radius: 6px; padding: 8px 14px;
        min-width: 110px; background: #ffffff; }}
.tile .label {{ color: #6e6d66; font-size: 11px; }}
.tile .value {{ font-size: 20px; font-weight: 600; }}
.tile .sub {{ font-size: 11px; color: #6e6d66; }}
.barrow {{ display: flex; align-items: center; gap: 8px; margin: 3px 0; }}
.rank {{ width: 90px; text-align: right; color: #6e6d66; }}
.bar {{ flex: 1; display: flex; gap: 2px; height: 14px; }}
.seg {{ border-radius: 4px; min-width: 2px; }}
.legend {{ margin: 8px 0 0 98px; }}
.key {{ margin-right: 14px; white-space: nowrap; }}
.swatch {{ display: inline-block; width: 10px; height: 10px;
          border-radius: 3px; margin-right: 4px; vertical-align: -1px; }}
table.data {{ border-collapse: collapse; margin-top: 10px; }}
table.data th, table.data td {{ border: 1px solid #e3e2da;
  padding: 2px 8px; text-align: right; font-variant-numeric: tabular-nums; }}
table.data th:first-child, table.data td:first-child {{ text-align: left; }}
ul.feed {{ list-style: none; padding: 0; margin: 0; }}
ul.feed li {{ padding: 2px 0; border-bottom: 1px solid #efeee6;
             font-variant-numeric: tabular-nums; }}
.status-good {{ color: {_STATUS['good']}; }}
.status-warning {{ color: {_STATUS['warning']}; }}
.status-serious {{ color: {_STATUS['serious']}; }}
.status-critical {{ color: {_STATUS['critical']}; }}
{_phase_style_rules()}
@media (prefers-color-scheme: dark) {{
  body {{ background: #1a1a19; color: #ffffff; }}
  .tile {{ background: #232322; border-color: #3a3a37; }}
  .muted, .tile .label, .tile .sub, .rank {{ color: #c3c2b7; }}
  table.data th, table.data td {{ border-color: #3a3a37; }}
  ul.feed li {{ border-color: #2c2c2a; }}
}}
"""
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<meta http-equiv='refresh' content='{int(refresh_s)}'>"
        "<title>sparknet dashboard</title>"
        f"<style>{css}</style></head><body>{body}</body></html>"
    )
