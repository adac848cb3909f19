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
with their table, the anomaly feed, the session panel of a recurrent
net's server (the ``session_cache`` registry source and the batched
decode's metrics, or on a router their sum over the replicas' health
scrapes), the serving tier's section on a router's page (replicas,
generations, retries, respawns, a row a replica) and the slow-request
panel (the slowest stitched request waterfalls,
``telemetry/reqtrace.py``) and the storage panel (the free space the
writers last saw, ``io_faults{site=,errno=}``, skipped snapshots and
the gang supervisor's holds for space; shown once any of them exists).
The JAX page's deployment section and its storage tile for the deploy
tee read a subsystem the port does not have yet and are not ported.

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

# fixed request-hop -> categorical slot assignment (light, dark) for
# the slow-request waterfalls (telemetry/reqtrace.py span taxonomy);
# same discipline as the phase palette: stable, never re-ranked.
# router.retry deliberately wears the warning status color AND a text
# flag in the row label — a retried hop is state, not just identity.
_HOP_COLORS = {
    "router.dispatch": ("#2a78d6", "#3987e5"),
    "router.retry": ("#fab219", "#fab219"),
    "server.request": ("#1baf7a", "#199e70"),
    "batcher.wait": ("#eda100", "#c98500"),
    "batcher.shed": ("#d03b3b", "#e66767"),
    "engine.compute": ("#4a3aa7", "#9085e9"),
    "engine.generate": ("#2a6a6a", "#3d8f8f"),
    "serve.serialize": ("#e87ba4", "#d55181"),
}


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
    for name, (lc, dc) in [("__other__", _OTHER_COLOR)] + list(
        _PHASE_COLORS.items()
    ):
        sel = f'[data-phase="{name}"]' if name != "__other__" else ".seg,.swatch"
        light.append(f"{sel}{{background:{lc}}}")
        dark.append(f"{sel}{{background:{dc}}}")
    for name, (lc, dc) in _HOP_COLORS.items():
        sel = f'[data-hop="{name}"]'
        light.append(f"{sel}{{background:{lc}}}")
        dark.append(f"{sel}{{background:{dc}}}")
    # the catch-all comes FIRST so named phases and hops override it
    light_css = "".join(light)
    dark_css = "".join(dark)
    return (
        light_css
        + "@media (prefers-color-scheme: dark){" + dark_css + "}"
    )


def _session_section(session: dict, decode: Optional[dict] = None) -> str:
    """Session-cache panel: hit/miss/evict/stale-gen tiles from the
    ``session_cache`` registry source. A hot swap shows up as a ``stale
    gen`` pulse: every invalidation is a counted rebuild, never a wrong
    answer. With batched decode live, batch-occupancy and tokens/s tiles
    from the ``decode`` metrics block."""
    total = sum(
        session.get(k, 0)
        for k in ("hits", "misses", "stale_gen", "rebuilt")
    )
    hit_rate = (
        f"{session.get('hits', 0) / total:.0%} hit rate" if total else ""
    )
    mb = session.get("resident_bytes", 0) / (1 << 20)
    cap = session.get("max_bytes", 0) / (1 << 20)
    tiles = [
        _tile("resident sessions", str(session.get("entries", 0)),
              f"{mb:.2f} / {cap:g} MB"),
        _tile("hits", str(session.get("hits", 0)), hit_rate),
        _tile("misses", str(session.get("misses", 0)), "cold rebuilds"),
        _tile("evictions", str(session.get("evictions", 0)),
              "LRU-by-hit"),
        _tile("stale gen", str(session.get("stale_gen", 0)),
              "hot-swap invalidations"),
        _tile("prefix rebuilt", str(session.get("rebuilt", 0)),
              "history mismatch"),
    ]
    if decode:
        occ = decode.get("occupancy")
        tps = (
            decode.get("window_tokens_per_sec")
            or decode.get("tokens_per_sec") or 0
        )
        tiles += [
            _tile("batch occupancy",
                  f"{occ:.0%}" if occ is not None else "—",
                  f"{decode.get('dispatches', 0)} dispatches"),
            _tile("decode tokens/s", f"{tps:g}",
                  f"{decode.get('rows', 0)} tokens, "
                  f"{decode.get('shed', 0)} shed"),
            _tile("coalesced", str(session.get("coalesced", 0)),
                  "same-session rows deferred"),
        ]
    return (
        '<section><h2>Sessions <span class="muted">'
        "(per-session decode-state cache; docs/SERVING.md)</span></h2>"
        f'<div class="tiles">{"".join(tiles)}</div></section>'
    )


def _router_section(router: dict) -> str:
    """Serving-tier tiles + per-replica table (router /dash only):
    healthy count, served generations, retry/respawn counters, and one
    row per replica — state, outstanding, generation, precision
    (quant variant — a rolled-back A/B reads straight off the table),
    p50/p99."""
    rm = router.get("router") or {}
    lat = rm.get("request_latency") or {}
    healthy = router.get("replicas_healthy", 0)
    total = router.get("replicas_total", 0)
    tiles = [
        _tile("replicas", f"{healthy}/{total}",
              "healthy" if healthy == total else "degraded"),
        _tile("served gen", ",".join(
            str(g) for g in router.get("generations", [])) or "0",
            f"{rm.get('rolls', 0)} rolls"),
        _tile("retries", str(rm.get("retries", 0)),
              f"{rm.get('failed', 0)} failed"),
        _tile("replica deaths", str(rm.get("replica_deaths", 0)),
              f"{rm.get('respawns', 0)} respawns"),
        _tile("router p99", (
            f"{lat.get('p99_ms'):.1f} ms"
            if lat.get("p99_ms") is not None else "—"
        )),
    ]
    rows = []
    for r in router.get("replicas", []):
        st = "good" if r.get("healthy") else "serious"
        label = "healthy" if r.get("healthy") else "ejected"
        rl = r.get("latency") or {}
        sc = r.get("session_cache") or {}
        fmt = lambda v: f"{v:.1f}" if v is not None else "—"
        rows.append(
            f'<tr><td>replica {r.get("index")}</td>'
            f'<td><span class="status-{st}">'
            f'{"●" if r.get("healthy") else "▲"} {label}</span></td>'
            f'<td>{_esc(r.get("addr") or "?")}</td>'
            f'<td>{r.get("outstanding", 0)}</td>'
            f'<td>{_esc(r.get("generation"))}</td>'
            f'<td>{_esc(r.get("quant") or "f32")}</td>'
            f'<td>{sc.get("entries", 0) if sc.get("enabled") else "—"}</td>'
            f'<td>{r.get("forwarded", 0)}</td>'
            f'<td>{fmt(rl.get("p50_ms"))}</td>'
            f'<td>{fmt(rl.get("p99_ms"))}</td></tr>'
        )
    table = (
        '<table class="data"><thead><tr><th>replica</th><th>state</th>'
        "<th>addr</th><th>outstanding</th><th>gen</th>"
        "<th>precision</th><th>sessions</th><th>forwarded</th>"
        "<th>p50 ms</th><th>p99 ms</th></tr></thead>"
        f'<tbody>{"".join(rows)}</tbody></table>'
    )
    return (
        f'<section><h2>Serving tier</h2>'
        f'<div class="tiles">{"".join(tiles)}</div>{table}</section>'
    )


def _session_aggregate(router: Optional[dict]) -> Optional[dict]:
    """Sum the replicas' ``session_cache`` health blocks into one
    router-level view (entries, hits, misses, ...)."""
    if router is None:
        return None
    agg: Dict[str, int] = {}
    seen = False
    for r in router.get("replicas", []):
        sc = r.get("session_cache")
        if not sc or not sc.get("enabled"):
            continue
        seen = True
        for k in ("entries", "resident_bytes", "max_bytes", "hits",
                  "misses", "evictions", "stale_gen", "rebuilt",
                  "coalesced"):
            agg[k] = agg.get(k, 0) + int(sc.get(k) or 0)
    return dict(agg, enabled=True) if seen else None


def _decode_aggregate(router: Optional[dict]) -> Optional[dict]:
    """Sum the replicas' batched-decode health blocks into
    one router-level view; occupancy is recomputed from the summed
    row counts, tokens/sec adds across replicas."""
    if router is None:
        return None
    agg: Dict[str, float] = {}
    seen = False
    for r in router.get("replicas", []):
        d = r.get("decode")
        if not d or not d.get("dispatches"):
            continue
        seen = True
        for k in ("dispatches", "rows", "padded_rows", "retired",
                  "shed", "tokens_per_sec"):
            agg[k] = agg.get(k, 0) + (d.get(k) or 0)
    if not seen:
        return None
    agg["occupancy"] = round(
        agg.get("rows", 0)
        / max(agg.get("rows", 0) + agg.get("padded_rows", 0), 1),
        4,
    )
    return agg


def _reqtrace_section(records: List[dict]) -> str:
    """Slow-request panel: top-K stitched waterfalls by latency (the
    router's completed traces, ``telemetry/reqtrace.py``).  One bar
    per request; segments are the hops' duration shares (leaf spans —
    batcher wait / engine compute / serialize — plus the router-side
    attempt spans' unoverlapped remainder would double-count, so the
    bar simply stacks every span's share of the trace's total span
    time: attribution, not a timeline).  Rows with a retry hop are
    flagged ``⟳ retried`` — never by color alone."""
    if not records:
        return ""
    rows = []
    for rec in sorted(records, key=lambda r: r.get("wall_ms", 0.0),
                      reverse=True):
        spans = rec.get("spans") or []
        total = sum(s.get("dur", 0.0) for s in spans)
        if total <= 0:
            continue
        segs = []
        retried = False
        for s in sorted(spans, key=lambda x: x.get("ts", 0)):
            name = s.get("name", "?")
            if name == "router.retry":
                retried = True
            dur_ms = s.get("dur", 0.0) / 1000.0
            segs.append(
                f'<div class="seg" data-hop="{_esc(name)}" '
                f'style="width:{max(s.get("dur", 0.0) / total * 100, 0.4):.2f}%" '
                f'title="{_esc(name)}: {dur_ms:.2f} ms"></div>'
            )
        label = rec.get("trace", "?")[:8]
        flag = ' <span class="status-warning">⟳ retried</span>' if retried \
            else ""
        rows.append(
            f'<div class="barrow"><div class="rank" '
            f'title="{_esc(rec.get("trace"))}">{_esc(label)}</div>'
            f'<div class="bar">{"".join(segs)}</div>'
            f'<div class="ms">{rec.get("wall_ms", 0):.1f} ms{flag}</div>'
            f"</div>"
        )
    seen: List[str] = []
    for rec in records:
        for s in rec.get("spans") or []:
            n = s.get("name", "?")
            if n not in seen:
                seen.append(n)
    legend = "".join(
        f'<span class="key"><span class="swatch" '
        f'data-hop="{_esc(n)}"></span>{_esc(n)}</span>'
        for n in seen
    )
    return (
        f'<section><h2>Slow requests <span class="muted">'
        f"(top {len(rows)} stitched waterfalls by latency; full traces "
        f"at /traces)</span></h2>"
        f'<div class="bars">{"".join(rows)}</div>'
        f'<div class="legend">{legend}</div></section>'
    )


def _storage_section(registry_snapshot: Dict[str, Any]) -> str:
    """The storage panel: disk headroom and every degradation the
    writers took (``io_faults{site=,errno=}``, skipped snapshots, the
    supervisor's holds for space), so a disk-pressure incident reads as
    counted policy. Rendered only once one of those signals exists."""
    metrics = registry_snapshot.get("metrics") or {}
    faults = metrics.get("io_faults") or {}
    skipped = metrics.get("snapshot_skipped") or {}
    free = (metrics.get("disk_free_bytes") or {}).get("") or {}
    # the supervisor's counters are a registry source of their own
    holds = (registry_snapshot.get("supervisor") or {}).get("io_holds", 0)
    n_faults = sum(int(v) for v in faults.values())
    n_skipped = sum(int(v) for v in skipped.values())
    if not (faults or skipped or holds or free):
        return ""
    free_v = free.get("value")
    tiles = [
        _tile("disk free",
              f"{free_v / 1e9:.2f} GB" if free_v is not None else "—",
              "last writer observation"),
        _tile("io faults", str(n_faults),
              f"{len(faults)} site/errno pairs"),
        _tile("snapshots skipped", str(n_skipped),
              "resume falls back one snapshot"),
        _tile("supervisor holds", str(int(holds)),
              "waited for space, not restart budget"),
    ]
    rows = []
    for label in sorted(faults):
        # "errno=enospc,site=snapshot" -> {"errno": ..., "site": ...}
        kv = dict(p.split("=", 1) for p in label.split(",") if "=" in p)
        rows.append(
            f'<tr><td>{_esc(kv.get("site", "?"))}</td>'
            f'<td>{_esc(kv.get("errno", "?"))}</td>'
            f"<td>{int(faults[label])}</td></tr>"
        )
    table = (
        '<table class="data"><thead><tr><th>site</th><th>errno</th>'
        f'<th>faults</th></tr></thead><tbody>{"".join(rows)}</tbody>'
        "</table>"
    ) if rows else ""
    return (
        '<section><h2>Storage <span class="muted">'
        "(writer degradations)</span></h2>"
        f'<div class="tiles">{"".join(tiles)}</div>{table}</section>'
    )


def render_html(
    registry_snapshot: Dict[str, Any],
    serve_metrics: Optional[dict] = None,
    cluster: Optional[dict] = None,
    anomalies: Optional[List[dict]] = None,
    model_name: str = "net",
    refresh_s: int = 2,
    router: Optional[dict] = None,
    reqtrace: Optional[List[dict]] = None,
) -> str:
    """The whole dashboard as one HTML string, rendered server-side
    from snapshots (the route passes live ones). ``router``: a
    ``Router.snapshot()``, which adds the serving tier's section (the
    router's ``/dash``). ``reqtrace``: stitched trace records
    (``reqtrace.slowest()``), which add the slow-request panel."""
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
    # the session panel: this process's own cache (registry source), or
    # the sum over the replicas' scrapes on a router; the batched
    # decode's tiles once it dispatched
    session = registry_snapshot.get("session_cache")
    if not (session and session.get("enabled")):
        session = _session_aggregate(router)
    decode = serve.get("decode")
    if not (decode and decode.get("dispatches")):
        decode = _decode_aggregate(router)
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
{_router_section(router) if router is not None else ''}
{_session_section(session, decode) if session else ''}
{_reqtrace_section(reqtrace) if reqtrace else ''}
{_storage_section(registry_snapshot)}
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
.ms {{ min-width: 110px; text-align: left; color: #6e6d66;
      font-variant-numeric: tabular-nums; }}
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
  .muted, .tile .label, .tile .sub, .rank, .ms {{ color: #c3c2b7; }}
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
