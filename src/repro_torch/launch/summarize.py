"""Plan and metric-log reports (port of ``repro/launch/summarize.py``).

    python -m repro_torch.launch.summarize --plan plan.json
    python -m repro_torch.launch.summarize --metrics events.jsonl

``plan_summary`` renders a ``QuantPlan`` JSON dict (realized bits/param
against the target, the per-layer allocation histogram), as
``python -m repro_torch.launch.plan inspect`` prints it;
``metrics_summary`` renders a ``repro_torch.obs`` (or ``repro.obs``)
JSONL metric log: counters and gauges as a table, histograms with their
quantiles.  Stdlib only, like the reference.  The reference's dry-run
roofline tables come with ``launch/dryrun.py`` (ROADMAP queue A).
"""
from __future__ import annotations

import argparse
import json

__all__ = ["plan_summary", "metrics_summary", "main"]


def _wmean(entries, field):
    tot = sum(e["out_features"] * e["in_features"] for e in entries)
    vals = [(e.get(field), e["out_features"] * e["in_features"])
            for e in entries]
    if any(v is None for v, _ in vals) or tot == 0:
        return None
    return sum(v * n for v, n in vals) / tot


def _layer_of(name):
    head = name.split("/", 1)[0]
    return int(head[1:]) if head.startswith("L") and head[1:].isdigit() \
        else -1


def plan_summary(d: dict, width: int = 40) -> str:
    """Render a QuantPlan JSON dict: realized bits/param vs target and the
    per-layer allocation histogram (param-weighted mean snapped bits)."""
    entries = d["entries"]
    budget = d["budget_bits_per_param"]
    planned = _wmean(entries, "snapped_bits")
    realized = _wmean(entries, "achieved_bits")
    out = [f"plan: {len(entries)} matrices, weighting={d['weighting']}, "
           f"schema v{d['schema_version']}"]
    line = (f"  budget {budget:.3f} bits/param | planned {planned:.3f}")
    if realized is not None:
        line += f" | realized {realized:.3f}"
    if d.get("budget_overrun"):
        line += "  [BUDGET OVERRUN — floors forced past the budget]"
    out.append(line)
    fmts = {}
    for e in entries:
        fmts[e["payload_bits"]] = fmts.get(e["payload_bits"], 0) + 1
    out.append("  payloads: " + ", ".join(
        f"int{b}×{c}" for b, c in sorted(fmts.items())))
    layers = {}
    for e in entries:
        n = e["out_features"] * e["in_features"]
        s = layers.setdefault(_layer_of(e["name"]), [0.0, 0.0])
        s[0] += e["snapped_bits"] * n
        s[1] += n
    out.append("  per-layer allocation (param-weighted mean snapped bits):")
    top = max((s[0] / s[1]) for s in layers.values()) if layers else 1.0
    for l, (num, den) in sorted(layers.items()):
        mean = num / den
        bar = "#" * max(1, int(round(width * mean / max(top, 1e-9))))
        tag = f"L{l}" if l >= 0 else "(?)"
        out.append(f"    {tag:>5} {mean:6.3f}b {bar}")
    return "\n".join(out)


def _fmt_val(name: str, v) -> str:
    """Seconds-suffixed metrics render in ms; everything else %g."""
    if v is None:
        return "-"
    if name.endswith("_seconds") and isinstance(v, (int, float)):
        return f"{v * 1e3:.2f}ms"
    return f"{v:g}" if isinstance(v, (int, float)) else str(v)


def _series_label(rec: dict) -> str:
    labels = rec.get("labels") or {}
    if not labels:
        return rec["name"]
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{rec['name']}{{{inner}}}"


def metrics_summary(lines, width: int = 30) -> str:
    """Render an obs JSONL metric log (DESIGN.md §11): counters and gauges
    as a value table, histograms with count/quantiles and a param-free
    #-bar over p50 (largest p50 = full width).  The reference's quality
    tables (DESIGN.md §14) come with ``serve/quality``."""
    recs = [json.loads(ln) for ln in lines if ln.strip()]
    by_kind = {"counter": [], "gauge": [], "histogram": []}
    for r in recs:
        by_kind.setdefault(r.get("kind", "?"), []).append(r)
    out = [f"metrics: {len(recs)} series "
           f"({len(by_kind['counter'])} counters, "
           f"{len(by_kind['gauge'])} gauges, "
           f"{len(by_kind['histogram'])} histograms)"]
    for kind in ("counter", "gauge"):
        if not by_kind[kind]:
            continue
        out.append(f"  {kind}s:")
        pad = max(len(_series_label(r)) for r in by_kind[kind])
        for r in sorted(by_kind[kind], key=_series_label):
            out.append(f"    {_series_label(r):<{pad}}  "
                       f"{_fmt_val(r['name'], r['value'])}")
    hists = by_kind["histogram"]
    if hists:
        out.append("  histograms:")
        top = max((r["quantiles"].get("0.5") or 0) for r in hists) or 1.0
        pad = max(len(_series_label(r)) for r in hists)
        for r in sorted(hists, key=_series_label):
            q = r["quantiles"]
            p50 = q.get("0.5")
            bar = "#" * max(1, int(round(width * (p50 or 0) / top)))
            out.append(
                f"    {_series_label(r):<{pad}}  n={r['count']}"
                f" p50={_fmt_val(r['name'], p50)}"
                f" p90={_fmt_val(r['name'], q.get('0.9'))}"
                f" p99={_fmt_val(r['name'], q.get('0.99'))}"
                f" max={_fmt_val(r['name'], r.get('max'))}"
                f"{'' if r.get('exact', True) else ' ~'} {bar}")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--plan", default=None,
                       help="summarize a QuantPlan artifact")
    group.add_argument("--metrics", default=None,
                       help="summarize a repro_torch.obs JSONL metric log "
                            "(counters + histogram quantiles)")
    args = ap.parse_args(argv)
    if args.plan:
        with open(args.plan) as f:
            print(plan_summary(json.load(f)))
        return
    with open(args.metrics) as f:
        print(metrics_summary(f))


if __name__ == "__main__":
    main()
