"""Dry-run roofline tables, plan and metric-log reports (port of
``repro/launch/summarize.py``).

    python -m repro_torch.launch.summarize [--dir experiments/dryrun_torch]
    python -m repro_torch.launch.summarize --plan plan.json
    python -m repro_torch.launch.summarize --metrics events.jsonl

``table`` renders the dry run's cell JSONs (``launch/dryrun.py``) as the
reference renders its own, character for character; ``plan_summary`` renders a ``QuantPlan`` JSON dict (realized bits/param
against the target, the per-layer allocation histogram), as
``python -m repro_torch.launch.plan inspect`` prints it;
``metrics_summary`` renders a ``repro_torch.obs`` (or ``repro.obs``)
JSONL metric log: counters and gauges as a table, histograms with their
quantiles, then the quality series' drift, SLO-burn and attribution
tables.  Stdlib only, like the reference.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["fmt_bytes", "load_all", "table", "plan_summary",
           "metrics_summary", "main"]


def fmt_bytes(b):
    if b >= 1 << 30:
        return f"{b / (1 << 30):.2f}G"
    if b >= 1 << 20:
        return f"{b / (1 << 20):.1f}M"
    return f"{b / 1024:.0f}K"


def load_all(d):
    """Every cell JSON of the dry-run directory ``d``, in file-name order."""
    rows = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def table(rows, mesh="single"):
    """The roofline table of ``mesh``'s 16-bit cells (one row per cell)."""
    hdr = ("| arch | shape | st | flops/dev | bytes/dev | coll/dev | "
           "compute_s | memory_s | coll_s | dom | useful | RLfrac | "
           "mem/dev |")
    sep = "|" + "---|" * 13
    out = [hdr, sep]
    for r in rows:
        if r.get("mesh") != mesh or (r.get("wbits", 16) != 16):
            continue
        if r.get("status") == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | SKIP | "
                       f"{r.get('reason', '')[:40]} |" + " |" * 9)
            continue
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | "
                       f"{r.get('status', '?').upper()} |" + " |" * 10)
            continue
        rl = r["roofline"]
        mem = r.get("memory_analysis", {})
        peak = mem.get("argument_size_in_bytes", 0) \
            + mem.get("temp_size_in_bytes", 0)
        out.append(
            f"| {r['arch']} | {r['shape']} | ok "
            f"| {rl['hlo_flops_per_device']:.2e} "
            f"| {rl['hlo_bytes_per_device']:.2e} "
            f"| {rl['collective_bytes_per_device']:.2e} "
            f"| {rl['compute_s']:.4f} | {rl['memory_s']:.4f} "
            f"| {rl['collective_s']:.4f} | {rl['dominant'][:4]} "
            f"| {rl['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} "
            f"| {fmt_bytes(peak)} |")
    return "\n".join(out)


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


def _quality_sections(recs, width: int = 30):
    """Render the quality-observatory views of a metric log (DESIGN.md
    §14): drift verdicts, SLO burn rates, and per-layer/matrix output-MSE
    attribution. Empty list when the log has no quality series."""
    out = []
    drift = [r for r in recs if r["name"] == "repro_quality_drift_total"]
    if drift:
        out.append("  drift verdicts:")
        pad = max(len((r.get("labels") or {}).get("series", "?"))
                  for r in drift)
        for r in sorted(drift,
                        key=lambda r: (r.get("labels") or {}).get(
                            "series", "")):
            series = (r.get("labels") or {}).get("series", "?")
            n = int(r.get("value") or 0)
            verdict = f"DRIFT x{n}" if n else "ok"
            out.append(f"    {series:<{pad}}  {verdict}")
    burns = {(r.get("labels") or {}).get("slo", "?"): r.get("value")
             for r in recs if r["name"] == "repro_slo_burn_rate"}
    oks = {(r.get("labels") or {}).get("slo", "?"): r.get("value")
           for r in recs if r["name"] == "repro_slo_ok"}
    if burns:
        out.append("  slo burn rates (1.0 = budget consumed at the "
                   "sustainable rate):")
        pad = max(len(k) for k in burns)
        top = max([v or 0.0 for v in burns.values()] + [1.0])
        for slo in sorted(burns):
            burn = burns[slo] or 0.0
            ok = oks.get(slo, 1.0)
            bar = "#" * max(1, int(round(width * burn / top)))
            out.append(f"    {slo:<{pad}}  burn={burn:7.3f}  "
                       f"{'ok  ' if ok else 'VIOL'}  {bar}")
    attrib = [r for r in recs if r["name"] == "repro_quality_attrib"]
    if attrib:
        out.append("  quality attribution (layer-weighted output MSE, "
                   "largest = full bar):")
        layers = {}
        for r in attrib:
            labels = r.get("labels") or {}
            layers.setdefault(labels.get("layer", "?"), []).append(
                (labels.get("matrix", "?"), r.get("value") or 0.0))
        totals = {layer: sum(v for _, v in rows)
                  for layer, rows in layers.items()}
        top = max(totals.values(), default=0.0) or 1.0
        for layer in sorted(layers, key=lambda s: (len(s), s)):
            rows = sorted(layers[layer], key=lambda mv: -mv[1])
            bar = "#" * max(1, int(round(width * totals[layer] / top)))
            worst = rows[0][0] if rows else "?"
            out.append(f"    L{layer:>3}  total={totals[layer]:.3e}  "
                       f"worst={worst}  {bar}")
    return out


def metrics_summary(lines, width: int = 30) -> str:
    """Render an obs JSONL metric log (DESIGN.md §11): counters and gauges
    as a value table, histograms with count/quantiles and a param-free
    #-bar over p50 (largest p50 = full width).  Quality series (DESIGN.md
    §14: ``serve/quality``, ``obs/slo``) additionally render the drift,
    SLO-burn and attribution tables (:func:`_quality_sections`)."""
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
    out.extend(_quality_sections(recs, width=width))
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--plan", default=None,
                       help="summarize a QuantPlan artifact instead of the "
                            "dry-run roofline tables")
    group.add_argument("--metrics", default=None,
                       help="summarize a repro_torch.obs JSONL metric log "
                            "(counters + histogram quantiles)")
    args = ap.parse_args(argv)
    if args.plan:
        with open(args.plan) as f:
            print(plan_summary(json.load(f)))
        return
    if args.metrics:
        with open(args.metrics) as f:
            print(metrics_summary(f))
        return
    print(table(load_all(args.dir), args.mesh))


if __name__ == "__main__":
    main()
