"""Plan summary rendering (port of ``plan_summary`` and its helpers from
``repro/launch/summarize.py``): the realized bits/param against the target
and the per-layer allocation histogram of a ``QuantPlan`` JSON dict, as
``python -m repro_torch.launch.plan inspect`` prints it.  The rest of the
reference module (grid tables, metric logs) comes with the port of
``obs`` (ROADMAP queue A item 10).
"""
from __future__ import annotations

__all__ = ["plan_summary"]


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
