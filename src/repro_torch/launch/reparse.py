"""Recompute the roofline fields of dry-run JSONs from their saved op logs
(port of ``repro/launch/reparse.py``).

The ``<tag>.ops.zz`` files (the step cost counter's op log,
``launch.hlo_cost``) let the roofline model be revised without tracing
the cells again:

    PYTHONPATH=src python -m repro_torch.launch.reparse \\
        --dir experiments/dryrun_torch

The FLOPs, bytes and collective bytes are recomputed from the log by
``hlo_cost.costs_from_log``, the function the live count used, so an
unchanged model restores every field bit for bit.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import zlib

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import OUT_DIR, report_of, roofline_fields
from repro_torch.launch.hlo_cost import costs_from_log

__all__ = ["reparse_file", "main"]


def reparse_file(jpath: str) -> bool:
    zpath = jpath[:-len(".json")] + ".ops.zz"
    if not os.path.exists(zpath):
        return False
    with open(jpath) as f:
        d = json.load(f)
    if d.get("status") != "ok":
        return False
    with open(zpath, "rb") as f:
        saved = json.loads(zlib.decompress(f.read()).decode())
    costs = costs_from_log(saved["oplog"], saved["trip_counts"])
    cfg = get_config(d["arch"])
    shape = SHAPES[d["shape"]]
    kind = d.get("kind", shape.kind)
    rep = report_of(cfg, shape, d["mesh"], d["chips"], kind, costs,
                    d.get("memory_analysis", {}))
    d.update(roofline_fields(rep))
    with open(jpath, "w") as f:
        json.dump(d, f, indent=1, default=float)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    n = 0
    for jpath in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        if reparse_file(jpath):
            n += 1
    print(f"reparsed {n} cells")


if __name__ == "__main__":
    main()
