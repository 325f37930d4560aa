"""Dry-run grid driver: one subprocess per cell, resumable (port of
``repro/launch/grid.py``).

Each cell runs ``python -m repro_torch.launch.dryrun --arch .. --shape ..
--mesh ..`` in its own process, so one cell's failure or its memory
cannot take the grid down.  Existing result JSONs are skipped: rerun any
time to fill gaps.  The traces run on ``meta`` tensors: no card is
needed.

    PYTHONPATH=src python -m repro_torch.launch.grid --mesh both
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import SHAPES, list_archs
from repro_torch.launch.dryrun import OUT_DIR


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--archs", default=None, help="comma-separated subset")
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--wbits", type=int, default=16)
    ap.add_argument("--timeout", type=int, default=3000)
    args = ap.parse_args(argv)

    archs = args.archs.split(",") if args.archs else list_archs()
    shapes = args.shapes.split(",") if args.shapes else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    print(f"grid: {len(cells)} cells", flush=True)
    os.makedirs(args.out, exist_ok=True)
    for i, (a, s, m) in enumerate(cells):
        tag = f"{a}__{s}__{m}" + (f"__w{args.wbits}" if args.wbits != 16
                                  else "")
        out_path = os.path.join(args.out, tag + ".json")
        if os.path.exists(out_path):
            print(f"[{i+1}/{len(cells)}] {tag}: cached", flush=True)
            continue
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               a, "--shape", s, "--mesh", m, "--out", args.out,
               "--wbits", str(args.wbits)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            tail = (r.stdout or r.stderr or "").strip().splitlines()
            msg = tail[-1] if tail else f"rc={r.returncode}"
        except subprocess.TimeoutExpired:
            msg = "TIMEOUT"
            with open(out_path, "w") as f:
                json.dump({"arch": a, "shape": s, "mesh": m,
                           "status": "timeout",
                           "timeout_s": args.timeout}, f)
        print(f"[{i+1}/{len(cells)}] {msg}  ({time.perf_counter()-t0:.0f}s)",
              flush=True)


if __name__ == "__main__":
    main()
