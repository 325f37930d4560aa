"""Run one benchmark cell once on an NVIDIA card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, last on standard error, each number the correctness check
compared beside its limit, and last on standard output one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and ``checks``.  Exits
non-zero without a result when there is no card, when the port is not
in this checkout's ``src/``, or when a JAX module was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one host thread for torch's CPU operators: the load is one process
    # (the port keeps its kernel builds in the checkout, src/repro_torch/
    # kernels/build/)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from perfbench import harness

    man = harness.manifest(ROOT)
    cell = {w["name"]: w for w in man["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import repro_torch
    except ImportError as e:
        print(f"the port is not in this checkout: {e}", file=sys.stderr)
        return 4
    if not Path(repro_torch.__file__).resolve().is_relative_to(
            ROOT / "src"):
        print(f"repro_torch comes from {repro_torch.__file__}, not from "
              f"{ROOT / 'src'}", file=sys.stderr)
        return 4
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device=torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}", file=sys.stderr)
        return 5
    for name, value in out.pop("notes", {}).items():
        print(f"note {name}: {value}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
