"""Read the correctness check of a cell for the program and for its
control, seed by seed, in one process.

    python3 perfbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed the cell's set-up and window run as in a benchmark run; then
the program's answers are judged against the plain reference (the
numbers a run prints under ``checks``), and the control, the reference one
precision below the configuration's (TF32 for float32) put in the
program's place, is judged the same way.  One JSON line per seed:
``{"seed", "program": {name: value}, "control": {name: value}}``.  The
limits in ``limits/<cell>.json`` are set between the two readings.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def read(workload: str, seed: int, seconds: float, **kw):
    """(program's numbers, control's numbers) of one seed; ``kw`` as
    ``harness.measured`` takes it."""
    from perfbench import harness
    run, entry, reference, limits = harness.measured(
        workload, seed, seconds, False, root=ROOT, **kw)
    program = entry.check(run, reference, limits)
    low = entry.control(run, reference, limits)
    return ({k: v["value"] for k, v in program.items()},
            {k: v["value"] for k, v in low.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        program, low = read(args.workload, seed, args.seconds,
                            device=torch.device("cuda", 0))
        print(json.dumps({"seed": seed, "program": program, "control": low}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
