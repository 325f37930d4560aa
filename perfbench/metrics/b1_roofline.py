"""b1_roofline (%): the B1 launches' least time over their device time,
in the traced steps.

Device time per launch: the mean duration of the traced records of the
packed dequant kernels (decode and tensor-core kernels).  Bound per
launch: the mean of peaks.b1_bound_s over the cell's per-step launch
shapes; every step launches each of them once, so the mean holds for
whole steps.  The profiler drops some records of kernels launched as
thread-block clusters, so the mean stands for the dropped ones too: the
note ``b1_records_per_launch`` sets the records against the launches the
port counted in the same steps (kernels.dequant.LAUNCHES[4])."""
from perfbench import peaks


def is_b1(name: str) -> bool:
    return "dequant_packed" in name or "PackedCodes" in name


def read(run):
    ops = getattr(run, "ops", None)
    if not ops:
        return None
    times = [b - a for name, a, b in ops if is_b1(name)]
    if not times:
        return None
    launches = getattr(run, "trace_b1_launches", 0)
    if launches:
        run.notes["b1_records_per_launch"] = len(times) / launches
    shapes = run.b1_step_shapes
    bound_s = sum(peaks.b1_bound_s(*s) for s in shapes) / len(shapes)
    return 100.0 * bound_s / (sum(times) / len(times) / 1e9)
