"""ptq_mfu (%): the least work WaterSIC needs for the window's matrices
(peaks.watersic_least_flops) per second of window, against the float32
peak outside the tensor cores."""
from perfbench import peaks


def read(run):
    if not run.matrices or run.window_s <= 0:
        return None
    flops = sum(peaks.watersic_least_flops(a, n) for (a, n), _ in run.matrices)
    return 100.0 * flops / run.window_s / peaks.FP32_FLOPS
