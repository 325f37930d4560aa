"""engine_ms (ms): the scheduler's host time per step outside the decode
dispatch: (sum of the engine's StepStats.step_s - the growth of its
decode_s) over the window's steps."""


def read(run):
    if not run.steps:
        return None
    return 1e3 * (run.engine_step_s - run.decode_s) / run.steps
