"""ptq_params_s (params/s): the parameters of every matrix quantized in the
window over the time from the window's start to the end of the last one."""


def read(run):
    return run.params / run.window_s if run.window_s > 0 else None
