"""decode_step_ms (ms): the engine's decode_s / decode_calls over the window:
one models.transformer.decode_step with the argmax's copy to the host."""


def read(run):
    if not run.decode_calls:
        return None
    return 1e3 * run.decode_s / run.decode_calls
