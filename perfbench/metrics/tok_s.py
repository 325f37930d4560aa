"""tok_s (tokens/s): every output token of the window over the window's
host-clock time."""


def read(run):
    return run.tokens / run.window_s if run.window_s > 0 else None
