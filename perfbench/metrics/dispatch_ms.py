"""dispatch_ms (ms): the mean of the program's ``serve.dispatch`` span
(serve/engine.ContinuousEngine.step: the decode dispatch from its entry to
its return, the host enqueuing the step) over the complete steps of
segment A of ``perfbench/progtrace.py`` (obs on, no profiler)."""
from perfbench import progtrace


def read(run):
    return progtrace.result(run).get("dispatch_ms")
