"""wait_ms (ms): the mean of the program's ``serve.sample`` span
(serve/engine._greedy: the argmax, its copy to the host and the host's
wait on the card) over the complete steps of segment A of
``perfbench/progtrace.py``; with ``dispatch_ms`` it makes up the step's
``serve.decode``."""
from perfbench import progtrace


def read(run):
    return progtrace.result(run).get("wait_ms")
