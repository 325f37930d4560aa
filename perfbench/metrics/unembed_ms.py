"""unembed_ms (ms): device time per step of the operations launched
inside the program's ``decode.unembed`` (the final norm and the tied
unembedding) and ``serve.sample`` (the argmax and its copy to the host)
spans, over segment B of ``perfbench/progtrace.py``."""
from perfbench import progtrace


def read(run):
    return progtrace.result(run).get("unembed_ms")
