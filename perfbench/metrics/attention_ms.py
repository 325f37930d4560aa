"""attention_ms (ms): device time per step of the operations launched
inside the program's ``decode.attention`` spans (models/layers
.attention_decode between the q/k/v projections and wo: rope, the K/V row
write, scores, mask, softmax, the product with V), over segment B of
``perfbench/progtrace.py`` (obs on, profiler on, after the traced
window)."""
from perfbench import progtrace


def read(run):
    return progtrace.result(run).get("attention_ms")
