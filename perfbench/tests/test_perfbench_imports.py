"""What a run loads: in a fresh process, a whole run of each cell (at a
small size on the CPU) leaves no module whose top-level name is jax,
jaxlib, flax or repro in ``sys.modules``, and the plain references load
nothing of the port."""
import json
import subprocess
import sys

from perfbench import harness

ROOT = harness.ROOT

RUN = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
from perfbench.tests import small
small.run(small.SERVE, seconds=0.2)
small.run(small.PTQ, seconds=0.2)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""

REFS = """
import json, sys
sys.path[:0] = [{root!r}]
from perfbench import harness
for name in ("dense_decoder", "watersic_f64"):
    harness.load_module(harness.BENCH / "reference" / (name + ".py"), name)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _modules(code):
    out = subprocess.run(
        [sys.executable, "-c", code.format(root=str(ROOT),
                                           src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    found = _modules(RUN)
    assert "repro_torch" in found
    assert not found & {"jax", "jaxlib", "flax", "repro"}


def test_references_load_nothing_of_the_port():
    found = _modules(REFS)
    assert not found & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "reprox", sys)
    assert "reprox" not in harness.forbidden_modules()
