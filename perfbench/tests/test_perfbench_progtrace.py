"""The program's spans on the profiler's clock (``perfbench/progtrace.py``):
the attribution of device operations to the innermost span of their
launch, the idle gaps by span, and the four readers on a small traced
run."""
import math

import pytest

from perfbench import harness, progtrace

from . import small

#: serve.step ⊃ serve.dispatch ⊃ decode.attention, decode.unembed; then
#: serve.sample, as one decode step records them
SPANS = [("serve.step", 0, 100), ("serve.decode", 5, 95),
         ("serve.dispatch", 5, 60), ("decode.attention", 10, 20),
         ("decode.attention", 30, 40), ("decode.unembed", 50, 55),
         ("serve.sample", 60, 95)]
NEW = ("attention_ms", "unembed_ms", "dispatch_ms", "wait_ms")


def test_innermost_span_of_an_instant():
    at = progtrace.Lookup(SPANS)
    assert [at(t) for t in (0, 7, 12, 25, 35, 52, 58, 70, 97, 100, 150)] \
        == ["serve.step", "serve.dispatch", "decode.attention",
            "serve.dispatch", "decode.attention", "decode.unembed",
            "serve.dispatch", "serve.sample", "serve.step", None, None]
    # a span crossing its parent's end is cut there
    cut = progtrace.Lookup([("a", 0, 10), ("b", 5, 20), ("c", 30, 40)])
    assert [cut(t) for t in (3, 7, 15, 35)] == ["a", "b", None, "c"]


def test_attribution_to_the_innermost_launch_span():
    ops = [("attn_kernel", 14, 24, 12),           # launched in attention
           ("dequant_tc::tc_kernel<PackedCodes<4>, 128>", 26, 56, 25),
           ("ampere_sgemm", 56, 76, 51),          # in the unembedding
           ("argmax", 90, 95, 70),                # in the sample
           ("orphan", 180, 190, None)]            # no launch found
    calls = [("cudaLaunchKernel", 12), ("cudaStreamSynchronize", 62),
             ("cudaStreamSynchronize", 58), ("cudaStreamSynchronize", 12)]
    got = progtrace.attribute(ops, calls, SPANS, 0, 200, n_steps=1)
    assert got["attention_ms"] == pytest.approx(10e-6)
    assert got["unembed_ms"] == pytest.approx((20 + 5) * 1e-6)
    assert got["b1_ms"] == pytest.approx(30e-6)
    assert got["b1_in_attention_ms"] == 0
    assert got["device_ms_by_span"]["serve.dispatch"] == pytest.approx(30e-6)
    assert got["device_ms_by_span"]["None"] == pytest.approx(10e-6)
    assert got["attributed_share"] == pytest.approx(65 / 75)
    assert got["launch_matched_share"] == pytest.approx(4 / 5)
    # the parts make up the busy time
    parts = got["attention_ms"] + got["unembed_ms"] + got["b1_ms"] \
        + got["rest_ms"]
    assert parts == pytest.approx(got["busy_ms"]) == pytest.approx(75e-6)
    assert got["blocking_calls_in_dispatch_per_step"] \
        == {"cudaStreamSynchronize in serve.dispatch": 1,
            "cudaStreamSynchronize in decode.attention": 1}
    # idle gaps carry the span that held the host at their midpoint
    gaps = dict(got["idle_gaps"])
    assert gaps["serve.sample: ampere_sgemm -> argmax"] == pytest.approx(14e-9)
    assert gaps["serve.dispatch: window start -> attn_kernel"] \
        == pytest.approx(14e-9)
    assert gaps["outside spans: orphan -> window end"] == pytest.approx(1e-8)


@pytest.fixture(scope="module")
def traced():
    return small.run(small.SERVE, trace=True, seconds=0.5)


def test_readers_give_finite_values_on_a_small_run(traced):
    got = traced["metrics"]
    for name in NEW:
        assert math.isfinite(got[name]["value"]) and got[name]["value"] > 0
    a = traced["notes"]["progtrace_a"]
    assert a["dispatch_plus_wait_over_decode"] == pytest.approx(1, abs=0.01)
    b = traced["notes"]["progtrace_b"]
    assert b["attributed_share"] > 0.5
    assert traced["notes"]["obs_on_tokens_equal"] == 1.0
    assert traced["correct"]


def test_breakdown_still_names_the_benchmarks_span(traced):
    keys = [k for k, _ in traced["breakdown"]["idle_gaps"]]
    assert keys and any(k.startswith("engine.step: ") for k in keys)


def test_readers_are_silent_without_the_programs_spans(monkeypatch):
    """A program whose tracer lacks ``intervals`` (the parent of the spans)
    gives none of the four metrics, builds nothing and raises nothing."""
    monkeypatch.setattr(progtrace, "supported", lambda: False)
    built = []
    monkeypatch.setattr(progtrace, "_rebuilt", built.append)
    run = harness.Run(trace=True, notes={})
    bench = harness.BENCH / "metrics"
    for name in NEW:
        reader = harness.load_module(bench / f"{name}.py", f"t_{name}")
        assert reader.read(run) is None
    assert built == [] and run.notes == {}


def test_manifest_lists_the_four_metrics_in_the_cell():
    per_layer = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for name in NEW:
        assert per_layer[name]["workloads"] == [small.SERVE]
        assert per_layer[name]["moves"] == "tok_s"
