"""The plain references agree with the port's CPU twins at small sizes:
the served tokens are the dense reference's best, and WaterSIC's answers
pass the float64 step-by-step judge (and equal the float64 reference's
codes where no rounding decision is close)."""
import pytest
import torch

from perfbench import harness, inputs

from .small import PTQ, SERVE, manifest, run, serve_arch


def test_served_tokens_are_the_references_best():
    out = run(SERVE)
    assert out["correct"], out["checks"]
    assert out["checks"]["max_logit_gap"]["value"] == 0.0
    assert out["attempted"] >= 4 and out["metrics"]["tok_s"]["value"] > 0


def test_watersic_answers_pass_the_float64_judge():
    out = run(PTQ)
    assert out["correct"], out["checks"]
    c = out["checks"]
    assert c["rounding_excess"]["value"] < 1e-4
    assert c["rescaler_excess"]["value"] < 1e-5
    assert out["attempted"] >= 3


def test_float64_reference_matches_the_port_codes():
    from repro_torch.core.watersic import CalibStats, quantize_at_rate
    ref = harness.load_module(harness.BENCH / "reference" / "watersic_f64.py",
                              "perfbench_test_watersic")
    cpu = torch.device("cpu")
    sigma = inputs.ptq_sigma(3, 0, "attn_in", 64, cpu, tokens=512, decay=1.0,
                             scale_sigma=0.5, dead_share=0.02)
    w = inputs.ptq_weight(3, 0, 0, (96, 64), cpu)
    q = quantize_at_rate(w.double(), CalibStats(sigma_x=sigma.double()), 3.0,
                         damp=0.05, seed=3)
    r = ref.quantize_at_rate(w, sigma, 3.0, damp=0.05, seed=3)
    assert (q.dead_mask == r["dead_mask"]).all()
    assert torch.equal(q.codes.long(), r["codes"].long())
    assert q.rate_eff == pytest.approx(r["rate_eff"], abs=1e-12)
    assert q.c == pytest.approx(r["c"], rel=1e-9)


def test_dense_reference_layer_matches_the_port():
    ref = harness.load_module(harness.BENCH / "reference" / "dense_decoder.py",
                              "perfbench_test_dense")
    arch = serve_arch()
    cpu = torch.device("cpu")
    lp = inputs.dense_layer(arch, 4, 0, cpu)
    x = torch.randn((2, 5, arch.d_model), generator=torch.Generator()
                    .manual_seed(0))
    deq = {**lp, "attn": {k: {**v, "w": ref.absmax_int4(v["w"])}
                          for k, v in lp["attn"].items()},
           "mlp": {k: {**v, "w": ref.absmax_int4(v["w"])}
                   for k, v in lp["mlp"].items()}}
    from repro_torch.models.layers import attention_train, mlp, rmsnorm
    h = rmsnorm(deq["ln_attn"], x)
    port = x + attention_train(deq["attn"], h, n_q=arch.n_heads,
                               n_kv=arch.n_kv, head_dim=arch.resolved_head_dim,
                               rope_theta=arch.rope_theta)
    port = port + mlp(deq["mlp"], rmsnorm(deq["ln_mlp"], port))
    assert torch.allclose(ref.layer(arch, lp, x), port, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cell", [SERVE, PTQ])
def test_traced_run_reports_per_layer_metrics(cell):
    out = run(cell, trace=True)
    assert out["correct"]
    assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0
    assert len(out["breakdown"]["device_ops"]) <= 10
    assert set(out["metrics"]) <= {m["name"] for m in manifest()["per_layer"]}
    assert out["metrics"]
