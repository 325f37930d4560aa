"""A run with the timed path broken underneath comes out not correct:
for each fault the cells can have, planted in the port at a small size
on the CPU (the harness's look for a card skipped)."""
import numpy as np
import torch

from .small import PTQ, SERVE, run


def test_sound_runs_are_correct():
    assert run(SERVE)["correct"] and run(PTQ)["correct"]


def test_serve_token_altered_where_produced(monkeypatch):
    from repro_torch.serve import engine
    greedy = engine._greedy

    def altered(logits):
        out = greedy(logits)
        out[0] = (out[0] + 1) % logits.shape[-1]
        return out
    monkeypatch.setattr(engine, "_greedy", altered)
    out = run(SERVE)
    assert not out["correct"]
    assert out["checks"]["max_logit_gap"]["value"] > 1e-2


def test_serve_step_returns_its_state_unchanged(monkeypatch):
    from repro_torch.serve.engine import ContinuousEngine
    dispatch = ContinuousEngine._decode_dispatch

    def unchanged(self):
        kv = [t.clone() for t in (self.cache.kv.k, self.cache.kv.v)]
        logits, cache = dispatch(self)
        cache.kv.k.copy_(kv[0])
        cache.kv.v.copy_(kv[1])
        return logits, cache
    monkeypatch.setattr(ContinuousEngine, "_decode_dispatch", unchanged)
    out = run(SERVE)
    assert not out["correct"]


def test_ptq_answer_altered_where_produced(monkeypatch):
    from repro_torch.core import watersic
    quantize = watersic.quantize_at_rate

    def altered(*a, **kw):
        q = quantize(*a, **kw)
        q.codes[0, 0] += 1
        return q
    monkeypatch.setattr(watersic, "quantize_at_rate", altered)
    out = run(PTQ)
    assert not out["correct"]
    assert out["checks"]["rounding_excess"]["value"] >= 0.49


def test_ptq_cancellation_returns_its_state_unchanged(monkeypatch):
    from repro_torch.core import watersic
    from repro_torch.core.zsic import ZSICResult

    def no_cancel(y, l, alphas, *, lmmse=True):
        step = torch.as_tensor(alphas, dtype=y.dtype) * torch.diagonal(l)
        codes = torch.round(y / step[None, :]).to(torch.int32)
        return ZSICResult(codes=codes, gammas=torch.ones_like(step),
                          residual=y)
    monkeypatch.setattr(watersic, "zsic_lmmse", no_cancel)
    out = run(PTQ)
    assert not out["correct"]
    assert np.isfinite(out["checks"]["rounding_excess"]["value"])
