"""Port of the rescaler fine-tune (``train/distill.py``,
``finetune_rescalers``) held against the JAX package on the 2-layer model
of ``tests/test_quant_pipeline.py``.

The port quantizes (WaterSIC, 1.5 bits) the reference's ``init_params``
weights, each stacked weight rescaled to std 1/sqrt(in_features) as in
``tests/test_torch_quant_pipeline.py``; its quantized tree and records
cross to the reference as numpy (the reference's own PTQ of the same
model takes 20 s on one CPU thread, the port's under one), and both
packages fine-tune the same records on the same batches.  Tolerances: the
KL of each of 5 f32 steps within 1e-5 relative, and the trained t and γ
within 1e-5 (rtol = atol, relative to each vector's largest value): f32
forwards in another order, carried through five AdamW steps.  ``_dequant_with`` (dead columns
placed) and its grads against the reference's at 1e-6.  Then the port's
``test_ft_improves_or_holds`` on a model the port trained itself.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_parity import assert_close, rescale_fan_in, to_numpy
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.data import DataConfig, global_batch_for_step
from repro_torch.models import from_jax_params, from_jax_quantized_linear
from repro_torch.quant.pipeline import PTQConfig, model_ppl, quantize_model
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.train.distill import _dequant_with, finetune_rescalers

CFG = dict(name="q", family="dense", n_layers=2, d_model=48, n_heads=3,
           n_kv=3, d_ff=96, vocab=96, head_dim=16)
TCFG = TArchConfig(**CFG)
DCFG = DataConfig(vocab=96, seq_len=40, global_batch=8)
TOL = 1e-5


def _jcfg():
    from repro.configs.base import ArchConfig
    return ArchConfig(**CFG)


@functools.lru_cache(maxsize=None)
def _ptq():
    """(float params numpy, quantized tree numpy, the records as the
    reference's ``QuantizedLinear`` with numpy fields, calibration
    batches): the port's WaterSIC PTQ at 1.5 bits."""
    import jax
    from repro.core import QuantizedLinear as JQuantizedLinear
    from repro.models import init_params, split_tree
    base = to_numpy(split_tree(init_params(_jcfg(),
                                           jax.random.PRNGKey(0)))[0])
    base = {**base, "layers": rescale_fan_in(base["layers"])}
    calib = [global_batch_for_step(DCFG, 900 + i)["tokens"]
             for i in range(2)]
    qp, qlin, _, _ = quantize_model(
        TCFG, from_jax_params(base, "cpu"), calib,
        PTQConfig(target_bits=1.5, method="watersic"))
    records = {k: JQuantizedLinear(
        codes=to_numpy(q.codes), alphas=to_numpy(q.alphas),
        gamma=to_numpy(q.gamma), t=to_numpy(q.t),
        dead_mask=q.dead_mask.copy(), c=q.c, entropy_bits=q.entropy_bits,
        rate_eff=q.rate_eff, out_features=q.out_features,
        in_features=q.in_features) for k, q in qlin.items()}
    return base, to_numpy(qp), records, calib


def test_finetune_matches_reference():
    """Five f32 ``finetune_rescalers`` steps on the same records and
    batches: each step's KL, and every trained t and γ."""
    from repro.train.distill import finetune_rescalers as jfinetune
    import jax
    import jax.numpy as jnp
    base, qp, qlin, calib = _ptq()
    _, want_tr, want_l = jfinetune(
        _jcfg(), jax.tree.map(jnp.asarray, base),
        jax.tree.map(jnp.asarray, qp), qlin, calib, steps=5, lr=2e-4,
        log_every=0)
    tqlin = {k: from_jax_quantized_linear(q, "cpu") for k, q in qlin.items()}
    before = {k: (q.t.clone(), q.gamma.clone()) for k, q in tqlin.items()}
    _, got_tr, got_l = finetune_rescalers(
        TCFG, from_jax_params(base, "cpu"), from_jax_params(qp, "cpu"),
        tqlin, calib, steps=5, lr=2e-4, log_every=0)
    np.testing.assert_allclose(got_l, want_l, rtol=TOL, atol=TOL)
    assert sorted(got_tr) == sorted(want_tr) == sorted(qlin)
    for k in qlin:
        for n in ("t", "g"):
            w = np.asarray(want_tr[k][n])
            assert_close(to_numpy(got_tr[k][n]) / np.abs(w).max(),
                         w / np.abs(w).max(), tol=TOL)
        # the records stay as they were: t and γ train in copies
        assert torch.equal(tqlin[k].t, before[k][0])
        assert torch.equal(tqlin[k].gamma, before[k][1])


def test_dequant_with_dead_columns_matches_reference():
    """Ŵ(t, γ) with dead input columns placed at their indices, and its
    grads in t and γ, against the reference's ``_dequant_with``."""
    import jax
    import jax.numpy as jnp
    from repro.train.distill import _dequant_with as jdequant
    rng = np.random.default_rng(5)
    a, n_in = 6, 10
    live = np.array([0, 2, 3, 6, 7, 9])
    codes = rng.integers(-4, 5, (a, live.size)).astype(np.int32)
    alphas = rng.uniform(0.5, 1.5, live.size).astype(np.float32)
    t = rng.uniform(0.5, 1.5, a).astype(np.float32)
    g = rng.uniform(0.5, 1.5, live.size).astype(np.float32)
    up = rng.standard_normal((n_in, a)).astype(np.float32)
    for idx in (live, None):
        c = codes if idx is not None else rng.integers(
            -4, 5, (a, n_in)).astype(np.int32)
        al = alphas if idx is not None else np.ones(n_in, np.float32)
        gg = g if idx is not None else np.ones(n_in, np.float32)
        jfrozen = (jnp.asarray(c), jnp.asarray(al),
                   None if idx is None else jnp.asarray(idx), n_in)
        tfrozen = (torch.as_tensor(c), torch.as_tensor(al),
                   None if idx is None else torch.as_tensor(idx), n_in)

        def jf(tt, ggg):
            return jnp.sum(jdequant(jfrozen, tt, ggg) * up)
        want = np.asarray(jdequant(jfrozen, jnp.asarray(t), jnp.asarray(gg)))
        want_g = jax.grad(jf, argnums=(0, 1))(jnp.asarray(t),
                                             jnp.asarray(gg))
        tt = torch.as_tensor(t).requires_grad_()
        tg = torch.as_tensor(gg).requires_grad_()
        got = _dequant_with(tfrozen, tt, tg)
        assert got.shape == (n_in, a)
        assert_close(got, want, tol=1e-6)
        got_g = torch.autograd.grad((got * torch.as_tensor(up)).sum(),
                                    (tt, tg))
        for x, y in zip(got_g, want_g):
            assert_close(x, np.asarray(y), tol=1e-6)


def test_ft_improves_or_holds():
    """The port's ``tests/test_quant_pipeline.py::test_ft_improves_or_holds``
    on a model the port trained (120 bf16 steps, the reference fixture's
    schedule): KL trends down and ppl does not regress by more than 10 %."""
    import jax
    from repro.models import init_params, split_tree
    base = to_numpy(split_tree(init_params(_jcfg(),
                                           jax.random.PRNGKey(0)))[0])
    state = init_train_state(from_jax_params(base, "cpu"))
    step = make_train_step(TCFG, AdamWConfig(lr=2e-3, total_steps=120,
                                             warmup_steps=10))
    for s in range(120):
        state, _ = step(state, {k: torch.as_tensor(v) for k, v in
                                global_batch_for_step(DCFG, s).items()})
    params = state.params
    calib = [global_batch_for_step(DCFG, 900 + i)["tokens"]
             for i in range(2)]
    evalb = [np.concatenate(
        [global_batch_for_step(DCFG, 1800)["tokens"],
         global_batch_for_step(DCFG, 1800)["targets"][:, -1:]], axis=1)]
    qp, qlin, _, _ = quantize_model(
        TCFG, params, calib, PTQConfig(target_bits=1.5, method="watersic"))
    ppl_q = model_ppl(TCFG, qp, evalb)
    qp_ft, _, losses = finetune_rescalers(TCFG, params, qp, qlin, calib,
                                          steps=40, lr=2e-4, log_every=0)
    ppl_ft = model_ppl(TCFG, qp_ft, evalb)
    assert np.mean(losses[-5:]) <= np.mean(losses[:5]) * 1.05
    assert ppl_ft <= ppl_q * 1.10
    assert not any(t.requires_grad for t in
                   (qp_ft["layers"]["attn"]["wq"]["w"],))


@pytest.mark.parametrize("steps", [3])
def test_finetune_leaves_the_quantized_tree_untouched(steps):
    """``finetune_rescalers`` returns a new tree: the input quantized
    tree's stacked weights keep their values."""
    base, qp, qlin, calib = _ptq()
    tqp = from_jax_params(qp, "cpu")
    snapshot = {k: v["w"].clone() for k, v in tqp["layers"]["attn"].items()}
    out, _, _ = finetune_rescalers(
        TCFG, from_jax_params(base, "cpu"), tqp,
        {k: from_jax_quantized_linear(q, "cpu") for k, q in qlin.items()},
        calib, steps=steps, log_every=0)
    for k, w in snapshot.items():
        assert torch.equal(tqp["layers"]["attn"][k]["w"], w)
    assert not torch.equal(out["layers"]["attn"]["wq"]["w"],
                           snapshot["wq"])
