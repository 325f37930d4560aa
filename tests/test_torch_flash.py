"""Port of flash attention (``kernels/flash``) and the full-sequence forward
(``models.layers.attention_train``, ``transformer.forward_train`` and
``loss_fn``) held against the JAX package.

The reference's Pallas kernel runs in interpret mode, as its own tests run
it.  Tolerances: twin vs the reference kernel or ``attention_ref`` 5e-5
absolute (the reference tests' own bound: f32 sums in another order);
attention, logits and loss 1e-5 (rtol = atol, attention outputs divided
by their largest magnitude first: the reference's stacked init gives them
magnitudes near 50) against the JAX model on the reference's
``init_params`` weights.  Kernel-vs-twin cases need the
card (``cuda`` marker): |Δ| ≤ 2e-5 + 2e-5·|twin|.
"""
import numpy as np
import pytest
import torch

from _torch_parity import (assert_close, graph_kernel_nodes, require_cuda,
                           to_numpy)
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.kernels.flash import (attention_ref, flash_attention,
                                       flash_attention_cuda)
from repro_torch.models import forward_train, from_jax_params, loss_fn
from repro_torch.models.layers import attention_train

TOL = 1e-5
KERNEL_TOL = 2e-5
#: head_dim 64 and n_q == n_kv: the flash path; the second is GQA (plain
#: path); the third has a local window (flash path with a window)
MODELS = {
    "mha64": dict(name="mha64", family="dense", n_layers=2, d_model=96,
                  n_heads=2, n_kv=2, d_ff=160, vocab=96, head_dim=64),
    "gqa": dict(name="gqa", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv=2, d_ff=128, vocab=80, head_dim=16),
    "win64": dict(name="win64", family="dense", n_layers=2, d_model=64,
                  n_heads=2, n_kv=2, d_ff=96, vocab=64, head_dim=64,
                  local_window=5),
}


def _qkv(b, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _jax_flash(q, k, v, **kw):
    import jax.numpy as jnp
    from repro.kernels.flash import flash_attention as jflash
    return np.asarray(jflash(*map(jnp.asarray, (q, k, v)), interpret=True,
                             **kw))


def _fold_ref(q, k, v, **kw):
    """The reference's materialized oracle on (B, S, H, d)."""
    import jax.numpy as jnp
    from repro.kernels.flash import attention_ref as jref
    b, s, h, d = q.shape
    fold = [jnp.moveaxis(jnp.asarray(x), 2, 1).reshape(b * h, s, d)
            for x in (q, k, v)]
    out = np.asarray(jref(*fold, **kw))
    return np.moveaxis(out.reshape(b, h, s, d), 1, 2)


@pytest.mark.parametrize("s,window", [(128, 0), (256, 0), (256, 64),
                                      (128, 32)])
def test_twin_matches_reference_kernel(s, window):
    q, k, v = _qkv(2, s, 2, 64, seed=s + window)
    want = _jax_flash(q, k, v, causal=True, window=window)
    got = flash_attention(*map(torch.as_tensor, (q, k, v)), causal=True,
                          window=window)
    assert got.shape == (2, s, 2, 64)
    assert np.abs(to_numpy(got) - want).max() < 5e-5


def test_ragged_causal_matches_reference_kernel():
    q, k, v = _qkv(1, 200, 2, 64, seed=3)
    want = _jax_flash(q, k, v, causal=True)
    got = flash_attention(*map(torch.as_tensor, (q, k, v)), causal=True)
    assert np.abs(to_numpy(got) - want).max() < 5e-5


def test_ragged_non_causal_matches_attention_ref():
    q, k, v = _qkv(1, 130, 2, 64, seed=0)
    want = _fold_ref(q, k, v, causal=False)
    got = flash_attention(*map(torch.as_tensor, (q, k, v)), causal=False)
    assert np.abs(to_numpy(got) - want).max() < 5e-5


def test_reference_flash_attends_padded_keys_when_not_causal():
    """Records a fault of the reference (ROADMAP queue C): its wrapper pads
    a ragged S with zero keys, which a non-causal mask lets through."""
    q, k, v = _qkv(1, 130, 2, 64, seed=0)
    flash = _jax_flash(q, k, v, causal=False)
    oracle = _fold_ref(q, k, v, causal=False)
    gap = float(np.abs(flash - oracle).max())
    assert gap > 0.2, (
        f"the reference's non-causal ragged flash now agrees with "
        f"attention_ref (max |Δ| {gap:.3e}); flash[0, :2, 0, :4] = "
        f"{flash[0, :2, 0, :4]}, attention_ref = {oracle[0, :2, 0, :4]}")
    causal = np.abs(_jax_flash(q, k, v, causal=True)
                    - _fold_ref(q, k, v, causal=True)).max()
    assert causal < 5e-5


def test_twin_is_attention_ref_on_folded_heads():
    q, k, v = _qkv(2, 40, 3, 16, seed=5)
    got = flash_attention(*map(torch.as_tensor, (q, k, v)), causal=True,
                          window=7)
    fold = [torch.as_tensor(x).transpose(1, 2).reshape(6, 40, 16)
            for x in (q, k, v)]
    want = attention_ref(*fold, causal=True, window=7)
    assert torch.equal(got, want.reshape(2, 3, 40, 16).transpose(1, 2))


def _cfgs(name):
    from repro.configs.base import ArchConfig
    return ArchConfig(**MODELS[name]), TArchConfig(**MODELS[name])


_PARAMS = {}


def _params(name):
    """(reference numpy params, the port's tree on the CPU)."""
    if name not in _PARAMS:
        import jax
        from repro.models import init_params, split_tree
        jcfg, _ = _cfgs(name)
        base = to_numpy(split_tree(init_params(jcfg,
                                               jax.random.PRNGKey(1)))[0])
        _PARAMS[name] = (base, from_jax_params(base, "cpu"))
    return _PARAMS[name]


def _tokens(cfg, b=2, s=24, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s + 1))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_attention_train_matches_reference(name):
    import jax
    import jax.numpy as jnp
    from repro.models.layers import attention_train as jattn
    jcfg, tcfg = _cfgs(name)
    base, tp = _params(name)
    x = np.random.default_rng(2).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    kw = dict(n_q=jcfg.n_heads, n_kv=jcfg.n_kv,
              head_dim=jcfg.resolved_head_dim, rope_theta=jcfg.rope_theta,
              causal=True, window=jcfg.local_window or None)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), base["layers"]["attn"])
    want = jattn(jp, jnp.asarray(x), **kw)
    tpl = {k: {kk: vv[0] for kk, vv in v.items()}
           for k, v in tp["layers"]["attn"].items()}
    got = attention_train(tpl, torch.as_tensor(x), **kw)
    scale = float(np.abs(np.asarray(want)).max())
    assert_close(to_numpy(got) / scale, np.asarray(want) / scale, tol=TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_train_and_loss_match_reference(name):
    import jax.numpy as jnp
    from repro.models import forward_train as jforward
    from repro.models import loss_fn as jloss
    jcfg, tcfg = _cfgs(name)
    base, tp = _params(name)
    toks = _tokens(jcfg)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "targets": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "targets": torch.as_tensor(toks[:, 1:])}
    assert_close(forward_train(tcfg, tp, tb), jforward(jcfg, base, jb),
                 tol=TOL)
    got, want = float(loss_fn(tcfg, tp, tb)), float(jloss(jcfg, base, jb))
    assert abs(got - want) <= TOL * (1 + abs(want))


def test_attention_train_routes_by_device(monkeypatch):
    """A CPU tensor under the flash conditions goes to the twin through
    ``kernels.flash.flash_attention``; other shapes never call it."""
    from repro_torch.kernels import flash
    calls = []
    real = flash.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(flash, "flash_attention", spy)
    for name in ("mha64", "gqa"):
        _, tcfg = _cfgs(name)
        _, tp = _params(name)
        toks = torch.as_tensor(_tokens(tcfg, s=9))
        forward_train(tcfg, tp, {"tokens": toks[:, :-1]})
    assert calls == [(2, 9, 2, 64)] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s,causal,window", [
    (128, True, 0), (256, True, 0), (200, True, 0), (256, True, 64),
    (200, True, 64), (130, False, 0), (77, False, 16), (1, True, 0),
    (1, False, 0), (40, True, 0), (40, False, 64), (256, False, 0),
    (200, False, 64)])
def test_kernel_matches_twin(d, s, causal, window):
    dev = require_cuda()
    q, k, v = [torch.as_tensor(x, device=dev)
               for x in _qkv(2, s, 3, d, seed=s + d)]
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=causal,
                           window=window).to(dev)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    bad = (got - want).abs() > KERNEL_TOL + KERNEL_TOL * want.abs()
    assert not bad.any(), float((got - want).abs().max())


@pytest.mark.cuda
def test_kernel_counts_launches_and_rejects_bad_operands():
    from repro_torch.kernels.flash import reset_launches
    dev = require_cuda()
    q, k, v = [torch.as_tensor(x, device=dev) for x in _qkv(1, 64, 2, 64)]
    reset_launches()
    flash_attention(q, k, v)
    assert flash_attention_cuda.launches == 1
    with pytest.raises(TypeError):
        flash_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        flash_attention_cuda(q[..., :48].contiguous(),
                             k[..., :48].contiguous(),
                             v[..., :48].contiguous())
    assert flash_attention_cuda.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 256])
def test_kernel_is_one_device_kernel_per_call(d):
    """One call is one kernel node in a CUDA graph of the call, and one
    count."""
    dev = require_cuda()
    q, k, v = [torch.as_tensor(x, device=dev) for x in _qkv(2, 200, 3, d)]
    before = flash_attention_cuda.launches
    assert graph_kernel_nodes(lambda: flash_attention_cuda(
        q, k, v, causal=False, window=64)) == [0]
    assert flash_attention_cuda.launches == before + 2


# ---------------------------------------------------------------------------
# gradients: the autograd wrapper (forward = kernel or twin, backward =
# the twin's gradient recomputed)
# ---------------------------------------------------------------------------


def _grad_cfgs():
    """2-layer minicpm-2b with reduced widths and head_dim 64, so every
    layer's attention takes the flash path in the port."""
    import dataclasses

    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    kw = dict(n_layers=2, d_model=128, n_heads=2, n_kv=2, head_dim=64,
              d_ff=192, vocab=160)
    return (dataclasses.replace(jget("minicpm-2b"), **kw),
            dataclasses.replace(tget("minicpm-2b"), **kw))


def test_loss_grads_match_reference_default_path():
    """vs ``jax.grad`` of ``repro.models.loss_fn`` on its default
    (materialized-softmax) path: the grads of wq/wk/wv and of the
    embedding, 1e-5 relative (normalized by the largest reference grad)."""
    import jax
    import jax.numpy as jnp
    from repro.models import init_params, split_tree
    from repro.models import loss_fn as jloss
    jcfg, tcfg = _grad_cfgs()
    base = to_numpy(split_tree(init_params(jcfg, jax.random.PRNGKey(3)))[0])
    toks = _tokens(jcfg, b=2, s=20, seed=4)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "targets": jnp.asarray(toks[:, 1:])}
    want = jax.grad(lambda p: jloss(jcfg, p, jb))(
        jax.tree.map(jnp.asarray, base))
    tp = from_jax_params(base, "cpu")
    leaves = {"wq": tp["layers"]["attn"]["wq"]["w"],
              "wk": tp["layers"]["attn"]["wk"]["w"],
              "wv": tp["layers"]["attn"]["wv"]["w"],
              "embed": tp["embed"]["w"]}
    for t in leaves.values():
        t.requires_grad_(True)
    loss = loss_fn(tcfg, tp, {"tokens": torch.as_tensor(toks[:, :-1]),
                              "targets": torch.as_tensor(toks[:, 1:])})
    loss.backward()
    for name, t in leaves.items():
        g = (np.asarray(want["embed"]["w"]) if name == "embed"
             else np.asarray(want["layers"]["attn"][name]["w"]))
        assert t.grad is not None, name
        scale = float(np.abs(g).max())
        assert scale > 0, name
        assert_close(to_numpy(t.grad) / scale, g / scale, tol=TOL)


def test_flash_backward_recomputes_through_the_twin():
    """``flash_attention`` is one autograd node whose forward runs without
    a graph (as the kernel does) and whose backward gives the twin's
    gradients: q, k, v grads equal those of ``attention_ref`` on the
    folded heads."""
    rng = np.random.default_rng(9)
    q, k, v = [torch.as_tensor(x, dtype=torch.float64).requires_grad_()
               for x in _qkv(2, 33, 3, 64, seed=9)]
    g = torch.as_tensor(rng.standard_normal((2, 33, 3, 64)))
    out = flash_attention(q, k, v, causal=True, window=7)
    assert "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (q, k, v), g)
    fold = [x.transpose(1, 2).reshape(6, 33, 64) for x in (q, k, v)]
    ref = attention_ref(*fold, causal=True, window=7)
    want = torch.autograd.grad(ref.reshape(2, 3, 33, 64).transpose(1, 2),
                               (q, k, v), g)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_kernel_grads_match_twin(d):
    """q/k/v grads through the wrapper on the card (forward: the kernel)
    against the twin's autograd on the same inputs."""
    dev = require_cuda()
    q, k, v = [torch.as_tensor(x, device=dev).requires_grad_()
               for x in _qkv(2, 130, 3, d, seed=d)]
    g = torch.randn((2, 130, 3, d), device=dev)
    before = flash_attention_cuda.launches
    out = flash_attention(q, k, v, causal=True)
    assert flash_attention_cuda.launches == before + 1
    got = torch.autograd.grad(out, (q, k, v), g)
    fold = [x.transpose(1, 2).reshape(6, 130, d) for x in (q, k, v)]
    ref = attention_ref(*fold, causal=True).reshape(2, 3, 130, d)
    want = torch.autograd.grad(ref.transpose(1, 2), (q, k, v), g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
