"""The port's RWKV6 blocks and the ssm family held against the JAX package.

Reduced rwkv6-7b (d 64, 2 layers, 4 heads of 16, decay LoRA 8) with the
reference's weights (``mu``, ``w0``, ``u`` and the norm scales perturbed
with numpy so they matter), converted with ``from_jax_params``; the block
functions run on layer 0 with numpy inputs; the engines serve
tests/test_continuous_batching.py's ``CFG_SSM``.

Tolerances: block outputs rtol = atol = 1e-5 of their largest entry
(the same f32 products summed in another order); model logits and states 1e-4, the states
relative to their largest entry (the WKV state reaches a few hundred);
with a bf16 cache 2e-2 (a shift state rounds to bf16 on either side of
an f32 tie now and then); parallel prefill against stepped at the
reference's rtol 1e-4 / atol 1e-5 (tests/test_parallel_prefill.py);
token streams and quantized trees exactly equal.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_parity import (assert_close, assert_trees_close, drive_engine,
                           graph_kernel_names, random_workload, require_cuda,
                           to_numpy)
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.models import (decode_chunk, decode_step, forward_train,
                                from_jax_params, init_cache, init_params,
                                loss_fn, prefill, rwkv6 as rk, split_layers)
from repro_torch.quant import quantize_params_tree
from repro_torch.serve import (ContinuousEngine, EngineConfig, Request,
                               ServeEngine)

ARCH = "rwkv6-7b"
TOL = 1e-4
BLOCK_TOL = 1e-5
BF16_TOL = 2e-2
CFG_SSM = dict(name="cbs", family="ssm", n_layers=2, d_model=32, n_heads=2,
               n_kv=2, d_ff=64, vocab=64, wkv_head_dim=16, decay_lora=8,
               subquadratic=True)
FORMATS = {"fp": None, "int8": dict(nbits=8),
           "int4": dict(nbits=4, packed=True)}


def _cfgs():
    from repro.configs import get_config
    return get_config(ARCH).reduced(), tget_config(ARCH).reduced()


@functools.lru_cache(maxsize=None)
def _tree(fmt="fp", engine_cfg=False):
    """The reference's value tree (numpy leaves): reduced rwkv6-7b with
    perturbed vectors, or ``CFG_SSM`` as the engines' test builds it."""
    import jax
    from repro.configs.base import ArchConfig
    from repro.models import init_params, split_tree

    if FORMATS[fmt] is not None:
        return _quantized(_tree("fp", engine_cfg), 8, fmt)
    jcfg = ArchConfig(**CFG_SSM) if engine_cfg else _cfgs()[0]
    base = to_numpy(split_tree(jax.jit(functools.partial(
        init_params, jcfg))(jax.random.PRNGKey(0)))[0])
    if not engine_cfg:
        rng = np.random.default_rng(3)
        lay = base["layers"]
        for node, key, std in ((lay["tm"], "mu", 0.3), (lay["cm"], "mu", 0.3),
                               (lay["tm"], "u", 0.3), (lay["tm"], "w0", 0.5)):
            node[key] = (node[key] + rng.standard_normal(node[key].shape)
                         * std).astype(np.float32)
        for node in (lay["ln_tm"], lay["ln_cm"], lay["tm"]["ln_out"]):
            node["scale"] = (1 + 0.1 * rng.standard_normal(
                node["scale"].shape)).astype(np.float32)
    return base


def _quantized(base, min_dim, fmt):
    """The served tree: the port's quantizer, whose bytes equal the
    reference's (tests/test_torch_models.py holds them), is much quicker
    on the CPU than the reference's eager one."""
    return to_numpy(quantize_params_tree(from_jax_params(base, "cpu"),
                                         min_dim=min_dim, **FORMATS[fmt]))


def _layer0(tree):
    """Layer 0 of a stacked numpy tree (its ``layers``)."""
    def cut(node):
        if isinstance(node, dict):
            return {k: cut(v) for k, v in node.items()}
        return node[0]
    return cut(tree["layers"])


def _jnp(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# -- block functions ----------------------------------------------------------


def test_shift_mix_and_decay_match_reference():
    """_token_shift, _mix and _decay (the LoRA decay through dense)."""
    from repro.models import rwkv6 as jrk
    lp = _layer0(_tree())["tm"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    tp, tx = from_jax_params(lp, "cpu"), torch.from_numpy(x)
    assert_close(rk._token_shift(tx), jrk._token_shift(x), tol=0)
    xp = rk._token_shift(tx)
    assert_close(rk._mix(tx, xp, tp["mu"][2]),
                 jrk._mix(x, np.asarray(jrk._token_shift(x)), lp["mu"][2]),
                 tol=BLOCK_TOL)
    assert_close(rk._decay(tp, tx), jrk._decay(_jnp(lp), x), tol=BLOCK_TOL)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("fn", ["time_mix_train", "time_mix_decode",
                                "channel_mix_train", "channel_mix_decode"])
def test_block_functions_match_reference(fn, fmt):
    """Each block function on layer 0 of the tree (fp, int8 codes, packed
    int4: the dequant-matmul twins) against the reference's on the same
    numpy inputs; the train forms also return the final WKV state."""
    import jax.numpy as jnp
    from repro.models import rwkv6 as jrk
    import jax
    jcfg, _ = _cfgs()
    hd = jcfg.wkv_head_dim
    lp = _layer0(_tree(fmt))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 6, 64)).astype(np.float32)
    x1 = x[:, :1]
    shift = rng.standard_normal((3, 64)).astype(np.float32)
    wkv = rng.standard_normal((3, 64 // hd, hd, hd)).astype(np.float32)
    part = "tm" if fn.startswith("time") else "cm"
    jp, tp = _jnp(lp[part]), from_jax_params(lp[part], "cpu")
    t = torch.from_numpy
    if fn == "time_mix_train":
        want = jax.jit(functools.partial(
            jrk.rwkv_time_mix_train, head_dim=hd, return_state=True))(
                jp, jnp.asarray(x))
        got = rk.rwkv_time_mix_train(tp, t(x), head_dim=hd,
                                     return_state=True)
        assert torch.equal(rk.rwkv_time_mix_train(tp, t(x), head_dim=hd),
                           got[0])
    elif fn == "time_mix_decode":
        want = jax.jit(functools.partial(
            jrk.rwkv_time_mix_decode, head_dim=hd))(jp, jnp.asarray(x1),
                                                    shift, wkv)
        got = rk.rwkv_time_mix_decode(tp, t(x1), t(shift), t(wkv),
                                      head_dim=hd)
    elif fn == "channel_mix_train":
        want = (jax.jit(jrk.rwkv_channel_mix_train)(jp, jnp.asarray(x)),)
        got = (rk.rwkv_channel_mix_train(tp, t(x)),)
    else:
        want = jax.jit(jrk.rwkv_channel_mix_decode)(jp, jnp.asarray(x1),
                                                    shift)
        got = rk.rwkv_channel_mix_decode(tp, t(x1), t(shift))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert_close(g, w, tol=BLOCK_TOL * max(1.0, float(np.abs(w).max())))


def test_rwkv6_init_has_the_reference_tree():
    """rwkv6_init unstacked and stacked: the reference's keys, shapes and
    dtypes (values are the port's own)."""
    import jax
    from repro.models import rwkv6 as jrk
    from repro.models import split_tree

    def normal(shape, std):
        return torch.randn(shape) * std
    for stack in (None, 3):
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), split_tree(
            jax.eval_shape(lambda: jrk.rwkv6_init(
                jax.random.PRNGKey(0), 64, 128, head_dim=16, decay_lora=8,
                stack=stack)))[0])
        got = jax.tree.map(lambda a: (tuple(a.shape),
                                      str(a.dtype).replace("torch.", "")),
                           rk.rwkv6_init(normal, 64, 128, head_dim=16,
                                         decay_lora=8, stack=stack))
        assert got == want


# -- the model ----------------------------------------------------------------


def test_forward_train_and_loss_match_reference():
    import jax
    import jax.numpy as jnp
    from repro.models import forward_train as jfwd
    from repro.models import loss_fn as jloss
    jcfg, tcfg = _cfgs()
    toks = _tokens(tcfg.vocab, 2, 9, seed=2)
    tgts = _tokens(tcfg.vocab, 2, 9, seed=3)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "targets": torch.from_numpy(tgts).long()}
    tp = from_jax_params(_tree(), "cpu")
    jp = _jnp(_tree())
    assert_close(forward_train(tcfg, tp, tb),
                 jax.jit(functools.partial(jfwd, jcfg))(jp, jb), tol=TOL)
    want_loss = jax.jit(functools.partial(jloss, jcfg))(jp, jb)
    assert abs(float(loss_fn(tcfg, tp, tb)) - float(want_loss)) < TOL


def _jax_steps(jcfg, tree, toks, max_len, dtype, pos0=None):
    import jax
    import jax.numpy as jnp
    from repro.models import decode_step as jstep
    from repro.models import init_cache as jcache
    cache = jcache(jcfg, toks.shape[0], max_len, dtype,
                   per_slot=pos0 is not None)
    if pos0 is not None:
        cache = cache._replace(pos=jnp.asarray(pos0, jnp.int32))
    step = jax.jit(lambda p, c, t: jstep(jcfg, p, c, t))
    out = []
    params = _jnp(tree)
    for j in range(toks.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(toks[:, j:j + 1]))
        out.append(np.asarray(logits))
    return out, cache


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype, per_slot):
    """Logits of every step and the final RWKVState (shift states in the
    cache dtype, WKV f32) against the reference's decode_step, lockstep
    and per-slot; the packed int4 tree runs B1's twin."""
    import jax.numpy as jnp
    jcfg, tcfg = _cfgs()
    tree = _tree("int4")
    toks = _tokens(tcfg.vocab, 3, 6, seed=4)
    pos0 = [0, 3, 9] if per_slot else None
    want, jc = _jax_steps(jcfg, tree, toks, 16, getattr(jnp, dtype), pos0)
    params = from_jax_params(tree, "cpu")
    cache = init_cache(tcfg, 3, 16, getattr(torch, dtype),
                       per_slot=per_slot, device="cpu")
    if per_slot:
        cache = cache._replace(pos=torch.tensor(pos0, dtype=torch.int32))
    tol = TOL if dtype == "float32" else BF16_TOL
    for j in range(toks.shape[1]):
        logits, cache = decode_step(tcfg, params, cache,
                                    torch.from_numpy(toks[:, j:j + 1]))
        assert_trees_close(logits, want[j], tol=tol, relative=True)
    assert [str(t.dtype) for t in cache.kv] == \
        [f"torch.{dtype}", f"torch.{dtype}", "torch.float32"]
    assert_trees_close(cache.kv, jc.kv, tol=tol, relative=True)
    np.testing.assert_array_equal(to_numpy(cache.pos), np.asarray(jc.pos))


def test_decode_chunk_matches_reference_and_its_steps():
    """decode_chunk against the reference's; in the port bit for bit the
    decode steps it is made of (stacked or pre-split params)."""
    import jax.numpy as jnp
    from repro.models import decode_chunk as jchunk
    from repro.models import init_cache as jcache
    jcfg, tcfg = _cfgs()
    tree = _tree("int8")
    toks = _tokens(tcfg.vocab, 2, 7, seed=5)
    want_l, want = jchunk(jcfg, _jnp(tree), jcache(jcfg, 2, 16, jnp.float32),
                          jnp.asarray(toks))
    params = from_jax_params(tree, "cpu")
    tt = torch.from_numpy(toks)
    la, a = decode_chunk(tcfg, params, init_cache(tcfg, 2, 16, torch.float32,
                                                  device="cpu"), tt)
    assert_close(la, want_l, tol=TOL)
    assert_trees_close(a.kv, want.kv, tol=TOL, relative=True)
    b = init_cache(tcfg, 2, 16, torch.float32, device="cpu")
    split = split_layers(params)
    for j in range(toks.shape[1]):
        lb, b = decode_step(tcfg, split, b, tt[:, j:j + 1])
    assert torch.equal(la, lb)
    assert all(torch.equal(x, y) for x, y in zip(a.kv, b.kv))


@pytest.mark.parametrize("mode", ["stepped", "parallel"])
def test_prefill_matches_reference(mode, monkeypatch):
    """Each prefill mode against the reference's same mode: last logits
    and every state leaf, bf16 shift states."""
    import jax
    import jax.numpy as jnp
    from repro.models import prefill as jprefill
    if mode == "parallel":
        monkeypatch.setenv("REPRO_OPTS", "parallel_prefill")
    jcfg, tcfg = _cfgs()
    tree = _tree("int4")
    toks = _tokens(tcfg.vocab, 2, 11, seed=6)
    want_l, want = jax.jit(lambda p, t: jprefill(jcfg, p, {"tokens": t}, 16,
                                                 jnp.float32))(
        _jnp(tree), jnp.asarray(toks))
    logits, cache = prefill(tcfg, from_jax_params(tree, "cpu"),
                            {"tokens": torch.from_numpy(toks)}, 16,
                            torch.float32)
    assert_close(logits, want_l, tol=TOL)
    assert_trees_close(cache.kv, want.kv, tol=TOL, relative=True)
    assert int(cache.pos) == int(want.pos) == 11
    _, bf = prefill(tcfg, from_jax_params(tree, "cpu"),
                    {"tokens": torch.from_numpy(toks)}, 16)
    assert [t.dtype for t in bf.kv] == [torch.bfloat16, torch.bfloat16,
                                        torch.float32]


def test_parallel_prefill_equals_stepped(monkeypatch):
    """In the port: the parallel prefill's logits, states and next decode
    step against the stepped prefill's (the reference's test and
    tolerance)."""
    _, tcfg = _cfgs()
    params = from_jax_params(_tree(), "cpu")
    toks = {"tokens": torch.from_numpy(_tokens(tcfg.vocab, 2, 12, seed=7))}
    lg_s, c_s = prefill(tcfg, params, toks, 16, torch.float32)
    monkeypatch.setenv("REPRO_OPTS", "parallel_prefill")
    lg_p, c_p = prefill(tcfg, params, toks, 16, torch.float32)
    monkeypatch.delenv("REPRO_OPTS")
    np.testing.assert_allclose(lg_p.numpy(), lg_s.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert_trees_close(c_p.kv, c_s.kv, tol=TOL, relative=True)
    tok = torch.zeros((2, 1), dtype=torch.long)
    l1, _ = decode_step(tcfg, params, c_s, tok)
    l2, _ = decode_step(tcfg, params, c_p, tok)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=1e-4, atol=1e-5)


def test_quantized_leaves_take_every_projection():
    """At min_dim 8 every dense of the block is a code leaf (10 stacked
    leaves: w_r w_k w_v w_g w_o decay_a decay_b, cm w_k w_v w_r) and the
    rest stays float, as in the reference's tree."""
    from repro_torch.kernels.dequant import payload_checksums
    tree = quantize_params_tree(from_jax_params(_tree(), "cpu"), min_dim=8,
                                nbits=4, packed=True)
    paths = sorted(payload_checksums(tree))
    assert paths == sorted(
        [f"layers/tm/{k}/w" for k in ("w_r", "w_k", "w_v", "w_g", "w_o",
                                      "decay_a", "decay_b")]
        + [f"layers/cm/{k}/w" for k in ("w_k", "w_v", "w_r")])


# -- the engines --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_fns():
    import jax
    from repro.configs.base import ArchConfig
    from repro.models import decode_chunk as jchunk
    from repro.models import decode_step as jstep
    cfg = ArchConfig(**CFG_SSM)
    return (cfg, jax.jit(lambda p, c, t: jstep(cfg, p, c, t)),
            jax.jit(lambda p, c, t: jchunk(cfg, p, c, t)))


@functools.lru_cache(maxsize=None)
def _engine_tree(fmt):
    base = _tree("fp", engine_cfg=True)
    return base if fmt == "fp" else _quantized(base, 16, fmt)


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_engine_streams_match_reference(fmt, continuous):
    """vs repro.serve's engines on test_continuous_batching's ssm config
    and workload: identical greedy streams, request by request."""
    import jax.numpy as jnp
    from repro import serve as jserve
    jcfg, jstep, jchunk = _jax_fns()
    tree = _engine_tree(fmt)
    workload = random_workload(31, CFG_SSM["vocab"])
    kw = dict(n_slots=3 if continuous else 4, max_len=24, prefill_chunk=3)
    jeng = (jserve.ContinuousEngine if continuous else jserve.ServeEngine)(
        jcfg, _jnp(tree), config=jserve.EngineConfig(
            cache_dtype=jnp.float32, decode_fn=jstep, decode_chunk_fn=jchunk,
            **kw))
    want = drive_engine(jeng, workload, continuous, jserve.Request)
    teng = (ContinuousEngine if continuous else ServeEngine)(
        TArchConfig(**CFG_SSM), from_jax_params(tree, "cpu"),
        config=EngineConfig(cache_dtype=torch.float32, **kw))
    assert drive_engine(teng, workload, continuous, Request) == want


@pytest.mark.parametrize("reset", [False, True])
def test_continuous_equals_static_in_the_port(reset):
    """The port's continuous engine (2 slots, idle rows stepping on pad
    tokens, optional eviction hygiene) against its static oracle, with a
    bf16 cache."""
    tree = from_jax_params(_engine_tree("int4"), "cpu")
    cfg = TArchConfig(**CFG_SSM)
    workload = random_workload(32, CFG_SSM["vocab"])
    ref = drive_engine(ServeEngine(cfg, tree, config=EngineConfig(
        n_slots=4, max_len=24, prefill_chunk=3)), workload, False, Request)
    out = drive_engine(ContinuousEngine(cfg, tree, config=EngineConfig(
        n_slots=2, max_len=24, prefill_chunk=3, reset_on_evict=reset)),
        workload, True, Request)
    assert out == ref


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshot_resume_across_packages(writer, tmp_path):
    """A continuous engine snapshots its RWKVState mid-run; the other
    package's engine resumes it and finishes with the uninterrupted run's
    streams."""
    import jax.numpy as jnp
    from repro import serve as jserve
    jcfg, jstep, jchunk = _jax_fns()
    tree = _engine_tree("fp")
    workload = random_workload(33, CFG_SSM["vocab"])
    kw = dict(n_slots=2, max_len=24, prefill_chunk=3)
    jkw = dict(cache_dtype=jnp.float32, decode_fn=jstep,
               decode_chunk_fn=jchunk, **kw)
    tcfg = TArchConfig(**CFG_SSM)
    ref = drive_engine(jserve.ContinuousEngine(
        jcfg, _jnp(tree), config=jserve.EngineConfig(**jkw)), workload,
        True, jserve.Request)
    ckpt = str(tmp_path / "snap")
    if writer == "jax":
        eng = jserve.ContinuousEngine(jcfg, _jnp(tree),
                                      config=jserve.EngineConfig(**jkw))
        req = jserve.Request
    else:
        eng = ContinuousEngine(tcfg, from_jax_params(tree, "cpu"),
                               config=EngineConfig(
                                   cache_dtype=torch.float32, **kw))
        req = Request
    for rid, (prompt, budget, _) in enumerate(workload):
        eng.submit(req(rid=rid, prompt=prompt.copy(), max_new_tokens=budget))
    delivered = {}
    for _ in range(4):
        delivered.update({r.rid: tuple(r.out_tokens) for r in eng.step()})
    eng.snapshot(ckpt)
    if writer == "jax":
        revived = ContinuousEngine.resume(
            ckpt, tcfg, from_jax_params(tree, "cpu"),
            config=EngineConfig(cache_dtype=torch.float32, **kw))
        assert isinstance(revived.cache.kv, rk.RWKVState)
    else:
        revived = jserve.ContinuousEngine.resume(
            ckpt, jcfg, _jnp(tree), config=jserve.EngineConfig(**jkw))
    delivered.update({r.rid: tuple(r.out_tokens)
                      for r in revived.run_until_done()})
    assert delivered == ref


# -- on the card --------------------------------------------------------------


@pytest.mark.cuda
def test_decode_step_on_card_launches_b1_per_dense():
    """Packed int4 on CUDA: one B1 launch per packed dense and layer per
    decode step (10 × 2), each a kernel node of a CUDA graph of the step;
    logits match the CPU twins'."""
    from repro_torch.kernels.dequant import LAUNCHES, reset_launches
    dev = require_cuda()
    tcfg = tget_config(ARCH).reduced()
    tree = quantize_params_tree(init_params(tcfg, 0, device="cpu"),
                                min_dim=8, nbits=4, packed=True)
    gpu = split_layers(from_jax_params(to_numpy(tree), dev))
    tok = torch.from_numpy(_tokens(tcfg.vocab, 3, 1, seed=8)).long()
    want, _ = decode_step(tcfg, tree, init_cache(
        tcfg, 3, 16, torch.float32, device="cpu"), tok)
    cache = init_cache(tcfg, 3, 16, torch.float32, device=dev)
    reset_launches()
    tok_dev = tok.to(dev)
    got, _ = decode_step(tcfg, gpu, cache, tok_dev)
    torch.cuda.synchronize()
    assert dict(LAUNCHES)[4] == 10 * tcfg.n_layers
    assert_close(got.cpu(), want, tol=1e-3)
    names = graph_kernel_names(lambda: decode_step(tcfg, gpu, cache,
                                                   tok_dev))
    assert sum("dequant_packed" in n for n in names) == 10 * tcfg.n_layers


@pytest.mark.parametrize("wbits", [4, 8])
def test_serve_driver_serves_the_arch(wbits):
    """``launch.serve --arch rwkv6-7b --reduced`` on the CPU, continuous
    and static: every request gets its budget of in-vocabulary tokens."""
    from repro_torch.launch import serve
    for extra in (["--continuous"], []):
        done = serve.main(["--arch", ARCH, "--reduced", "--wbits",
                           str(wbits), "--requests", "3", "--max-new", "3",
                           "--device", "cpu"] + extra)
        assert len(done) == 3
        assert all(len(r.out_tokens) == 3 and max(r.out_tokens) < 256
                   for r in done)
