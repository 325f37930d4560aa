"""Port of training on one device (``train/optimizer.py``,
``train/train_loop.py``, ``dist/fault.run_with_restarts``) held against
the JAX package on the 2-layer model of ``tests/test_train_loop.py``.

Weights are the reference's ``init_params`` values handed over as numpy,
each stacked weight rescaled to std 1/sqrt(in_features) for both packages
(the reference's stacked init takes the layer count as fan-in, ROADMAP
queue C, and its residual stream then turns every f32 comparison into one
of rounding noise).  Tolerances, each against the reference:

* schedules, ``global_norm``, ``clip_by_norm`` and ``adamw_update`` on a
  seeded tree: 1e-6 relative (the same float32 arithmetic; sums over a
  leaf in another order);
* f32 train steps: losses and params within 1e-5 (rtol = atol; params,
  m and v relative to each leaf's largest value): f32 matmuls in another
  order, carried through three AdamW steps.  These run at eps = 1e-6: at
  the default 1e-8 a grad at the f32 rounding level of its leaf (2e-9 and
  2e-8 against a largest grad of 9e-3 here) gets an Adam direction
  m̂/(√v̂+ε) of order one from noise alone, so that weight moves up to lr
  apart in one step (the default eps is held on fixed grads by
  ``test_adamw_update_matches_reference`` and in the bf16 steps);
* bf16 train steps (the default compute dtype): losses within 1e-2
  relative (bf16 rounds to 2**-8 = 3.9e-3; the two packages' bf16 matmuls
  round in different places) and params within BF16_PARAM_ATOL (below);
* ``microbatch_grads``: n_micro 4 against 1 at the reference test's own
  rtol 2e-4 / atol 2e-5, each against the reference's at 1e-5.
"""
import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_close, rescale_fan_in, to_numpy,
                           tree_leaves)
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.data import DataConfig, global_batch_for_step
from repro_torch.dist.checkpoint import list_steps, restore_checkpoint
from repro_torch.dist.fault import RestartPolicy, run_with_restarts
from repro_torch.models import from_jax_params
from repro_torch.train import (AdamWConfig, AdamWState, TrainState,
                               adamw_init, adamw_update, cosine_schedule,
                               global_norm, init_train_state,
                               make_train_step,
                               microbatch_grads, wsd_schedule)
from repro_torch.train.optimizer import clip_by_norm

CFG = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=2,
           n_kv=2, d_ff=64, vocab=64, head_dim=16)
TCFG = TArchConfig(**CFG)
DCFG = DataConfig(vocab=64, seq_len=24, global_batch=8)
TOL = 1e-5
OPT_TOL = 1e-6
#: a bf16 grad whose sign differs between the packages (a near-zero
#: grad rounded apart) turns the first Adam direction m̂/√v̂ from +1 to
#: −1: it can move a weight by 2·lr per step, 3 steps here
BF16_PARAM_ATOL = 2 * 5e-3 * 3


def _jcfg():
    from repro.configs.base import ArchConfig
    return ArchConfig(**CFG)


def _base(seed=0):
    """The reference's init_params (numpy), stacked weights rescaled."""
    import jax
    from repro.models import init_params, split_tree
    base = to_numpy(split_tree(init_params(_jcfg(),
                                           jax.random.PRNGKey(seed)))[0])
    return {**base, "layers": rescale_fan_in(base["layers"])}


def _jbatch(step):
    import jax.numpy as jnp
    return {k: jnp.asarray(v)
            for k, v in global_batch_for_step(DCFG, step).items()}


def _tbatch(step):
    return {k: torch.as_tensor(v)
            for k, v in global_batch_for_step(DCFG, step).items()}


def _seeded_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((11,)).astype(np.float32) * 3,
                  "d": rng.standard_normal((4, 3, 2)).astype(np.float32)}}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

SCHEDULES = [
    dict(schedule="cosine", lr=1.0, warmup_steps=5, total_steps=50),
    dict(schedule="cosine", lr=3e-3, warmup_steps=10, total_steps=150,
         min_lr_frac=0.01),
    dict(schedule="wsd", lr=1.0, warmup_steps=10, total_steps=100,
         stable_frac=0.8, min_lr_frac=0.1),
    dict(schedule="wsd", lr=3e-3, warmup_steps=1, total_steps=30),
    dict(schedule="const", lr=2e-3),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: kw["schedule"]
                         + f"-{kw['lr']}")
def test_schedules_match_reference(kw):
    """``_lr`` (cosine, wsd, const) at int32 steps 0..total+5 against the
    reference's ``_lr``, within 1e-6 of the peak lr (near the cosine's end
    1 + cos(πt) cancels, and an ulp of f32 cos is a larger share of it)."""
    import jax.numpy as jnp
    from repro.train.optimizer import AdamWConfig as JAdamWConfig
    from repro.train.optimizer import _lr as jlr
    from repro_torch.train.optimizer import _lr
    cfg, jcfg = AdamWConfig(**kw), JAdamWConfig(**kw)
    for s in range(cfg.total_steps + 6 if cfg.schedule != "const" else 5):
        got = _lr(cfg, torch.tensor(s, dtype=torch.int32))
        want = np.asarray(jlr(jcfg, jnp.asarray(s, jnp.int32)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=OPT_TOL,
                                   atol=OPT_TOL * cfg.lr)


def test_wsd_schedule_shape():
    cfg = AdamWConfig(lr=1.0, schedule="wsd", warmup_steps=10,
                      total_steps=100, stable_frac=0.8, min_lr_frac=0.1)
    lrs = [float(wsd_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 5, 10, 50, 79, 90, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == lrs[3] == pytest.approx(1.0)   # stable plateau
    assert lrs[4] == pytest.approx(1.0, abs=0.05)
    assert lrs[5] < 1.0
    assert lrs[6] == pytest.approx(0.1, abs=1e-6)   # decayed to min


def test_cosine_schedule_monotone_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=5, total_steps=50)
    lrs = [float(cosine_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(50)]
    assert lrs[5] == pytest.approx(1.0)
    assert all(a >= b - 1e-9 for a, b in zip(lrs[5:], lrs[6:]))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    """``global_norm`` and ``clip_by_norm`` (clipping and not) against the
    reference's on a seeded tree, 1e-6 relative."""
    import jax.numpy as jnp
    from repro.train.optimizer import clip_by_norm as jclip
    from repro.train.optimizer import global_norm as jnorm
    tree = _seeded_tree(1)
    jt = {"a": jnp.asarray(tree["a"]),
          "b": {k: jnp.asarray(v) for k, v in tree["b"].items()}}
    tt = from_jax_params(tree, "cpu")
    np.testing.assert_allclose(float(global_norm(tt)), float(jnorm(jt)),
                               rtol=OPT_TOL)
    got, gn = clip_by_norm(tt, max_norm)
    want, jgn = jclip(jt, max_norm)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=OPT_TOL)
    assert_trees_close(got, want, tol=OPT_TOL)


@pytest.mark.parametrize("kw", [dict(), dict(clip_norm=0.0),
                                dict(schedule="wsd", weight_decay=0.0,
                                     warmup_steps=2, total_steps=10)],
                         ids=["clip", "noclip", "wsd-nowd"])
def test_adamw_update_matches_reference(kw):
    """Four ``adamw_update`` steps on a seeded tree with seeded grads
    against the reference's: params, m, v, step, lr and grad norm, 1e-6
    relative; the port updates params, m and v in place."""
    import jax.numpy as jnp
    from repro.train.optimizer import AdamWConfig as JAdamWConfig
    from repro.train.optimizer import adamw_init as jinit
    from repro.train.optimizer import adamw_update as jupdate
    kw = dict(dict(lr=1e-2, warmup_steps=1, total_steps=20), **kw)
    cfg, jcfg = AdamWConfig(**kw), JAdamWConfig(**kw)

    def jtree(t):
        return {"a": jnp.asarray(t["a"]),
                "b": {k: jnp.asarray(v) for k, v in t["b"].items()}}
    params = _seeded_tree(2)
    tp, jp = from_jax_params(params, "cpu"), jtree(params)
    ts, js = adamw_init(tp), jinit(jp)
    first = tree_leaves(tp)
    for i in range(4):
        g = _seeded_tree(10 + i)
        tp, ts, tm = adamw_update(cfg, tp, from_jax_params(g, "cpu"), ts)
        jp, js, jm = jupdate(jcfg, jp, jtree(g), js)
        assert int(ts.step) == int(js.step) == i + 1
        assert ts.step.dtype == torch.int32
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=OPT_TOL)
        assert_trees_close(tp, jp, tol=OPT_TOL, relative=True)
        assert_trees_close((ts.m, ts.v), (js.m, js.v), tol=OPT_TOL,
                           relative=True)
    assert all(a is b for a, b in zip(first, tree_leaves(tp)))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def _ref_steps(base, opt_kw, n, compute, n_micro=1):
    """The reference's jitted train step from ``base``: (losses, final
    state as numpy)."""
    import jax
    import jax.numpy as jnp
    from repro.train import AdamWConfig as JAdamWConfig
    from repro.train import TrainState as JTrainState
    from repro.train import adamw_init as jinit
    from repro.train import make_train_step as jmake
    params = jax.tree.map(jnp.asarray, base)
    state = JTrainState(params=params, opt=jinit(params), err=None)
    step = jax.jit(jmake(_jcfg(), JAdamWConfig(**opt_kw), n_micro=n_micro,
                         compute_dtype=compute))
    losses = []
    for s in range(n):
        state, m = step(state, _jbatch(s))
        losses.append(float(m["loss"]))
    return losses, state


def _port_steps(base, opt_kw, n, compute, n_micro=1):
    state = init_train_state(from_jax_params(base, "cpu"))
    step = make_train_step(TCFG, AdamWConfig(**opt_kw), n_micro=n_micro,
                           compute_dtype=compute)
    losses = []
    for s in range(n):
        state, m = step(state, _tbatch(s))
        losses.append(float(m["loss"]))
    return losses, state


OPT_KW = dict(lr=5e-3, total_steps=150, warmup_steps=1)
#: the f32 comparisons' eps (module docstring)
F32_KW = dict(OPT_KW, eps=1e-6)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_f32_match_reference(n_micro):
    """Three f32 steps of ``make_train_step`` (one batch, and two
    microbatches) against the reference's: each loss, the params, m and
    v within 1e-5."""
    import jax.numpy as jnp
    base = _base(0)
    want_l, want = _ref_steps(base, F32_KW, 3, jnp.float32, n_micro)
    got_l, got = _port_steps(base, F32_KW, 3, torch.float32, n_micro)
    np.testing.assert_allclose(got_l, want_l, rtol=TOL, atol=TOL)
    assert int(got.opt.step) == int(want.opt.step) == 3
    assert_trees_close(got.params, want.params, tol=TOL, relative=True)
    assert_trees_close((got.opt.m, got.opt.v), (want.opt.m, want.opt.v),
                       tol=TOL, relative=True)
    assert got.err is None


def test_train_steps_bf16_match_reference():
    """Three steps at the default bf16 compute dtype (f32 masters): each
    loss within 1e-2 relative, the f32 params within BF16_PARAM_ATOL."""
    import jax.numpy as jnp
    base = _base(0)
    want_l, want = _ref_steps(base, OPT_KW, 3, jnp.bfloat16)
    got_l, got = _port_steps(base, OPT_KW, 3, torch.bfloat16)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-2)
    for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
        a, b = to_numpy(a), np.asarray(b)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=BF16_PARAM_ATOL)


def test_microbatch_grads_match_full_batch_and_reference():
    """n_micro 4 against 1 (f32 compute; the reference test's
    tolerances), each against the reference's ``microbatch_grads``."""
    import jax.numpy as jnp
    from repro.train import microbatch_grads as jmicro
    base = _base(1)
    tp = from_jax_params(base, "cpu")
    got = {n: microbatch_grads(TCFG, tp, _tbatch(0), n,
                               compute_dtype=torch.float32) for n in (1, 4)}
    import jax
    jparams = jax.tree.map(jnp.asarray, base)
    for n in (1, 4):
        wl, wg = jmicro(_jcfg(), jparams, _jbatch(0), n,
                        compute_dtype=jnp.float32)
        assert abs(float(got[n][0]) - float(wl)) <= TOL * (1 + float(wl))
        assert_trees_close(got[n][1], wg, tol=TOL, relative=True)
    assert abs(float(got[1][0]) - float(got[4][0])) < 1e-5
    for a, b in zip(tree_leaves(got[1][1]), tree_leaves(got[4][1])):
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), rtol=2e-4,
                                   atol=2e-5)
    assert all(x.dtype == torch.float32 for x in tree_leaves(got[4][1]))


def test_bf16_grads_opt_narrows_each_microbatch(monkeypatch):
    """Under ``REPRO_OPTS=bf16_grads`` each microbatch's f32 grads are
    rounded to bf16 before the f32 accumulator adds them: the mean equals
    the mean of the bf16-rounded per-microbatch grads, and the reference's
    under the same option within one bf16 ulp of each leaf's largest grad
    (2**-8 of it: an f32 grad on a bf16 rounding boundary in one package
    rounds to the other neighbour)."""
    import jax
    import jax.numpy as jnp
    from repro.train import microbatch_grads as jmicro
    base = _base(1)
    tp = from_jax_params(base, "cpu")
    monkeypatch.setenv("REPRO_OPTS", "bf16_grads")
    _, narrowed = microbatch_grads(TCFG, tp, _tbatch(0), 2,
                                   compute_dtype=torch.float32)
    _, want = jmicro(_jcfg(), jax.tree.map(jnp.asarray, base), _jbatch(0), 2,
                     compute_dtype=jnp.float32)
    for a, b in zip(tree_leaves(narrowed), tree_leaves(want)):
        a, b = to_numpy(a), np.asarray(b)
        assert np.abs(a - b).max() <= 2.0 ** -8 * np.abs(b).max()
    monkeypatch.delenv("REPRO_OPTS")
    halves = [microbatch_grads(TCFG, tp, {k: v[i * 4:(i + 1) * 4]
                                          for k, v in _tbatch(0).items()},
                               1, compute_dtype=torch.float32)[1]
              for i in range(2)]
    moved = 0
    for got, a, b in zip(tree_leaves(narrowed), tree_leaves(halves[0]),
                         tree_leaves(halves[1])):
        rounded = (a.to(torch.bfloat16).float()
                   + b.to(torch.bfloat16).float()) / 2
        assert torch.equal(got, rounded)
        moved += not torch.equal(got, (a + b) / 2)
    assert moved


def test_loss_decreases():
    """The port's ``test_train_loop.py::test_loss_decreases``: 150 f32
    steps on the pipeline's batches."""
    params = from_jax_params(_base(0), "cpu")
    opt = AdamWConfig(lr=5e-3, total_steps=150, warmup_steps=10)
    state = TrainState(params=params, opt=adamw_init(params), err=None)
    step = make_train_step(TCFG, opt, compute_dtype=torch.float32)
    losses = []
    for s in range(150):
        state, m = step(state, _tbatch(s))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.05


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """A reference ``TrainState`` checkpoint (two f32 steps) restores into
    the port's ``TrainState`` (params, m, v and the int32 step on the
    CPU), and the port's next f32 step equals the reference's next step
    within 1e-5."""
    import jax
    import jax.numpy as jnp
    from repro.dist.checkpoint import save_checkpoint as jsave
    from repro.train import AdamWConfig as JAdamWConfig
    from repro.train import make_train_step as jmake
    base = _base(0)
    _, jstate = _ref_steps(base, F32_KW, 2, jnp.float32)
    jsave(str(tmp_path), 2, jstate)
    template = init_train_state(from_jax_params(base, "cpu"))
    state, manifest = restore_checkpoint(str(tmp_path), template)
    assert manifest["step"] == 2
    assert state.opt.step.dtype == torch.int32 and int(state.opt.step) == 2
    assert_trees_close(state.params, jstate.params, tol=0)
    step = make_train_step(TCFG, AdamWConfig(**F32_KW),
                           compute_dtype=torch.float32)
    state, m = step(state, _tbatch(2))
    jstate, jm = jax.jit(jmake(_jcfg(), JAdamWConfig(**F32_KW),
                               compute_dtype=jnp.float32))(jstate,
                                                           _jbatch(2))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= TOL
    assert_trees_close(state.params, jstate.params, tol=TOL, relative=True)


# ---------------------------------------------------------------------------
# run_with_restarts (tests/test_fault.py's four, against the port)
# ---------------------------------------------------------------------------


def test_run_with_restarts_recovers(tmp_path):
    """Inject failures; training must resume from the checkpoint and finish
    with the same result as a failure-free run."""
    calls = {"n": 0}

    def flaky_step(step, state):
        calls["n"] += 1
        if calls["n"] in (7, 15):  # two injected crashes
            raise RuntimeError("node failure")
        return {"x": state["x"] + 1}

    state0 = {"x": torch.zeros(())}
    final, step = run_with_restarts(
        flaky_step, state0, n_steps=20, ckpt_dir=str(tmp_path),
        save_every=5, sleep_fn=lambda s: None)
    assert step == 20
    assert float(final["x"]) == 20.0  # exactly-once semantics via ckpt


def test_run_with_restarts_backoff_resets_after_success_streak(tmp_path):
    """With ``reset_after`` the success streak between failures refunds
    the budget, so every restart waits the BASE delay and the run
    survives more failures than max_restarts."""
    crash_at = {4, 12, 20, 28}          # 4 spaced one-shot failures
    slept = []

    def flaky_step(step, state):
        if step in crash_at:
            crash_at.remove(step)       # one-shot: succeeds on replay
            raise RuntimeError("transient blip")
        return {"x": state["x"] + 1}

    final, step = run_with_restarts(
        flaky_step, {"x": torch.zeros(())}, n_steps=32,
        ckpt_dir=str(tmp_path), save_every=2,
        policy=RestartPolicy(max_restarts=2, backoff_base_s=1.0,
                             reset_after=3),
        sleep_fn=slept.append)
    assert step == 32 and float(final["x"]) == 32.0
    assert slept == [1.0, 1.0, 1.0, 1.0]


def test_run_with_restarts_without_reset_escalates_and_dies(tmp_path):
    """The same failure pattern WITHOUT reset_after burns the lifetime
    budget — delays escalate and the third crash is fatal."""
    crash_at = {4, 12, 20, 28}
    slept = []

    def flaky_step(step, state):
        if step in crash_at:
            crash_at.remove(step)
            raise RuntimeError("transient blip")
        return {"x": state["x"] + 1}

    with pytest.raises(RuntimeError, match="transient blip"):
        run_with_restarts(flaky_step, {"x": torch.zeros(())}, n_steps=32,
                          ckpt_dir=str(tmp_path), save_every=2,
                          policy=RestartPolicy(max_restarts=2,
                                               backoff_base_s=1.0),
                          sleep_fn=slept.append)
    assert slept == [1.0, 2.0]          # escalating, then budget exhausted


def test_run_with_restarts_exhausts_budget(tmp_path):
    def always_fail(step, state):
        raise RuntimeError("dead")

    with pytest.raises(RuntimeError):
        run_with_restarts(always_fail, {"x": torch.zeros(())}, n_steps=5,
                          ckpt_dir=str(tmp_path),
                          policy=RestartPolicy(max_restarts=2),
                          sleep_fn=lambda s: None)


def _run_train_with_restarts(ckpt, crash_at):
    """8 f32 steps of the in-place train step under ``run_with_restarts``
    (a checkpoint every 3 steps), failing once at each step of
    ``crash_at``; returns (losses by step, final state)."""
    step = make_train_step(TCFG, AdamWConfig(**OPT_KW),
                           compute_dtype=torch.float32)
    losses = {}
    pending = set(crash_at)

    def step_fn(s, state):
        if s in pending:
            pending.remove(s)
            raise RuntimeError("injected")
        state, m = step(state, _tbatch(s - 1))
        losses[s] = float(m["loss"])
        return state
    state = init_train_state(from_jax_params(_base(0), "cpu"))
    final, _ = run_with_restarts(step_fn, state, n_steps=8,
                                 ckpt_dir=str(ckpt), save_every=3,
                                 sleep_fn=lambda s: None)
    return losses, final


def _assert_same_run(got, clean):
    assert got[0] == clean[0]
    for a, b in zip(tree_leaves(got[1]), tree_leaves(clean[1])):
        assert torch.equal(a, b)
    assert isinstance(got[1].opt, AdamWState)


def test_train_state_resumes_through_run_with_restarts(tmp_path):
    """The in-place train step under ``run_with_restarts`` with one crash
    after a checkpoint gives the losses and params of an uninterrupted
    run, bit for bit (the same ops on the CPU)."""
    _assert_same_run(_run_train_with_restarts(tmp_path / "b", (5,)),
                     _run_train_with_restarts(tmp_path / "a", ()))


def test_train_state_failure_before_the_first_save(tmp_path):
    """A crash before the first periodic save (step 2 of save-every 3)
    replays from the committed step-0 checkpoint, not from the initial
    state the in-place step has already moved: losses and params equal
    an uninterrupted run's bit for bit."""
    got = _run_train_with_restarts(tmp_path / "b", (2,))
    assert 0 in list_steps(str(tmp_path / "b"))
    _assert_same_run(got, _run_train_with_restarts(tmp_path / "a", ()))
