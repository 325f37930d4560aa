"""The port's end-to-end lifecycle and train driver: train → checkpoint /
restart → PTQ → serve (``tests/test_system.py::test_full_lifecycle`` on
``repro_torch``, with the reference's gates), and
``python -m repro_torch.launch.train`` restoring on start.

The model starts from the reference's ``init_params`` values handed over
as numpy; every step after that is the port's (bf16 compute, the
reference test's schedule).  Gates, as the reference's: the mean loss of
the last 10 steps below the first 10's, the realized rate within 0.05 of
2.5 bits, WaterSIC ppl ≤ 1.02 × HPTQ ppl at matched rate, the int8
serving codes' first-step logits within 2e-2 of the largest value of the
dequantized path's, and three served requests.  The restart is held
harder than the reference holds it: the restored state equals the saved
one byte for byte, and the driver's resumed run ends on the loss of an
uninterrupted run, bit for bit (the same CPU ops in the same order).
"""
import os

import numpy as np
import torch

from _torch_parity import to_numpy, tree_leaves
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.data import DataConfig, global_batch_for_step
from repro_torch.dist.checkpoint import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.launch import train as launch_train
from repro_torch.models import decode_step, from_jax_params, init_cache
from repro_torch.quant import from_watersic
from repro_torch.quant.pipeline import PTQConfig, model_ppl, quantize_model
from repro_torch.serve import EngineConfig, Request, ServeEngine
from repro_torch.train import (AdamWConfig, TrainState, adamw_init,
                               make_train_step)

CFG = dict(name="sys", family="dense", n_layers=2, d_model=48, n_heads=3,
           n_kv=3, d_ff=96, vocab=96, head_dim=16)
TCFG = TArchConfig(**CFG)


def _reference_init():
    import jax
    from repro.configs.base import ArchConfig
    from repro.models import init_params, split_tree
    return to_numpy(split_tree(init_params(ArchConfig(**CFG),
                                           jax.random.PRNGKey(0)))[0])


def _batch(dcfg, s):
    return {k: torch.as_tensor(v)
            for k, v in global_batch_for_step(dcfg, s).items()}


def test_full_lifecycle(tmp_path):
    dcfg = DataConfig(vocab=TCFG.vocab, seq_len=40, global_batch=8)
    base = _reference_init()
    params = from_jax_params(base, "cpu")
    opt = AdamWConfig(lr=2e-3, total_steps=120, warmup_steps=10)
    state = TrainState(params=params, opt=adamw_init(params), err=None)
    step = make_train_step(TCFG, opt)

    # --- 1/2: train with a mid-run checkpoint + restore -------------------
    losses = []
    for s in range(60):
        state, m = step(state, _batch(dcfg, s))
        losses.append(float(m["loss"]))
    save_checkpoint(str(tmp_path), 60, state)
    saved = [t.clone() for t in tree_leaves(state)]
    state = None  # "crash"
    fresh = from_jax_params(base, "cpu")
    fresh = TrainState(params=fresh, opt=adamw_init(fresh), err=None)
    state, _ = restore_checkpoint(str(tmp_path), fresh,
                                  step=latest_step(str(tmp_path)))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state), saved))
    for s in range(60, 120):
        state, m = step(state, _batch(dcfg, s))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    params = state.params

    # --- 3/4: PTQ at 2.5 bits; WaterSIC ≤ HPTQ at matched rate -------------
    calib = [global_batch_for_step(dcfg, 900)["tokens"]]
    evalb = [np.concatenate(
        [global_batch_for_step(dcfg, 1800)["tokens"],
         global_batch_for_step(dcfg, 1800)["targets"][:, -1:]], axis=1)]
    qp_ws, qlin, budget, _ = quantize_model(
        TCFG, params, calib, PTQConfig(target_bits=2.5, method="watersic"))
    qp_h, _, _, _ = quantize_model(
        TCFG, params, calib, PTQConfig(target_bits=2.5, method="hptq"))
    assert abs(budget.realized_rate - 2.5) < 0.05
    ppl_ws = model_ppl(TCFG, qp_ws, evalb)
    ppl_h = model_ppl(TCFG, qp_h, evalb)
    assert np.isfinite(ppl_ws) and ppl_ws <= ppl_h * 1.02

    # --- 5/6: int8 serving codes agree with the dequantized path ----------
    groups = {}
    for name, q in qlin.items():
        groups.setdefault(tuple(name.split("/")[1:]), {})[int(name[1])] = \
            from_watersic(q)
    qp_int8 = {**qp_ws, "layers": {k: dict(v) for k, v in
                                   qp_ws["layers"].items()}}
    for path, per_layer in groups.items():
        stacked = {k: torch.stack([per_layer[l][k]
                                   for l in range(TCFG.n_layers)])
                   for k in ("codes", "s", "t")}
        node = qp_int8["layers"]
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = {**node[path[-1]], "w": stacked}
    tok = torch.zeros((2, 1), dtype=torch.long)
    lg_f, _ = decode_step(TCFG, qp_ws, init_cache(TCFG, 2, 8, torch.float32,
                                                  device="cpu"), tok)
    lg_q, _ = decode_step(TCFG, qp_int8, init_cache(TCFG, 2, 8, torch.float32,
                                                    device="cpu"), tok)
    scale = float(lg_f.abs().max()) + 1e-6
    assert float((lg_f - lg_q).abs().max()) / scale < 2e-2

    eng = ServeEngine(TCFG, qp_int8,
                      config=EngineConfig(n_slots=2, max_len=24))
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=rng.integers(0, TCFG.vocab, 4)
                           .astype(np.int32), max_new_tokens=3))
    done = eng.run_until_done()
    assert len(done) == 3


def test_train_driver_restores_on_start(tmp_path, capsys):
    """``launch.train --device cpu --reduced``: a run whose last
    checkpoint was lost (a crash between two saves) restores the step
    before it on restart and ends on the uninterrupted run's loss."""
    argv = ["--arch", "minicpm-2b", "--reduced", "--steps", "6", "--batch",
            "4", "--seq", "16", "--save-every", "3", "--n-micro", "2",
            "--device", "cpu"]
    clean = launch_train.main(argv + ["--ckpt", str(tmp_path / "a")])
    ckpt = tmp_path / "b"
    launch_train.main(argv + ["--ckpt", str(ckpt)])
    assert latest_step(str(ckpt)) == 6
    os.rename(ckpt / "step_00000006", ckpt / "step_00000006.tmp.crashed")
    capsys.readouterr()
    resumed = launch_train.main(argv + ["--ckpt", str(ckpt)])
    assert "restored step 3" in capsys.readouterr().out
    assert resumed == clean and np.isfinite(clean)
