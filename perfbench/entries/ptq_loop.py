"""WaterSIC quantization of a model's linear layers, one matrix after
another, through the port's ``core.watersic.quantize_at_rate`` (the call
``quant.pipeline`` makes for ``method="watersic"``).

Set-up makes the first layer's Σ_X of each tap and warms up the card's
solvers on every in-feature width of the cell.  The window quantizes the
matrices in ``quantize_model``'s order, each drawn from the seed, and
starts no new one after ``--seconds``; the one under way finishes and
counts.  A traced run then profiles the next matrices for
``trace_seconds``, apart from the window, whose host-clock numbers the
profiler would slow.  ``check`` judges a sample of the window's answers, drawn from
the seed, step by step in float64 (``reference.follow``): every code
against the rounding of its target, the dead features, the realized rate
and the output distortion against float64 rescalers fitted to the same
codes.
"""
from __future__ import annotations

import gc
import time
import types

import numpy as np
import torch

from perfbench import devtrace, inputs

_SAMPLE = 9          # numpy stream tag of the check's sample


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sigma(run, layer, tap, n):
    tr = run.traffic
    return inputs.ptq_sigma(
        run.seed, layer, tap, n, run.device, tokens=tr["calib_tokens"],
        decay=tr["spectrum_decay"], scale_sigma=tr["channel_scale_sigma"],
        dead_share=tr["dead_share"])


def _seed(run) -> int:
    return int(run.seed) % 2 ** 63


def measure(run):
    from repro_torch.core.watersic import CalibStats, quantize_at_rate

    arch, tr, dev = run.arch, run.traffic, run.device
    if dev.type == "cuda":
        torch.empty(0, device=dev)          # the context, before its stats
        torch.cuda.reset_peak_memory_stats(dev)
    t_setup = time.perf_counter()
    mats = inputs.ptq_matrices(arch)
    sigmas = {(0, tap): _sigma(run, 0, tap, n)
              for layer, _, tap, (_, n) in mats if layer == 0}
    for n in sorted({n for _, _, _, (_, n) in mats}):
        w = torch.randn((64, n), device=dev)
        quantize_at_rate(w, CalibStats(sigma_x=torch.eye(n, device=dev)),
                         tr["target_bits"], damp=tr["damp"], seed=0)
    del w
    _sync(dev)
    gc.collect()
    gc.freeze()          # the set-up's objects leave the collector's walk
    run.setup_s = time.perf_counter() - t_setup

    rec = devtrace.Recorder()
    done = []

    def quantize(index, start):
        """Quantize matrix ``index`` (sigmas of its layer kept)."""
        nonlocal sigmas
        layer, name, tap, shape = mats[index]
        if (layer, tap) not in sigmas:
            sigmas = {k: v for k, v in sigmas.items() if k[0] == layer}
            sigmas[(layer, tap)] = _sigma(run, layer, tap, shape[1])
        w = inputs.ptq_weight(run.seed, layer, index, shape, dev)
        with rec.span(f"quantize_at_rate {name}"):
            q = quantize_at_rate(w, CalibStats(sigma_x=sigmas[(layer, tap)]),
                                 tr["target_bits"], damp=tr["damp"],
                                 seed=_seed(run))
            _sync(dev)
        return {"index": index, "layer": layer, "name": name, "tap": tap,
                "shape": shape, "q": q, "end": time.perf_counter() - start,
                "print": (w.sum(dtype=torch.float64)
                          + sigmas[(layer, tap)].sum(dtype=torch.float64))}

    w0 = time.perf_counter()
    while len(done) < len(mats) and time.perf_counter() - w0 < run.seconds:
        done.append(quantize(len(done), w0))
    run.window_s = done[-1]["end"] if done else 0.0
    run.params = sum(a * n for d in done for a, n in [d["shape"]])
    run.matrices = [(d["shape"], d["end"]) for d in done]
    run.attempted, run.failed = len(done), 0
    run.notes = {"matrix_s": [
        [d["name"], d["end"] - (done[i - 1]["end"] if i else 0.0)]
        for i, d in enumerate(done)]}
    if run.trace:
        # the card's trace, after the window: the profiler slows the host
        traced = []
        with devtrace.DeviceTrace(dev) as dtr:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < tr["trace_seconds"]:
                traced.append(quantize((len(done) + len(traced))
                                       % len(mats), t0))
        run.traced_params = sum(a * n for d in traced
                                for a, n in [d["shape"]])
        devtrace.keep(run, dtr, rec.spans)
    pick = inputs.rng(run.seed, _SAMPLE).permutation(len(done))[
        :run.traffic["check_matrices"]]
    run.sample = [done[i] for i in sorted(pick)]
    for d in run.sample:
        d["print"] = float(d["print"])
    run.done = done


def release(run):
    """Drop the program's state but the sampled results."""
    run.done = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def distortion(w, sigma, q) -> float:
    """(1/an)·tr((W−Ŵ)Σ(W−Ŵ)ᵀ) in float64 of an answer ``q`` (its codes,
    spacings, rescalers and dead columns), worked out here."""
    a, n = w.shape
    w = w.double()
    live = torch.as_tensor(~np.asarray(q.dead_mask), device=w.device)
    w_hat = torch.zeros_like(w)
    w_hat[:, live] = (q.t.double()[:, None] * q.codes.double()
                      * (q.alphas.double() * q.gamma.double())[None, :])
    err = w - w_hat
    return float(((err @ sigma.double()) * err).sum() / (a * n))


def judge(run, reference, d, q) -> dict:
    """The numbers an answer ``q`` to the sampled matrix ``d`` is judged
    by: ``reference.follow`` in float64 from its own codes and c."""
    w = inputs.ptq_weight(run.seed, d["layer"], d["index"], d["shape"],
                          run.device)
    sigma = _sigma(run, d["layer"], d["tap"], d["shape"][1])
    again = float(w.sum(dtype=torch.float64) + sigma.sum(dtype=torch.float64))
    f = reference.follow(w, sigma, q.codes, q.c, q.dead_mask,
                         damp=run.traffic["damp"])
    return {"rounding_excess": f["rounding_excess"],
            "dead_differ": float(f["dead_differ"]),
            "rate_miss_bits": abs(f["entropy_bits"]
                                  - run.traffic["target_bits"]),
            "rescaler_excess": distortion(w, sigma, q) / f["distortion"] - 1.0
            if f["distortion"] > 0 else float("inf"),
            "inputs_differ": float(again != d["print"])}


def _worst(rows, limits):
    worst = {}
    for row in rows:
        for k, v in row.items():
            worst[k] = max(worst.get(k, -float("inf")), v)
    return {k: {"value": v, "limit": limits[k]["limit"]}
            for k, v in worst.items()}


def check(run, reference, limits):
    """Each sampled answer, judged step by step in float64."""
    return _worst([judge(run, reference, d, d["q"]) for d in run.sample],
                  limits)


def control(run, reference, limits):
    """The control's reading: the reference in float32 with TF32 on, in
    the program's place, judged as the program's answer is."""
    rows = []
    for d in run.sample:
        w = inputs.ptq_weight(run.seed, d["layer"], d["index"], d["shape"],
                              run.device)
        sigma = _sigma(run, d["layer"], d["tap"], d["shape"][1])
        low = reference.quantize_at_rate(
            w, sigma, run.traffic["target_bits"], damp=run.traffic["damp"],
            seed=_seed(run), dtype=torch.float32, tf32=True)
        del w, sigma
        rows.append(judge(run, reference, d, types.SimpleNamespace(**low)))
    return _worst(rows, limits)
