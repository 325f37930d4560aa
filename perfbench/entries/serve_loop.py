"""Closed-loop generation through the port's ``ContinuousEngine``.

Set-up builds the served tree (``quant.quantize_params_by_layer`` over
the benchmark's seeded layers), the engine the serve launcher builds, and
admits every client's first request in bursts of ``admit_burst``; a few
steps more warm up the decode step.  The window then calls
``engine.step()`` until ``--seconds`` have passed; a client whose request
finishes sends its next one at once.  Each step's return is stamped on the
host: every request that got a token there counts one gap since its
previous token.  A traced run then profiles ``trace_seconds`` of steps
more, apart from the window, whose host-clock numbers it would slow.

``check`` runs the plain reference once over a sample of the served
requests (their prompts and the tokens the timed path served) and reads
how far each served token's logit lies below the reference's best.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import devtrace, host, inputs

_SAMPLE = 9          # numpy stream tag of the check's sample


def _fingerprint(tree) -> torch.Tensor:
    """Sum of every leaf in float64 (a 0-d device tensor, no sync)."""
    leaves = []

    def walk(node):
        for v in node.values():
            if isinstance(v, dict):
                walk(v)
            else:
                leaves.append(v.sum(dtype=torch.float64))
    walk(tree)
    return torch.stack(leaves).sum()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _build_kernels(dev):
    """Seconds the port took to build (or find) its kernel libraries, or
    None where it builds them only at their first use."""
    if dev.type != "cuda":
        return None
    try:
        from repro_torch.kernels._build import build_all
    except ImportError:
        return None
    t = time.perf_counter()
    build_all()
    return time.perf_counter() - t


def measure(run):
    from repro_torch.kernels.dequant import LAUNCHES
    from repro_torch.quant import quantize_params_by_layer
    from repro_torch.serve.config import EngineConfig
    from repro_torch.serve.engine import ContinuousEngine, Request

    arch, tr, dev, seed = run.arch, run.traffic, run.device, run.seed
    if tr["wbits"] != 4:
        raise ValueError("serve_loop serves packed int4 trees")
    if dev.type == "cuda":
        torch.empty(0, device=dev)          # the context, before its stats
        torch.cuda.reset_peak_memory_stats(dev)
    t_setup = time.perf_counter()
    kernels_s = _build_kernels(dev)
    t_kernels = time.perf_counter()
    prints = []

    def layer_source(layer):
        tree = inputs.dense_layer(arch, seed, layer, dev)
        prints.append(_fingerprint(tree))
        return tree

    tree = quantize_params_by_layer(
        arch, layer_source, inputs.dense_shared(arch, seed, dev),
        nbits=4, packed=True)
    run.layer_prints = torch.stack(prints).cpu()
    t_built = time.perf_counter()
    engine = ContinuousEngine(arch, tree, config=EngineConfig(
        n_slots=tr["n_slots"], max_len=tr["max_len"],
        prefill_chunk=tr["prefill_chunk"]))
    plen, budget = tr["prompt_len"], tr["max_new_tokens"]
    issued = [0] * tr["clients"]
    client_of = {}

    def send(client):
        k = issued[client]
        issued[client] += 1
        req = Request(rid=len(client_of),
                      prompt=inputs.prompt(seed, client, k, plen, arch.vocab),
                      max_new_tokens=budget)
        client_of[req.rid] = client
        engine.submit(req)

    def step():
        finished = engine.step()
        for r in finished:
            send(client_of[r.rid])
        return finished

    burst = tr["admit_burst"]
    for start in range(0, tr["clients"], burst):
        for client in range(start, min(tr["clients"], start + burst)):
            send(client)
        step()
    t_admitted = time.perf_counter()
    for _ in range(tr["warmup_steps"]):
        step()
    _sync(dev)
    gc.collect()
    gc.freeze()          # the set-up's objects leave the collector's walk
    run.setup_s = time.perf_counter() - t_setup
    run.notes = {"kernel_build_s": kernels_s,
                 "tree_s": t_built - t_kernels,
                 "admit_s": t_admitted - t_built,
                 "warmup_s": t_setup + run.setup_s - t_admitted}
    peak = 0
    if dev.type == "cuda":
        # set-up holds a burst's sub-cache the window no longer has
        peak = torch.cuda.max_memory_allocated(dev)
        run.notes["memory_peak_bytes_setup"] = peak
        torch.cuda.reset_peak_memory_stats(dev)

    live = {r.rid: r for r in engine.slots if r is not None}
    seen = {rid: len(r.out_tokens) for rid, r in live.items()}
    rec = devtrace.Recorder()
    gaps, tokens, steps, live_positions = [], 0, 0, 0
    n0 = len(engine.step_stats)
    dec_s0, dec_c0 = engine.decode_s, engine.decode_calls
    launches0 = LAUNCHES[4]
    step_cpu = []
    with host.Window() as hw:
        w0 = last_t = time.perf_counter()
        last = {rid: w0 for rid in live}
        while time.perf_counter() - w0 < run.seconds:
            live_positions += sum(len(r.prompt) + len(r.out_tokens)
                                  for r in engine.slots if r is not None)
            c0 = time.thread_time()
            with rec.span("engine.step"):
                finished = step()
            step_cpu.append(time.thread_time() - c0)
            now = time.perf_counter()
            steps += 1
            tokens += engine.step_stats[-1].new_tokens
            for r in [*engine.slots, *finished]:
                if r is None:
                    continue
                live[r.rid] = r
                n = len(r.out_tokens)
                if n > seen.get(r.rid, 0):
                    if r.rid in last:
                        gaps.append(now - last[r.rid])
                    last[r.rid] = now
                    seen[r.rid] = n
            last_t = now
    run.window_s = last_t - w0
    run.steps, run.tokens = steps, tokens
    run.gaps_s = np.asarray(gaps)
    run.notes.update(hw.readings)
    walls = np.asarray([s.step_s for s in engine.step_stats[n0:]])
    if walls.size:
        run.notes["step_ms_min_med_p95_max"] = [
            float(1e3 * q) for q in (walls.min(), np.median(walls),
                                     np.quantile(walls, 0.95), walls.max())]
        # the time a slow step lost, and how much of it the main thread
        # spent off its CPU (it spins while it waits for the card)
        cpu = np.asarray(step_cpu[-walls.size:])
        slow = walls > 1.1 * walls.min()
        lost = float((walls[slow] - walls.min()).sum())
        run.notes["slow_steps"] = int(slow.sum())
        if lost > 0:
            run.notes["slow_loss_off_cpu_share"] = float(
                (walls[slow] - cpu[slow]).sum()) / lost
    if dev.type == "cuda":
        run.notes["memory_peak_bytes_window"] = \
            torch.cuda.max_memory_allocated(dev)
    window = engine.step_stats[n0:]
    run.engine_step_s = sum(s.step_s for s in window)
    run.decode_s = engine.decode_s - dec_s0
    run.decode_calls = engine.decode_calls - dec_c0
    run.b1_launches = LAUNCHES[4] - launches0
    run.b1_step_shapes = [(tr["n_slots"], i, o) for _ in range(arch.n_layers)
                          for _, _, (i, o) in inputs.dense_layer_shapes(arch)]
    run.attn_live_positions = live_positions * arch.n_layers
    run.attempted = sum(1 for r in live.values() if seen[r.rid] > 0)
    run.failed = len(engine.dropped)
    if run.trace:
        # the card's trace, after the window: the profiler slows the host
        launches0 = LAUNCHES[4]
        with devtrace.DeviceTrace(dev) as dtr:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < tr["trace_seconds"]:
                with rec.span("engine.step"):
                    step()
        run.trace_b1_launches = LAUNCHES[4] - launches0
        devtrace.keep(run, dtr, rec.spans)
    if dev.type == "cuda":
        run.memory_peak_bytes = max(peak,
                                    torch.cuda.max_memory_allocated(dev))
    # the served requests the check reads: a sample drawn from the seed,
    # with the longest in it
    served = sorted(live.values(), key=lambda r: (-len(r.out_tokens), r.rid))
    pick = inputs.rng(seed, _SAMPLE).permutation(len(served) - 1)[
        :tr["check_requests"] - 1] + 1
    run.sample = [(np.asarray(r.prompt), np.asarray(r.out_tokens, np.int64))
                  for r in [served[0], *(served[i] for i in sorted(pick))]]
    run.engine, run.tree = engine, tree


def release(run):
    """Drop the program's state before the reference runs."""
    run.engine = run.tree = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def _judge(run, reference, limits, gaps_fn):
    arch, dev, seed = run.arch, run.device, run.seed
    prints = []

    def layer_source(layer):
        tree = inputs.dense_layer(arch, seed, layer, dev)
        prints.append(_fingerprint(tree))
        return tree

    gaps = gaps_fn(arch, layer_source, inputs.dense_shared(arch, seed, dev),
                   run.sample)
    again = torch.stack(prints).cpu()
    return {"max_logit_gap": {"value": float(max(g.max() for g in gaps)),
                              "limit": limits["max_logit_gap"]["limit"]},
            "inputs_differ": {"value": float((again != run.layer_prints)
                                             .sum()),
                              "limit": 0.0}}


def check(run, reference, limits):
    """The served tokens against the float32 reference."""
    return _judge(run, reference, limits, reference.served_logit_gaps)


def control(run, reference, limits):
    """The control's reading on the same prompts and served tokens: the
    reference in TF32 in the program's place."""
    return _judge(run, reference, limits, reference.control_logit_gaps)
