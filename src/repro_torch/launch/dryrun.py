"""Multi-pod dry run: trace every (arch × shape × mesh) cell (port of
``repro/launch/dryrun.py``).

For each cell this traces rank 0's program of the step on ``meta``
tensors under the production mesh (``launch.mesh.make_production_mesh``:
a ``ShapeMesh`` of 256 or 512 ranks) with the step cost counter
(``launch.hlo_cost``) watching, which is the port's counterpart of the
reference's ``jax.eval_shape`` plus lowering: it needs no card and
computes nothing.  It shows, without hardware,
  * that the layout is coherent (every rank's program runs on its blocks,
    every collective has a shape),
  * what the rank holds and allocates (``memory_analysis``: the bytes of
    its arguments and the peak of the storages it creates),
  * and the roofline terms with one H100 SXM's figures
    (``launch.roofline``): FLOPs, HBM bytes and collective bytes counted
    over the port's own eager ops.  Modeled, not measured.

Train cells run the FSDP × TP step (``models.fsdp_tp_layout``: params,
AdamW moments and grads cut ``d_model_w`` over the data axes and heads /
ff / vocab / experts / recurrent state over ``model``), each rank on its
rows of the batch, with the reference's microbatch rule
(``_auto_micro``), for every family.  The ssm family's WKV recurrence is
a loop over time whose 4096 steps per layer and microbatch the counter
would watch op by op (hours on the CPU), so its train cells trace the
step at 11 and at 13 tokens and extrapolate the op log linearly to the
shape's length: exact for the counts, FLOPs and bytes (every op is per
token or per step, no attention), and for the collectives, whose shapes
carry the length in one dim (the peak is extrapolated alike, a model).

Prefill and decode cells run the port's one mesh-serving design, the
in-feature (k) shard of every big matmul over ``model``
(``serve/sharded.py``: each rank computes its partial, the partials are
all-gathered and chain-summed; the decode cache's buffer axis is cut
over ``model`` and gathered per layer), with the batch split over the
data axes (a batch that does not divide is served whole by the rank, the
reference's ``_dp_if_divisible``).  The reference lowers the same cells
under GSPMD with heads and ff cut over ``model``, so the two packages'
collective bytes differ by design.  ``--wbits 4`` serves packed int4
(B1) where the reference lowers native int4 codes; ``--wbits 8`` int8
codes (B2).

The ssm and hybrid families prefill by stepping ``decode_chunk`` over
the prompt (the reference's stepped baseline): S token steps that run the
same ops on the same shapes.  Their prefill cells trace the prompt at 1
and at 2 tokens and extrapolate the op log linearly to S (exact, since
every step is the same), the counterpart of the reference's trip-count
weighting: their ``multiplicity_ratio`` is the weighted dot FLOPs over
the traced ones.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k \\
        --mesh single --out experiments/dryrun_torch/
    python -m repro_torch.launch.dryrun --all --mesh both  (sequential)

Writes one JSON per cell, ``<out>/<arch>__<shape>__<mesh>[__w<bits>].json``
(an existing file is kept: the grid is resumable), and in place of the
reference's ``.hlo.zz`` the counter's op log, ``<tag>.ops.zz`` (zlib'd
JSON), from which ``launch.reparse`` recomputes the roofline fields.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import zlib

import torch

from repro_torch.configs import SHAPES, get_config, input_specs, list_archs
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.dist.sharding import (batch_spec, manual_axes, use_layout,
                                       use_mesh)
from repro_torch.launch.hlo_cost import costs_from_log, count_costs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import model_flops, report_from_costs
from repro_torch.models import (fsdp_tp_blocks, fsdp_tp_layout, init_params,
                                prefill)
from repro_torch.quant import quantize_params_tree
from repro_torch.serve.sharded import (build_sharded_decode_fns, local_view,
                                       shard_params_tree)
from repro_torch.train import AdamWConfig, init_train_state, make_train_step

__all__ = ["run_cell", "main"]

#: the port's dry-run artifacts (the reference's are experiments/dryrun,
#: which its own artifact test reads)
OUT_DIR = "experiments/dryrun_torch"
_SKIP = "full-attention arch: 500k KV decode out of scope (DESIGN.md §5)"


def _dp_size(mesh) -> int:
    n = 1
    for a in batch_spec(mesh):
        n *= mesh.shape[a]
    return n


def _rank_rows(batch, mesh):
    """Rank 0's rows of a (meta) global batch: its block along the data
    axes when the batch divides over them, else the whole batch."""
    n, coord = _dp_size(mesh), 0
    for a in batch_spec(mesh):
        coord = coord * mesh.shape[a] + mesh.axis_index(a)

    def rows(x):
        b = x.shape[0]
        if b % n:
            return x
        return x.narrow(0, coord * (b // n), b // n)
    return {k: rows(v) for k, v in batch.items()}


def _auto_micro(cfg: ArchConfig, shape: ShapeSpec, mesh) -> int:
    """The reference's rule: ``REPRO_N_MICRO``, else the config's
    ``microbatch``, else min(rows per data rank, 16), lowered until it
    divides the global batch."""
    env = os.environ.get("REPRO_N_MICRO")
    if env:
        return int(env)
    if cfg.microbatch:
        return cfg.microbatch
    per_dev = max(shape.global_batch // _dp_size(mesh), 1)
    n_micro = min(per_dev, 16)
    while shape.global_batch % n_micro:
        n_micro -= 1
    return max(n_micro, 1)


def _tag(arch, shape_name, mesh_kind, wbits) -> str:
    return f"{arch}__{shape_name}__{mesh_kind}" + \
        (f"__w{wbits}" if wbits != 16 else "")


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             wbits: int = 16, out_dir: str = OUT_DIR,
             force: bool = False) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    tag = _tag(arch, shape_name, mesh_kind, wbits)
    out_path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.subquadratic:
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                  "status": "skipped", "reason": _SKIP}
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
        return result

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    ops_path = os.path.join(out_dir, tag + ".ops.zz")
    t0 = time.time()
    try:
        with use_mesh(mesh):
            if shape.kind == "train":
                result = _trace_train(cfg, shape, mesh, mesh_kind, ops_path)
            else:
                result = _trace_serve(cfg, shape, mesh, mesh_kind, ops_path,
                                      prefill_cell=(shape.kind == "prefill"),
                                      wbits=wbits)
    except Exception as e:  # noqa: BLE001 — recorded as cell failure
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                  "status": "failed", "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    result.update({"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                   "chips": mesh.size, "wbits": wbits,
                   "elapsed_s": round(time.time() - t0, 1)})
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1, default=float)
    return result


def tokens_of(shape: ShapeSpec, kind: str) -> int:
    return shape.global_batch * (shape.seq_len if kind != "decode" else 1)


def report_of(cfg, shape, mesh_kind, chips, kind, costs, memory):
    """The cell's roofline report from its counted costs and memory."""
    mf = model_flops(cfg.active_param_count(), tokens_of(shape, kind),
                     "train" if kind == "train" else "serve")
    peak = memory.get("argument_size_in_bytes", 0) \
        + memory.get("temp_size_in_bytes", 0)
    return report_from_costs(arch=cfg.name, shape=shape.name, mesh=mesh_kind,
                             chips=chips, costs=costs, model_flops_total=mf,
                             mem_peak_bytes=peak)


def roofline_fields(rep) -> dict:
    """The JSON fields a report sets (``launch.reparse`` rewrites them)."""
    return {"roofline": rep.to_json(), "dominant": rep.dominant,
            "bound_time_s": rep.bound_time_s,
            "roofline_fraction": rep.roofline_fraction,
            "n_collectives": dict(rep.collective_breakdown)}


def _collect(costs, cfg, shape, mesh, mesh_kind, kind, ops_path, trips):
    with open(ops_path, "wb") as f:
        f.write(zlib.compress(json.dumps(
            {"oplog": costs.oplog, "trip_counts": list(trips)})
            .encode(), 6))
    memory = {"argument_size_in_bytes": costs.argument_bytes,
              "temp_size_in_bytes": costs.peak_temp_bytes}
    rep = report_of(cfg, shape, mesh_kind, mesh.size, kind, costs, memory)
    return {"status": "ok", "kind": kind, "memory_analysis": memory,
            "cost_analysis": {"flops": costs.dot_flops,
                              "bytes accessed": costs.hbm_bytes},
            **roofline_fields(rep),
            "collective_counts": costs.n_collectives,
            "kernel_launches": costs.kernel_launches,
            "trip_counts": costs.trip_counts, "n_ops": costs.n_ops}


def _trace_train(cfg, shape, mesh, mesh_kind, ops_path):
    lay = fsdp_tp_layout(cfg, mesh)
    state = init_train_state(fsdp_tp_blocks(
        cfg, init_params(cfg, device="meta"), lay))
    batch = _rank_rows(input_specs(cfg, shape), mesh)
    n_micro = _auto_micro(cfg, shape, mesh)
    step = make_train_step(cfg, AdamWConfig(schedule=cfg.lr_schedule),
                           n_micro=n_micro)
    trips = (cfg.n_layers, n_micro)
    with use_layout(lay):
        if cfg.family == "ssm":
            trips += (shape.seq_len,)
            costs = _seq_extrapolated(step, state, batch, shape.seq_len,
                                      mesh, trips)
        else:
            costs = count_costs(step, state, batch, mesh=mesh,
                                trip_counts=trips)
    out = _collect(costs, cfg, shape, mesh, mesh_kind, "train", ops_path,
                   trips)
    out["n_micro"] = n_micro
    return out


def _serving_tree(cfg, wbits, shards):
    """The k-sharded serving tree of ``--wbits`` on meta: 16 keeps the
    weights, 8 int8 codes, 4 packed int4."""
    params = init_params(cfg, device="meta")
    if wbits == 8:
        params = quantize_params_tree(params)
    elif wbits == 4:
        params = quantize_params_tree(params, nbits=4, packed=True)
    return shard_params_tree(params, shards)


def _trace_serve(cfg, shape, mesh, mesh_kind, ops_path, *,
                 prefill_cell: bool, wbits: int):
    shards = mesh.shape["model"]
    tree = _serving_tree(cfg, wbits, shards)
    local = local_view(tree, mesh)
    batch = _rank_rows(input_specs(cfg, shape), mesh)
    trips = (cfg.n_layers,)
    if prefill_cell:
        def fn(p, b):
            with manual_axes(axis="model", shards=shards,
                             cache_sharded=False):
                return prefill(cfg, p, b, max_len=shape.seq_len)
        if cfg.family not in ("ssm", "hybrid"):
            costs = count_costs(fn, local, batch, mesh=mesh,
                                trip_counts=trips)
        else:
            s = batch["tokens"].shape[1]
            trips += (s,)
            costs = _stepped(fn, local, batch, s, mesh, trips)
        return _collect(costs, cfg, shape, mesh, mesh_kind, "prefill",
                        ops_path, trips)
    step_fn, _ = build_sharded_decode_fns(cfg, tree, mesh)
    rows = batch["token"].shape[0]
    cache = step_fn.init_cache(cfg, rows, shape.seq_len, torch.bfloat16,
                               device="meta")
    costs = count_costs(step_fn, local, cache, batch["token"], mesh=mesh,
                        trip_counts=trips)
    return _collect(costs, cfg, shape, mesh, mesh_kind, "decode", ops_path,
                    trips)


def _stepped(fn, params, batch, steps, mesh, trips):
    """The costs of ``fn`` over a prompt of ``steps`` tokens that it steps
    one token at a time: traced at 1 and 2 tokens, every count of the op
    log taken as the 1-token count plus (steps − 1) times the difference
    (the per-token step), the peak as the larger of the two traces'."""
    def at(n):
        return count_costs(fn, params, {**batch, "tokens":
                                        batch["tokens"][:, :n]},
                           mesh=mesh).oplog
    one, two = at(1), at(2)

    def line(x, y):
        return x + (steps - 1) * (y - x)
    coll = {k: line(one["collectives"].get(k, 0), two["collectives"].get(k, 0))
            for k in sorted(set(one["collectives"]) | set(two["collectives"]))}
    return _weighted(one, two, line, coll, one["argument_bytes"],
                     max(one["peak_temp_bytes"], two["peak_temp_bytes"]),
                     trips)


def _weighted(one, two, line, coll, argument_bytes, peak, trips):
    """The costs of an op log extrapolated from the traces ``one`` and
    ``two``: each op's and kernel's calls, FLOPs and bytes along
    ``line``, the collectives, arguments and peak given; its
    ``multiplicity_ratio`` the weighted dot FLOPs over ``two``'s."""
    def rows(key):
        p, q = one[key], two[key]
        return {k: [line(x, y) for x, y in zip(p.get(k, [0, 0.0, 0.0]),
                                                q.get(k, [0, 0.0, 0.0]))]
                for k in sorted(set(p) | set(q))}
    log = {"ops": rows("ops"), "kernels": rows("kernels"),
           "collectives": dict(sorted(coll.items())),
           "argument_bytes": argument_bytes, "peak_temp_bytes": peak}
    traced = costs_from_log(two).dot_flops
    log["multiplicity_ratio"] = (costs_from_log(log).dot_flops / traced
                                 if traced else 1.0)
    costs = costs_from_log(log, trips)
    costs.oplog = log
    return costs


#: the two lengths an ssm train cell is traced at: no dim of a model
#: (head counts, widths, their cuts, the mix coefficients' 5) equals them
_SEQ_TRACED = (11, 13)


def _seq_key(key: str, n: int, seq: int) -> str:
    """A collective record's key (``op|dtype|dims|bytes``) of a trace at
    ``n`` tokens, moved to ``seq``: each dim equal to ``n`` (the length)
    becomes ``seq`` and the bytes scale with it."""
    op, dtype, dims, nbytes = key.split("|")
    shape = [int(d) for d in dims.split(",") if d]
    hits = sum(1 for d in shape if d == n)
    shape = [seq if d == n else d for d in shape]
    nbytes = int(nbytes) // n ** hits * seq ** hits
    return f"{op}|{dtype}|{','.join(str(d) for d in shape)}|{nbytes}"


def _seq_extrapolated(fn, state, batch, seq, mesh, trips):
    """The costs of the train step ``fn`` over ``seq`` tokens from its
    traces at the two :data:`_SEQ_TRACED` lengths: every count of the op
    log (calls, FLOPs, bytes; arguments and peak) taken as linear in the
    length; the collectives, the same calls at both lengths, moved to
    ``seq`` (:func:`_seq_key`)."""
    a, b = _SEQ_TRACED

    def at(n):
        return count_costs(fn, state, {k: v[:, :n] for k, v in
                                       batch.items()}, mesh=mesh).oplog
    one, two = at(a), at(b)

    def line(x, y):
        return x + (seq - a) * (y - x) / (b - a)
    coll = {}
    for log, n in ((one, a), (two, b)):
        moved = {}
        for k, c in log["collectives"].items():
            key = _seq_key(k, n, seq)
            moved[key] = moved.get(key, 0) + c
        if coll and moved != coll:
            raise ValueError("the collectives of the traces at "
                             f"{_SEQ_TRACED} tokens differ past the length")
        coll = moved
    return _weighted(one, two, line, coll,
                     line(one["argument_bytes"], two["argument_bytes"]),
                     line(one["peak_temp_bytes"], two["peak_temp_bytes"]),
                     trips)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--wbits", type=int, default=16, choices=[16, 8, 4])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                r = run_cell(arch, shape, mesh_kind, wbits=args.wbits,
                             out_dir=args.out, force=args.force)
                status = r.get("status")
                dom = r.get("dominant", "-")
                print(f"{arch:24s} {shape:12s} {mesh_kind:6s} {status:8s} "
                      f"dominant={dom} t={r.get('elapsed_s', 0)}s",
                      flush=True)


if __name__ == "__main__":
    main()
