"""The port's dry-run tooling (``configs.base`` shape grid and input
specs, the meta param trees, ``launch.{dryrun,reparse,grid,summarize}``)
held against the reference's.

* ``SHAPES``, ``runnable_cells`` and ``input_specs`` (shapes and dtypes;
  the port's are ``meta`` tensors) equal the reference's for every arch.
* The meta param tree of every arch (``init_params(device="meta")``, the
  reference's ``eval_shape`` of ``init_params`` → ``split_tree``) equal
  leaf by leaf in shape and dtype, unquantized and after
  ``quantize_params_tree`` at 8 bits and at 4 (packed: the port serves
  int4 as planar nibbles, the reference's ``packed=True`` rung), and
  ``param_specs_tree`` equal to the reference's ``spec_for_axes`` of the
  split axes under the production rules.
* ``summarize.fmt_bytes`` and ``table`` render the same rows character
  for character as the reference's.
* ``run_cell`` on full-width cells traced on ``meta`` under the 256-rank
  mesh: ``ok``, 256 chips, a dominant term and the reference's JSON
  fields; the MoE, ssm and hybrid ``train_4k`` cells ``ok`` too (one
  microbatch, ``REPRO_N_MICRO=1``, to keep their traces short), with
  their B3 launches and collective counts; ``long_500k`` skipped on a
  full-attention arch; ``reparse`` restores every field bit for bit;
  the CLI and one grid subprocess write their cells.
* The ssm train cell's extrapolation from 11 and 13 tokens equals the
  counter's direct count of the step at a third length.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import _torch_parity  # noqa: F401  (one intra-op thread)
from repro_torch.configs import (SHAPES, get_config, input_specs,
                                 list_archs, runnable_cells)
from repro_torch.launch import dryrun, reparse, summarize
from repro_torch.models import init_params, param_specs_tree
from repro_torch.dist.sharding import default_rules
from repro_torch.quant import quantize_params_tree
from repro_torch.tree import tree_leaves_with_path

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("status", "kind", "memory_analysis", "cost_analysis", "roofline",
          "dominant", "bound_time_s", "roofline_fraction", "n_collectives",
          "chips", "wbits", "elapsed_s")


def test_shape_grid_and_cells_match_the_reference():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import runnable_cells as jcells
    assert {k: (v.name, v.kind, v.seq_len, v.global_batch)
            for k, v in SHAPES.items()} == {
        k: (v.name, v.kind, v.seq_len, v.global_batch)
        for k, v in JSHAPES.items()}
    assert runnable_cells() == jcells()


@pytest.mark.parametrize("arch", sorted(
    ["minicpm-2b", "qwen1.5-32b", "qwen2.5-32b", "minitron-8b",
     "phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b", "rwkv6-7b",
     "recurrentgemma-2b", "whisper-base", "paligemma-3b"]))
def test_input_specs_and_param_counts_match(arch):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.configs import input_specs as jspecs
    cfg, jcfg = get_config(arch), jget(arch)
    assert arch in list_archs()
    for name in SHAPES:
        got, want = input_specs(cfg, SHAPES[name]), jspecs(jcfg,
                                                           JSHAPES[name])
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert str(got[k].dtype).replace("torch.", "") \
                == str(want[k].dtype)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def _shapes(tree):
    return {path: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for path, x in tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2.5-32b",
                                  "phi3.5-moe-42b-a6.6b", "rwkv6-7b",
                                  "recurrentgemma-2b", "whisper-base",
                                  "paligemma-3b"])
def test_meta_param_trees_match_eval_shape(arch):
    import jax
    from jax.tree_util import keystr, tree_flatten_with_path
    from repro.configs import get_config as jget
    from repro.dist.sharding import default_rules as jrules
    from repro.dist.sharding import spec_for_axes as jspec
    from repro.models import init_params as jinit
    from repro.models import split_tree
    from repro.quant import quantize_params_tree as jquant
    jcfg, cfg = jget(arch), get_config(arch)
    px = jax.eval_shape(lambda k: jinit(jcfg, k), jax.random.PRNGKey(0))
    jparams, axes = split_tree(px)
    params = init_params(cfg, device="meta")
    for wbits in (16, 8, 4):
        if wbits == 16:
            want, got = jparams, params
        else:
            kw = dict(nbits=wbits, packed=wbits == 4)
            want = jax.eval_shape(lambda p: jquant(p, **kw), jparams)
            got = quantize_params_tree(params, **kw)
        want = {keystr(p): (tuple(x.shape), str(x.dtype))
                for p, x in tree_flatten_with_path(want)[0]}
        assert _shapes(got) == want, wbits
    rules = default_rules(False)
    jspecs = jax.tree.map(lambda a: tuple(jspec(a, jrules(False))), axes,
                          is_leaf=lambda x: isinstance(x, tuple))
    want = {keystr(p): s for p, s in tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, tuple))[0]}
    got = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        else:
            got[path] = node
    walk(param_specs_tree(cfg, rules), "")
    assert got == want


ROWS = [
    {"arch": "a", "shape": "train_4k", "mesh": "single", "status": "ok",
     "wbits": 16, "roofline": {
         "hlo_flops_per_device": 1.234e15, "hlo_bytes_per_device": 5.6e12,
         "collective_bytes_per_device": 7.89e10, "compute_s": 1.2476,
         "memory_s": 1.6716, "collective_s": 0.1753, "dominant": "memory",
         "useful_ratio": 0.7312}, "roofline_fraction": 0.5458,
     "memory_analysis": {"argument_size_in_bytes": 3 << 30,
                         "temp_size_in_bytes": 5 << 29}},
    {"arch": "b", "shape": "long_500k", "mesh": "single",
     "status": "skipped", "reason": "full-attention arch: 500k KV decode "
                                    "out of scope (DESIGN.md §5)"},
    {"arch": "c", "shape": "train_4k", "mesh": "single", "status": "failed"},
    {"arch": "d", "shape": "decode_32k", "mesh": "multi", "status": "ok",
     "wbits": 16, "roofline": {
         "hlo_flops_per_device": 2e12, "hlo_bytes_per_device": 3e9,
         "collective_bytes_per_device": 0.0, "compute_s": 0.002,
         "memory_s": 0.0009, "collective_s": 0.0, "dominant": "compute",
         "useful_ratio": 0.5}, "roofline_fraction": 0.25,
     "memory_analysis": {"argument_size_in_bytes": 700 << 10}},
    {"arch": "e", "shape": "decode_32k", "mesh": "single", "status": "ok",
     "wbits": 4},
]


def test_summarize_renders_as_the_reference():
    from repro.launch import summarize as jsum
    for b in (0, 1000, 5 << 20, 3 << 30, 123456789):
        assert summarize.fmt_bytes(b) == jsum.fmt_bytes(b)
    for mesh in ("single", "multi"):
        assert summarize.table(ROWS, mesh) == jsum.table(ROWS, mesh)


#: the train cells of the MoE, ssm and hybrid families, traced in one
#: microbatch
FAMILY_TRAIN = {"moe": "moonshot-v1-16b-a3b", "ssm": "rwkv6-7b",
                "hybrid": "recurrentgemma-2b"}


#: their collectives per step on rank 0: 48 / 32 / 26 layers' blocks
#: gathered over data (and the MoE router's logits, the RG-LRU's conv
#: output over model), the sums of the tensor-parallel products and of
#: the reduce-scatters, the vocab-parallel loss's max
FAMILY_COLLECTIVES = {
    "moe": {"all_gather": 433, "all_reduce_max": 1, "all_reduce_sum": 651},
    "ssm": {"all_gather": 289, "all_reduce_max": 1, "all_reduce_sum": 611},
    "hybrid": {"all_gather": 201, "all_reduce_max": 1,
               "all_reduce_sum": 439},
    # its 8 local-attention layers: 10 q heads padded to 16 and the kv
    # head on every rank, one and one per rank
    "hybrid_kernels": {"flash_attention": 8},
}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dry")
    rows = {
        "decode": dryrun.run_cell("minicpm-2b", "decode_32k", "single",
                                  wbits=4, out_dir=str(out)),
        "train": dryrun.run_cell("whisper-base", "train_4k", "single",
                                 out_dir=str(out)),
        "skip": dryrun.run_cell("minicpm-2b", "long_500k", "single",
                                out_dir=str(out)),
    }
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_N_MICRO", "1")
        for key, arch in FAMILY_TRAIN.items():
            rows[key] = dryrun.run_cell(arch, "train_4k", "single",
                                        out_dir=str(out))
    return out, rows


def test_cells_trace_on_meta(cells):
    out, rows = cells
    for key in ("decode", "train"):
        r = rows[key]
        assert r["status"] == "ok", r.get("traceback")
        assert r["chips"] == 256
        assert r["dominant"] in ("compute", "memory", "collective")
        assert set(FIELDS) <= set(r)
        assert {"argument_size_in_bytes", "temp_size_in_bytes"} \
            <= set(r["memory_analysis"])
        assert {"flops", "bytes accessed"} <= set(r["cost_analysis"])
        assert r["bound_time_s"] > 0 and r["roofline_fraction"] > 0
    # 40 layers × 7 k-sharded int4 products; the KV gathered per layer
    assert rows["decode"]["kernel_launches"] == {
        "dequant_matmul_packed_int4": 280}
    assert rows["decode"]["collective_counts"] == {"all_gather": 360}
    # whisper's 6 + 6 self-attention layers through B3, 16 microbatches
    assert rows["train"]["n_micro"] == 16
    assert rows["train"]["kernel_launches"] == {"flash_attention": 192}
    for key in FAMILY_TRAIN:
        r = rows[key]
        assert r["status"] == "ok", r.get("traceback")
        assert r["n_micro"] == 1 and r["chips"] == 256
        assert set(FIELDS) <= set(r)
        assert r["bound_time_s"] > 0 and r["roofline_fraction"] > 0
    # 16 q and 16 kv heads over 16 ranks: one and one, through B3 in
    # each of the 48 layers
    assert rows["moe"]["kernel_launches"] == {"flash_attention": 48}
    assert rows["moe"]["collective_counts"] == FAMILY_COLLECTIVES["moe"]
    assert rows["ssm"]["kernel_launches"] == {}
    assert rows["ssm"]["collective_counts"] == FAMILY_COLLECTIVES["ssm"]
    assert rows["ssm"]["trip_counts"] == [4096, 32, 1]
    assert rows["hybrid"]["kernel_launches"] == \
        FAMILY_COLLECTIVES["hybrid_kernels"]
    assert rows["hybrid"]["collective_counts"] == \
        FAMILY_COLLECTIVES["hybrid"]
    assert rows["skip"]["status"] == "skipped"


def test_ssm_train_extrapolation_equals_a_direct_count():
    """rwkv6-7b's train step on the 256-rank mesh, one microbatch: the
    op log extrapolated from 11 and 13 tokens to 17 equals the counter's
    log of the step traced at 17 tokens (counts, FLOPs, bytes and
    collectives; the peak is a model and left out)."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.dist.sharding import use_layout, use_mesh
    from repro_torch.launch.hlo_cost import count_costs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import fsdp_tp_blocks, fsdp_tp_layout
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    cfg = get_config("rwkv6-7b")
    mesh = make_production_mesh()
    lay = fsdp_tp_layout(cfg, mesh)
    state = init_train_state(fsdp_tp_blocks(
        cfg, init_params(cfg, device="meta"), lay))
    batch = dryrun._rank_rows(input_specs(cfg, SHAPES["train_4k"]), mesh)
    step = make_train_step(cfg, AdamWConfig(), n_micro=1)
    with use_mesh(mesh), use_layout(lay):
        got = dryrun._seq_extrapolated(step, state, batch, 17, mesh, ())
        want = count_costs(step, state, {k: v[:, :17]
                                         for k, v in batch.items()},
                           mesh=mesh)
    assert got.oplog["collectives"] == want.oplog["collectives"]
    assert got.oplog["ops"].keys() == want.oplog["ops"].keys()
    for name, row in want.oplog["ops"].items():
        assert got.oplog["ops"][name] == pytest.approx(row, rel=1e-12), name
    assert got.n_ops == want.n_ops
    assert got.argument_bytes == want.argument_bytes
    assert torch.tensor(got.dot_flops).item() == pytest.approx(
        want.dot_flops, rel=1e-12)


def test_reparse_restores_the_fields_bit_for_bit(cells):
    out, rows = cells
    for key in ("decode", "train"):
        tag = dryrun._tag(rows[key]["arch"], rows[key]["shape"], "single",
                          rows[key]["wbits"])
        path = os.path.join(out, tag + ".json")
        with open(path) as f:
            before = json.load(f)
        broken = dict(before, roofline={}, dominant="x", bound_time_s=0.0,
                      roofline_fraction=0.0, n_collectives={})
        with open(path, "w") as f:
            json.dump(broken, f)
        assert reparse.reparse_file(path)
        with open(path) as f:
            assert json.load(f) == before


def test_cli_and_grid_write_cells(tmp_path):
    dryrun.main(["--arch", "paligemma-3b", "--shape", "decode_32k",
                 "--mesh", "multi", "--wbits", "8", "--out", str(tmp_path)])
    with open(tmp_path / "paligemma-3b__decode_32k__multi__w8.json") as f:
        r = json.load(f)
    assert r["status"] == "ok" and r["chips"] == 512
    assert set(r["kernel_launches"]) == {"dequant_matmul_int8"}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.grid", "--mesh", "single",
         "--archs", "rwkv6-7b,whisper-base", "--shapes", "long_500k",
         "--out", str(tmp_path)], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert done.returncode == 0, done.stderr
    with open(tmp_path / "whisper-base__long_500k__single.json") as f:
        assert json.load(f)["status"] == "skipped"
    with open(tmp_path / "rwkv6-7b__long_500k__single.json") as f:
        r = json.load(f)
    assert r["status"] == "ok", r.get("traceback")
    assert r["kind"] == "decode"
    assert "grid: 2 cells" in done.stdout
