"""Tensor-parallel k-sharded serving on 4 gloo ranks (DESIGN.md §13).

One spawned launch of 4 rank processes (``launch.mesh.launch_ranks``,
joined under a timeout) serves every job below on its local view of a
4-way sharded tree; each rank's token streams must equal, bit for bit,
the single-process oracle's over the same sharded tree
(``serve.run_oracle``): the reference mesh test's six trees (fp, int8,
int4, int3, int2, a crc32 format mix) on its staggered arrivals, with the
KV buffer sharded (max_len 16) and replicated (max_len 18); device-loss
chaos recovered equal to the clean mesh run; a clean collective audit;
obs on and off; a request whose deadline expires at the same step on
every rank.  Then the serve driver's ``--mesh`` run through
``benchmarks/check_mesh.py``, and the launcher's failure paths (a rank's
exception re-raised, a hung rank killed at the timeout).  The reference's
own mesh tests are red on the installed JAX (ROADMAP queue C); the port's
oracle is held against the reference's in tests/test_torch_sharding.py.
"""
import functools
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one intra-op thread, for the ranks too)
from repro_torch.configs.base import ArchConfig
from repro_torch.dist.fault import RestartPolicy
from repro_torch.launch.mesh import launch_ranks
from repro_torch.models import init_params
from repro_torch.quant import quantize_params_tree
from repro_torch.serve import (EngineConfig, MeshJob, ResilienceConfig,
                               run_oracle, serve_mesh_jobs,
                               shard_params_tree)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ArchConfig(name="m", family="dense", n_layers=2, d_model=32, n_heads=2,
                 n_kv=2, d_ff=64, vocab=64, head_dim=16)
TREES = ("fp", "int8", "int4", "int3", "int2", "mixed")
RANKS = 4
TIMEOUT_S = 120.0
#: (max_len, KV buffer sharded over the 4 ranks?)
LAYOUTS = ((16, True), (18, False))


def mixed_bits(path):
    return [2, 3, 4, 8][zlib.crc32("/".join(path).encode()) % 4]


def work():
    """The reference mesh script's staggered arrivals."""
    rng = np.random.default_rng(3)
    return [(0, 0, rng.integers(0, CFG.vocab, 5).astype(np.int32), 4, None),
            (0, 1, rng.integers(0, CFG.vocab, 7).astype(np.int32), 3, None),
            (1, 2, rng.integers(0, CFG.vocab, 4).astype(np.int32), 5, None),
            (3, 3, rng.integers(0, CFG.vocab, 6).astype(np.int32), 4, None)]


@functools.lru_cache(maxsize=None)
def _trees():
    params = init_params(CFG, 0, device="cpu")
    trees = {
        "fp": params,
        "int8": quantize_params_tree(params, min_dim=16),
        "int4": quantize_params_tree(params, nbits=4, packed=True,
                                     min_dim=16),
        "int3": quantize_params_tree(params, nbits=3, min_dim=16),
        "int2": quantize_params_tree(params, nbits=2, min_dim=16),
        "mixed": quantize_params_tree(params, min_dim=16,
                                      nbits_by_path=mixed_bits)}
    return {k: shard_params_tree(v, RANKS, min_dim=16)
            for k, v in trees.items()}


def _jobs():
    trees = _trees()
    jobs = [MeshJob(f"{name}-{max_len}", CFG, trees[name],
                    EngineConfig(n_slots=2, max_len=max_len, prefill_chunk=4),
                    work())
            for name in TREES for max_len, _ in LAYOUTS]

    def retry():
        return EngineConfig(n_slots=2, max_len=16, prefill_chunk=4,
                            resilience=ResilienceConfig(retry=RestartPolicy(
                                max_restarts=8, backoff_base_s=0.0,
                                reset_after=4)))
    # seeded_plan("device-loss", 0) kills serve.decode dispatches 12 and
    # 20: 6 requests of 4 + 10 tokens on 2 slots make 27
    rng = np.random.default_rng(5)
    long_work = [(0, i, rng.integers(0, CFG.vocab, 4).astype(np.int32), 10,
                  None) for i in range(6)]
    jobs += [MeshJob("chaos-clean", CFG, trees["int3"], retry(), long_work),
             MeshJob("chaos-device-loss", CFG, trees["int3"], retry(),
                     long_work, chaos=("device-loss", 0))]
    # with obs on, the int4-16 job again (its run above has obs off)
    jobs.append(MeshJob("obs-on", CFG, trees["int4"], EngineConfig(
        n_slots=2, max_len=16, prefill_chunk=4), work(), obs=True))
    # request 0 (12 tokens) expires after a few 4-rank steps on rank 0's
    # clock; the others have no deadline
    long = [(0, 0, work()[2][2], 12, 0.05)] + [w for w in work()[1:]]
    jobs.append(MeshJob("deadline", CFG, trees["int4"], EngineConfig(
        n_slots=2, max_len=16, prefill_chunk=4,
        resilience=ResilienceConfig()), long))
    return jobs


_LAUNCH = {}


def _mesh():
    """{job name: [rank 0's record, …, rank 3's]} of one 4-rank launch,
    made once per module: a failed launch is kept and re-raised too, so
    it costs one launch, not one per test."""
    if not _LAUNCH:
        jobs = _jobs()
        try:
            ranks = launch_ranks(serve_mesh_jobs, RANKS, (jobs, RANKS),
                                 timeout_s=TIMEOUT_S)
            _LAUNCH["ok"] = {j.name: [r[i] for r in ranks]
                             for i, j in enumerate(jobs)}
        except Exception as e:
            _LAUNCH["err"] = e
    if "err" in _LAUNCH:
        raise _LAUNCH["err"]
    return _LAUNCH["ok"]


@functools.lru_cache(maxsize=None)
def _oracle(name):
    job = next(j for j in _jobs() if j.name == name)
    return run_oracle(job)


@pytest.mark.parametrize("max_len,sharded", LAYOUTS)
@pytest.mark.parametrize("tree", TREES)
def test_mesh_streams_equal_the_oracle(tree, max_len, sharded):
    """Every rank serves the oracle's streams bit for bit, with the KV
    buffer sharded over the ranks (16 slots) or replicated (18)."""
    name = f"{tree}-{max_len}"
    want = _oracle(name)
    assert sorted(want["streams"]) == [0, 1, 2, 3]
    assert all(want["streams"].values())
    for r in _mesh()[name]:
        assert r["streams"] == want["streams"], (r["rank"], name)
        assert r["cache_sharded"] == [sharded]
        assert r["weight_bytes"] < want["weight_bytes"] or tree == "fp"


def test_mesh_device_loss_recovered_equal_to_clean():
    """Seeded device-loss faults kill decode dispatches on every rank at
    the same index; the retry policy replays them and the recovered
    streams equal the fault-free mesh run's (and the oracle's)."""
    runs = _mesh()
    clean = runs["chaos-clean"][0]["streams"]
    assert clean == _oracle("chaos-clean")["streams"]
    assert sorted(clean) == list(range(6))
    for r in runs["chaos-clean"] + runs["chaos-device-loss"]:
        assert r["streams"] == clean, r["rank"]
    assert [r["faults"] for r in runs["chaos-clean"]] == [0] * RANKS
    assert [r["faults"] for r in runs["chaos-device-loss"]] == [2] * RANKS


def test_mesh_collective_audit_is_clean():
    """No integer all-gather (no weight byte crosses ranks); the float
    partial and K/V gathers are there, and one clock broadcast per step."""
    for name, ranks in _mesh().items():
        for r in ranks:
            assert r["integer_allgathers"] == [], (name, r["rank"])
            assert r["allgathers"] > 0 and r["allgather_dtypes"] \
                == ["float32"], (name, r["rank"])
            assert r["broadcasts"] > 0
            assert r["backend"] == "gloo" and r["staging"] == "none"
    from repro_torch.serve import integer_allgathers
    assert integer_allgathers([("all_gather", "uint8", (4, 8, 16), 512),
                               ("all_gather", "int32", (4,), 16),
                               ("all_gather", "float32", (4, 8), 128)]) \
        == ["all_gather uint8[4, 8, 16] 512 B"]


def test_mesh_obs_parity():
    """obs records, never steers: equal streams off and on; one mesh
    dispatch counted per engine device call and one compile span per
    (tag, cache and token shapes) key, as in the reference."""
    runs = _mesh()
    for off, on in zip(runs["int4-16"], runs["obs-on"]):
        assert on["streams"] == off["streams"]
        c = on["counters"]
        dispatches = sum(v for k, v in c.items()
                         if k.startswith("repro_serve_mesh_dispatch_total"))
        compiles = sum(v for k, v in c.items()
                       if k.startswith("repro_serve_mesh_compile_total"))
        assert dispatches == on["decode_calls"] + on["prefill_calls"]
        assert 'repro_serve_mesh_compile_total{tag="step"}' in c
        assert len(on["compile_spans"]) == compiles >= 2
        for span in on["compile_spans"]:
            assert span["shards"] == RANKS
            assert span["tag"] in ("step", "chunk")
        assert c['repro_serve_finished_total{engine="continuous"}'] == 4
        assert "counters" not in off


def test_mesh_deadline_expires_alike_on_every_rank():
    """Deadlines run on rank 0's clock, broadcast each step: the expired
    request is dropped at the same step (same partial stream length) and
    every other stream is the same on every rank."""
    ranks = _mesh()["deadline"]
    first = ranks[0]
    assert [d[:2] for d in first["dropped"]] == [(0, "deadline")]
    assert sorted(first["streams"]) == [1, 2, 3]
    for r in ranks[1:]:
        assert r["dropped"] == first["dropped"]
        assert r["streams"] == first["streams"]


def test_serve_driver_mesh_passes_check_mesh(tmp_path):
    """``launch.serve --mesh --ranks 4 --device cpu --mesh-json`` and the
    stdlib gate ``benchmarks/check_mesh.py`` on its JSON, unchanged."""
    from repro_torch.launch import serve
    path = tmp_path / "mesh.json"
    meshed = serve.main(["--arch", "minicpm-2b", "--reduced", "--wbits", "4",
                         "--continuous", "--requests", "3", "--max-new", "4",
                         "--mesh", "--ranks", str(RANKS), "--device", "cpu",
                         "--mesh-json", str(path)])
    assert len(meshed) == 3
    data = json.loads(path.read_text())
    assert data["identical"] and data["shards"] == RANKS
    res = subprocess.run([sys.executable,
                          os.path.join(ROOT, "benchmarks", "check_mesh.py"),
                          str(path)], capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "check_mesh: OK" in res.stdout


def _fail_on_rank_1(rank):
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank one fails")
    dist.barrier()               # waits for rank 1, which never comes
    return rank


def _hang_on_rank_1(rank):
    if rank == 1:
        time.sleep(3600)
    return rank


def test_launch_ranks_reraises_and_kills_at_the_timeout():
    """A rank's exception reaches the caller (the rank stuck in a
    collective is killed); a hung rank is killed at the timeout."""
    with pytest.raises(ValueError, match="rank one fails") as err:
        launch_ranks(_fail_on_rank_1, 2, timeout_s=60)
    assert any("raised on rank 1 of 2" in n for n in err.value.__notes__)
    t0 = time.monotonic()
    # rank 1 hangs; on a loaded host rank 0 may still be starting too
    with pytest.raises(TimeoutError, match=r"ranks \[(0, )?1\] of 2"):
        launch_ranks(_hang_on_rank_1, 2, timeout_s=5)
    assert time.monotonic() - t0 < 30


@pytest.mark.cuda
def test_device_mailboxes_gather_like_gloo():
    """Ranks sharing the one card gather through CUDA-IPC mailboxes
    (``staging == "device"``): the same stacked and tiled results as the
    host gather, over shapes that grow the mailboxes."""
    from _torch_parity import require_cuda
    require_cuda()
    if torch.cuda.device_count() != 1:
        pytest.skip("the mailboxes serve ranks that share one card")
    out = launch_ranks(_gather_rank, 2, device="cuda", timeout_s=120)
    assert out == [True, True]


def _gather_rank(rank):
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model_parallel=2, device="cuda")
    assert mesh.staging == "device"
    ok = True
    for shape in ((8, 5), (3, 1 << 19), (8, 5), (2, 7, 3)):
        g = torch.Generator().manual_seed(rank * 100 + len(shape))
        x = torch.randn(shape, generator=g)
        want = [torch.randn(shape, generator=torch.Generator().manual_seed(
            r * 100 + len(shape))) for r in range(2)]
        for tiled, dim in ((False, 0), (True, 1)):
            got = mesh.all_gather(x.cuda(), "model", dim, tiled).cpu()
            ref = torch.cat(want, dim) if tiled else torch.stack(want, dim)
            ok = ok and torch.equal(got, ref)
    mesh.close()
    return ok
