"""Small stand-ins of the two cells for the CPU tests: the published
families at widths the quantizer takes (every matrix at least 64 wide),
and traffic cut to a few slots and tokens."""
import dataclasses

from perfbench import harness

SERVE = "qwen2.5-32b.decode-128"
#: prepared (``perfbench/prepared/``), not in BENCHMARK.json yet
PTQ = "minicpm-2b.ptq-w3"


def with_prepared(man, name):
    """``man`` with the entries of ``perfbench/prepared/<name>.json``
    added: a cell whose files are here but which ``BENCHMARK.json`` does
    not list yet, run by these tests alone."""
    extra = harness.load_json(harness.BENCH / "prepared" / f"{name}.json")
    return {k: v + extra.get(k, []) if isinstance(v, list) else v
            for k, v in man.items()}


def manifest():
    """BENCHMARK.json with the prepared PTQ cell added."""
    return with_prepared(harness.manifest(), PTQ)


def serve_arch():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen2.5-32b").reduced(),
                               d_model=128, head_dim=32, d_ff=256)


def serve_traffic(**kw):
    t = harness.load_json(harness.BENCH / "traffic" / "decode-128.json")
    return {**t, "n_slots": 4, "clients": 4, "max_len": 40, "prompt_len": 8,
            "max_new_tokens": 24, "prefill_chunk": 8, "admit_burst": 2,
            "check_requests": 3, "trace_seconds": 0.3, **kw}


def ptq_arch():
    from repro_torch.configs import get_config
    return get_config("minicpm-2b").reduced()


def ptq_traffic(**kw):
    t = harness.load_json(harness.BENCH / "traffic" / "ptq-w3.json")
    return {**t, "calib_tokens": 512, "check_matrices": 3,
            "trace_seconds": 0.3, **kw}


def run(cell, seed=12345678901, seconds=0.5, trace=False, root=None,
        like=None, **kw):
    """One run of ``cell`` at the small size of ``like`` (the cell itself
    by default)."""
    import torch
    small = {SERVE: (serve_arch, serve_traffic), PTQ: (ptq_arch, ptq_traffic)}
    arch, traffic = small[like or cell]
    extra = {"man": manifest()} if root is None else {"root": root}
    return harness.run_cell(cell, seed, seconds, trace,
                            device=torch.device("cpu"), arch=arch(),
                            traffic=traffic(**kw), **extra)
