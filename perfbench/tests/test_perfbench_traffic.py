"""Inputs are a function of the seed alone: the same seed gives the same
prompts, weights and Σ_X, another seed others; seeds past 32 bits and
negative seeds are taken."""
import numpy as np
import pytest
import torch

from perfbench import inputs

from .small import ptq_arch, serve_arch

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 3, 2 ** 40 + 1, -5])
def test_prompts_are_the_seeds(seed):
    a = inputs.prompt(seed, 3, 1, 32, 152064)
    b = inputs.prompt(seed, 3, 1, 32, 152064)
    assert np.array_equal(a, b) and a.dtype == np.int32
    assert not np.array_equal(a, inputs.prompt(seed + 1, 3, 1, 32, 152064))
    assert not np.array_equal(a, inputs.prompt(seed, 4, 1, 32, 152064))
    assert a.min() >= 0 and a.max() < 152064


def test_dense_layers_are_the_seeds():
    arch = serve_arch()
    a = inputs.dense_layer(arch, 11, 1, CPU)
    b = inputs.dense_layer(arch, 11, 1, CPU)
    c = inputs.dense_layer(arch, 11, 0, CPU)
    assert torch.equal(a["attn"]["wq"]["w"], b["attn"]["wq"]["w"])
    assert not torch.equal(a["attn"]["wq"]["w"], c["attn"]["wq"]["w"])
    assert "b" in a["attn"]["wk"] and "b" not in a["attn"]["wo"]
    shared = inputs.dense_shared(arch, 11, CPU)
    assert shared["embed"]["w"].shape == (arch.padded_vocab, arch.d_model)


def test_ptq_inputs_are_the_seeds():
    arch = ptq_arch()
    mats = inputs.ptq_matrices(arch)
    assert [m[1] for m in mats[:7]] == ["wq", "wk", "wv", "wo", "w_gate",
                                        "w_up", "w_out"]
    kw = dict(tokens=256, decay=1.0, scale_sigma=0.5, dead_share=0.05)
    s1 = inputs.ptq_sigma(5, 0, "mlp_act", 128, CPU, **kw)
    s2 = inputs.ptq_sigma(5, 0, "mlp_act", 128, CPU, **kw)
    assert torch.equal(s1, s2)
    d = torch.diagonal(s1)
    assert int((d == 0).sum()) == round(0.05 * 128)
    w = inputs.ptq_weight(5, 0, 6, (64, 128), CPU)
    assert torch.equal(w, inputs.ptq_weight(5, 0, 6, (64, 128), CPU))
