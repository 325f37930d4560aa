"""The yardstick's arithmetic reproduces the bounds PERF.md's kernel
table gives, and counts a step's and a quantization's work from shapes."""
import pytest

from perfbench import inputs, peaks


@pytest.mark.parametrize("m,k,n,us", [(256, 2304, 2304, 8.24),
                                      (128, 5120, 27648, 109.93),
                                      (256, 2304, 5760, 20.61)])
def test_b1_bound_matches_the_kernel_table(m, k, n, us):
    assert round(peaks.b1_bound_s(m, k, n) * 1e6, 2) == us


def test_b1_bound_at_decode_is_bytes():
    # m = 8: the payload dominates, 2304 x 2304 int4 = 2.65 MB
    t = peaks.b1_bound_s(8, 2304, 2304)
    assert t == pytest.approx((2304 * 1152 + 4 * 8 * 2304 + 4 * 4608
                               + 4 * 8 * 2304) / peaks.HBM_BYTES_S)


def test_qwen_decode_step_operations():
    from repro_torch.configs import get_config
    arch = get_config("qwen2.5-32b")
    linear = arch.n_layers * sum(i * o for _, _, (i, o)
                                 in inputs.dense_layer_shapes(arch))
    flops = peaks.dense_step_flops(linear, arch.vocab * arch.d_model, 128,
                                   0, arch.n_heads, arch.resolved_head_dim)
    assert 8.1e12 < flops < 8.3e12          # 2 · 32.0 G params · 128 tokens


def test_watersic_least_work():
    assert peaks.watersic_least_flops(2304, 2304) == pytest.approx(
        2304 ** 3 * (1 + 1 / 3))
