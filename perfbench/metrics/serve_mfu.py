"""serve_mfu (%): the operations the window's decode steps need (2 per
linear and unembedding parameter per token, plus attention over each
slot's live positions) per second of window, against the bf16 peak."""
from perfbench import inputs, peaks


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    arch = run.arch
    linear = arch.n_layers * sum(i * o for _, _, (i, o)
                                 in inputs.dense_layer_shapes(arch))
    flops = peaks.dense_step_flops(linear, arch.vocab * arch.d_model,
                                   run.tokens, run.attn_live_positions,
                                   arch.n_heads, arch.resolved_head_dim)
    return 100.0 * flops / run.window_s / peaks.BF16_FLOPS
