"""repro_torch.models — the models of the dense, MoE, ssm (RWKV6), hybrid
(RG-LRU), encoder–decoder and prefix-LM families: serving and evaluation
paths."""
from . import rglru, rwkv6
from .convert import (from_jax_calib_stats, from_jax_params,
                      from_jax_params_by_layer, from_jax_quantized_linear)
from .transformer import (DecodeCache, FsdpTpLayout, cache_reset_slot,
                          cache_rows, fsdp_tp_blocks, fsdp_tp_gather,
                          fsdp_tp_layout,
                          cache_write_slot, capture_cross_kv, decode_chunk,
                          decode_layers, decode_step, encode, forward_train,
                          expert_specs, init_cache, init_layer_params,
                          init_params, init_shared_params, layer_kv,
                          loss_fn, param_axes, param_specs_tree, prefill,
                          prefill_layers, split_layers)

__all__ = ["DecodeCache", "FsdpTpLayout", "fsdp_tp_blocks", "fsdp_tp_gather",
           "fsdp_tp_layout", "cache_reset_slot", "cache_rows", "cache_write_slot",
           "capture_cross_kv", "decode_chunk", "decode_layers", "decode_step",
           "encode", "expert_specs", "forward_train",
           "from_jax_calib_stats", "from_jax_params",
           "from_jax_params_by_layer",
           "from_jax_quantized_linear",
           "init_cache", "init_layer_params", "init_params",
           "init_shared_params", "layer_kv", "loss_fn", "param_axes",
           "param_specs_tree", "prefill",
           "prefill_layers", "rglru", "rwkv6", "split_layers"]
