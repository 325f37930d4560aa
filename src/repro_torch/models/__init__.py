"""repro_torch.models — the dense decoder: serving and evaluation paths."""
from .convert import (from_jax_calib_stats, from_jax_params,
                      from_jax_quantized_linear)
from .transformer import (DecodeCache, cache_reset_slot, cache_write_slot,
                          decode_chunk, decode_step, forward_train,
                          init_cache, init_params, loss_fn, split_layers)

__all__ = ["DecodeCache", "cache_reset_slot", "cache_write_slot",
           "decode_chunk", "decode_step", "forward_train",
           "from_jax_calib_stats", "from_jax_params",
           "from_jax_quantized_linear",
           "init_cache", "init_params", "loss_fn", "split_layers"]
