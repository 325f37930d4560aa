"""repro_torch.models — the dense decoder of the serving path."""
from .convert import from_jax_params
from .transformer import (DecodeCache, cache_reset_slot, cache_write_slot,
                          decode_chunk, decode_step, init_cache, init_params,
                          split_layers)

__all__ = ["DecodeCache", "cache_reset_slot", "cache_write_slot",
           "decode_chunk", "decode_step", "from_jax_params", "init_cache",
           "init_params", "split_layers"]
