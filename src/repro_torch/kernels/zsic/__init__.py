from .ops import zsic_block, zsic_quantize
from .ref import zsic_block_ref
from .zsic_block import MAX_BLOCK, reset_launches, zsic_block_cuda

__all__ = ["MAX_BLOCK", "reset_launches", "zsic_block", "zsic_block_cuda",
           "zsic_block_ref", "zsic_quantize"]
