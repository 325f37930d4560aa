from .flash_attention import HEAD_DIMS, flash_attention_cuda, reset_launches
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["HEAD_DIMS", "attention_ref", "flash_attention",
           "flash_attention_cuda", "reset_launches"]
