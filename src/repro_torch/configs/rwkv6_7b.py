"""rwkv6-7b [ssm]: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536 —
Finch, data-dependent decay. [arXiv:2404.05892; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv=64, d_ff=14336, vocab=65536,
    wkv_head_dim=64, decay_lora=64, subquadratic=True,
    source="arXiv:2404.05892; hf",
))
