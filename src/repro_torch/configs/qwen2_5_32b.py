"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — GQA + QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=8, d_ff=27648, vocab=152064,
    qkv_bias=True, activation="silu", gated_mlp=True, rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
))
