"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40) d_ff=27392
vocab=152064 — QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=40, d_ff=27392, vocab=152064,
    qkv_bias=True, activation="silu", gated_mlp=True,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
))
