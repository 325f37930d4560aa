"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, pattern 1 attn per 2 recurrent.
[arXiv:2402.19427; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv=1, d_ff=7680, vocab=256000,
    head_dim=256, activation="gelu", gated_mlp=True, embed_scale=True,
    block_pattern=("rec", "rec", "attn"), local_window=2048, lru_width=2560,
    conv_width=4, subquadratic=True,
    source="arXiv:2402.19427; hf",
))
