"""minicpm-2b [dense]: 40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753.
WSD LR schedule (arch llama-like). [arXiv:2404.06395; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv=36, d_ff=5760, vocab=122753,
    activation="silu", gated_mlp=True, lr_schedule="wsd",
    source="arXiv:2404.06395; hf",
))
