"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6 (kimi/moonlight).
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv=16, d_ff=1408, vocab=163840,
    n_experts=64, top_k=6, activation="silu", gated_mlp=True,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
))
