"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216 — SigLIP frontend STUB (input_specs provides patch
embeddings); gemma backbone with prefix-LM mask. [arXiv:2407.07726; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, d_ff=16384, vocab=257216,
    head_dim=256, activation="gelu", gated_mlp=True, embed_scale=True,
    prefix_tokens=256, frontend="vision",
    source="arXiv:2407.07726; hf",
))
