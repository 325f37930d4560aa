"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000 — pruned nemotron (relu² MLP, untied embeddings in the
original; we keep the brief's dims). [arXiv:2407.14679; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=16384, vocab=256000,
    activation="relu2", gated_mlp=False,
    source="arXiv:2407.14679; hf",
))
