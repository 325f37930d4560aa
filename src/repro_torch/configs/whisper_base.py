"""whisper-base [audio]: 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865.
Enc-dec; conv frontend is a STUB (input_specs provides frame embeddings).
[arXiv:2212.04356; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv=8, d_ff=2048, vocab=51865,
    qkv_bias=True, out_bias=True, activation="gelu", gated_mlp=False,
    norm="layernorm", tie_embeddings=True,
    enc_layers=6, enc_seq=1500, frontend="audio",
    source="arXiv:2212.04356; unverified",
))
