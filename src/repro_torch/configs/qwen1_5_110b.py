"""qwen1.5-110b [dense] — hf:Qwen/Qwen1.5 family (hf-verified).

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064 — QKV bias.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
)
