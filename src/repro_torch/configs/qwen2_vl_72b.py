"""qwen2-vl-72b [vlm] — arXiv:2409.12191 (hf-verified).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 — M-RoPE (sectioned
t/h/w rotary), dynamic resolution.  Backbone only: the vision frontend is a
stub per the assignment (input_specs provides precomputed patch embeddings).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    mrope=True,
    frontend="vision",
    rope_theta=1e6,
)
