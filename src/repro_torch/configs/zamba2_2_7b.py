"""zamba2-2.7b [hybrid] — arXiv:2411.15242 (hf-verified).

54L d_model=2560 (Mamba2 blocks) + shared attention block (32H, kv 32,
MLP d_ff=10240) applied every 6 SSM layers with shared weights;
ssm_state=64, vocab=32000.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    attn_every=6,
    shared_attn_d_ff=10240,
)
