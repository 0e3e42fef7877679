"""mamba2-2.7b [ssm] — arXiv:2405.21060 (unverified tier).

64L d_model=2560 (attention-free) vocab=50280, ssm_state=128 — SSD
(state-space duality), chunked scan, expand 2, head_dim 64.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
)
