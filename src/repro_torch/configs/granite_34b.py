"""granite-34b [dense] — arXiv:2405.04324 (hf-verified).

88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152 — code model.
Non-gated GELU MLP (the published 34B total only reconciles with the
GPTBigCode-style 2·d·d_ff MLP, not a gated SwiGLU); MQA per the assignment.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    act="gelu",
    gated_ffn=False,
    rope_theta=1e4,
)
