"""minicpm-2b [dense] — arXiv:2404.06395 (hf-verified).

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753 — llama-like with
depth-scaled residuals; WSD LR schedule implemented in repro_torch.optim.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    residual_scale=1.4 / (40 ** 0.5),   # scale_depth / sqrt(L)
    rope_theta=1e4,
)
