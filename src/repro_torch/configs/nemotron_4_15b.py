"""nemotron-4-15b [dense] — arXiv:2402.16819 (unverified tier).

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000 — squared-ReLU,
non-gated MLP.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    act="relu2",
    gated_ffn=False,
    rope_theta=1e4,
)
