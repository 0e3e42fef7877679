"""hubert-xlarge [audio] — arXiv:2106.07447 (unverified tier).

48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504 — encoder-only masked
prediction over codebook targets; the CNN waveform frontend is a stub per
the assignment (input_specs provides precomputed frame embeddings).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    encoder_only=True,
    frontend="audio",
    act="gelu",
    gated_ffn=False,
)
