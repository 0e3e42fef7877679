"""moonshot-v1-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B (hf-verified).

48L d_model=2048 16H (GQA kv=16) d_ff=1408(expert) vocab=163840,
MoE 64e top-6 + 2 shared experts, first layer dense (d_ff 11264).

Note: the assignment pins 48 layers (the HF checkpoint has 27); we follow
the assignment, which yields 28.4B total / 4.8B active params.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,               # dense first layer
    vocab=163840,
    n_experts=64,
    experts_per_token=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=5e4,
)
