"""deepseek-v3-671b [moe] — arXiv:2412.19437 (hf-verified).

61L d_model=7168 128H d_ff=2048(expert) vocab=129280, MoE 256e top-8,
1 shared expert, MLA (q_lora 1536 / kv_lora 512 / nope 128 / rope 64 /
v_head 128), 3 leading dense layers (dense d_ff 18432), MTP depth 1.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,               # dense layers (first 3)
    vocab=129280,
    n_experts=256,
    experts_per_token=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=3,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mtp=True,
    rope_theta=1e4,
)
