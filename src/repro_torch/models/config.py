"""Architecture configuration system (reference: ``repro/models/config.py``).

One ``ArchConfig`` per assigned architecture (exact public-literature
numbers live in ``repro_torch.configs.<id>``), plus reduced smoke variants
and the four input-shape cells each architecture pairs with.  Pure data: the
port keeps its own copy, field for field, so ``param_count`` and
``active_param_count`` are the reference's arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention details
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    mrope: bool = False         # Qwen2-VL sectioned (t,h,w) RoPE
    encoder_only: bool = False

    # activation / ffn
    act: str = "silu"           # silu (gated) | relu2 (non-gated) | gelu
    gated_ffn: bool = True

    # residual scaling (MiniCPM depth-scaled residuals)
    residual_scale: float = 1.0

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0  # leading dense layers in MoE stacks

    # MLA (DeepSeek-V3)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # Multi-token prediction (DeepSeek-V3 MTP)
    mtp: bool = False

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    attn_every: int = 0          # hybrid: shared attn block every k ssm layers
    shared_attn_d_ff: int = 0    # zamba2 shared block MLP width

    # modality frontend stub
    frontend: str = ""           # "" | "audio" | "vision"

    # numerics
    norm_eps: float = 1e-5

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (attention-free or hybrid)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs accounting)."""
        d, v = self.d_model, self.vocab
        total = v * d  # embed
        if not self.encoder_only:
            total += d * v  # lm head
        for layer in range(self.n_layers):
            total += self._layer_params(layer)
        if self.family == "hybrid" and self.attn_every:
            total += self._attn_params() + 2 * d * self.shared_attn_d_ff
        if self.mtp:
            total += self._layer_params(self.n_layers - 1) + 2 * d * d
        return total

    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla:
            q = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.qk_rope_dim)
            kv = d * (self.kv_lora_rank + self.qk_rope_dim) \
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim
                                                      + self.v_head_dim)
            o = self.n_heads * self.v_head_dim * d
            return q + kv + o
        hd = self.hd
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d

    def _ffn_params(self, d_ff: int) -> int:
        mult = 3 if self.gated_ffn else 2
        return mult * self.d_model * d_ff

    def _ssm_params(self) -> int:
        d, di, ds = self.d_model, self.d_inner, self.ssm_state
        n_groups = 1
        in_proj = d * (2 * di + 2 * n_groups * ds + self.ssm_heads)
        conv = 4 * (di + 2 * n_groups * ds)
        extra = 3 * self.ssm_heads  # A_log, D, dt_bias
        out = di * d
        return in_proj + conv + extra + out + di

    def _layer_params(self, layer: int) -> int:
        if self.family == "ssm":
            return self._ssm_params()
        if self.family == "hybrid":
            return self._ssm_params()
        ffn = (self._ffn_params(self.d_ff)
               if (not self.is_moe or layer < self.first_dense_layers)
               else (self.n_experts + self.n_shared_experts)
               * self._ffn_params(self.moe_d_ff) // 1)
        return self._attn_params() + ffn

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed-to experts count)."""
        if not self.is_moe:
            return self.param_count()
        d, v = self.d_model, self.vocab
        total = v * d + d * v
        for layer in range(self.n_layers):
            if layer < self.first_dense_layers:
                ffn = self._ffn_params(self.d_ff)
            else:
                ffn = (self.experts_per_token + self.n_shared_experts) \
                    * self._ffn_params(self.moe_d_ff)
            total += self._attn_params() + ffn
        return total

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(4, self.n_kv_heads if self.n_kv_heads else 4)),
            head_dim=16,
            d_ff=128,
            vocab=256,
            n_experts=8 if self.is_moe else 0,
            experts_per_token=2 if self.is_moe else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_d_ff=32 if self.is_moe else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            q_lora_rank=32 if self.mla else 0,
            kv_lora_rank=16 if self.mla else 0,
            qk_nope_dim=16 if self.mla else 0,
            qk_rope_dim=8 if self.mla else 0,
            v_head_dim=16 if self.mla else 0,
            ssm_state=16 if self.is_ssm else 0,
            ssm_head_dim=16 if self.is_ssm else 64,
            ssm_chunk=16 if self.is_ssm else 128,
            attn_every=2 if self.family == "hybrid" else 0,
            shared_attn_d_ff=128 if self.family == "hybrid" else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeCfg, ...] = (
    ShapeCfg("train_4k", 4_096, 256, "train"),
    ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    ShapeCfg("decode_32k", 32_768, 128, "decode"),
    ShapeCfg("long_500k", 524_288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def cell_is_applicable(cfg: ArchConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """The assignment's own skip rules (documented in DESIGN.md §5)."""
    if shape.kind == "decode" and cfg.encoder_only:
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k requires sub-quadratic attention"
    return True, ""
