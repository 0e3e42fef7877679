"""Architecture registry: ``--arch <id>`` resolution (reference:
``repro/configs``; the ten published configurations, number for number)."""
from ..models.config import SHAPE_BY_NAME, SHAPES, ArchConfig, ShapeCfg

from . import (deepseek_v3_671b, granite_34b, hubert_xlarge, mamba2_2_7b,
               minicpm_2b, moonshot_v1_16b_a3b, nemotron_4_15b, qwen1_5_110b,
               qwen2_vl_72b, zamba2_2_7b)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (deepseek_v3_671b, moonshot_v1_16b_a3b, granite_34b,
              nemotron_4_15b, qwen1_5_110b, minicpm_2b, qwen2_vl_72b,
              mamba2_2_7b, zamba2_2_7b, hubert_xlarge)
}


def get_arch(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return ARCHS[name[: -len("-smoke")]].smoke()
    return ARCHS[name]
