"""Model zoo on PyTorch: dense/MoE/MLA transformers, Mamba2 SSD, hybrid,
encoder (reference: ``repro/models``)."""
from .config import (SHAPE_BY_NAME, SHAPES, ArchConfig, ShapeCfg,
                     cell_is_applicable)
from .model import (decode_step, decode_step_, forward, init_cache,
                    init_params, layer_plan, loss_fn, meta_cache, meta_params)
