"""Optimizer, LR schedules and gradient compression on PyTorch (reference:
``repro/optim``)."""
from .adamw import AdamWConfig, adamw_init, adamw_update, adamw_update_
from .schedule import wsd_schedule, cosine_schedule
from .compress import compress_int8, decompress_int8, compressed_psum
