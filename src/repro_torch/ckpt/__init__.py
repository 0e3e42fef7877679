"""Snapshots of the streaming service (the reference's ``repro/ckpt``)."""
from .checkpoint import (checkpoint_steps, latest_step, latest_valid_step,
                         load_checkpoint, prune_checkpoints,
                         read_manifest_meta, reshard, save_checkpoint,
                         verify_checkpoint)
