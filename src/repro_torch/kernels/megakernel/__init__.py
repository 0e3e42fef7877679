"""Megakernel: fused chain evaluation of one sorted interval."""
from .ops import fused_chain_eval
from .ref import fused_chain_eval_ref

__all__ = ["fused_chain_eval", "fused_chain_eval_ref"]
