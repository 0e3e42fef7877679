"""Megakernel: fused chain evaluation of a stream of sorted intervals."""
from .ops import fused_chain_eval
from .ref import fused_chain_eval_ref, fused_chain_stream_ref

__all__ = ["fused_chain_eval", "fused_chain_eval_ref",
           "fused_chain_stream_ref"]
