"""Serving substrate: prefill/decode step builders + batched engine."""

from .engine import Engine, GenerationResult, make_decode_step, make_prefill_step

__all__ = ["Engine", "GenerationResult", "make_decode_step", "make_prefill_step"]
