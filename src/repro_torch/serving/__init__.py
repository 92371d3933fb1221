"""Serving entry points of the port (prefill also on a mesh)."""

from .serve import greedy_generate, make_prefill_step, make_serve_step

__all__ = ["make_serve_step", "make_prefill_step", "greedy_generate"]
