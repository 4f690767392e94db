"""Serving: greedy generation and the continuous-batching engine."""

from repro_torch.serve.engine import ServeEngine, greedy_generate

__all__ = ["ServeEngine", "greedy_generate"]
