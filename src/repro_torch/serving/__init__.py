"""Serving: the token engine (continuous batching over decode slots)."""
from repro_torch.serving.engine import Engine, Request  # noqa: F401
