"""The import guard: no module of JAX or of the JAX package may be loaded.

Names are compared by their top-level part whole (the part before the first
dot), so the port's ``repro_torch`` is not taken for the JAX package
``repro``.
"""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def top_levels(modules) -> set:
    return {m.split(".")[0] for m in modules}


def forbidden_loaded() -> list:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted(top_levels(list(sys.modules)) & set(FORBIDDEN))
