"""Acceleration layer: provider registry (≙ runmat-accelerate-api registry,
crates/runmat-accelerate-api/src/lib.rs provider registry + tests :3728-3848).

One active engine per process (the reference supports per-device provider
tables; multi-device work is expressed through jax.sharding inside the single
engine rather than through multiple providers)."""

from __future__ import annotations

from typing import Optional

_ENGINE = None


def active_engine():
    return _ENGINE


def set_engine(engine) -> None:
    global _ENGINE
    _ENGINE = engine


def init_engine(platform: Optional[str] = None, **kwargs):
    """Create and activate the jax engine (idempotent)."""
    global _ENGINE
    if _ENGINE is None:
        from .engine import JaxEngine
        _ENGINE = JaxEngine(platform=platform, **kwargs)
    return _ENGINE


def reset_engine() -> None:
    global _ENGINE
    _ENGINE = None
