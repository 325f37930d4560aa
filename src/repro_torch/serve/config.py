"""Engine-construction config (port of ``repro/serve/config.py``).

One frozen :class:`EngineConfig` carries the scheduler geometry, the
decode-fn injection and the optional resilience / quality / requant
subsystems for either engine; :func:`resolve_engine_config` is the single
shim that turns legacy per-option kwargs into one.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional

import torch

from .quality import QualityMonitor
from .requant import RequantConfig
from .resilience import ResilienceConfig

__all__ = ["EngineConfig", "resolve_engine_config"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Construction parameters for either serving engine.

    ``decode_fn``/``decode_chunk_fn`` inject dispatch functions with the
    signature ``fn(params, cache, tokens)``; None uses the model's
    ``decode_step``/``decode_chunk``.  ``reset_on_evict`` is
    continuous-engine only.  The three subsystem fields carry
    fully-constructed configs/monitors — None disables each subsystem
    with one ``is None`` test on the hot path.
    """

    n_slots: int = 4
    max_len: int = 256
    cache_dtype: Any = torch.float32
    prefill_chunk: Optional[int] = None
    decode_fn: Optional[Callable] = None
    decode_chunk_fn: Optional[Callable] = None
    reset_on_evict: bool = False
    resilience: Optional[ResilienceConfig] = None
    quality: Optional[QualityMonitor] = None
    requant: Optional[RequantConfig] = None


_CONFIG_KEYS = frozenset(f.name for f in dataclasses.fields(EngineConfig))


def resolve_engine_config(config: Optional[EngineConfig], kwargs: dict, *,
                          where: str = "engine") -> EngineConfig:
    """``config=`` alone passes through; legacy kwargs alone convert to an
    :class:`EngineConfig` under a ``DeprecationWarning``; mixing the two or
    passing an unknown option is a ``TypeError``."""
    unknown = sorted(set(kwargs) - _CONFIG_KEYS)
    if unknown:
        raise TypeError(f"{where}: unknown engine option(s) {unknown}; "
                        f"valid: {sorted(_CONFIG_KEYS)}")
    if config is not None:
        if kwargs:
            raise TypeError(
                f"{where}: pass either config=EngineConfig(...) or legacy "
                f"kwargs, not both (got {sorted(kwargs)})")
        return config
    if kwargs:
        warnings.warn(
            f"{where}: per-option engine kwargs are deprecated; pass "
            f"config=EngineConfig(...) instead", DeprecationWarning,
            stacklevel=3)
        return EngineConfig(**kwargs)
    return EngineConfig()
