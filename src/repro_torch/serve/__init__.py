"""repro_torch.serve — batched serving engines and the serving-side
subsystems (port of ``repro/serve/__init__.py``).

Construct engines from ONE :class:`EngineConfig` (``ServeEngine`` /
``ContinuousEngine`` take ``config=``), or go from a plan to a served
engine with the live sense→decide→act requant loop attached via
:func:`engine_from_plan`.  Tensor-parallel serving (``serve/sharded``) is
the multi-device slice's (ROADMAP item 11).
"""
from .config import EngineConfig, resolve_engine_config
from .engine import (ContinuousEngine, Request, RoundStats, ServeEngine,
                     StepStats)
from .quality import QualityConfig, QualityMonitor
from .requant import (RequantActuator, RequantConfig, SigmaSnapshot,
                      engine_from_plan, replan_from_sigma,
                      sigma_threshold_detectors)
from .resilience import (DegradePolicy, EngineStalledError, PayloadGuard,
                         ResilienceConfig, SlowStepDetector, build_bit_ladder)

__all__ = [
    # construction API
    "EngineConfig", "resolve_engine_config", "engine_from_plan",
    # engines + request types
    "ServeEngine", "ContinuousEngine", "Request", "RoundStats", "StepStats",
    # quality observatory (§14)
    "QualityConfig", "QualityMonitor",
    # live requantization (§15)
    "RequantActuator", "RequantConfig", "SigmaSnapshot",
    "replan_from_sigma", "sigma_threshold_detectors",
    # resilience (§12)
    "DegradePolicy", "EngineStalledError", "PayloadGuard",
    "ResilienceConfig", "SlowStepDetector", "build_bit_ladder",
]
