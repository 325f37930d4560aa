"""repro_torch.serve — batched serving engines and the serving-side
subsystems (port of ``repro/serve/__init__.py``).

Construct engines from ONE :class:`EngineConfig` (``ServeEngine`` /
``ContinuousEngine`` take ``config=``), or go from a plan to a served
engine with the live sense→decide→act requant loop attached via
:func:`engine_from_plan`.  ``serve/sharded`` serves a k-sharded tree
through one process per rank over ``torch.distributed`` (DESIGN.md §13).
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
from .sharded import (MeshJob, build_sharded_decode_fns, build_sharded_engine,
                      cache_pspecs, integer_allgathers, local_view,
                      params_pspecs, run_oracle, serve_mesh_jobs,
                      shard_params_tree)

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
    # tensor-parallel k-sharded serving (§13)
    "MeshJob", "build_sharded_decode_fns", "build_sharded_engine",
    "cache_pspecs", "integer_allgathers", "local_view", "params_pspecs",
    "run_oracle", "serve_mesh_jobs", "shard_params_tree",
]
