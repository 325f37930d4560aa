"""repro_torch.serve — batched serving engines."""
from .config import EngineConfig, resolve_engine_config
from .engine import (ContinuousEngine, EngineStalledError, Request,
                     RoundStats, ServeEngine, StepStats)

__all__ = ["EngineConfig", "resolve_engine_config", "ContinuousEngine",
           "EngineStalledError", "Request", "RoundStats", "ServeEngine",
           "StepStats"]
