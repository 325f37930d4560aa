"""repro_torch.data — the synthetic token pipeline (numpy only)."""
from .pipeline import (DataConfig, SyntheticLM, global_batch_for_step,
                       host_batch_for_step)

__all__ = ["DataConfig", "SyntheticLM", "global_batch_for_step",
           "host_batch_for_step"]
