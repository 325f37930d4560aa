"""repro_torch.dist — the port of ``repro.dist``: the fault primitives the
plan executor and the serving engines use (``fault``) and single-device
step-directory checkpoints (``checkpoint``, the engines' snapshots);
sharding and restart-from-checkpoint come with the multi-device slice
(ROADMAP queue A item 11)."""
from .checkpoint import (cleanup_old, latest_step, list_steps, read_manifest,
                         restore_checkpoint, save_checkpoint)
from .fault import Heartbeat, RestartPolicy, StragglerMonitor

__all__ = ["Heartbeat", "RestartPolicy", "StragglerMonitor", "cleanup_old",
           "latest_step", "list_steps", "read_manifest",
           "restore_checkpoint", "save_checkpoint"]
