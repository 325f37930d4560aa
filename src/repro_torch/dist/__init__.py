"""repro_torch.dist — the port of ``repro.dist``: the fault primitives the
train driver, the plan executor and the serving engines use (``fault``,
with restart-from-checkpoint), step-directory checkpoints
(``checkpoint``: train states and the engines' snapshots, restored whole
or as a rank's blocks on a mesh), and the logical-axis rules and the SPMD
seam of the ranks (``sharding``)."""
from .checkpoint import (cleanup_old, latest_step, list_steps, read_manifest,
                         restore_checkpoint, save_checkpoint)
from .fault import (Heartbeat, RestartPolicy, StragglerMonitor,
                    run_with_restarts)

__all__ = ["Heartbeat", "RestartPolicy", "StragglerMonitor", "cleanup_old",
           "latest_step", "list_steps", "read_manifest",
           "restore_checkpoint", "run_with_restarts", "save_checkpoint"]
