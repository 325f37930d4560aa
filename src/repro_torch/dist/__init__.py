"""repro_torch.dist — the port of ``repro.dist``: so far the fault
primitives the plan executor uses (``fault``); checkpoints, sharding and
restart-from-checkpoint come with the multi-device slice (ROADMAP queue A
item 11)."""
from .fault import Heartbeat, RestartPolicy, StragglerMonitor

__all__ = ["Heartbeat", "RestartPolicy", "StragglerMonitor"]
