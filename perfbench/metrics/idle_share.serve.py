"""idle_share.serve (%): the share of the traced window with no device
operation running (the union of the profiler's device intervals)."""
from perfbench.devtrace import idle_share_pct as read  # noqa: F401
