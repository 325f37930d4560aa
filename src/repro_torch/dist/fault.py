"""Fault-tolerance primitives of the plan executor (port of the stdlib half
of ``repro/dist/fault.py``).

* :class:`Heartbeat` — one atomically rewritten liveness file per host;
  any host (or an external watchdog) reads the directory to see who is
  alive and how far along they are.
* :class:`StragglerMonitor` — rolling per-host step-time means; a host is
  flagged when it runs ``threshold``× slower than the median host.
* :class:`RestartPolicy` — capped exponential backoff with a hard restart
  budget.

The reference module also holds ``run_with_restarts``, which drives
resume-from-checkpoint through ``dist/checkpoint.py``; it comes with the
checkpoints (ROADMAP queue A item 11).  These three use only the stdlib.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import uuid
from collections import deque
from statistics import median
from typing import Dict, List, Optional

__all__ = ["Heartbeat", "StragglerMonitor", "RestartPolicy"]

_HB_SUFFIX = ".hb"


class Heartbeat:
    """One atomically-rewritten liveness file per host."""

    def __init__(self, hb_dir: str, host_id: str):
        self.hb_dir = hb_dir
        self.host_id = host_id
        os.makedirs(hb_dir, exist_ok=True)
        self._path = os.path.join(hb_dir, f"{host_id}{_HB_SUFFIX}")

    def beat(self, step: int) -> None:
        """Record that this host completed ``step`` (write → rename, so a
        reader never sees a torn file).

        The payload carries BOTH clocks: ``time`` (wall, for humans and
        cross-host dashboards) and ``mono`` (``time.monotonic()``, for
        staleness).  Staleness must never ride the wall clock — an NTP
        step or admin ``date`` jump would age every heartbeat at once,
        fake a dead fleet, and trigger spurious restarts.  CLOCK_MONOTONIC
        is shared by all processes on a machine, so single-machine
        watchdogs (the plan executor, tests) compare it directly; a
        cross-host reader falls back to the wall field and inherits its
        caveats.
        """
        tmp = f"{self._path}.tmp.{uuid.uuid4().hex[:8]}"
        with open(tmp, "w") as f:
            json.dump({"host": self.host_id, "step": int(step),
                       "time": time.time(), "mono": time.monotonic()}, f)
        os.replace(tmp, self._path)

    @staticmethod
    def alive_hosts(hb_dir: str,
                    max_age_s: Optional[float] = None) -> Dict[str, int]:
        """host_id → last step, for every heartbeat file (optionally only
        those younger than ``max_age_s``).

        Staleness uses the beat's ``mono`` stamp against the reader's
        ``time.monotonic()`` (wall-clock-jump immune; see :meth:`beat`),
        falling back to the wall ``time`` field for heartbeats written by
        older code.
        """
        out: Dict[str, int] = {}
        if not os.path.isdir(hb_dir):
            return out
        now_mono = time.monotonic()
        now_wall = time.time()
        for name in os.listdir(hb_dir):
            if not name.endswith(_HB_SUFFIX):
                continue
            try:
                with open(os.path.join(hb_dir, name)) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue  # torn/garbage file: treat as not beating
            if not isinstance(rec, dict) or "step" not in rec:
                continue  # parseable but malformed: also not beating
            if max_age_s is not None:
                age = (now_mono - rec["mono"] if "mono" in rec
                       else now_wall - rec.get("time", 0))
                if age > max_age_s:
                    continue
            out[rec.get("host", name[:-len(_HB_SUFFIX)])] = int(rec["step"])
        return out


class StragglerMonitor:
    """Relative straggler detection over rolling per-host step times.

    A host straggles when its rolling mean exceeds ``threshold`` × the
    median of all hosts' rolling means.  At least ``min_observations``
    samples are required before a host can be flagged (cold-start compiles
    should not page anyone), and ``skip_first`` observations per host are
    discarded outright — the first step after a restart carries the jit
    compile, and ONE such sample in a small window is enough to make a
    perfectly healthy host's mean cross the threshold (the cold-start
    false positive tests/test_fault.py pins).
    """

    def __init__(self, threshold: float = 2.0, window: int = 50,
                 min_observations: int = 3, skip_first: int = 0):
        self.threshold = threshold
        self.window = window
        self.min_observations = min_observations
        self.skip_first = skip_first
        self._times: Dict[str, deque] = {}
        self._skipped: Dict[str, int] = {}

    def observe(self, host: str, step_time_s: float) -> None:
        if self._skipped.get(host, 0) < self.skip_first:
            self._skipped[host] = self._skipped.get(host, 0) + 1
            return
        self._times.setdefault(host, deque(maxlen=self.window)) \
            .append(float(step_time_s))

    def means(self, min_count: int = 1) -> Dict[str, float]:
        """Rolling mean per host with at least ``min_count`` samples.

        ``min_count`` guards every consumer against cold-start hosts: a
        host one sample into its window has a "mean" that is really just
        its compile time, and letting it into a fleet summary (or the
        straggler median) is how fresh hosts get paged at startup.
        """
        return {h: sum(t) / len(t) for h, t in self._times.items()
                if len(t) >= max(1, min_count)}

    def stragglers(self) -> List[str]:
        # warm hosts only, for the median too: one cold host's compile-time
        # sample must neither get flagged nor inflate the baseline that
        # everyone else is compared against
        means = self.means(min_count=self.min_observations)
        if len(means) < 2:
            return []  # "relative to whom?" needs at least one peer
        med = median(means.values())
        return sorted(h for h, m in means.items()
                      if m > self.threshold * med)


@dataclasses.dataclass
class RestartPolicy:
    """Capped exponential backoff with a hard restart budget.

    With ``reset_after=N`` set, a streak of N consecutive successes
    (reported via :meth:`record_success`) refunds the whole budget and
    resets the backoff to base.  Without it (default) the budget is
    lifetime: a long-running service that hits one transient blip per
    day would exhaust a 3-restart budget by Thursday and fail hard on a
    fault it has recovered from three times already.
    """

    max_restarts: int = 3
    backoff_base_s: float = 1.0
    backoff_mult: float = 2.0
    backoff_max_s: float = 300.0
    #: successes-in-a-row that refund the restart budget (None = never)
    reset_after: Optional[int] = None
    _used: int = dataclasses.field(default=0, repr=False)
    _streak: int = dataclasses.field(default=0, repr=False)

    def next_delay(self) -> Optional[float]:
        """Seconds to wait before the next restart, or None when the
        budget is exhausted (caller should re-raise / page)."""
        self._streak = 0
        if self._used >= self.max_restarts:
            return None
        delay = min(self.backoff_base_s * self.backoff_mult ** self._used,
                    self.backoff_max_s)
        self._used += 1
        return delay

    def record_success(self) -> None:
        """Note one successful step; a ``reset_after`` streak refunds the
        restart budget (no-op when ``reset_after`` is unset or the budget
        is untouched)."""
        if self.reset_after is None or self._used == 0:
            return
        self._streak += 1
        if self._streak >= self.reset_after:
            self._used = 0
            self._streak = 0

    @property
    def restarts_used(self) -> int:
        return self._used
