"""repro_torch.chaos — deterministic, seeded fault injection (port of
``repro/chaos/__init__.py``, DESIGN.md §12).

The chaos harness is the testable half of the serving-resilience story:
every fault class the resilience layer claims to survive (device loss,
straggling steps, corrupted packed payloads, admission failures, clock
skew) can be *injected on demand*, at a seed-determined schedule, through
explicit hooks in the serving engines — and the recovery machinery's
output is then asserted bit-identical to the fault-free run (the
chaos-smoke CI matrix, benchmarks/check_chaos.py).

Design mirrors ``repro_torch.obs``: one process-wide runtime behind a module
facade, OFF by default.  Every hook site in the engines is guarded by a
single :func:`enabled` boolean check, so the disabled (default,
production) path costs one attribute read — no dict walk, no allocation
— and the engines' token streams and stats are byte-identical with the
subsystem absent (asserted in tests/test_torch_chaos.py).

Usage::

    plan = chaos.seeded_plan("device-loss", seed=0)
    with chaos.active(plan):
        engine.run_until_done()          # faults fire, resilience recovers
    # ... or install()/uninstall() for non-scoped control

Determinism contract: a :class:`FaultSpec`'s firing schedule is a fixed
set of *site-invocation indices* derived from the plan seed — never from
wall clock or global RNG state — so the same (fault kind, seed) pair
replays the exact same fault sequence on every run, which is what lets
CI assert stream bit-identity under fault.  Faults fire AT the hook,
*before* the engine mutates any state for that step, so a retried hook
is side-effect-free by construction (the injection-hook contract,
DESIGN.md §12).
"""
from __future__ import annotations

import contextlib
from typing import Optional

from .plan import (FAULT_KINDS, ChaosPlan, ChaosRuntime, FaultSpec,
                   InjectedFault, seeded_plan)

__all__ = ["FAULT_KINDS", "ChaosPlan", "ChaosRuntime", "FaultSpec",
           "InjectedFault", "seeded_plan", "enabled", "install",
           "uninstall", "runtime", "active", "fire"]

_runtime: Optional[ChaosRuntime] = None


def enabled() -> bool:
    """True when a fault plan is installed (the engines' one-check guard)."""
    return _runtime is not None


def install(plan: ChaosPlan) -> ChaosRuntime:
    """Arm ``plan``; returns the runtime (for injection-log inspection)."""
    global _runtime
    _runtime = ChaosRuntime(plan)
    return _runtime


def uninstall() -> None:
    global _runtime
    _runtime = None


def runtime() -> Optional[ChaosRuntime]:
    return _runtime


@contextlib.contextmanager
def active(plan: ChaosPlan):
    """Scoped install/uninstall; yields the armed runtime."""
    rt = install(plan)
    try:
        yield rt
    finally:
        uninstall()


def fire(site: str, *, engine=None) -> None:
    """Hook entry point: give every armed fault at ``site`` its chance.

    Called by the engines as ``if chaos.enabled(): chaos.fire(site,
    engine=self)`` — the enabled() guard keeps the disabled path at one
    boolean test.  May raise :class:`InjectedFault` (device-loss /
    admission-failure), sleep (slow-step), corrupt a payload leaf or skew
    the engine's wall clock (via the engine handle).  Each call advances
    the site's invocation counter exactly once, fired or not.
    """
    if _runtime is not None:
        _runtime.fire(site, engine=engine)
