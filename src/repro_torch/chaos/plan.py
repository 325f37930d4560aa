"""Fault plans and the injection runtime (port of ``repro/chaos/plan.py``,
DESIGN.md §12).

A :class:`ChaosPlan` is a list of :class:`FaultSpec`s.  Each spec names a
*fault kind* (the taxonomy below), the *hook site* it attaches to, and
the exact set of site-invocation indices at which it fires — derived
once from the plan seed by :func:`seeded_plan`, never re-randomized at
fire time, so a (kind, seed) pair replays identically forever.

Fault taxonomy (kind → default site → action):

=================== ============== ==========================================
device-loss         serve.decode   raise :class:`InjectedFault` (transient;
                                   the retry-with-backoff path must recover)
slow-step           serve.decode   sleep ``delay_s`` inside the timed decode
                                   region (the slow-step detector must flag)
corrupt-payload     serve.step     XOR ``n_bytes`` bytes of one quantized
                                   codes leaf (the integrity checksums must
                                   detect and heal before the next dispatch)
admission-failure   serve.admit    raise :class:`InjectedFault` at admission
                                   (requests must survive in the queue)
clock-skew          serve.step     add ``skew_s`` to the engine's wall clock
                                   (deadlines ride monotonic, so NOTHING may
                                   drop — the negative-space invariant)
=================== ============== ==========================================

Every injection is appended to the runtime's ``log`` and, when
``repro_torch.obs`` is enabled, emitted as a ``chaos.inject`` trace
instant plus a ``repro_chaos_injected_total{kind,site}`` counter — the
event stream benchmarks/check_chaos.py reconciles recovery actions
against.

The schedules, the chosen leaf and the flipped byte offsets are the
reference's for the same (kind, seed) and the same tree.  One difference
of mechanism: the reference rewrites the leaf functionally in
``engine.params``; the port's engines decode through per-layer views of
the stacked leaves, so the corruption flips the bytes IN PLACE
(``copy_`` into the existing codes tensor, on its device) and the
serving kernel reads them on its next launch.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs

__all__ = ["FAULT_KINDS", "FaultSpec", "ChaosPlan", "ChaosRuntime",
           "InjectedFault", "seeded_plan"]

FAULT_KINDS = ("device-loss", "slow-step", "corrupt-payload",
               "admission-failure", "clock-skew")

#: kind → default hook site (see the taxonomy table above)
_DEFAULT_SITE = {"device-loss": "serve.decode",
                 "slow-step": "serve.decode",
                 "corrupt-payload": "serve.step",
                 "admission-failure": "serve.admit",
                 "clock-skew": "serve.step"}


class InjectedFault(RuntimeError):
    """A deliberately injected *transient* fault.

    The resilience layer treats this as retryable by default (it models a
    lost device / failed admission RPC, not a logic bug), so a configured
    RestartPolicy absorbs it; with no retry policy it propagates like any
    other error.
    """

    def __init__(self, kind: str, site: str, index: int):
        super().__init__(f"injected {kind} at {site}[{index}]")
        self.kind = kind
        self.site = site
        self.index = index


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault kind armed at one site for a fixed set of invocations."""

    kind: str
    site: str
    at: Tuple[int, ...]                  # site-invocation indices (sorted)
    args: Tuple[Tuple[str, Any], ...] = ()   # kind-specific knobs (frozen)

    def arg(self, name: str, default=None):
        return dict(self.args).get(name, default)


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    seed: int
    specs: Tuple[FaultSpec, ...]

    def kinds(self) -> List[str]:
        return sorted({s.kind for s in self.specs})


def seeded_plan(kind: str, seed: int, *, horizon: int = 24,
                n_faults: int = 2, first: int = 1,
                **overrides) -> ChaosPlan:
    """Build the canonical one-kind plan for the chaos matrix.

    The firing indices are ``n_faults`` distinct site invocations drawn
    uniformly from ``[first, horizon)`` by a generator keyed on ``(seed,
    crc32(kind))`` — different fault kinds with the same seed get
    different (but individually reproducible) schedules.  ``first`` skips
    invocation 0 by default so the engine always completes one clean
    step/admission before the first fault (compile caches warm up
    fault-free).  ``overrides`` land in the spec's args (``delay_s``,
    ``skew_s``, ``n_bytes``).
    """
    if kind not in FAULT_KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; "
                         f"expected one of {FAULT_KINDS}")
    rng = np.random.default_rng([int(seed), zlib.crc32(kind.encode())])
    span = max(1, horizon - first)
    n = min(int(n_faults), span)
    at = tuple(sorted(int(i) for i in
                      rng.choice(span, size=n, replace=False) + first))
    defaults: Dict[str, Any] = {"delay_s": 0.05, "skew_s": 3600.0,
                                "n_bytes": 3}
    defaults.update(overrides)
    spec = FaultSpec(kind=kind, site=_DEFAULT_SITE[kind], at=at,
                     args=tuple(sorted(defaults.items())))
    return ChaosPlan(seed=int(seed), specs=(spec,))


def _codes_leaves(tree) -> List[Tuple[str, dict]]:
    """(path, qweight-dict) for every quantized codes leaf, in
    leaf_inventory's path vocabulary (the shared integrity key space)."""
    from repro_torch.quant import is_qweight   # lazy: chaos stays light
    out: List[Tuple[str, dict]] = []

    def walk(node, path):
        if isinstance(node, dict):
            if is_qweight(node):
                out.append(("/".join(path), node))
                return
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))

    walk(tree, ())
    return out


class ChaosRuntime:
    """Armed plan + per-site invocation counters + injection log.

    One runtime per installed plan; counters start at zero, so replaying
    the same workload under the same plan fires the same faults.  The
    corruption RNG is seeded from the plan seed — independent of the
    schedule draw — so *what* gets corrupted is as reproducible as *when*.
    """

    def __init__(self, plan: ChaosPlan):
        self.plan = plan
        self.counters: Dict[str, int] = {}
        self.log: List[Dict[str, Any]] = []
        self._corrupt_rng = np.random.default_rng([plan.seed, 0xC0DE])
        self._sleep = time.sleep

    def injected(self, kind: Optional[str] = None) -> int:
        return sum(1 for e in self.log if kind is None or e["kind"] == kind)

    def _record(self, spec: FaultSpec, index: int, **detail) -> None:
        self.log.append({"kind": spec.kind, "site": spec.site,
                         "index": index, **detail})
        obs.instant("chaos.inject", kind=spec.kind, site=spec.site,
                    index=index, **detail)
        obs.counter("repro_chaos_injected_total", kind=spec.kind,
                    site=spec.site).inc()

    def fire(self, site: str, *, engine=None) -> None:
        index = self.counters.get(site, 0)
        self.counters[site] = index + 1
        raise_after: Optional[Tuple[FaultSpec, int]] = None
        for spec in self.plan.specs:
            if spec.site != site or index not in spec.at:
                continue
            if spec.kind in ("device-loss", "admission-failure"):
                # record first, then raise once every non-raising fault at
                # this index has run (a raise must not eat a sibling spec)
                raise_after = (spec, index)
            elif spec.kind == "slow-step":
                self._record(spec, index, delay_s=spec.arg("delay_s"))
                self._sleep(float(spec.arg("delay_s", 0.05)))
            elif spec.kind == "clock-skew":
                skew = float(spec.arg("skew_s", 3600.0))
                self._record(spec, index, skew_s=skew)
                if engine is not None:
                    engine._clock_skew_s += skew
            elif spec.kind == "corrupt-payload":
                self._corrupt(spec, index, engine)
            else:  # pragma: no cover - guarded by seeded_plan
                raise ValueError(spec.kind)
        if raise_after is not None:
            spec, index = raise_after
            self._record(spec, index)
            raise InjectedFault(spec.kind, site, index)

    def _corrupt(self, spec: FaultSpec, index: int, engine) -> None:
        """XOR-flip payload bytes of one seeded-chosen quantized leaf, in
        place on the leaf's device."""
        if engine is None:
            return
        leaves = _codes_leaves(engine.params)
        if not leaves:
            self._record(spec, index, path=None)
            return
        path, leaf = leaves[int(self._corrupt_rng.integers(len(leaves)))]
        codes = leaf["codes"]
        host = codes.detach().cpu().numpy().copy()   # host copy to mutate
        flat = host.reshape(-1).view(np.uint8)
        n = min(int(spec.arg("n_bytes", 3)), flat.size)
        offs = self._corrupt_rng.choice(flat.size, size=n, replace=False)
        flat[offs] ^= 0xFF
        codes.copy_(torch.from_numpy(host))
        self._record(spec, index, path=path, n_bytes=n)
