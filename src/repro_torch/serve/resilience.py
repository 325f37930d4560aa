"""Serving resilience: deadlines, shedding, retries, integrity, degradation
(port of ``repro/serve/resilience.py``, DESIGN.md §12).

One optional :class:`ResilienceConfig` attaches the whole layer to either
engine; with it absent (the default) the engines behave exactly as
before — every resilience branch sits behind one ``is None`` test.  The
pieces, each independently switchable:

* **Deadlines + cancellation** — a request may carry ``deadline_s``
  (relative to arrival).  Expiry is measured on ``time.monotonic()``
  (NEVER the wall clock: the chaos clock-skew fault jumps the engine's
  wall clock by an hour and nothing may drop), checked each scheduler
  step; expired queued requests are dropped before admission, expired
  in-flight requests are cancelled and their slot freed.  Dropped
  requests are *reported* — ``engine.dropped``, ``Request.dropped`` /
  ``drop_reason``, a ``repro_serve_dropped_total{reason}`` counter —
  never silently truncated.

* **Bounded admission + load shedding** — ``queue_cap`` bounds the
  queue; ``submit`` on a full queue sheds the request (returns False,
  records the drop) instead of growing without bound.

* **Transient-step retry** — decode/admission dispatches wrap in a
  :class:`~repro_torch.dist.fault.RestartPolicy` retry loop (capped exponential
  backoff, success-streak budget refund).  Faults fire at the chaos hook
  *before* the engine mutates state for the step, so a retry replays an
  identical dispatch — recovered streams stay bit-identical.

* **Payload integrity** — :class:`PayloadGuard` checksums every
  quantized code payload (``kernels.dequant.ops.payload_checksums``,
  keyed like ``quant.leaf_inventory``; every check copies each payload
  to the host, as the reference does) and keeps pristine host copies;
  ``heal`` restores the exact bytes IN PLACE (``copy_`` into the served
  codes tensor, which the per-layer views the engines decode through
  share), then cross-checks the healed leaf by decoding it through the
  plain PyTorch twin (``kernels/dequant/ref.unpack_payload_ref``) against
  the pristine codes — the kernel-independent witness that the healed
  payload dequantizes correctly.

* **Overload degradation** — :class:`DegradePolicy` carries a bit ladder
  of param trees (built by :func:`build_bit_ladder` from the existing
  ``quantize_params_tree`` machinery).  Sustained queue depth above the
  high watermark hot-swaps the engine one rung DOWN (int4 → int3 → int2:
  every slot's next dispatch reads fewer weight bytes, so decode
  throughput rises exactly when load demands it — the WaterSIC
  graceful-degradation lever); depth at/below the low watermark steps
  back UP.  Swaps happen at step boundaries; the KV cache is
  format-independent so in-flight slots continue seamlessly.

* **Snapshots** — ``snapshot_every`` periodically writes the continuous
  engine's full state (cache pytree + host scheduler state) through
  ``dist.checkpoint``; ``ContinuousEngine.resume`` rebuilds a
  bit-identical engine from the latest committed snapshot (the
  kill-resume invariant the chaos matrix asserts).
"""
from __future__ import annotations

import dataclasses
import time
from statistics import median
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.chaos import InjectedFault
from repro_torch.dist.fault import RestartPolicy
from repro_torch.kernels.dequant.ops import (_walk_qweights,
                                             payload_checksums,
                                             verify_payloads)

__all__ = ["EngineStalledError", "ResilienceConfig", "DegradePolicy",
           "PayloadGuard", "SlowStepDetector", "build_bit_ladder"]


class EngineStalledError(RuntimeError):
    """``run_until_done`` exhausted its step budget with work pending.

    Carries the stuck-slot table and queue depth so the page names the
    victims instead of a bare "timed out": ``stuck`` is a list of
    ``(slot, rid, tokens_emitted, budget)`` rows.
    """

    def __init__(self, max_steps: int, stuck: List[Tuple[int, int, int, int]],
                 queue_depth: int):
        rows = ", ".join(f"slot {s}: rid={r} {t}/{b} tokens"
                         for s, r, t, b in stuck) or "none"
        super().__init__(
            f"engine stalled after {max_steps} steps: "
            f"{len(stuck)} stuck slot(s) [{rows}], "
            f"{queue_depth} request(s) still queued")
        self.max_steps = max_steps
        self.stuck = stuck
        self.queue_depth = queue_depth


class SlowStepDetector:
    """Flag scheduler steps that run ``threshold``× the rolling median.

    The single-engine sibling of ``dist.fault.StragglerMonitor`` (which
    compares *hosts*): here the baseline is the engine's own recent step
    times, so an injected slow-step (or a genuinely wedged dispatch)
    stands out once ``warmup`` normal steps have been observed.
    """

    def __init__(self, threshold: float = 4.0, window: int = 32,
                 warmup: int = 4):
        self.threshold = threshold
        self.window = window
        self.warmup = warmup
        self._times: List[float] = []

    def observe(self, step_s: float) -> bool:
        """Record one step time; True if it flags as slow."""
        slow = (len(self._times) >= self.warmup
                and step_s > self.threshold * median(self._times))
        self._times.append(float(step_s))
        if len(self._times) > self.window:
            del self._times[0]
        return slow


class PayloadGuard:
    """Checksum + pristine-copy integrity guard over quantized payloads.

    Keeps, per quantized leaf (keyed by the ``leaf_inventory`` path): the
    crc32 of its code payload and a host-side pristine byte copy.  The
    copies cost a fraction of the bf16 tree the payloads replaced
    (sub-byte codes), and they are what makes healing *exact* — a healed
    leaf is byte-identical to the original, so recovered token streams
    are bit-identical to the fault-free run.
    """

    def __init__(self, params):
        self.checksums = payload_checksums(params)
        self._pristine = {path: leaf["codes"].detach().cpu().numpy().copy()
                          for path, leaf in _walk_qweights(params)}

    def verify(self, params) -> List[str]:
        """Sorted paths whose payload bytes drifted from the baseline."""
        return verify_payloads(params, self.checksums)

    def heal(self, params, corrupted: Sequence[str]):
        """Restore each corrupted leaf's payload from the pristine copy,
        in place, and return ``params`` (the same tree).

        Each healed payload is cross-checked through the plain twin: the
        restored bytes must decode (``unpack_payload_ref``) to the same
        codes as the pristine copy — a packed-layout-aware witness that
        healing really round-tripped, independent of the serving kernel.
        """
        from repro_torch.kernels.dequant.ref import (payload_nbits,
                                                     unpack_payload_ref)
        leaves = dict(_walk_qweights(params))
        for path in corrupted:
            if path not in self._pristine or path not in leaves:
                raise KeyError(f"no pristine copy for corrupted payload "
                               f"{path!r} (schema drift since the guard "
                               f"was built)")
            leaves[path]["codes"].copy_(
                torch.from_numpy(self._pristine[path]))
        for path in corrupted:
            clean = torch.from_numpy(self._pristine[path])
            leaf = leaves[path]["codes"].detach().cpu()
            if clean.dtype == torch.uint8 and clean.ndim >= 2:
                # twin cross-check: the payload now IN the tree must
                # decode to the pristine codes
                nbits = payload_nbits(clean)
                if not torch.equal(unpack_payload_ref(leaf, nbits),
                                   unpack_payload_ref(clean, nbits)):
                    raise AssertionError(
                        f"healed payload {path!r} fails the twin "
                        f"decode cross-check")
            elif not torch.equal(leaf, clean):
                raise AssertionError(f"healed codes {path!r} differ from "
                                     f"the pristine copy")
        if verify_payloads(params, self.checksums):
            raise AssertionError("healing left payloads corrupted")
        return params


@dataclasses.dataclass
class DegradePolicy:
    """Queue-pressure-driven bit-ladder hot-swap policy.

    ``ladder`` is ordered highest rate first (rung 0 is what the engine
    was constructed with).  Queue depth ≥ ``high_watermark`` for
    ``streak`` consecutive steps shifts one rung down; depth ≤
    ``low_watermark`` (same streak) shifts back up.  ``cooldown_steps``
    separates consecutive shifts so a burst cannot slam the engine down
    the whole ladder in two steps.
    """

    ladder: List[Tuple[str, object]]          # [(rung name, params tree)]
    high_watermark: int = 8
    low_watermark: int = 1
    streak: int = 2
    cooldown_steps: int = 4

    def __post_init__(self):
        if len(self.ladder) < 2:
            raise ValueError("a degradation ladder needs >= 2 rungs")
        if self.low_watermark >= self.high_watermark:
            raise ValueError("low_watermark must sit below high_watermark")


def build_bit_ladder(params, rungs: Sequence[Optional[int]] = (None, 4, 3, 2),
                     **quant_kw) -> List[Tuple[str, object]]:
    """Quantize ``params`` down the serving bit ladder (DESIGN.md §8/§12).

    ``rungs`` lists payload bit-widths highest-rate first; ``None`` keeps
    the tree as passed (rung 0 = the engine's nominal serving format).
    Each rung reuses the existing ``quantize_params_tree`` machinery
    (``quant_kw`` — e.g. ``min_dim`` — passes through), so the degraded
    trees serve through the same packed kernels as a planner-chosen
    format — degradation IS mixed-rate serving with the rate chosen by
    load instead of by the waterfiller.  ``params`` must be the raw
    (unquantized) tree for the quantized rungs to be built.
    """
    from repro_torch.quant import quantize_params_tree
    ladder: List[Tuple[str, object]] = []
    for r in rungs:
        if r is None:
            ladder.append(("native", params))
        elif r == 4:
            ladder.append(("int4", quantize_params_tree(
                params, nbits=4, packed=True, **quant_kw)))
        elif r in (2, 3, 8):
            ladder.append((f"int{r}", quantize_params_tree(
                params, nbits=r, **quant_kw)))
        else:
            raise ValueError(f"no serving rung for {r!r} bits")
    return ladder


@dataclasses.dataclass
class ResilienceConfig:
    """Everything optional; ``ResilienceConfig()`` alone only enables the
    slow-step detector and exact drop accounting."""

    # bounded admission / shedding
    queue_cap: Optional[int] = None
    # deadlines (seconds from arrival; per-request deadline_s wins)
    default_deadline_s: Optional[float] = None
    # transient-dispatch retry (None = fail fast, as before)
    retry: Optional[RestartPolicy] = None
    retry_sleep: Callable[[float], None] = time.sleep
    #: exception types treated as transient beyond chaos.InjectedFault
    transient: Tuple[type, ...] = ()
    # payload integrity (verify every N steps; None = off)
    integrity_every: Optional[int] = None
    # overload degradation
    degrade: Optional[DegradePolicy] = None
    # periodic engine snapshots (continuous engine)
    snapshot_dir: Optional[str] = None
    snapshot_every: Optional[int] = None
    snapshot_keep: int = 3
    # slow-step detection
    slow_step_threshold: float = 4.0
    slow_step_window: int = 32
    slow_step_warmup: int = 4

    def transient_types(self) -> Tuple[type, ...]:
        return (InjectedFault,) + tuple(self.transient)

    def make_detector(self) -> SlowStepDetector:
        return SlowStepDetector(self.slow_step_threshold,
                                self.slow_step_window,
                                self.slow_step_warmup)
