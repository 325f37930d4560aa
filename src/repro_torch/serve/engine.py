"""Batched serving engines: static rounds + continuous batching (port of
``repro/serve/engine.py``).

  * :class:`ServeEngine` — static batching rounds: each round admits up to
    ``n_slots`` queued requests of equal prompt length, prefills them in
    lockstep on a fresh cache and decodes greedily until every admitted
    request filled its budget.  The simple differential oracle.
  * :class:`ContinuousEngine` — continuous batching on one slot-indexed
    cache with per-slot positions: an admission burst co-prefills its
    common prefix (``decode_chunk``), ragged tails finish per row, each row
    is grafted into its free slot (``cache_write_slot``), then ONE lockstep
    ``decode_step`` serves all slots; finished slots are evicted.

Prefill is per-token (``prefill_chunk=None``) or chunked (``decode_chunk``
of C tokens per call, identical to C decode steps).  Requests carry
arrival, first-token and finish stamps (``ttft_s``/``tpot_s``); rounds
and steps land in ``round_stats`` / ``step_stats``.

Observability (DESIGN.md §11): with ``repro_torch.obs`` enabled both
engines record the reference's spans (``serve.prefill``, ``serve.decode``,
``serve.admit`` on one lane per slot, ``serve.step``), instants
(``serve.request.arrival`` / ``first_token`` / ``finish``), counters,
gauges and TTFT/TPOT histograms under the same names and labels, made
from the same perf_counter stamps as the stats, and charge every forward
dispatch its modeled weight traffic (``record_weight_traffic``).  The
continuous engine splits each ``serve.decode`` into the port's own
``serve.dispatch`` (the host enqueuing the step) and ``serve.sample``
(the argmax, its copy to the host and the wait on the card); the step's
``decode.attention`` and ``decode.unembed`` spans (``models``) nest in
the dispatch.  Off, it is one boolean test per site and the streams are
unchanged.

Resilience (DESIGN.md §12): ``EngineConfig(resilience=ResilienceConfig(
...))`` enables per-request deadlines on the monotonic clock, a bounded
queue with load shedding, transient-dispatch retry
(``dist.fault.RestartPolicy``), payload checksums with exact in-place
healing (``serve.resilience.PayloadGuard``), queue-pressure degradation
down the bit ladder (a tree swap at a step boundary; the KV cache is
format-independent) and periodic snapshots through ``dist.checkpoint``
(``ContinuousEngine.resume``).  The chaos hooks (``repro_torch.chaos``)
sit at serve.step / serve.admit / serve.decode (continuous) and
serve.round (static), each behind one ``chaos.enabled()`` test, and fire
before the engine writes any state for that step: the decode writes the
KV cache in place, and a retried dispatch rewrites the same rows with the
same values, so recovered streams equal the fault-free run's.  A quality
monitor (``EngineConfig(quality=...)``) samples after each step and a
requant actuator (``attach_requant``) is polled after it, both only with
obs on.  With every subsystem off each branch is one ``is None`` /
``enabled()`` test and the streams are unchanged.

Tree swaps (degradation, requant) rebuild the per-layer views the decode
reads (``_step_params``); payload corruption and healing write the codes
tensors in place, which those views share.

The engines run on the device of ``params`` (the embedding's device).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch import chaos, obs
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.dequant.ops import (record_weight_traffic,
                                             weight_format_bytes)
from repro_torch.models import (cache_reset_slot, cache_rows,
                                cache_write_slot, decode_chunk, decode_step,
                                init_cache, split_layers)
from repro_torch.quant import leaf_format_histogram, qweight_bytes
from repro_torch.serve.config import EngineConfig, resolve_engine_config
from repro_torch.serve.resilience import (EngineStalledError, PayloadGuard,
                                          ResilienceConfig)

__all__ = ["Request", "RoundStats", "StepStats", "ServeEngine",
           "ContinuousEngine", "EngineStalledError", "EngineConfig",
           "ResilienceConfig"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    arrival_s: Optional[float] = None      # set by submit() if unset
    first_token_s: Optional[float] = None  # first output token materialized
    finish_s: Optional[float] = None       # budget filled
    # resilience (DESIGN.md §12)
    deadline_s: Optional[float] = None     # seconds from arrival; expiry is
                                           # measured on the MONOTONIC clock
    arrival_mono: Optional[float] = None   # monotonic arrival (deadline base)
    dropped: bool = False                  # shed or deadline-expired
    drop_reason: Optional[str] = None      # "shed-queue-full" | "deadline"

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token: queue wait + prefill + first argmax."""
        if self.arrival_s is None or self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token after the first (None if < 2)."""
        if self.first_token_s is None or self.finish_s is None \
                or len(self.out_tokens) < 2:
            return None
        return (self.finish_s - self.first_token_s) \
            / (len(self.out_tokens) - 1)


@dataclasses.dataclass
class RoundStats:
    """Wall-clock + dispatch accounting for one static-batching round."""

    batch: int
    prompt_len: int
    prefill_calls: int
    prefill_s: float                 # up to the last prefill logits ready
    decode_calls: int
    decode_s: float
    new_tokens: int
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    tpot_s: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class StepStats:
    """One continuous-batching scheduler step."""

    active: int
    admitted: int
    finished: int
    new_tokens: int
    step_s: float


def _sync(t: torch.Tensor) -> None:
    """Wait for the device work that produces ``t`` (timing boundaries)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _greedy(logits: torch.Tensor) -> np.ndarray:
    """Argmax on the device; only the B token ids cross to the host."""
    return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()


def _run_prefill(decode_fn, decode_chunk_fn, params, cache,
                 prompts: np.ndarray, chunk: Optional[int], device):
    """Feed the prompt through the cache; returns (logits, cache, calls).

    Chunked mode issues ceil(plen/chunk) ``decode_chunk`` calls; per-token
    mode is the plen-call reference path.  Shared by both engines so the
    prefill semantics cannot drift between them."""
    plen = prompts.shape[1]
    toks = torch.as_tensor(prompts, dtype=torch.long, device=device)
    logits = None
    calls = 0
    if chunk and plen > 1:
        for s0 in range(0, plen, chunk):
            logits, cache = decode_chunk_fn(params, cache,
                                            toks[:, s0:s0 + chunk])
            calls += 1
    else:
        for t in range(plen):
            logits, cache = decode_fn(params, cache, toks[:, t:t + 1])
            calls += 1
    return logits, cache, calls


class _EngineBase:
    """Construction, observability and resilience shared by both engines.

    ``_format_bytes`` lazily caches the tree's per-format stored bytes
    (the ``quant.leaf_inventory`` grouping) so each device dispatch can be
    charged its modeled weight read; every obs hook is one
    ``obs.enabled()`` test when disabled, every resilience branch one
    ``is None`` test."""

    _obs_engine = "?"
    _fmt_bytes = None

    def _format_bytes(self):
        if self._fmt_bytes is None:
            self._fmt_bytes = weight_format_bytes(self.params)
        return self._fmt_bytes

    def _setup(self, cfg: ArchConfig, params, config: EngineConfig):
        self.config = config
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["w"].device
        self.n_slots = config.n_slots
        self.max_len = config.max_len
        self.cache_dtype = config.cache_dtype
        self.prefill_chunk = config.prefill_chunk
        self._quality = config.quality   # optional serve.quality monitor
        self.queue: deque = deque()
        self._init_resilience(config.resilience)  # may swap params to rung 0
        # per-layer views cut once, not on every decode step
        self._step_params = split_layers(self.params)
        # realized weight bytes vs bf16 and the per-leaf format mix
        self.weight_bytes, self.weight_bytes_bf16 = qweight_bytes(self.params)
        self.weight_formats = leaf_format_histogram(self.params)
        self._decode = config.decode_fn or (
            lambda p, c, tok: decode_step(cfg, p, c, tok))
        self._decode_chunk = config.decode_chunk_fn or (
            lambda p, c, toks: decode_chunk(cfg, p, c, toks))
        # a rank's injected dispatches (serve.sharded) bring the rank's
        # cache factory (its block of the buffer axis) and rank 0's clock
        self._init_cache = getattr(config.decode_fn, "init_cache", init_cache)
        self._clock = getattr(config.decode_fn, "clock", None)

    def _fresh_cache(self, batch: int, per_slot: bool = False):
        return self._init_cache(self.cfg, batch, self.max_len,
                                self.cache_dtype, per_slot=per_slot,
                                device=self.device)

    def _prefill(self, cache, prompts: np.ndarray):
        return _run_prefill(self._decode, self._decode_chunk,
                            self._step_params, cache, prompts,
                            self.prefill_chunk, self.device)

    # -- resilience (DESIGN.md §12) ----------------------------------------

    def _init_resilience(self, resilience: Optional[ResilienceConfig]):
        """Wire the optional resilience layer; runs after ``self.params``
        is set and BEFORE the weight accounting (a degradation ladder's
        rung 0 replaces the constructor's params)."""
        self.resilience = resilience
        self.dropped: List[Request] = []    # shed + deadline-expired
        self.slow_steps = 0                 # detector flags (host counter)
        self._clock_skew_s = 0.0            # chaos clock-skew lands here
        self._tick = 0                      # step/round index (1-based)
        self._guard: Optional[PayloadGuard] = None
        self._detector = None
        self._rung = 0
        self._streak_over = 0
        self._streak_under = 0
        self._degrade_cooldown = 0
        self.rung_history: List[tuple] = []  # [(tick, rung name, direction)]
        # hot-swap state (DESIGN.md §15): a staged tree applied at the next
        # step boundary + an optional requant actuator bound afterwards
        self._pending_swap: Optional[tuple] = None     # (tree, reason)
        self.swap_history: List[tuple] = []            # [(tick, reason)]
        self.requant = None
        if resilience is None:
            return
        self._detector = resilience.make_detector()
        if resilience.degrade is not None:
            # the engine serves rung 0 of the ladder from the start
            name, tree = resilience.degrade.ladder[0]
            self.params = tree
            self.rung_history.append((0, name, "init"))
        if resilience.integrity_every:
            self._guard = PayloadGuard(self.params)

    def _now(self) -> float:
        """Wall-clock stamp source for stats/latency accounting:
        perf_counter plus the chaos clock-skew offset (skew-vulnerable BY
        DESIGN, so the clock-skew fault visibly lands in the stats clock
        while deadlines, which ride ``time.monotonic``, never see it).
        On a mesh rank: rank 0's reading at the step's start plus the time
        since (``serve.sharded.MeshClock``)."""
        now = time.perf_counter() if self._clock is None \
            else self._clock.perf_counter()
        return now + self._clock_skew_s

    def _mono(self) -> float:
        """The monotonic clock of every decision (deadlines, arrivals).
        On a mesh rank it is rank 0's reading, broadcast at the top of the
        step, so every rank takes the same decisions in the same order;
        a request submitted between steps is stamped with the last
        step's reading."""
        return time.monotonic() if self._clock is None \
            else self._clock.monotonic()

    def _sync_clock(self) -> None:
        if self._clock is not None:
            self._clock.sync()

    def _submit_common(self, req: Request) -> bool:
        """Arrival stamping + deadline default + load shedding.  Returns
        False (and records the drop) when the bounded queue is full; the
        caller must not enqueue in that case."""
        if req.arrival_s is None:
            req.arrival_s = self._now()
        if req.arrival_mono is None:
            req.arrival_mono = self._mono()
        res = self.resilience
        if res is not None:
            if req.deadline_s is None:
                req.deadline_s = res.default_deadline_s
            if res.queue_cap is not None and len(self.queue) >= res.queue_cap:
                self._drop(req, "shed-queue-full")
                return False
        return True

    def _drop(self, req: Request, reason: str, slot=None) -> None:
        """Record a shed/expired request — reported, never silent."""
        req.dropped = True
        req.drop_reason = reason
        self.dropped.append(req)
        if obs.enabled():
            kw = {} if slot is None else {"slot": int(slot)}
            obs.instant("serve.request.dropped", rid=req.rid, reason=reason,
                        engine=self._obs_engine, **kw)
            obs.counter("repro_serve_dropped_total", reason=reason,
                        engine=self._obs_engine).inc()

    def _deadline_expired(self, req: Request, now_mono: float) -> bool:
        return (req.deadline_s is not None
                and req.arrival_mono is not None
                and now_mono - req.arrival_mono > req.deadline_s)

    def _expire_queue(self) -> None:
        """Drop queued requests whose deadline passed (before admission:
        prefilling a request that can no longer finish in time is the
        worst way to spend a dispatch)."""
        if self.resilience is None or not self.queue:
            return
        now_mono = self._mono()
        keep: deque = deque()
        for r in self.queue:
            if self._deadline_expired(r, now_mono):
                self._drop(r, "deadline")
            else:
                keep.append(r)
        self.queue = keep

    def _retry(self, site: str, fn):
        """Run ``fn`` under the transient-retry policy (fail fast if none).
        Only the configured transient types (``chaos.InjectedFault`` plus
        ``ResilienceConfig.transient``) are retried; anything else — and
        transient faults past the restart budget — propagates."""
        res = self.resilience
        if res is None or res.retry is None:
            return fn()
        policy = res.retry
        transient = res.transient_types()
        failures = 0
        while True:
            try:
                out = fn()
            except transient as e:
                delay = policy.next_delay()
                if delay is None:
                    raise
                failures += 1
                if obs.enabled():
                    obs.instant("resilience.retry", site=site,
                                engine=self._obs_engine, delay_s=delay,
                                error=type(e).__name__)
                    obs.counter("repro_serve_retries_total", site=site,
                                engine=self._obs_engine).inc()
                res.retry_sleep(delay)
            else:
                policy.record_success()
                if failures and obs.enabled():
                    obs.counter("repro_serve_recovered_total", site=site,
                                engine=self._obs_engine).inc()
                return out

    def _verify_integrity(self) -> None:
        """Checksum the serving payloads; heal exact bytes on mismatch."""
        res = self.resilience
        if self._guard is None or self._tick % res.integrity_every != 0:
            return
        corrupted = self._guard.verify(self.params)
        if not corrupted:
            return
        t0 = time.perf_counter()
        self.params = self._guard.heal(self.params, corrupted)
        t1 = time.perf_counter()
        if obs.enabled():
            obs.complete("resilience.heal", t0, t1, engine=self._obs_engine,
                         paths=list(corrupted))
            obs.counter("repro_serve_integrity_corrupt_total",
                        engine=self._obs_engine).inc(len(corrupted))
            obs.counter("repro_serve_integrity_healed_total",
                        engine=self._obs_engine).inc(len(corrupted))

    def _maybe_degrade(self) -> None:
        """Watermark ladder walk: sustained overload → one rung down,
        sustained calm → one rung up (never past either end)."""
        res = self.resilience
        pol = res.degrade if res is not None else None
        if pol is None:
            return
        depth = len(self.queue)
        if depth >= pol.high_watermark:
            self._streak_over += 1
            self._streak_under = 0
        elif depth <= pol.low_watermark:
            self._streak_under += 1
            self._streak_over = 0
        else:
            self._streak_over = self._streak_under = 0
        if self._degrade_cooldown > 0:
            self._degrade_cooldown -= 1
            return
        if self._streak_over >= pol.streak and self._rung < len(pol.ladder) - 1:
            self._set_rung(self._rung + 1, "down", depth)
        elif self._streak_under >= pol.streak and self._rung > 0:
            self._set_rung(self._rung - 1, "up", depth)

    def _set_rung(self, rung: int, direction: str, depth: int) -> None:
        """Hot-swap the tree to ladder rung ``rung`` at a step boundary
        (the KV cache is weight-format-independent: in-flight slots keep
        decoding)."""
        pol = self.resilience.degrade
        name, tree = pol.ladder[rung]
        self._rung = rung
        self._swap_tree(tree, reason=f"degrade:{name}")
        self._degrade_cooldown = pol.cooldown_steps
        self._streak_over = self._streak_under = 0
        self.rung_history.append((self._tick, name, direction))
        if obs.enabled():
            obs.instant("resilience.degrade", engine=self._obs_engine,
                        rung=name, direction=direction, queue_depth=depth)
            obs.counter("repro_serve_degrade_total", engine=self._obs_engine,
                        direction=direction).inc()

    # -- generic hot-swap (DESIGN.md §15) -----------------------------------

    def request_swap(self, tree, *, reason: str = "requant") -> None:
        """Stage a new served tree, applied at the NEXT step boundary —
        never mid-step.  A second request before the boundary replaces
        the first (last writer wins)."""
        self._pending_swap = (tree, reason)

    def _apply_pending_swap(self) -> None:
        if self._pending_swap is None:
            return
        tree, reason = self._pending_swap
        self._pending_swap = None
        self._swap_tree(tree, reason=reason)

    def _swap_tree(self, tree, *, reason: str) -> None:
        """Swap the served tree (degradation and requant): rebuilds the
        per-layer views the decode reads, refreshes byte/format
        accounting, REBASELINES the integrity guard on the new pristine
        payloads and tells the quality monitor, whose cached expected
        distortions belong to the old codes."""
        self.params = tree
        self._step_params = split_layers(tree)
        self._fmt_bytes = None
        self.weight_bytes, self.weight_bytes_bf16 = qweight_bytes(tree)
        self.weight_formats = leaf_format_histogram(tree)
        if self._guard is not None:
            self._guard = PayloadGuard(tree)
        self.swap_history.append((self._tick, reason))
        if self._quality is not None:
            hook = getattr(self._quality, "on_swap", None)
            if hook is not None:
                hook(reason=reason)
        if obs.enabled():
            obs.instant("serve.swap", engine=self._obs_engine, reason=reason,
                        tick=self._tick)
            obs.counter("repro_serve_swaps_total",
                        engine=self._obs_engine).inc()

    def attach_requant(self, actuator) -> None:
        """Bind a ``serve.requant`` actuator; the engine polls it once
        per step after quality sampling, behind the same obs gate."""
        self.requant = actuator

    def _poll_requant(self) -> None:
        if self.requant is not None and self._quality is not None \
                and obs.enabled():
            self.requant.poll(self)

    def _observe_step_time(self, dt: float) -> None:
        if self._detector is not None and self._detector.observe(dt):
            self.slow_steps += 1
            if obs.enabled():
                obs.instant("resilience.slow_step", engine=self._obs_engine,
                            step_s=dt)
                obs.counter("repro_serve_slow_steps_total",
                            engine=self._obs_engine).inc()

    # -- observability (DESIGN.md §11) --------------------------------------

    def _obs_arrival(self, req: Request) -> None:
        if obs.enabled():
            obs.instant("serve.request.arrival", rid=req.rid,
                        engine=self._obs_engine)
            obs.gauge("repro_serve_queue_depth",
                      engine=self._obs_engine).set(len(self.queue))

    def _obs_request_done(self, req: Request, slot=None) -> None:
        kw = {} if slot is None else {"slot": int(slot)}
        obs.instant("serve.request.finish", rid=req.rid,
                    engine=self._obs_engine, **kw)
        obs.counter("repro_serve_finished_total",
                    engine=self._obs_engine).inc()
        if req.ttft_s is not None:
            obs.histogram("repro_serve_ttft_seconds",
                          engine=self._obs_engine).observe(req.ttft_s)
        if req.tpot_s is not None:
            obs.histogram("repro_serve_tpot_seconds",
                          engine=self._obs_engine).observe(req.tpot_s)


class ServeEngine(_EngineBase):
    """Static-batching rounds — the reference scheduler."""

    _obs_engine = "static"

    def __init__(self, cfg: ArchConfig, params, *,
                 config: Optional[EngineConfig] = None, **kwargs):
        self._setup(cfg, params,
                    resolve_engine_config(config, kwargs, where="ServeEngine"))
        self.round_stats: List[RoundStats] = []

    def submit(self, req: Request) -> bool:
        if not self._submit_common(req):
            return False
        self.queue.append(req)
        self._obs_arrival(req)
        return True

    def _admit(self) -> List[Request]:
        """Pop up to n_slots queued requests sharing the head's prompt len."""
        if not self.queue:
            return []
        plen = len(self.queue[0].prompt)
        admitted, rest = [], deque()
        while self.queue and len(admitted) < self.n_slots:
            r = self.queue.popleft()
            if len(r.prompt) == plen:
                admitted.append(r)
            else:
                rest.append(r)
        rest.extend(self.queue)
        self.queue = rest
        return admitted

    def run_round(self) -> List[Request]:
        """One static-batching round; returns the finished requests."""
        self._tick += 1
        self._sync_clock()
        self._apply_pending_swap()      # round boundary: a staged tree lands
        if chaos.enabled():
            # the static engine's one hook site; nothing is admitted yet,
            # so a retry is trivially safe
            self._retry("serve.round",
                        lambda: chaos.fire("serve.round", engine=self))
        if self.resilience is not None:
            self._verify_integrity()
            self._expire_queue()
            self._maybe_degrade()
        batch = self._admit()
        if not batch:
            return []
        b = len(batch)
        plen = len(batch[0].prompt)
        budget = max(r.max_new_tokens for r in batch)
        if plen + budget > self.max_len:
            raise ValueError(f"round needs {plen + budget} positions, the "
                             f"cache holds {self.max_len}")
        cache = self._fresh_cache(b)
        prompts = np.stack([r.prompt for r in batch]).astype(np.int32)
        t0 = self._now()
        logits, cache, prefill_calls = self._prefill(cache, prompts)
        _sync(logits)
        t1 = self._now()
        last = _greedy(logits)
        # budget-exact generation: each request stops at its own budget,
        # and the round issues exactly max(budget) - 1 decode calls
        decode_steps = 0
        while True:
            t_tok = self._now()
            for i, r in enumerate(batch):
                if len(r.out_tokens) < r.max_new_tokens:
                    r.out_tokens.append(int(last[i]))
                    if r.first_token_s is None:
                        r.first_token_s = t_tok
                    if len(r.out_tokens) >= r.max_new_tokens:
                        r.finish_s = t_tok
            if all(len(r.out_tokens) >= r.max_new_tokens for r in batch):
                break
            decode_steps += 1
            tok = torch.as_tensor(last[:, None], dtype=torch.long,
                                  device=self.device)
            logits, cache = self._decode(self._step_params, cache, tok)
            last = _greedy(logits)
        t2 = self._now()
        st = RoundStats(
            batch=b, prompt_len=plen, prefill_calls=prefill_calls,
            prefill_s=t1 - t0, decode_calls=decode_steps, decode_s=t2 - t1,
            new_tokens=sum(len(r.out_tokens) for r in batch),
            ttft_s=[r.ttft_s for r in batch],
            tpot_s=[r.tpot_s for r in batch if r.tpot_s is not None])
        self.round_stats.append(st)
        if obs.enabled():
            # registry/tracer views of the SAME stamps RoundStats carries
            obs.complete("serve.prefill", t0, t1, engine="static",
                         batch=b, calls=st.prefill_calls)
            obs.complete("serve.decode", t1, t2, engine="static",
                         batch=b, calls=st.decode_calls)
            obs.counter("repro_serve_rounds_total").inc()
            obs.counter("repro_serve_admitted_total",
                        engine="static").inc(b)
            obs.counter("repro_serve_tokens_total",
                        engine="static").inc(st.new_tokens)
            obs.gauge("repro_serve_queue_depth",
                      engine="static").set(len(self.queue))
            for r in batch:
                self._obs_request_done(r)
            record_weight_traffic(self._format_bytes(),
                                  st.prefill_calls + st.decode_calls)
        for r in batch:
            r.done = True
        self._observe_step_time(t2 - t0)
        if self._quality is not None and obs.enabled():
            # quality sampling (DESIGN.md §14): only with obs on AND a
            # monitor attached, so the default path is unchanged
            self._quality.observe_step(self, t2 - t0, batch)
        self._poll_requant()
        return batch

    def run_until_done(self, max_rounds: int = 1000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_rounds):
            if not self.queue:
                break
            done.extend(self.run_round())
        return done


class ContinuousEngine(_EngineBase):
    """Continuous-batching scheduler: per-slot decode streams with
    in-flight admission and eviction.

    Token streams equal those of the static oracle for the dense, ssm,
    hybrid, encoder–decoder and prefix-LM families: prefill is decode
    steps and decode is row-wise (the recurrent blocks' contractions
    included), so the mixed batch never couples slots; an idle slot's
    recurrent rows step on a pad token, isolated, until the next graft
    overwrites them.  Requests carry tokens only, as the reference's: an
    encoder–decoder slot's cross K/V (the cache's extras, grafted, cut
    and reset with its K/V) stay zero and a prefix-LM request has no
    image prefix; ``models.prefill`` takes frames and patches.
    """

    _obs_engine = "continuous"

    def __init__(self, cfg: ArchConfig, params, *,
                 config: Optional[EngineConfig] = None, **kwargs):
        self._setup(cfg, params, resolve_engine_config(
            config, kwargs, where="ContinuousEngine"))
        self.reset_on_evict = self.config.reset_on_evict
        self.step_stats: List[StepStats] = []
        self.finished: List[Request] = []
        self.cache = self._fresh_cache(self.n_slots, per_slot=True)
        self.slots: List[Optional[Request]] = [None] * self.n_slots
        self._last = np.zeros((self.n_slots,), np.int32)  # next input token
        self.prefill_calls = 0
        self.prefill_s = 0.0
        self.decode_calls = 0
        self.decode_s = 0.0

    def submit(self, req: Request) -> bool:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(f"request {req.rid} exceeds cache length "
                             f"{self.max_len}")
        if not self._submit_common(req):
            return False
        self.queue.append(req)
        self._obs_arrival(req)
        return True

    @property
    def active_slots(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    def _admit_many(self, pairs, finished: List[Request]) -> None:
        """Prefill a burst of admissions together, then graft each slot.

        The burst shares one lockstep prefill over its COMMON prefix
        length; each longer prompt finishes its ragged tail on its own
        batch-1 row.  ``prefill_s`` bills only prefill device work."""
        g = len(pairs)
        reqs = [r for _, r in pairs]
        common = min(len(r.prompt) for r in reqs)
        t0 = self._now()
        sub = self._fresh_cache(g)
        toks = np.stack([np.asarray(r.prompt[:common], np.int32)
                         for r in reqs])
        logits, sub, calls = self._prefill(sub, toks)
        _sync(logits)
        t1 = self._now()
        self.prefill_s += t1 - t0
        obs.complete("serve.prefill", t0, t1, engine="continuous",
                     slots=[s for s, _ in pairs], calls=calls,
                     common_len=common)
        for i, (slot, req) in enumerate(pairs):
            if g == 1:
                sub_i, log_i = sub, logits
            else:
                sub_i = cache_rows(sub, i)
                log_i = logits[i:i + 1]
            tail = np.asarray(req.prompt[common:], np.int32)
            if tail.size:
                t_tail = self._now()
                log_i, sub_i, c_tail = self._prefill(sub_i, tail[None, :])
                _sync(log_i)
                t_tail_end = self._now()
                self.prefill_s += t_tail_end - t_tail
                obs.complete("serve.prefill", t_tail, t_tail_end,
                             engine="continuous", slot=slot, rid=req.rid,
                             calls=c_tail)
                calls += c_tail
            first = int(_greedy(log_i)[0])
            self.cache = cache_write_slot(self.cache, sub_i, slot)
            t_tok = self._now()
            req.first_token_s = t_tok
            req.out_tokens.append(first)
            self.slots[slot] = req
            self._last[slot] = first
            if obs.enabled():
                # per-slot admission lane: burst prefill + this row's graft
                obs.complete("serve.admit", t0, t_tok, tid=slot, slot=slot,
                             engine="continuous", rid=req.rid,
                             prompt_len=len(req.prompt))
                obs.instant("serve.request.first_token", rid=req.rid,
                            slot=slot, engine="continuous")
            if len(req.out_tokens) >= req.max_new_tokens:
                self._finish(slot, req, t_tok, finished)
        self.prefill_calls += calls
        if obs.enabled():
            obs.counter("repro_serve_admitted_total",
                        engine="continuous").inc(g)
            obs.counter("repro_serve_tokens_total",
                        engine="continuous").inc(g)
            record_weight_traffic(self._format_bytes(), calls)

    def _free_slot(self, slot: int) -> None:
        self.slots[slot] = None
        self._last[slot] = 0
        if self.reset_on_evict:
            # optional hygiene: the next graft overwrites the row anyway
            self.cache = cache_reset_slot(self.cache, slot)

    def _finish(self, slot: int, req: Request, t: float,
                finished: List[Request]) -> None:
        req.done = True
        req.finish_s = t
        self._free_slot(slot)
        self.finished.append(req)
        finished.append(req)
        if obs.enabled():
            obs.counter("repro_serve_evicted_total").inc()
            self._obs_request_done(req, slot=slot)

    def _expire_slots(self) -> None:
        """Cancel in-flight requests whose deadline passed; free the slot
        (its stale row is handled exactly like an eviction's)."""
        now_mono = self._mono()
        for i, r in enumerate(self.slots):
            if r is not None and self._deadline_expired(r, now_mono):
                self._free_slot(i)
                self._drop(r, "deadline", slot=i)

    def _admit_burst(self, pairs, finished: List[Request]) -> None:
        """Chaos-hooked admission entry: the admission-failure fault fires
        here, BEFORE any prefill/graft state write, so a retry replays the
        identical burst."""
        if chaos.enabled():
            chaos.fire("serve.admit", engine=self)
        self._admit_many(pairs, finished)

    def _decode_dispatch(self):
        """Chaos-hooked decode entry (device-loss / slow-step site).

        The fault fires before the decode writes this step's K/V rows into
        the cache; a retried decode recomputes from the same params,
        tokens and positions and rewrites the same rows with the same
        values, so the retry is exact."""
        if chaos.enabled():
            chaos.fire("serve.decode", engine=self)
        tok = torch.as_tensor(self._last[:, None], dtype=torch.long,
                              device=self.device)
        return self._decode(self._step_params, self.cache, tok)

    def step(self) -> List[Request]:
        """One scheduler iteration: admit → lockstep decode → evict.

        Returns the requests that finished during this step.  With
        resilience configured the step also fires the serve.step chaos
        hook, heals corrupted payloads, expires deadlined requests
        (queued and in-flight), walks the degradation ladder, retries
        transient admission/decode faults and snapshots periodically."""
        finished: List[Request] = []
        self._tick += 1
        self._sync_clock()
        self._apply_pending_swap()      # step boundary: a staged tree lands
        t0 = self._now()
        if chaos.enabled():
            chaos.fire("serve.step", engine=self)
        if self.resilience is not None:
            self._verify_integrity()
            self._expire_queue()
            self._expire_slots()
            self._maybe_degrade()
        pairs = []
        while self.queue and None in self.slots:
            slot = self.slots.index(None)
            req = self.queue.popleft()
            self.slots[slot] = req          # reserve before the next index()
            pairs.append((slot, req))
        admitted = len(pairs)
        if pairs:
            try:
                self._retry("serve.admit",
                            lambda: self._admit_burst(pairs, finished))
            except BaseException:
                # retry budget exhausted (or not transient): un-reserve the
                # untouched requests and put them back at the FRONT of the
                # queue in arrival order, so nothing is silently lost (an
                # injected fault fires before _admit_many writes anything)
                for slot, req in pairs:
                    if self.slots[slot] is req and not req.out_tokens:
                        self.slots[slot] = None
                for slot, req in reversed(pairs):
                    if not req.out_tokens and not req.dropped:
                        self.queue.appendleft(req)
                raise
        active = [i for i, r in enumerate(self.slots) if r is not None]
        decoded = 0
        if active:
            td = self._now()
            logits, self.cache = self._retry("serve.decode",
                                             self._decode_dispatch)
            t_disp = self._now()
            last = _greedy(logits)
            t_tok = self._now()
            self.decode_calls += 1
            self.decode_s += t_tok - td
            obs.complete("serve.decode", td, t_tok, engine="continuous",
                         slots=active)
            obs.complete("serve.dispatch", td, t_disp, engine="continuous")
            obs.complete("serve.sample", t_disp, t_tok, engine="continuous")
            for i in active:
                r = self.slots[i]
                r.out_tokens.append(int(last[i]))
                self._last[i] = last[i]
                decoded += 1
                if len(r.out_tokens) >= r.max_new_tokens:
                    self._finish(i, r, t_tok, finished)
        t_end = self._now()
        self.step_stats.append(StepStats(
            active=len(active), admitted=admitted, finished=len(finished),
            new_tokens=admitted + decoded, step_s=t_end - t0))
        if obs.enabled():
            obs.complete("serve.step", t0, t_end, engine="continuous",
                         active=len(active), admitted=admitted,
                         finished=len(finished))
            obs.counter("repro_serve_tokens_total",
                        engine="continuous").inc(decoded)
            obs.gauge("repro_serve_slots_active",
                      engine="continuous").set(self.active_slots)
            obs.gauge("repro_serve_queue_depth",
                      engine="continuous").set(len(self.queue))
            if active:
                record_weight_traffic(self._format_bytes(), 1)
        self._observe_step_time(t_end - t0)
        if self._quality is not None and obs.enabled():
            # quality sampling (DESIGN.md §14): only with obs on AND a
            # monitor attached, so the default path is unchanged
            self._quality.observe_step(self, t_end - t0, self.slots)
        self._poll_requant()
        res = self.resilience
        if (res is not None and res.snapshot_every and res.snapshot_dir
                and self._tick % res.snapshot_every == 0):
            self.snapshot(res.snapshot_dir)
        return finished

    # -- snapshot / resume (DESIGN.md §12) ----------------------------------

    @staticmethod
    def _req_record(r: Request) -> dict:
        """JSON-portable request record for the snapshot manifest."""
        return {"rid": r.rid,
                "prompt": np.asarray(r.prompt).tolist(),
                "max_new_tokens": r.max_new_tokens,
                "out_tokens": list(r.out_tokens),
                "deadline_s": r.deadline_s,
                "arrival_s": r.arrival_s,
                "first_token_s": r.first_token_s}

    def snapshot(self, ckpt_dir: str, *, keep: Optional[int] = None) -> str:
        """Write a crash-consistent engine snapshot via ``dist.checkpoint``.

        Device state (slot cache, int8 scales included, and the next-token
        vector) is brought to the host into the checkpoint payload; host
        scheduler state (slot/queue request records, tick, rung) rides the
        manifest's ``extra_meta`` JSON.  The write is atomic, so a kill at
        any moment leaves the last committed snapshot restorable."""
        from repro_torch.dist.checkpoint import save_checkpoint
        res = self.resilience
        if keep is None:
            keep = res.snapshot_keep if res is not None else 3
        state = {"cache": self.cache, "last": np.asarray(self._last)}
        meta = {
            "engine": {"n_slots": self.n_slots, "max_len": self.max_len,
                       "prefill_chunk": self.prefill_chunk,
                       "reset_on_evict": self.reset_on_evict,
                       "tick": self._tick, "rung": self._rung},
            "slots": [None if r is None else self._req_record(r)
                      for r in self.slots],
            "queue": [self._req_record(r) for r in self.queue],
        }
        t0 = time.perf_counter()
        path = save_checkpoint(ckpt_dir, self._tick, state, keep=keep,
                               extra_meta=meta)
        t1 = time.perf_counter()
        if obs.enabled():
            obs.complete("resilience.snapshot", t0, t1, engine="continuous",
                         step=self._tick, path=str(path))
            obs.counter("repro_serve_snapshots_total",
                        engine="continuous").inc()
        return str(path)

    @classmethod
    def resume(cls, ckpt_dir: str, cfg: ArchConfig, params, *,
               step: Optional[int] = None,
               config: Optional[EngineConfig] = None,
               **kwargs) -> "ContinuousEngine":
        """Rebuild an engine from the latest (or ``step``-th) snapshot.

        ``params`` must be the serving tree the snapshotting engine held
        (weights are not in the snapshot).  Scheduler state — slot
        assignments, partial token streams, queue order, tick — and the
        cache come back exactly: the fresh engine's cache is the restore
        template, so every leaf lands in a new buffer of its dtype on the
        engine's device.
        Deadline clocks restart at resume (``time.monotonic`` is
        process-local)."""
        from repro_torch.dist.checkpoint import (read_manifest,
                                                 restore_checkpoint)
        manifest = read_manifest(ckpt_dir, step=step)
        meta = manifest["meta"]
        em = meta["engine"]
        if config is not None:
            if kwargs:
                raise TypeError("resume: pass either config=EngineConfig"
                                "(...) or legacy kwargs, not both "
                                f"(got {sorted(kwargs)})")
        else:
            # legacy-kwarg path: the snapshot's geometry fills the gaps
            kwargs.setdefault("n_slots", em["n_slots"])
            kwargs.setdefault("max_len", em["max_len"])
            kwargs.setdefault("prefill_chunk", em.get("prefill_chunk"))
            kwargs.setdefault("reset_on_evict",
                              em.get("reset_on_evict", False))
            config = EngineConfig(**kwargs)
        eng = cls(cfg, params, config=config)
        if eng.n_slots != em["n_slots"] or eng.max_len != em["max_len"]:
            raise ValueError(
                f"snapshot geometry (n_slots={em['n_slots']}, "
                f"max_len={em['max_len']}) does not match the engine "
                f"(n_slots={eng.n_slots}, max_len={eng.max_len})")
        template = {"cache": eng.cache, "last": np.asarray(eng._last)}
        state, _ = restore_checkpoint(ckpt_dir, template,
                                      step=manifest["step"])
        eng.cache = state["cache"]
        eng._last = np.asarray(state["last"]).astype(np.int32)

        now_mono = eng._mono()

        def revive(rec: dict) -> Request:
            req = Request(rid=rec["rid"],
                          prompt=np.asarray(rec["prompt"], np.int32),
                          max_new_tokens=rec["max_new_tokens"],
                          out_tokens=list(rec["out_tokens"]),
                          deadline_s=rec.get("deadline_s"))
            req.arrival_s = rec.get("arrival_s")
            req.first_token_s = rec.get("first_token_s")
            req.arrival_mono = now_mono
            return req

        eng.slots = [None if rec is None else revive(rec)
                     for rec in meta["slots"]]
        eng.queue = deque(revive(rec) for rec in meta["queue"])
        eng._tick = em["tick"]
        rung = em.get("rung", 0)
        if rung and eng.resilience is not None \
                and eng.resilience.degrade is not None:
            eng._set_rung(rung, "resume", len(eng.queue))
        if obs.enabled():
            obs.instant("resilience.resume", engine="continuous",
                        step=em["tick"], slots=sum(
                            1 for r in eng.slots if r is not None),
                        queued=len(eng.queue))
        return eng

    def run_until_done(self, max_steps: int = 100_000) -> List[Request]:
        """Step until idle; raise :class:`EngineStalledError` (naming the
        stuck slots and queue depth) if ``max_steps`` runs out with work
        pending."""
        done: List[Request] = []
        for _ in range(max_steps):
            if not self.queue and self.active_slots == 0:
                return done
            done.extend(self.step())
        if self.queue or self.active_slots:
            stuck = [(i, r.rid, len(r.out_tokens), r.max_new_tokens)
                     for i, r in enumerate(self.slots) if r is not None]
            raise EngineStalledError(max_steps, stuck, len(self.queue))
        return done

