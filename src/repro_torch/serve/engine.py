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
dispatch its modeled weight traffic (``record_weight_traffic``).  Off, it
is one boolean test per site and the streams are unchanged.  The
reference's chaos, resilience, quality, requant and snapshot hooks are
later slices of the port and are left out here.

The engines run on the device of ``params`` (the embedding's device).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.dequant.ops import (record_weight_traffic,
                                             weight_format_bytes)
from repro_torch.models import (cache_reset_slot, cache_write_slot,
                                decode_chunk, decode_step, init_cache,
                                split_layers)
from repro_torch.quant import leaf_format_histogram, qweight_bytes
from repro_torch.serve.config import EngineConfig, resolve_engine_config

__all__ = ["Request", "RoundStats", "StepStats", "ServeEngine",
           "ContinuousEngine", "EngineStalledError", "EngineConfig"]


class EngineStalledError(RuntimeError):
    """``run_until_done`` ran out of steps with work still pending."""

    def __init__(self, max_steps, stuck, queued):
        self.max_steps, self.stuck, self.queued = max_steps, stuck, queued
        super().__init__(
            f"engine stalled after {max_steps} steps: {queued} queued, "
            f"stuck slots (slot, rid, emitted, budget) = {stuck}")


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
    """Construction and observability shared by both engines.

    ``_format_bytes`` lazily caches the tree's per-format stored bytes
    (the ``quant.leaf_inventory`` grouping) so each device dispatch can be
    charged its modeled weight read; every obs hook is one
    ``obs.enabled()`` test when disabled."""

    _obs_engine = "?"
    _fmt_bytes = None

    def _format_bytes(self):
        if self._fmt_bytes is None:
            self._fmt_bytes = weight_format_bytes(self.params)
        return self._fmt_bytes

    def _obs_arrival(self, req: "Request") -> None:
        if obs.enabled():
            obs.instant("serve.request.arrival", rid=req.rid,
                        engine=self._obs_engine)
            obs.gauge("repro_serve_queue_depth",
                      engine=self._obs_engine).set(len(self.queue))

    def _obs_request_done(self, req: "Request", slot=None) -> None:
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

    def _setup(self, cfg: ArchConfig, params, config: EngineConfig):
        self.config = config
        self.cfg = cfg
        self.params = params
        # per-layer views cut once, not on every decode step
        self._step_params = split_layers(params)
        self.device = params["embed"]["w"].device
        self.n_slots = config.n_slots
        self.max_len = config.max_len
        self.cache_dtype = config.cache_dtype
        self.prefill_chunk = config.prefill_chunk
        self.queue: deque = deque()
        # realized weight bytes vs bf16 and the per-leaf format mix
        self.weight_bytes, self.weight_bytes_bf16 = qweight_bytes(params)
        self.weight_formats = leaf_format_histogram(params)
        self._decode = config.decode_fn or (
            lambda p, c, tok: decode_step(cfg, p, c, tok))
        self._decode_chunk = config.decode_chunk_fn or (
            lambda p, c, toks: decode_chunk(cfg, p, c, toks))

    def _fresh_cache(self, batch: int, per_slot: bool = False):
        return init_cache(self.cfg, batch, self.max_len, self.cache_dtype,
                          per_slot=per_slot, device=self.device)

    def _prefill(self, cache, prompts: np.ndarray):
        return _run_prefill(self._decode, self._decode_chunk,
                            self._step_params, cache, prompts,
                            self.prefill_chunk, self.device)


class ServeEngine(_EngineBase):
    """Static-batching rounds — the reference scheduler."""

    _obs_engine = "static"

    def __init__(self, cfg: ArchConfig, params, *,
                 config: Optional[EngineConfig] = None, **kwargs):
        self._setup(cfg, params,
                    resolve_engine_config(config, kwargs, where="ServeEngine"))
        self.round_stats: List[RoundStats] = []

    def submit(self, req: Request) -> bool:
        if req.arrival_s is None:
            req.arrival_s = time.perf_counter()
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
        t0 = time.perf_counter()
        logits, cache, prefill_calls = self._prefill(cache, prompts)
        _sync(logits)
        t1 = time.perf_counter()
        last = _greedy(logits)
        # budget-exact generation: each request stops at its own budget,
        # and the round issues exactly max(budget) - 1 decode calls
        decode_steps = 0
        while True:
            t_tok = time.perf_counter()
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
        t2 = time.perf_counter()
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

    Token streams equal those of the static oracle for the dense family:
    prefill is decode steps and decode is row-wise, so the mixed batch
    never couples slots.
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
        if req.arrival_s is None:
            req.arrival_s = time.perf_counter()
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
        t0 = time.perf_counter()
        sub = self._fresh_cache(g)
        toks = np.stack([np.asarray(r.prompt[:common], np.int32)
                         for r in reqs])
        logits, sub, calls = self._prefill(sub, toks)
        _sync(logits)
        t1 = time.perf_counter()
        self.prefill_s += t1 - t0
        obs.complete("serve.prefill", t0, t1, engine="continuous",
                     slots=[s for s, _ in pairs], calls=calls,
                     common_len=common)
        for i, (slot, req) in enumerate(pairs):
            if g == 1:
                sub_i, log_i = sub, logits
            else:
                sub_i = sub._replace(kv=type(sub.kv)(
                    *(t[:, i:i + 1] for t in sub.kv)))
                log_i = logits[i:i + 1]
            tail = np.asarray(req.prompt[common:], np.int32)
            if tail.size:
                t_tail = time.perf_counter()
                log_i, sub_i, c_tail = self._prefill(sub_i, tail[None, :])
                _sync(log_i)
                t_tail_end = time.perf_counter()
                self.prefill_s += t_tail_end - t_tail
                obs.complete("serve.prefill", t_tail, t_tail_end,
                             engine="continuous", slot=slot, rid=req.rid,
                             calls=c_tail)
                calls += c_tail
            first = int(_greedy(log_i)[0])
            self.cache = cache_write_slot(self.cache, sub_i, slot)
            t_tok = time.perf_counter()
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

    def _finish(self, slot: int, req: Request, t: float,
                finished: List[Request]) -> None:
        req.done = True
        req.finish_s = t
        self.slots[slot] = None
        self._last[slot] = 0
        if self.reset_on_evict:
            # optional hygiene: the next graft overwrites the row anyway
            self.cache = cache_reset_slot(self.cache, slot)
        self.finished.append(req)
        finished.append(req)
        if obs.enabled():
            obs.counter("repro_serve_evicted_total").inc()
            self._obs_request_done(req, slot=slot)

    def step(self) -> List[Request]:
        """One scheduler iteration: admit → lockstep decode → evict.
        Returns the requests that finished during this step."""
        finished: List[Request] = []
        t0 = time.perf_counter()
        pairs = []
        while self.queue and None in self.slots:
            slot = self.slots.index(None)
            req = self.queue.popleft()
            self.slots[slot] = req          # reserve before the next index()
            pairs.append((slot, req))
        admitted = len(pairs)
        if pairs:
            self._admit_many(pairs, finished)
        active = [i for i, r in enumerate(self.slots) if r is not None]
        decoded = 0
        if active:
            td = time.perf_counter()
            tok = torch.as_tensor(self._last[:, None], dtype=torch.long,
                                  device=self.device)
            logits, self.cache = self._decode(self._step_params, self.cache,
                                              tok)
            last = _greedy(logits)
            t_tok = time.perf_counter()
            self.decode_calls += 1
            self.decode_s += t_tok - td
            obs.complete("serve.decode", td, t_tok, engine="continuous",
                         slots=active)
            for i in active:
                r = self.slots[i]
                r.out_tokens.append(int(last[i]))
                self._last[i] = last[i]
                decoded += 1
                if len(r.out_tokens) >= r.max_new_tokens:
                    self._finish(i, r, t_tok, finished)
        t_end = time.perf_counter()
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
        return finished

    def run_until_done(self, max_steps: int = 100_000) -> List[Request]:
        """Step until idle; raise :class:`EngineStalledError` if
        ``max_steps`` runs out with work pending."""
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
