"""Serve-side quality observatory (port of ``repro/serve/quality.py``,
DESIGN.md §14).

The engines measure latency and bytes (§11); this module watches the
quantity the paper says quality IS a function of — the input-activation
covariance Σ_X — and the output discrepancy the deployed quantization
actually incurs, live, behind the same one-boolean ``obs.enabled()``
no-op contract as every other instrumentation site.

:class:`QualityMonitor` attaches to either engine (``quality=`` ctor
field of ``EngineConfig``) and, on a deterministic tick schedule (never
wall-clock):

* **streamed Σ_X** — every ``sigma_every`` steps, shadow-runs the
  current in-flight token window through the fp reference model with
  ``quant.calibrate.forward_with_taps`` and folds each matrix's input
  tap into a Welford estimator (``obs.streamsig``).  Divergence against
  the calibration statistics — relative Frobenius shift when the full
  calibration Σ is available, top-eigenvalue / spectrum shift against
  the plan's stored sensitivity spectra — is published as per-matrix
  ``repro_quality_sigma_*`` gauges and fed to the drift detectors.
* **distortion probes** — every ``probe_every`` steps, re-runs the
  window through BOTH the fp twin and the served tree, records the
  realized logits MSE, and per matrix materializes the served Ŵ via
  ``kernels.dequant.ref.dequantize_leaf_ref`` to measure the realized
  output discrepancy  mean_t‖x_t(Ŵ−W)‖²/N  — the live estimate of
  tr((Ŵ−W)ᵀ Σ (Ŵ−W))/N that reconciles against the plan's predicted
  per-matrix distortion (``repro_quality_*`` histograms/gauges;
  benchmarks/check_quality.py gates the ratio).  Linearity-theorem
  output weights turn the absolute per-matrix errors into the
  per-layer quality attribution ``launch/summarize.py`` renders.
* **drift + SLO** — step-time / integrity / divergence / logits-MSE
  series run through ``obs.drift`` detectors (flags surface as
  ``quality.drift`` instants + ``repro_quality_drift_total``), and
  ``obs.slo`` burn rates evaluate every ``slo_every`` steps.

The shadow forwards cost one extra fp forward per sampled step — a
sampling knob, not a serving-path change: with ``obs`` disabled the
engines never call into this module (tests/test_torch_quality.py).  The
tapped forwards run on the device of the trees (the served tree's dense
layers through the dequant kernels on the card); the streamed statistics
are float64 numpy on the host, as in the reference, and the Σ spectra
(eigvalsh) are float64 on the params' device, as in ``plan.sensitivity``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

import torch

from repro_torch import obs
from repro_torch.obs.drift import Cusum, DriftMonitor, PageHinkley, Threshold
from repro_torch.obs.slo import SloSpec, default_slos, evaluate_slos
from repro_torch.obs.streamsig import (SigmaTracker, frobenius_shift,
                                       spectrum_shift, top_eig_shift)

__all__ = ["QualityConfig", "QualityMonitor"]

#: serving format → payload bits/weight (bound lookups; raw fp has none)
_FORMAT_BITS = {"int8": 8, "int4": 4, "packed-int4": 4,
                "packed-int3": 3, "packed-int2": 2}


def _np64(x) -> np.ndarray:
    """float64 numpy copy of a tensor (any device) or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _default_detectors():
    """Series-keyed detector factories (obs/drift.py, all deterministic).

    ``step_s`` uses a slack of one baseline mean and an 8-baseline
    decision interval: a chaos slow-step sleep (≥ 10× a quick-model
    step) trips it in one sample while ordinary jitter does not.
    ``integrity`` flags ANY corrupt-payload detection.  Divergence and
    logits series get a CUSUM tuned for sustained upward shifts.
    """
    return {
        "step_s": lambda: PageHinkley(delta=1.0, lam=8.0, burn_in=4),
        "integrity": lambda: Threshold(limit=0.0),
        "logits_mse": lambda: Cusum(k=1.0, h=8.0, burn_in=4),
    }


@dataclasses.dataclass
class QualityConfig:
    """Sampling cadence + detector/SLO wiring for one monitor."""

    sigma_every: int = 4          # shadow Σ_X update period (ticks)
    probe_every: int = 8          # distortion-probe period (ticks)
    slo_every: int = 16           # burn-rate evaluation period (ticks)
    window: int = 16              # token-history tail per request
    max_rows: int = 8             # shadow-batch row cap
    slos: Optional[List[SloSpec]] = None          # default: default_slos()
    detectors: Optional[Dict[str, Any]] = None    # default: _default_detectors
    track_sigma_drift: bool = True  # feed sigma divergence to detectors


class QualityMonitor:
    """Live quality signals for one served model; see module docstring.

    ``reference_params`` is the fp tree the served weights quantized
    from (same structure, raw leaves).  ``calib`` (optional) is the
    calibration ``StatsAccumulator`` whose ``L{l}/{tap}/xx`` second
    moments anchor divergence and expected-distortion computation;
    ``sensitivities`` (optional) are the plan's ``MatrixSensitivity``
    records — their spectra give a Σ-free divergence reference and
    their weights the output-error attribution coefficients.
    """

    def __init__(self, cfg, reference_params, *, calib=None,
                 sensitivities=None, config: Optional[QualityConfig] = None):
        from repro_torch.quant.pipeline import matrix_tap_map
        self.cfg = cfg
        self.ref = reference_params
        self._device = reference_params["embed"]["w"].device
        self.calib = calib
        self.config = config or QualityConfig()
        self.mats = matrix_tap_map(cfg, reference_params)
        self.sens_by_name = {s.name: s for s in (sensitivities or [])}
        self.slos = (self.config.slos if self.config.slos is not None
                     else default_slos())
        self.tracker = SigmaTracker()
        self.drift = DriftMonitor(
            detectors=self.config.detectors or _default_detectors(),
            default=PageHinkley)
        self.tick = 0
        self.probes: List[Dict[str, Any]] = []
        self.slo_rows: List[Dict[str, Any]] = []
        self._integrity_last = 0.0
        self._ref_sigma: Dict[str, np.ndarray] = {}     # sigma_key → Σ_calib
        self._ref_spec: Dict[str, np.ndarray] = {}      # sigma_key → λ(Σ)
        self._expected: Dict[str, Dict[str, float]] = {}  # name → cache
        self._attrib_w: Dict[str, float] = {}           # name → w_l
        if calib is not None:
            for rec in self.mats:
                key = rec["sigma_key"]
                if key not in self._ref_sigma and calib.has(key):
                    sig = _np64(calib.get(key))
                    self._ref_sigma[key] = sig
                    self._ref_spec[key] = self._spectrum(sig)

    # -- engine hook (called behind obs.enabled() by both engines) ----------

    def observe_step(self, engine, dt: float, reqs) -> None:
        """One scheduler step/round: feed series, run due sampling."""
        self.tick += 1
        self._series("step_s", dt)
        cur = sum(obs.counters_snapshot(
            "repro_serve_integrity_corrupt_total").values())
        self._series("integrity", cur - self._integrity_last)
        self._integrity_last = cur
        c = self.config
        due_sigma = c.sigma_every and self.tick % c.sigma_every == 0
        due_probe = c.probe_every and self.tick % c.probe_every == 0
        if due_sigma or due_probe:
            toks = self._window_tokens(reqs)
            if toks is not None:
                from repro_torch.quant.calibrate import forward_with_taps
                t0 = time.perf_counter()
                logits_fp, taps = forward_with_taps(self.cfg, self.ref, toks)
                if due_sigma:
                    self._update_sigma(taps)
                if due_probe:
                    self._probe(engine, toks, logits_fp, taps)
                obs.complete("quality.shadow", t0, time.perf_counter(),
                             tick=self.tick, rows=int(toks.shape[0]),
                             sigma=bool(due_sigma), probe=bool(due_probe))
        if c.slo_every and self.tick % c.slo_every == 0:
            self.slo_rows = evaluate_slos(self.slos)

    # -- swap/requant hooks (DESIGN.md §15) ---------------------------------

    def on_swap(self, *, reason: str = "") -> None:
        """The engine hot-swapped its served tree (degrade or requant):
        drop every cached expected distortion.  The cache is keyed
        (matrix, format), but the CODES changed even where the format
        did not — a stale entry would reconcile the new tree against the
        old tree's quantization error."""
        self._expected.clear()

    def rebase_sigma(self, sigma_by_tap: Dict[str, Any]) -> None:
        """Re-anchor the divergence reference after a requant actuation.

        ``sigma_by_tap`` maps tap ids (``"L{l}/{tap}"``) to the
        uncentered Σ the new plan was solved from.  The matching
        calibration-side references, the drift detectors over those
        series, and the cached attribution weights of the affected
        matrices (all functions of Σ) are replaced, so post-swap
        divergence gauges and drift series measure movement from the
        NEW operating point — otherwise the detector would keep firing
        on the very drift the actuator just absorbed.
        """
        rebased = set()
        for rec in self.mats:
            tap_id = f"L{rec['layer']}/{rec['tap']}"
            if tap_id not in sigma_by_tap:
                continue
            key = rec["sigma_key"]
            if key not in rebased:
                sig = _np64(sigma_by_tap[tap_id])
                self._ref_sigma[key] = sig
                self._ref_spec[key] = self._spectrum(sig)
                self.drift.reset(f"sigma_fro:{tap_id}")
                rebased.add(key)
            self._attrib_w.pop(rec["name"], None)
        self._expected.clear()

    # -- internals ----------------------------------------------------------

    def _series(self, name: str, value: float) -> None:
        if self.drift.observe(name, value):
            flag = self.drift.flags[-1]
            obs.instant("quality.drift", series=name, value=float(value),
                        index=flag.index, tick=self.tick)
            obs.counter("repro_quality_drift_total", series=name).inc()

    def _window_tokens(self, reqs) -> Optional[np.ndarray]:
        """Last-``window`` token tails of the in-flight requests, cropped
        to a common length (a shadow batch for the tap forward)."""
        seqs = []
        for r in reqs:
            if r is None:
                continue
            seq = np.concatenate([np.asarray(r.prompt, np.int32),
                                  np.asarray(r.out_tokens, np.int32)])
            seqs.append(seq[-self.config.window:])
            if len(seqs) >= self.config.max_rows:
                break
        if not seqs:
            return None
        common = min(len(s) for s in seqs)
        if common == 0:
            return None
        return np.stack([s[-common:] for s in seqs]).astype(np.int32)

    def _spectrum(self, sig: np.ndarray) -> np.ndarray:
        """Ascending eigenvalues of the symmetrized Σ, clipped ≥ 0, in
        float64 on the reference params' device (at full width a 5760-wide
        Σ's eigvalsh on the host takes seconds)."""
        from repro_torch.plan.sensitivity import _spectrum
        return _spectrum(torch.as_tensor(sig, device=self._device))

    def _update_sigma(self, taps) -> None:
        # per tap, once per update: the estimate, its Σ (a fresh array per
        # read), the shift against the calibration Σ and the spectrum; the
        # reference recomputes these per matrix, with the same values
        fresh: Dict[str, Dict[str, Any]] = {}
        for rec in self.mats:
            key = rec["sigma_key"]
            tap_id = f"L{rec['layer']}/{rec['tap']}"
            if tap_id not in fresh:
                x = _np64(taps[rec["layer"]][rec["tap"]])
                est = self.tracker.update(tap_id, x)
                fresh[tap_id] = {"sigma": est.sigma}
            cur = fresh[tap_id]
            if "spec" not in cur and (key in self._ref_sigma
                                      or rec["name"] in self.sens_by_name):
                cur["spec"] = self._spectrum(cur["sigma"])
            name = rec["name"]
            sens = self.sens_by_name.get(name)
            if key in self._ref_sigma:
                if "fro" not in cur:
                    cur["fro"] = frobenius_shift(cur["sigma"],
                                                 self._ref_sigma[key])
                fro = cur["fro"]
                obs.gauge("repro_quality_sigma_fro_shift",
                          matrix=name).set(fro)
                top = top_eig_shift(cur["spec"], self._ref_spec[key])
                obs.gauge("repro_quality_sigma_topeig_shift",
                          matrix=name).set(top)
                if self.config.track_sigma_drift:
                    self._series(f"sigma_fro:{tap_id}", fro)
            elif sens is not None:
                spec = cur["spec"]
                obs.gauge("repro_quality_spectrum_shift", matrix=name) \
                    .set(spectrum_shift(spec, sens.lambdas))
                obs.gauge("repro_quality_sigma_topeig_shift", matrix=name) \
                    .set(top_eig_shift(spec, sens.lambdas))

    def _leaf_for(self, params, path):
        node = params["layers"]
        for k in path:
            node = node[k]
        return node["w"]

    def _expected_for(self, name: str, fmt: str, err: np.ndarray,
                      sigma_key: str) -> Optional[float]:
        """tr(Eᵀ Σ_calib E)/N — the plan-side prediction of the deployed
        tree's realized distortion — cached per (matrix, format) since
        the served codes are static between tree swaps."""
        cache = self._expected.setdefault(name, {})
        if fmt in cache:
            return cache[fmt]
        sig = self._ref_sigma.get(sigma_key)
        if sig is None:
            cache[fmt] = None
            return None
        val = float(np.einsum("io,ij,jo->", err, sig, err)) / err.size
        cache[fmt] = val
        return val

    def _attrib_weight(self, name: str, w_fp: np.ndarray,
                       sigma_key: str) -> float:
        """Linearity-theorem output weight w_l: the plan's coefficient if
        sensitivities were provided, else 1/tr(WᵀΣW) from calibration,
        else uniform."""
        if name in self._attrib_w:
            return self._attrib_w[name]
        sens = self.sens_by_name.get(name)
        if sens is not None:
            w = float(sens.weight)
        else:
            sig = self._ref_sigma.get(sigma_key)
            if sig is None:
                w = 1.0
            else:
                tr = float(np.einsum("io,ij,jo->", w_fp, sig, w_fp))
                w = 1.0 / max(tr, 1e-30)
        self._attrib_w[name] = w
        return w

    def _probe(self, engine, toks, logits_fp, taps) -> None:
        from repro_torch.kernels.dequant.ref import dequantize_leaf_ref
        from repro_torch.plan.sensitivity import distortion_at_rate
        from repro_torch.quant.calibrate import forward_with_taps
        from repro_torch.quant.qlinear import is_qweight, leaf_format
        logits_q, _ = forward_with_taps(self.cfg, engine.params, toks)
        d = _np64(logits_q) - _np64(logits_fp)
        lmse = float(np.mean(d * d))
        obs.histogram("repro_quality_logits_mse",
                      engine=engine._obs_engine).observe(lmse)
        self._series("logits_mse", lmse)
        rows: List[Dict[str, Any]] = []
        for rec in self.mats:
            name, l = rec["name"], rec["layer"]
            leaf = self._leaf_for(engine.params, rec["path"])
            fmt = leaf_format(leaf) if is_qweight(leaf) else "raw"
            if fmt == "raw":
                continue                      # fp leaf: zero discrepancy
            w_hat = dequantize_leaf_ref(leaf, index=l)       # (in, out)
            w_fp = _np64(self._leaf_for(self.ref, rec["path"])[l])
            err = _np64(w_hat) - w_fp
            x = _np64(taps[l][rec["tap"]])
            x = x.reshape(-1, x.shape[-1])
            y = x @ err
            measured = float(np.mean(np.sum(y * y, axis=1))) / err.size
            expected = self._expected_for(name, fmt, err, rec["sigma_key"])
            sens = self.sens_by_name.get(name)
            bound = None
            if sens is not None and fmt in _FORMAT_BITS:
                bound = distortion_at_rate(sens, float(_FORMAT_BITS[fmt]))
            obs.histogram("repro_quality_matrix_mse", format=fmt) \
                .observe(measured)
            ratio = None
            if expected:
                ratio = measured / expected
                obs.gauge("repro_quality_matrix_ratio", matrix=name) \
                    .set(ratio)
            w_attr = self._attrib_weight(name, w_fp, rec["sigma_key"])
            obs.gauge("repro_quality_attrib", matrix=name,
                      layer=str(l)).set(w_attr * measured * err.size)
            rows.append({"matrix": name, "layer": l, "format": fmt,
                         "measured": measured, "expected": expected,
                         "ratio": ratio, "bound": bound,
                         "attrib": w_attr * measured * err.size})
        self.probes.append({"tick": self.tick, "logits_mse": lmse,
                            "mats": rows})
        obs.instant("quality.probe", tick=self.tick, logits_mse=lmse,
                    n_mats=len(rows))

    # -- reporting ----------------------------------------------------------

    def matrix_summary(self) -> List[Dict[str, Any]]:
        """Per-matrix aggregate over every probe run so far."""
        agg: Dict[str, Dict[str, Any]] = {}
        for p in self.probes:
            for row in p["mats"]:
                a = agg.setdefault(row["matrix"], {
                    "matrix": row["matrix"], "layer": row["layer"],
                    "format": row["format"], "n": 0, "measured": 0.0,
                    "expected": row["expected"], "bound": row["bound"],
                    "attrib": 0.0})
                a["n"] += 1
                a["measured"] += row["measured"]
                a["attrib"] += row["attrib"]
        out = []
        for a in sorted(agg.values(), key=lambda r: r["matrix"]):
            n = max(a["n"], 1)
            a["measured"] /= n
            a["attrib"] /= n
            a["ratio"] = (a["measured"] / a["expected"]
                          if a["expected"] else None)
            out.append(a)
        return out

    def summary(self) -> Dict[str, Any]:
        """JSON-portable verdict block (the bench artifact embeds this)."""
        lmses = [p["logits_mse"] for p in self.probes]
        return {
            "ticks": self.tick,
            "n_probes": len(self.probes),
            "logits_mse_mean": (float(np.mean(lmses)) if lmses else None),
            "matrices": self.matrix_summary(),
            "drift": self.drift.summary(),
            "slo": self.slo_rows,
            "sigma_keys": self.tracker.keys(),
        }
