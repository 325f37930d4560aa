"""repro_torch.plan — the global mixed-precision planner (port of
``repro.plan``, DESIGN.md §10).

Per-matrix distortion-rate curves from calibration spectra
(``sensitivity``), the global bit budget allocated by bisection on one
water level and snapped onto the serving grid (``waterfill``), a
versioned, diffable artifact that loads in either package (``artifact``),
and parallel execution of the independent per-matrix quantizations
(``executor``).  ``core.rate_alloc.PlanBudget`` and
``quant.pipeline.quantize_model(plan=...)`` run a plan through the
sequential pipeline.
"""
from .artifact import PLAN_SCHEMA_VERSION, PlanEntry, QuantPlan
from .executor import (ExecutorReport, execute_plan, plan_inputs_for_model,
                       quantize_model_with_plan)
from .sensitivity import (MatrixSensitivity, apply_constraints,
                          collect_sigma_x, distortion_at_rate,
                          model_sensitivities, rd_curve,
                          sensitivity_from_matrix, sensitivity_from_streamed)
from .waterfill import (SERVING_FORMATS, allocation_distortion, build_plan,
                        even_plan, even_spread_target, payload_bits_for,
                        rewaterfill_subset, snap_bits, waterfill_bits)

__all__ = [
    "PLAN_SCHEMA_VERSION", "PlanEntry", "QuantPlan",
    "ExecutorReport", "execute_plan", "plan_inputs_for_model",
    "quantize_model_with_plan",
    "MatrixSensitivity", "apply_constraints", "collect_sigma_x",
    "distortion_at_rate", "model_sensitivities", "rd_curve",
    "sensitivity_from_matrix", "sensitivity_from_streamed",
    "SERVING_FORMATS", "allocation_distortion", "build_plan", "even_plan",
    "even_spread_target", "payload_bits_for", "rewaterfill_subset",
    "snap_bits", "waterfill_bits",
]
