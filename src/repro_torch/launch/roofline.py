"""Roofline analysis of a step from its counted costs (port of
``repro/launch/roofline.py``).

Three terms per (arch × shape × mesh), in seconds, with one NVIDIA H100
SXM's published figures (:class:`HW`):

    compute    = dot_FLOPs_per_device / 989e12          (bf16 dense peak)
    memory     = HBM_bytes_per_device / 3.35e12         (HBM3 bandwidth)
    collective = collective_bytes_per_device / 450e9    (NVLink, one way)

FLOPs, bytes and collective bytes come from ``launch.hlo_cost``'s counter
over the port's own execution (:func:`report_from_costs`, the counterpart
of the reference's ``report_from_artifacts`` over HLO).  The collective
term takes one rate, as the reference's does.  Also derives MODEL_FLOPS
(6·N·D train, 2·N·D inference; N_active for MoE), the usefulness ratio
MODEL_FLOPS / counted FLOPs, and names the dominant term.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

__all__ = ["HW", "HBM_BYTES_PER_S", "BF16_FLOP_PER_S", "F32_FLOP_PER_S",
           "collective_bytes_from_log", "model_flops", "RooflineReport",
           "report_from_costs"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One NVIDIA H100 SXM (80 GB HBM3) at its 700 W power limit, dense
    rates from NVIDIA's data sheet.  A card set below 700 W runs slower
    under load: state a share of these peaks beside the card's limit."""
    peak_flops: float = 989e12        # bf16 tensor cores, dense
    hbm_bw: float = 3.35e12           # bytes/s of HBM3
    link_bw: float = 450e9            # bytes/s of NVLink 4, each way
    n_links: int = 1                  # one aggregate rate, as the reference


#: the card's figures that ``chip_smoke.py``'s kernel bounds take
HBM_BYTES_PER_S = HW().hbm_bw
BF16_FLOP_PER_S = HW().peak_flops
F32_FLOP_PER_S = 67e12                # f32 outside the tensor cores


def collective_bytes_from_log(
        log: Iterable[Tuple[str, str, Tuple[int, ...], int]]
) -> Dict[str, float]:
    """Per-collective-kind byte totals of a mesh's ``(op, dtype, shape,
    bytes)`` log (result bytes per rank), with their ``total``."""
    out: Dict[str, float] = {}
    for op, _, _, nbytes in log:
        out[op] = out.get(op, 0.0) + float(nbytes)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """6·N·D for training, 2·N·D for inference forward."""
    if kind == "train":
        return 6.0 * n_params_active * tokens
    return 2.0 * n_params_active * tokens


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, float]
    model_flops_total: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    useful_ratio: float = 0.0
    bytes_per_device_peak: float = 0.0   # argument + peak temporary bytes

    def finalize(self, hw: HW = HW()) -> "RooflineReport":
        self.compute_s = self.hlo_flops_per_device / hw.peak_flops
        self.memory_s = self.hlo_bytes_per_device / hw.hbm_bw
        self.collective_s = self.collective_bytes_per_device / \
            (hw.n_links * hw.link_bw)
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.dominant = max(terms, key=terms.get)
        total_flops = self.hlo_flops_per_device * self.chips
        self.useful_ratio = (self.model_flops_total / total_flops
                             if total_flops else 0.0)
        return self

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the card's peak the dominant-term time implies for
        the useful model FLOPs: (MODEL_FLOPS/chips/peak) / bound_time."""
        if self.bound_time_s == 0:
            return 0.0
        ideal = self.model_flops_total / self.chips / HW().peak_flops
        return ideal / self.bound_time_s

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def report_from_costs(*, arch: str, shape: str, mesh: str, chips: int,
                      costs, model_flops_total: float,
                      mem_peak_bytes: float = 0.0,
                      hw: HW = HW()) -> RooflineReport:
    """A report from one rank's ``launch.hlo_cost.StepCosts``.  The
    counter sees every iteration of the eager program, so no loop
    multiplicity is applied; the breakdown keeps the kernels' share of
    the FLOPs and the count of ops beside the collectives' bytes."""
    rep = RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops_per_device=costs.dot_flops,
        hlo_bytes_per_device=costs.hbm_bytes,
        collective_bytes_per_device=costs.collective_bytes,
        collective_breakdown=dict(costs.collective_breakdown),
        model_flops_total=model_flops_total,
        bytes_per_device_peak=mem_peak_bytes,
    ).finalize(hw)
    rep.collective_breakdown["kernel_flops"] = costs.kernel_flops
    rep.collective_breakdown["n_ops"] = float(costs.n_ops)
    rep.collective_breakdown["loop_multiplicity"] = costs.multiplicity_ratio
    return rep
