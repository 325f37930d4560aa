"""repro_torch.core — WaterSIC, its baselines and the serving packer.

Public API (the reference's names):
  ZSIC (Alg. 1):       zsic_numpy, zsic, zsic_lmmse_numpy, zsic_lmmse,
                       zsic_blocked
  WaterSIC (Alg. 2/3): plain_watersic, watersic_quantize, quantize_at_rate,
                       CalibStats, QuantizedLinear
  Baselines:           rtn_absmax, huffman_rtn
  Rates/coding:        empirical_entropy, effective_rate, HuffmanCode,
                       huffman_bits, codec_bits_zlib, codec_bits_lzma
  Theory (§3):         waterfilling_rate, high_rate_bound, gptq_gap_bits,
                       watersic_gap_bits, GAP_CUBE_BITS, random_covariance
  Rescalers (Alg. 4):  find_optimal_rescalers
  Budget (App. D):     RateBudget, PlanBudget (a repro_torch.plan plan)
  Packing:             pack_codes and the planar packers/unpackers
"""
from .entropy import (HuffmanCode, codec_bits_lzma, codec_bits_zlib,
                      column_entropies, effective_rate, empirical_entropy,
                      huffman_bits)
from .packing import (CODE_RANGE, PAD_MULT, pack_codes, pack_int2_planar,
                      pack_int3_planar, pack_int4_planar, unpack_int2_planar,
                      unpack_int3_planar, unpack_int4_planar)
from .rate_alloc import PlanBudget, RateBudget
from .rescalers import RescalerResult, find_optimal_rescalers, rescaler_loss
from .rtn import huffman_rtn, rtn_absmax
from .theory import (GAP_CUBE_BITS, chol_lower, gptq_gap_bits, high_rate_bound,
                     predicted_distortion_gptq, predicted_distortion_watersic,
                     random_covariance, waterfilling_distortion,
                     waterfilling_rate, watersic_gap_bits)
from .watersic import (CalibStats, QuantizedLinear, initial_spacing,
                       layer_distortion, plain_watersic, quantize_at_rate,
                       watersic_quantize)
from .zsic import (ZSICResult, zsic, zsic_blocked, zsic_lmmse,
                   zsic_lmmse_numpy, zsic_numpy)

__all__ = [k for k in dir() if not k.startswith("_")]
