from .dequant_matmul import (LAUNCHES, PLANE_GROUPS, dequant_matmul_int8_cuda,
                             dequant_matmul_packed_cuda, reset_launches)
from .ops import (dequant_matmul, dequant_matmul_packed, payload_checksums,
                  payload_nbits, verify_payloads)
from .ref import (dequant_matmul_packed_ref, dequant_matmul_ref,
                  dequantize_leaf_ref, dequantize_ref, unpack_payload_ref)

__all__ = ["LAUNCHES", "PLANE_GROUPS", "dequant_matmul_int8_cuda",
           "dequant_matmul_packed_cuda",
           "reset_launches", "dequant_matmul", "dequant_matmul_packed",
           "payload_checksums", "payload_nbits", "verify_payloads",
           "dequant_matmul_packed_ref", "dequant_matmul_ref",
           "dequantize_leaf_ref", "dequantize_ref", "unpack_payload_ref"]
