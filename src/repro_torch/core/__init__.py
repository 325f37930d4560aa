"""repro_torch.core — the parts of ``repro.core`` the serving path needs."""
from .packing import (CODE_RANGE, PAD_MULT, pack_codes, pack_int2_planar,
                      pack_int3_planar, pack_int4_planar, unpack_int2_planar,
                      unpack_int3_planar, unpack_int4_planar)

__all__ = ["CODE_RANGE", "PAD_MULT", "pack_codes", "pack_int2_planar",
           "pack_int3_planar", "pack_int4_planar", "unpack_int2_planar",
           "unpack_int3_planar", "unpack_int4_planar"]
