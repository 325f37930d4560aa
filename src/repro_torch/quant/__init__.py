from .qlinear import (from_watersic, is_packed2_qweight, is_packed3_qweight,
                      is_packed_qweight, is_qweight, leaf_format,
                      leaf_format_histogram, leaf_inventory,
                      quantize_params_tree, qweight_bytes,
                      serving_formats_from_plan)

__all__ = ["from_watersic", "is_packed2_qweight", "is_packed3_qweight",
           "is_packed_qweight", "is_qweight", "leaf_format",
           "leaf_format_histogram", "leaf_inventory", "quantize_params_tree",
           "qweight_bytes", "serving_formats_from_plan"]
