from .qlinear import (is_packed2_qweight, is_packed3_qweight,
                      is_packed_qweight, is_qweight, leaf_format,
                      leaf_format_histogram, leaf_inventory,
                      quantize_params_tree, qweight_bytes)

__all__ = ["is_packed2_qweight", "is_packed3_qweight", "is_packed_qweight",
           "is_qweight", "leaf_format", "leaf_format_histogram",
           "leaf_inventory", "quantize_params_tree", "qweight_bytes"]
