"""repro_torch.configs — the dense, MoE, ssm (RWKV6), hybrid (RG-LRU),
encoder–decoder (whisper) and prefix-LM (paligemma) architectures the
port serves."""
import importlib

_MODULES = ["minicpm_2b", "qwen1_5_32b", "qwen2_5_32b", "minitron_8b",
            "phi3_5_moe", "moonshot_v1_16b", "rwkv6_7b",
            "recurrentgemma_2b", "whisper_base", "paligemma_3b"]
_loaded = False


def _load_all():
    global _loaded
    if not _loaded:
        for m in _MODULES:
            importlib.import_module(f"repro_torch.configs.{m}")
        _loaded = True


from .base import (SHAPES, ArchConfig, ShapeSpec, get_config,  # noqa: E402
                   input_specs, list_archs, runnable_cells)

__all__ = ["ArchConfig", "SHAPES", "ShapeSpec", "get_config", "input_specs",
           "list_archs", "runnable_cells"]
