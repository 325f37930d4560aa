"""repro_torch.configs — the dense architectures the port serves."""
import importlib

_MODULES = ["minicpm_2b", "qwen1_5_32b", "qwen2_5_32b", "minitron_8b"]
_loaded = False


def _load_all():
    global _loaded
    if not _loaded:
        for m in _MODULES:
            importlib.import_module(f"repro_torch.configs.{m}")
        _loaded = True


from .base import ArchConfig, get_config, list_archs  # noqa: E402

__all__ = ["ArchConfig", "get_config", "list_archs"]
