"""Model configurations of the port: the paper CNN (``paper_cnn``) and the
LM architectures, copied from the reference (plain Python, no framework).
``load_all()`` imports every arch module (idempotent)."""
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    ArchConfig,
    AttentionSpec,
    EncoderSpec,
    LayerSpec,
    MLPSpec,
    MoESpec,
    ShapeConfig,
    SSMSpec,
    all_archs,
    get_arch,
    shape_applicable,
)

_LOADED = False

ARCH_MODULES = (
    "gemma3_27b",
    "tinyllama_1_1b",
    "jamba_v0_1_52b",
    "llama3_8b",
    "whisper_tiny",
    "mamba2_370m",
    "deepseek_v2_236b",
    "pixtral_12b",
    "stablelm_1_6b",
    "llama4_maverick_400b",
)


def load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib

    for mod in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True
