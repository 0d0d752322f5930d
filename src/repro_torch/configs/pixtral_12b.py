"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072. Pixtral-ViT vision encoder + projector is a STUB —
``input_specs`` provides patch embeddings prepended to the token stream;
the language backbone is mistral-nemo-like. [hf:mistralai/Pixtral-12B-2409]
"""
from repro_torch.configs.base import (
    ArchConfig,
    AttentionSpec,
    LayerSpec,
    MLPSpec,
    register,
)

_LAYER = LayerSpec(
    kind="attn",
    attn=AttentionSpec(num_heads=32, num_kv_heads=8, head_dim=128),
    mlp=MLPSpec(kind="dense", d_ff=14336, activation="silu"),
)


@register
def pixtral_12b() -> ArchConfig:
    return ArchConfig(
        name="pixtral-12b",
        family="vlm",
        citation="hf:mistralai/Pixtral-12B-2409",
        d_model=5120,
        vocab_size=131_072,
        pattern=(_LAYER,),
        repeats=40,
        rope_theta=1_000_000.0,
        norm_eps=1e-5,
        frontend="vision_stub",
        frontend_tokens=256,  # one 1024px image -> 256 merged patch embeddings
    )
