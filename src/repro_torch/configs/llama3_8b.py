"""llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256. [arXiv:2407.21783]
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
def llama3_8b() -> ArchConfig:
    return ArchConfig(
        name="llama3-8b",
        family="dense",
        citation="arXiv:2407.21783",
        d_model=4096,
        vocab_size=128_256,
        pattern=(_LAYER,),
        repeats=32,
        rope_theta=500_000.0,
        norm_eps=1e-5,
    )
