"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000. llama2-arch small. [arXiv:2401.02385]
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
    attn=AttentionSpec(num_heads=32, num_kv_heads=4, head_dim=64),
    mlp=MLPSpec(kind="dense", d_ff=5632, activation="silu"),
)


@register
def tinyllama_1_1b() -> ArchConfig:
    return ArchConfig(
        name="tinyllama-1.1b",
        family="dense",
        citation="arXiv:2401.02385",
        d_model=2048,
        vocab_size=32_000,
        pattern=(_LAYER,),
        repeats=22,
        rope_theta=10_000.0,
        norm_eps=1e-5,
    )
