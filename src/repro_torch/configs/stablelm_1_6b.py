"""stablelm-1.6b [dense] — 24L d_model=2048 32H (kv=32, i.e. MHA)
d_ff=5632 vocab=100352. LayerNorm + partial rotary (25%).
[hf:stabilityai/stablelm-2-1_6b]
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
    attn=AttentionSpec(num_heads=32, num_kv_heads=32, head_dim=64, rope_frac=0.25),
    mlp=MLPSpec(kind="dense", d_ff=5632, activation="silu"),
)


@register
def stablelm_1_6b() -> ArchConfig:
    return ArchConfig(
        name="stablelm-1.6b",
        family="dense",
        citation="hf:stabilityai/stablelm-2-1_6b",
        d_model=2048,
        vocab_size=100_352,
        pattern=(_LAYER,),
        repeats=24,
        norm="layernorm",
        norm_eps=1e-5,
        rope_theta=10_000.0,
    )
